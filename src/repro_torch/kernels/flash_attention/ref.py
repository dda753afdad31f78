"""The plain version of GQA attention (causal / sliding window / q_offset).

The counterpart of the reference's ``kernels/flash_attention/ref.py::
attention_ref``: float32 scores, the masks from absolute positions, a full
softmax (fully masked rows give 0), output in ``q.dtype``.  It is the CPU
path of ``flash_attention`` and the card's oracle for the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hkv, Sk, D] → [B, Hq, Sq, D].

    Query head h reads kv head ``h // (Hq // Hkv)``; query row i sits at
    absolute position ``q_offset + i``, key row j at j.  A key is seen when
    ``j <= pos`` (causal) and ``j > pos - window`` (window)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    scale = sm_scale if sm_scale is not None else D ** -0.5
    qg = q.float().reshape(B, Hkv, group, Sq, D)          # head h = kv·group + g
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bkgqs,bksd->bkgqd", p / denom, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
