"""The plain versions of GQA attention (causal / sliding window / q_offset).

``attention_plain`` is the counterpart of the reference's
``kernels/flash_attention/ref.py::attention_ref``: float32 scores, the masks
from absolute positions, a full softmax (fully masked rows give 0), output
in ``q.dtype``.  It is the CPU path of ``flash_attention`` and the card's
oracle for the kernels.  ``attention_int8_plain`` is the same over an int8
KV cache, dequantized first as the reference's decode does.
``decode_attention_split_plain`` is the decode
kernel's arithmetic written out (a softmax per split of the visible rows,
then the merge), so that the CPU tests hold that decomposition to the JAX
package.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def dequantize_kv(x8: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Float32 rows of an int8 cache: ``x8`` [..., S, D] times its bfloat16
    per-row ``scale`` [..., S], one float32 multiply an element (the
    reference's ``qk8.astype(f32) * sk.astype(f32)[..., None]``)."""
    return x8.float() * scale.float()[..., None]


def attention_int8_plain(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                         k_scale: torch.Tensor, v_scale: torch.Tensor, *,
                         causal: bool = True, window: Optional[int] = None,
                         sm_scale: Optional[float] = None,
                         q_offset: int = 0) -> torch.Tensor:
    """``attention_plain`` over an int8 KV cache: k8, v8 [B, Hkv, Sk, D] int8
    with bfloat16 scales [B, Hkv, Sk], dequantized by ``dequantize_kv``;
    output in ``q.dtype``."""
    return attention_plain(q, dequantize_kv(k8, k_scale), dequantize_kv(v8, v_scale),
                           causal=causal, window=window, sm_scale=sm_scale,
                           q_offset=q_offset)


def visible_rows(Sq: int, Sk: int, causal: bool, window: Optional[int],
                 q_offset: int) -> Tuple[int, int]:
    """``[k_lo, k_hi)``: the key rows some query row of the call may see
    (rows outside it are never read); empty when ``k_lo == k_hi``."""
    hi = min(Sk, q_offset + Sq) if causal else Sk
    lo = max(0, q_offset - window + 1) if window is not None else 0
    return lo, max(hi, lo)


def decode_attention_split_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 splits: int, chunk: int, causal: bool = True,
                                 window: Optional[int] = None,
                                 sm_scale: Optional[float] = None,
                                 q_offset: int = 0) -> torch.Tensor:
    """``attention_plain`` as the decode kernel computes it: the visible rows
    ``[k_lo, k_hi)`` (``visible_rows``) cut into ``splits`` runs of ``chunk``
    rows (``ops.decode_splits``); per run and query row, m = the largest
    visible score, l = sum exp(s - m), acc = sum exp(s - m) v (an empty run
    holds (-inf, 0, 0)); then m* = max m, l* = sum l e^(m - m*), out = sum acc
    e^(m - m*) / max(l*, 1e-30).  Float32 throughout; q [B, Hq, Sq, D], k and
    v [B, Hkv, Sk, D]."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = Hq // Hkv
    R = group * Sq
    scale = sm_scale if sm_scale is not None else D ** -0.5
    lo, hi = visible_rows(Sq, Sk, causal, window, q_offset)
    qr = q.float().reshape(B, Hkv, R, D) * scale        # row r = g * Sq + i
    pos = torch.arange(R, device=q.device) % Sq + q_offset
    ms, ls, accs = [], [], []
    for s in range(splits):
        a = lo + s * chunk
        e = min(a + chunk, hi)
        if e <= a:
            ms.append(torch.full((B, Hkv, R), float("-inf"), device=q.device))
            ls.append(torch.zeros((B, Hkv, R), device=q.device))
            accs.append(torch.zeros((B, Hkv, R, D), device=q.device))
            continue
        kp = torch.arange(a, e, device=q.device)[None, :]
        sc = torch.einsum("bkrd,bksd->bkrs", qr, k[:, :, a:e].float())
        mask = torch.ones((R, e - a), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kp <= pos[:, None]
        if window is not None:
            mask &= kp > pos[:, None] - window
        sc = sc.masked_fill(~mask, float("-inf"))
        m = sc.amax(dim=-1)
        p = torch.exp(sc - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkrs,bksd->bkrd", p, v[:, :, a:e].float()))
    m = torch.stack(ms)
    mstar = m.amax(dim=0)
    w = torch.exp(m - torch.where(torch.isinf(mstar), torch.zeros_like(mstar), mstar))
    den = (torch.stack(ls) * w).sum(dim=0).clamp_min(1e-30)
    out = (torch.stack(accs) * w[..., None]).sum(dim=0) / den[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)
