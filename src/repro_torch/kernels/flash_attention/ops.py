"""The attention kernel's wrapper, its plain version and its launch count.

  flash_attention    GQA attention with a causal mask, a sliding window and
                     an absolute offset of the first query row (``q_offset``)
  decode_attention   one new token per sequence against the first
                     ``cache_len`` rows of a KV cache

``impl='torch'`` runs the plain version (``ref.attention_plain``) on any
device.  ``impl='cuda'`` on CPU tensors also runs the plain version (that is
how the CPU tests reach this path); on CUDA tensors it launches
``csrc/flash_attention.cu`` or raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import build
from ..common import check_impl
from .ref import attention_plain

LAUNCHES = {"flash_attention": 0}

#: head widths the kernel is built for (``csrc/flash_attention.cu``)
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_operand(t: torch.Tensor, name: str, dev, dtype) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != 4 or t.stride(3) != 1:
        raise ValueError(f"{name} must be [B, H, S, D] with a contiguous last axis")
    vec = 16 // t.element_size()             # the kernel moves rows 16 bytes at a time
    if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
        raise ValueError(f"{name}: base and strides must be 16-byte aligned")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    impl: str = "cuda") -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hkv, Sk, D] (Sk >= Sq for decode) →
    [B, Hq, Sq, D] in ``q.dtype``; see ``ref.attention_plain``."""
    if check_impl(impl) == "torch" or not q.is_cuda:
        return attention_plain(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale, q_offset=q_offset)
    dev = q.device
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not built; the kernel takes {HEAD_DIMS}")
    if Hq % Hkv or tuple(k.shape) != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        _check_operand(t, name, dev, q.dtype)
    # [B, Sq, Hq, D] storage: the caller's transpose back to [B, S, Hq·D] is free
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=dev).transpose(1, 2)
    if B and Hq and Sq:
        scale = sm_scale if sm_scale is not None else D ** -0.5
        lib = build.load("flash_attention")
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
            B, Hq, Hkv, Sq, Sk, D, _DTYPES[q.dtype], float(scale), int(causal),
            0 if window is None else int(window), int(q_offset),
            torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "flash_attention_fwd")
        LAUNCHES["flash_attention"] += 1
    return out


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, *, window: Optional[int] = None,
                     sm_scale: Optional[float] = None, impl: str = "cuda") -> torch.Tensor:
    """Single-token decode: q1 [B, Hq, 1, D] at position ``cache_len - 1``
    against caches [B, Hkv, Smax, D]; the causal bound reads only the first
    ``cache_len`` rows."""
    if not 1 <= cache_len <= k_cache.shape[2]:
        raise ValueError(f"cache_len {cache_len} outside 1..{k_cache.shape[2]}")
    return flash_attention(q1, k_cache, v_cache, causal=True, window=window,
                           sm_scale=sm_scale, q_offset=cache_len - 1, impl=impl)
