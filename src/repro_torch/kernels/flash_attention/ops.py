"""The attention kernels' wrapper, their routes, plain versions and launch
counts.

  flash_attention    GQA attention with a causal mask, a sliding window and
                     an absolute offset of the first query row (``q_offset``)
  decode_attention   one new token per sequence against the first
                     ``cache_len`` rows of a KV cache

``impl='torch'`` runs the plain version (``ref.attention_plain``) on any
device.  ``impl='cuda'`` on CPU tensors also runs the plain version (that is
how the CPU tests reach this path); on CUDA tensors it launches one of three
kernels, as ``attention_route`` picks from the call's shape, or raises:

  'decode'  at most 16 query rows per kv head (Sq x group): every decode
            step.  ``csrc/flash_decode.cu``, split-K over the visible cache
            rows (``visible_rows``, cut by ``decode_splits``), the q heads of
            a kv head in one block, then a merge pass; float32 or bfloat16.
  'tc'      bfloat16 at d_head 64, 128 or 256: every prefill of the LM.
            ``csrc/flash_attention_sm90.cu``, wgmma and TMA.
  'simt'    the rest (float32; d_head 16 or 32): ``csrc/flash_attention.cu``,
            the products on the CUDA cores in float32.

An int8 KV cache (``scales=(k_scale, v_scale)``: int8 K and V with a
bfloat16 scale per row, the reference's ``kv_cache_quant``) takes the decode
route only, through the same kernel's int8 instantiation
(``csrc/flash_decode_int8.cu``, d_head 64, 128 or 256); on the card a call off
that route raises.  Its plain version is ``ref.attention_int8_plain``.

``LAUNCHES`` counts kernel launches: ``'flash_attention'`` every one,
``'flash_attention_<route>'`` those of each route (a decode launch is its
split pass and merge pass), and ``'flash_attention_decode_int8'`` the decode
launches over an int8 cache (counted under ``'flash_attention_decode'`` too).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import build
from ..common import launches_kernel
from .ref import attention_int8_plain, attention_plain, visible_rows

ROUTES = ("tc", "decode", "simt")
LAUNCHES = {"flash_attention": 0, **{f"flash_attention_{r}": 0 for r in ROUTES},
            "flash_attention_decode_int8": 0}

#: head widths the kernels are built for, and those of the tensor-core route
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)
#: head widths of the decode kernel's int8 instantiation
INT8_HEAD_DIMS = (64, 128, 256)
#: query rows per kv head that the decode kernel holds in one block
DECODE_ROWS = 16
#: the fewest cache rows a decode split walks: below it the partials'
#: float32 traffic (D + 2 floats a row and split) starts to tell
MIN_SPLIT_ROWS = 64
#: decode blocks the splits aim at per SM (six of d_head 256 fit one)
DECODE_BLOCKS_PER_SM = 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENTRY = {"tc": ("flash_attention_sm90", "flash_attention_tc_fwd"),
          "decode": ("flash_decode", "flash_decode_fwd"),
          "decode_int8": ("flash_decode_int8", "flash_decode_int8_fwd"),
          "simt": ("flash_attention", "flash_attention_fwd")}
_FNS: dict = {}
_SM_COUNT: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def attention_route(dtype: torch.dtype, D: int, Sq: int, group: int) -> str:
    """The kernel a CUDA call goes to: 'decode' where its Sq x group query
    rows per kv head fit one block (<= 16), else 'tc' for bfloat16 at d_head
    64, 128 or 256, else 'simt'.  From the shape alone: no device sync."""
    if Sq * group <= DECODE_ROWS:
        return "decode"
    if dtype == torch.bfloat16 and D in TC_HEAD_DIMS:
        return "tc"
    return "simt"


def decode_splits(batch: int, kv_heads: int, rows: int, sm_count: int) -> Tuple[int, int]:
    """(splits, chunk) of the decode kernel: split s walks the visible rows
    ``[k_lo + s * chunk, min(k_lo + (s + 1) * chunk, k_hi))`` of every
    (batch, kv head), where ``rows = k_hi - k_lo``.  Enough splits for
    ``DECODE_BLOCKS_PER_SM`` of the ``batch * kv_heads * splits`` blocks on
    each of the card's ``sm_count`` SMs (the loads in flight that keep HBM
    busy), but runs of at least ``MIN_SPLIT_ROWS`` rows; none empty.  From
    the shape alone: no device sync."""
    if rows <= 0:
        return 1, 0
    want = -(-DECODE_BLOCKS_PER_SM * sm_count // max(batch * kv_heads, 1))
    splits = max(1, min(want, rows // MIN_SPLIT_ROWS))
    chunk = -(-rows // splits)
    return -(-rows // chunk), chunk


def sm_count(dev: torch.device) -> int:
    """The card's SM count, read once per device."""
    n = _SM_COUNT.get(dev.index)
    if n is None:
        n = _SM_COUNT[dev.index] = torch.cuda.get_device_properties(dev).multi_processor_count
    return n


def _fn(route: str):
    """The C entry point of a route (or 'decode_int8'), looked up once."""
    f = _FNS.get(route)
    if f is None:
        lib, name = _ENTRY[route]
        f = _FNS[route] = getattr(build.load(lib), name)
    return f


def _strides(t: torch.Tensor, name: str, dev, dtype, vec: int) -> tuple:
    """An operand's strides, after the checks the kernels rely on: [B, H, S,
    D] on ``dev`` in ``dtype``, the last axis contiguous, base and strides on
    16 bytes (``vec`` elements: the kernels move rows 16 bytes at a time)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    st = t.stride()
    if len(st) != 4 or st[3] != 1:
        raise ValueError(f"{name} must be [B, H, S, D] with a contiguous last axis")
    if t.data_ptr() % 16 or st[0] % vec or st[1] % vec or st[2] % vec:
        raise ValueError(f"{name}: base and strides must be 16-byte aligned")
    return st


def _scale_strides(t: torch.Tensor, name: str, dev, shape: tuple) -> tuple:
    """An int8 cache's scales: bfloat16 [B, Hkv, Sk] on ``dev``, any strides
    (the kernel reads them one at a time)."""
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name} must be torch.bfloat16, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {list(shape)}, got {list(t.shape)}")
    return t.stride()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    sm_scale: Optional[float] = None, q_offset: int = 0,
                    scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    impl: str = "cuda") -> torch.Tensor:
    """q [B, Hq, Sq, D]; k, v [B, Hkv, Sk, D] (Sk >= Sq for decode) →
    [B, Hq, Sq, D] in ``q.dtype``; see ``ref.attention_plain``.  With
    ``scales`` (bfloat16 [B, Hkv, Sk] each), k and v are an int8 cache; see
    ``ref.attention_int8_plain``.  Every decode step calls this once a
    layer, so its host time is kept short."""
    if scales is None and torch.int8 in (k.dtype, v.dtype):
        raise TypeError("an int8 cache needs its scales: pass scales=(k_scale, v_scale)")
    if not launches_kernel(impl, "flash_attention", q, k, v):
        if scales is not None:
            return attention_int8_plain(q, k, v, *scales, causal=causal, window=window,
                                        sm_scale=sm_scale, q_offset=q_offset)
        return attention_plain(q, k, v, causal=causal, window=window,
                               sm_scale=sm_scale, q_offset=q_offset)
    dev, dtype = q.device, q.dtype
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    code = _DTYPES.get(dtype)
    if code is None:
        raise TypeError(f"q must be float32 or bfloat16, got {dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head width {D} not built; the kernels take {HEAD_DIMS}")
    if Hq % Hkv or k.shape != (B, Hkv, Sk, D) or v.shape != k.shape:
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    vec = 8 if code else 4
    qs = _strides(q, "q", dev, dtype, vec)
    if scales is None:
        ks, vs = (_strides(t, n, dev, dtype, vec) for t, n in ((k, "k"), (v, "v")))
    else:   # int8 rows: 16 elements a 16-byte load
        if Sq * (Hq // Hkv) > DECODE_ROWS:
            raise ValueError(f"the int8 cache takes the decode route only: {Sq} query rows "
                             f"x group {Hq // Hkv} > {DECODE_ROWS}")
        if D not in INT8_HEAD_DIMS:
            raise ValueError(f"head width {D} not built for the int8 cache; it takes "
                             f"{INT8_HEAD_DIMS}")
        ks, vs = (_strides(t, n, dev, torch.int8, 16) for t, n in ((k, "k"), (v, "v")))
        sks, svs = (_scale_strides(t, n, dev, (B, Hkv, Sk))
                    for t, n in zip(scales, ("k_scale", "v_scale")))
    # [B, Sq, Hq, D] storage: the caller's transpose back to [B, S, Hq·D] is free
    os_ = (Sq * Hq * D, D, Hq * D)
    out = torch.empty_strided((B, Hq, Sq, D), (*os_, 1), dtype=dtype, device=dev)
    if not (B and Hq and Sq):
        return out
    route = attention_route(dtype, D, Sq, Hq // Hkv)
    entry = route if scales is None else "decode_int8"    # the C entry point
    scale = float(sm_scale if sm_scale is not None else D ** -0.5)
    win = 0 if window is None else int(window)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *qs[:3], *ks[:3], *vs[:3], *os_)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if route == "decode":
        lo, hi = visible_rows(Sq, Sk, causal, window, q_offset)
        splits, chunk = decode_splits(B, Hkv, hi - lo, sm_count(dev))
        R = Hq // Hkv * Sq
        scratch = torch.empty(B * Hkv * splits * R * (D + 2), dtype=torch.float32, device=dev)
        if scales is not None:
            args += (scales[0].data_ptr(), scales[1].data_ptr(), *sks[:3], *svs[:3])
        err = _fn(entry)(*args, B, Hq, Hkv, Sq, D, code, scale, int(causal), win,
                         int(q_offset), lo, hi, chunk, splits, scratch.data_ptr(), stream)
    elif route == "tc":
        for t, name in ((q, "q"), (k, "k"), (v, "v")):
            if any(s == 0 and n > 1 for s, n in zip(t.stride(), t.shape)):
                raise ValueError(f"{name}: an axis of stride 0 has no tensor map")
        err = _fn(route)(*args, B, Hq, Hkv, Sq, Sk, D, scale, int(causal), win,
                         int(q_offset), stream)
    else:
        err = _fn(route)(*args, B, Hq, Hkv, Sq, Sk, D, code, scale, int(causal), win,
                         int(q_offset), stream)
    if err:
        build.check(err, _ENTRY[entry][1])
    LAUNCHES["flash_attention"] += 1
    LAUNCHES["flash_attention_" + route] += 1
    if scales is not None:
        LAUNCHES["flash_attention_decode_int8"] += 1
    return out


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     cache_len: int, *, window: Optional[int] = None,
                     sm_scale: Optional[float] = None,
                     scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                     impl: str = "cuda") -> torch.Tensor:
    """Single-token decode: q1 [B, Hq, 1, D] at position ``cache_len - 1``
    against caches [B, Hkv, Smax, D] (int8 with ``scales`` [B, Hkv, Smax]
    each); the causal bound reads only the first ``cache_len`` rows."""
    if not 1 <= cache_len <= k_cache.shape[2]:
        raise ValueError(f"cache_len {cache_len} outside 1..{k_cache.shape[2]}")
    return flash_attention(q1, k_cache, v_cache, causal=True, window=window,
                           sm_scale=sm_scale, q_offset=cache_len - 1, scales=scales,
                           impl=impl)

