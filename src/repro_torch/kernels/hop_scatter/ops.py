"""The hop kernels' wrappers, their plain PyTorch versions and launch counts.

One traversal hop is

    src_val  = state[:, src]                # gather   [Q, E, *TS]
    cnt_e    = src_val * edge_weights       # mask     [Q, E, *TS]
    arrivals = segment_sum(cnt_e, dst)      # deliver  [Q, V, *TS]

over traversal edges sorted by arrival, so destination v's edges are the run
``ptr[v]:ptr[v+1]`` of the CSR pointer ``ptr`` (int32 [V+1]).  Every operand
carries a leading query axis Q (the reference gets it by vmap); a per-query
operand may be shared across queries as an ``expand``-ed view (query stride 0).

Four wrappers, one per CUDA kernel of ``csrc/hop_scatter.cu``:

  fused_hop_cols       static/bucket hop without the [Q, E, C] intermediate;
                       optional MIN/MAX extremum channel
  fused_hop_interval   the same in interval mode (B*(B+1) running-interval
                       cells, with the start/end clamps of each edge)
  scatter_cols         delivery of per-edge contributions that exist already
                       (ETR hops)
  scatter_extremum     segment min/max of a per-edge channel gated by alive

A wrapper given CPU tensors runs its plain version (``*_plain``); given CUDA
tensors it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches by wrapper name.  The sources say which TPU kernel each replaces and
what bounds it on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import build

LAUNCHES = {"fused_hop_cols": 0, "fused_hop_interval": 0, "scatter_cols": 0,
            "scatter_extremum": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# =========================================================================
# plain versions (the CPU path, and the card's oracle for the kernels)
# =========================================================================
def segment_ids(ptr: torch.Tensor, n_edges: int) -> torch.Tensor:
    """int64 [E] destination of each edge from the CSR pointer."""
    V = ptr.shape[0] - 1
    counts = (ptr[1:] - ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(V, device=ptr.device), counts,
                                   output_size=n_edges)


def _pad_row(x: torch.Tensor, fill: float) -> torch.Tensor:
    """Append the row that source id N (the zero/neutral row) reads."""
    pad = torch.full((x.shape[0], 1) + tuple(x.shape[2:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def _segment_sum(contrib: torch.Tensor, ptr: torch.Tensor) -> torch.Tensor:
    Qn, E = contrib.shape[:2]
    V = ptr.shape[0] - 1
    out = contrib.new_zeros((Qn, V) + tuple(contrib.shape[2:]))
    return out.index_add_(1, segment_ids(ptr, E), contrib)


def _segment_extremum(m_e, alive, ptr, neutral: float, op_is_min: bool):
    Qn, E = m_e.shape
    V = ptr.shape[0] - 1
    vals = torch.where(alive, m_e, torch.full_like(m_e, neutral))
    seg = segment_ids(ptr, E).expand(Qn, E)
    out = torch.full((Qn, V), neutral, dtype=torch.float32, device=m_e.device)
    return out.scatter_reduce_(1, seg, vals, "amin" if op_is_min else "amax",
                               include_self=True)


def interval_apply_plain(cells, w, sb, eb):
    """The interval-cell edge algebra on gathered state [Q, E, B, B+1]:
    clamp cell starts up to ``sb`` and ends down to ``eb`` (the mass below a
    threshold moves onto the threshold row/column), zero cells with s >= e,
    scale by ``w`` — ``superstep.apply_validity(MODE_INTERVAL)`` per edge."""
    B, Bp1 = cells.shape[-2], cells.shape[-1]
    dev = cells.device
    s_ids = torch.arange(B, device=dev).view(B, 1)
    e_ids = torch.arange(Bp1, device=dev).view(1, Bp1)
    sbx = sb[..., None, None]
    ebx = eb[..., None, None]
    acc_s = (cells * (s_ids <= sbx)).sum(dim=-2, keepdim=True)
    cells = cells * (s_ids > sbx) + (s_ids == sbx) * acc_s
    acc_e = (cells * (e_ids >= ebx)).sum(dim=-1, keepdim=True)
    cells = cells * (e_ids < ebx) + (e_ids == ebx) * acc_e
    cells = cells * (s_ids < e_ids)
    return cells * w[..., None, None]


def fused_hop_cols_plain(state, src, w, ptr, mch=None, neutral: float = 0.0,
                         op_is_min: bool = True):
    """[Q, N, C] state, int32 [E] src (N = zero row), [Q, E, C] weights →
    ([Q, V, C] arrivals, [Q, V] extremum | None)."""
    srcl = src.long()
    contrib = _pad_row(state, 0.0)[:, srcl] * w
    out = _segment_sum(contrib, ptr)
    if mch is None:
        return out, None
    alive = contrib.sum(dim=-1) > 0
    return out, _segment_extremum(_pad_row(mch, neutral)[:, srcl], alive, ptr,
                                  neutral, op_is_min)


def fused_hop_interval_plain(state, src, w, sb, eb, ptr, mch=None,
                             neutral: float = 0.0, op_is_min: bool = True):
    """[Q, N, B, B+1] state, int32 [E] src, [Q, E] weight and clamp buckets
    → ([Q, V, B, B+1] arrivals, [Q, V] extremum | None)."""
    srcl = src.long()
    contrib = interval_apply_plain(_pad_row(state, 0.0)[:, srcl], w, sb, eb)
    out = _segment_sum(contrib, ptr)
    if mch is None:
        return out, None
    alive = contrib.sum(dim=(-2, -1)) > 0
    return out, _segment_extremum(_pad_row(mch, neutral)[:, srcl], alive, ptr,
                                  neutral, op_is_min)


def scatter_cols_plain(contrib, ptr):
    """[Q, E, *TS] per-edge contributions → [Q, V, *TS] segment sums."""
    return _segment_sum(contrib, ptr)


def scatter_extremum_plain(m_e, alive, ptr, neutral: float, op_is_min: bool):
    """[Q, E] channel gated by ``alive > 0`` → [Q, V] segment min/max;
    empty segments hold ``neutral``."""
    return _segment_extremum(m_e, alive > 0, ptr, neutral, op_is_min)


# =========================================================================
# kernel launches
# =========================================================================
def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _qstride(t: torch.Tensor, name: str) -> int:
    """Query-axis stride in elements: per-query rows must be contiguous, and
    the query axis either packed or broadcast (stride 0)."""
    if not t[0].is_contiguous():
        raise ValueError(f"{name}: each query's rows must be contiguous")
    inner = t[0].numel()
    if t.shape[0] > 1 and t.stride(0) not in (0, inner):
        raise ValueError(f"{name}: query stride must be 0 or {inner}")
    return t.stride(0) if t.shape[0] > 1 else inner


def _check_index(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 vector on {device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def fused_hop_cols(state, src, w, ptr, mch=None, neutral: float = 0.0,
                   op_is_min: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused static/bucket hop; see ``fused_hop_cols_plain``."""
    if not state.is_cuda:
        return fused_hop_cols_plain(state, src, w, ptr, mch, neutral, op_is_min)
    dev = state.device
    Qn, N, C = state.shape
    E = src.shape[0]
    V = ptr.shape[0] - 1
    _check_index(src, "src", dev)
    _check_index(ptr, "ptr", dev)
    _check(state, "state", torch.float32, (Qn, N, C), dev)
    _check(w, "w", torch.float32, (Qn, E, C), dev)
    sq, wq = _qstride(state, "state"), _qstride(w, "w")
    mq, mptr = 0, None
    if mch is not None:
        _check(mch, "mch", torch.float32, (Qn, N), dev)
        mq, mptr = _qstride(mch, "mch"), mch.data_ptr()
    out = torch.empty((Qn, V, C), dtype=torch.float32, device=dev)
    mout = torch.empty((Qn, V), dtype=torch.float32, device=dev) if mch is not None else None
    if V and Qn:
        lib = build.load()
        err = lib.hop_fused_cols(state.data_ptr(), sq, N, C, src.data_ptr(),
                                 w.data_ptr(), wq, ptr.data_ptr(), V, Qn, mptr, mq,
                                 float(neutral), int(op_is_min), out.data_ptr(),
                                 None if mout is None else mout.data_ptr(),
                                 _stream(dev))
        build.check(err, "hop_fused_cols")
        LAUNCHES["fused_hop_cols"] += 1
    return out, mout


def fused_hop_interval(state, src, w, sb, eb, ptr, mch=None, neutral: float = 0.0,
                       op_is_min: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Fused interval hop; see ``fused_hop_interval_plain``."""
    if not state.is_cuda:
        return fused_hop_interval_plain(state, src, w, sb, eb, ptr, mch, neutral,
                                        op_is_min)
    dev = state.device
    Qn, N, B, Bp1 = state.shape
    if Bp1 != B + 1:
        raise ValueError(f"interval state must be [Q, N, B, B+1], got {tuple(state.shape)}")
    E = src.shape[0]
    V = ptr.shape[0] - 1
    _check_index(src, "src", dev)
    _check_index(ptr, "ptr", dev)
    _check(state, "state", torch.float32, (Qn, N, B, Bp1), dev)
    _check(w, "w", torch.float32, (Qn, E), dev)
    _check(sb, "sb", torch.int32, (Qn, E), dev)
    _check(eb, "eb", torch.int32, (Qn, E), dev)
    sq = _qstride(state, "state")
    wq, sbq, ebq = _qstride(w, "w"), _qstride(sb, "sb"), _qstride(eb, "eb")
    mq, mptr = 0, None
    if mch is not None:
        _check(mch, "mch", torch.float32, (Qn, N), dev)
        mq, mptr = _qstride(mch, "mch"), mch.data_ptr()
    out = torch.empty((Qn, V, B, Bp1), dtype=torch.float32, device=dev)
    mout = torch.empty((Qn, V), dtype=torch.float32, device=dev) if mch is not None else None
    if V and Qn:
        lib = build.load()
        err = lib.hop_fused_interval(state.data_ptr(), sq, N, B, src.data_ptr(),
                                     w.data_ptr(), wq, sb.data_ptr(), sbq,
                                     eb.data_ptr(), ebq, ptr.data_ptr(), V, Qn,
                                     mptr, mq, float(neutral), int(op_is_min),
                                     out.data_ptr(),
                                     None if mout is None else mout.data_ptr(),
                                     _stream(dev))
        build.check(err, "hop_fused_interval")
        LAUNCHES["fused_hop_interval"] += 1
    return out, mout


def scatter_cols(contrib, ptr) -> torch.Tensor:
    """Delivery of per-edge contributions; see ``scatter_cols_plain``."""
    if not contrib.is_cuda:
        return scatter_cols_plain(contrib, ptr)
    dev = contrib.device
    Qn, E = contrib.shape[:2]
    ts = tuple(contrib.shape[2:])
    C = 1
    for d in ts:
        C *= d
    V = ptr.shape[0] - 1
    _check_index(ptr, "ptr", dev)
    if contrib.dtype != torch.float32:
        raise TypeError(f"contrib must be float32, got {contrib.dtype}")
    cq = _qstride(contrib, "contrib")
    out = torch.empty((Qn, V) + ts, dtype=torch.float32, device=dev)
    if V and Qn:
        lib = build.load()
        err = lib.hop_scatter_cols(contrib.data_ptr(), cq, C, ptr.data_ptr(), V, Qn,
                                   out.data_ptr(), _stream(dev))
        build.check(err, "hop_scatter_cols")
        LAUNCHES["scatter_cols"] += 1
    return out


def scatter_extremum(m_e, alive, ptr, neutral: float, op_is_min: bool) -> torch.Tensor:
    """Segment min/max of a gated per-edge channel; see
    ``scatter_extremum_plain``."""
    if not m_e.is_cuda:
        return scatter_extremum_plain(m_e, alive, ptr, neutral, op_is_min)
    dev = m_e.device
    Qn, E = m_e.shape
    V = ptr.shape[0] - 1
    _check_index(ptr, "ptr", dev)
    _check(m_e, "m_e", torch.float32, (Qn, E), dev)
    _check(alive, "alive", torch.float32, (Qn, E), dev)
    mq, aq = _qstride(m_e, "m_e"), _qstride(alive, "alive")
    out = torch.empty((Qn, V), dtype=torch.float32, device=dev)
    if V and Qn:
        lib = build.load()
        err = lib.hop_scatter_extremum(m_e.data_ptr(), mq, alive.data_ptr(), aq,
                                       ptr.data_ptr(), V, Qn, float(neutral),
                                       int(op_is_min), out.data_ptr(), _stream(dev))
        build.check(err, "hop_scatter_extremum")
        LAUNCHES["scatter_extremum"] += 1
    return out
