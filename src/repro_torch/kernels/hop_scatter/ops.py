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

The partitioned executor runs B1-B3 over every worker's local arrival CSR in
one launch of the same wrappers: ``worker_csr`` flattens the workers' CSRs
into one over the (worker, owned slot) destinations and the REAL owned edges
only, and its pointer is the ``ptr`` of the call.  Each worker pads its edge
row to the longest worker's and puts the pads on a trash segment; the
flattened CSR leaves them out, so no lane ever walks a pad edge.  A
destination's run is the same run, in the same canonical order, as in the
global arrival CSR.

A wrapper given CPU tensors runs its plain version (``*_plain``); given CUDA
tensors it launches its kernel or raises.  ``LAUNCHES`` counts kernel
launches by wrapper name.  The sources say which TPU kernel each replaces and
what bounds it on the card.  The launch choices are pure functions of the
shapes and alignments, made on the host without a device sync: for B1 and
B3 ``cols_vector_width`` / ``vector_width`` (columns a lane loads) and
``lane_group`` (edge slots a destination, from ``common``, which B5 shares);
for B4 ``vector_width`` (16-byte loads of the query rows) and
``extremum_tiles`` (its tiles of ``EXT_TILE`` edges).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import build
from ..common import WARP, lane_group  # noqa: F401  (lane_group: B1/B3's edge slots)

LAUNCHES = {"fused_hop_cols": 0, "fused_hop_interval": 0, "scatter_cols": 0,
            "scatter_extremum": 0}
SECTOR_FLOATS = 8   # floats in a 32-byte sector
VEC = 4             # floats in a float4
EXT_TILE = 1024     # B4: edges a tile; the C side refuses a scratch too short for its kExtTile


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
# the worker form: every worker's local arrival CSR as one CSR
# =========================================================================
@dataclasses.dataclass
class WorkerCSR:
    """The workers' local arrival CSRs flattened into one over their real
    owned edges.  Destination ``w * v_max + v`` is worker w's owned slot v;
    real edge i is the ``real[i]``-th entry of the padded [W, e_max] rows
    (worker-major, canonical order inside a worker)."""
    n_workers: int
    v_max: int
    ptr: torch.Tensor    # int32 [W * v_max + 1] flattened arrival CSR
    real: torch.Tensor   # int64 [E_real] flat padded position w * e_max + j
    n_real: int          # real edges: ptr[-1]
    n_pad: int           # pad slots of the [W, e_max] rows, left out

    @property
    def n_dst(self) -> int:
        return self.n_workers * self.v_max


def worker_csr(ptr_w: np.ndarray, e_max: int, device) -> WorkerCSR:
    """Build the flattened layout from the per-worker arrival pointers
    ``ptr_w`` int [W, v_max + 2] (``PartitionArrays.worker_arrival_ptr``:
    worker w's real edges are the first ``ptr_w[w, v_max]`` of its row, the
    rest its trash segment)."""
    W, vp2 = ptr_w.shape
    v_max = vp2 - 2
    ptr_w = ptr_w.astype(np.int64)
    n_real_w = ptr_w[:, v_max]
    n_real = int(n_real_w.sum())
    base = np.concatenate(([0], np.cumsum(n_real_w)[:-1]))
    flat = np.empty(W * v_max + 1, np.int64)
    flat[:-1] = (ptr_w[:, :v_max] + base[:, None]).reshape(-1)
    flat[-1] = n_real
    real = np.concatenate([w * e_max + np.arange(n, dtype=np.int64)
                           for w, n in enumerate(n_real_w)])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return WorkerCSR(n_workers=W, v_max=v_max, ptr=t(flat.astype(np.int32)),
                     real=t(real), n_real=n_real, n_pad=int(W * e_max - n_real))


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


def query_stride(t: torch.Tensor, name: str) -> int:
    """Query-axis stride in elements: per-query rows must be contiguous, and
    the query axis either packed or broadcast (stride 0).  Read from the
    strides alone (no view is made: this runs on every launch)."""
    if t.shape[0] > 1 and t.is_contiguous():
        return t.stride(0)
    shape, strides = t.shape, t.stride()
    inner = 1
    for i in range(len(shape) - 1, 0, -1):
        if shape[i] > 1 and strides[i] != inner:
            raise ValueError(f"{name}: each query's rows must be contiguous")
        inner *= max(shape[i], 1)
    if t.shape[0] > 1 and t.stride(0) not in (0, inner):
        raise ValueError(f"{name}: query stride must be 0 or {inner}")
    return t.stride(0) if t.shape[0] > 1 else inner


def _check_index(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 vector on {device}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def vector_width(C: int, *rows: Tuple[torch.Tensor, int]) -> int:
    """Columns a lane of the narrow-row kernels loads at once: 4 (a float4)
    where C is a multiple of 4 and every table (tensor, query stride) starts
    and strides on 16 bytes, else 1."""
    if C % VEC or any(t.data_ptr() % 16 or qs % VEC for t, qs in rows):
        return 1
    return VEC


def cols_vector_width(C: int, extremum: bool, *rows: Tuple[torch.Tensor, int]) -> int:
    """Columns a lane of B1's narrow kernel loads: 1 where the extremum
    channel makes B1 read the packed [N, Q, C + 1] table (C below a sector:
    its rows are C + 1 wide), else ``vector_width`` over the state and
    weights, given as (tensor, query stride)."""
    if extremum and C < SECTOR_FLOATS:
        return 1
    return vector_width(C, *rows)


def extremum_tiles(E: int) -> int:
    """B4's tiles over E edges: E // EXT_TILE + 1, so that the last tile,
    which may hold no edge, also owns the destinations whose runs start at E
    (tile t owns every destination v with t * EXT_TILE <= ptr[v] < (t + 1) *
    EXT_TILE)."""
    return E // EXT_TILE + 1


def _source_table(state, sq, mch):
    """The state (query stride ``sq``) and extremum channel as B1 reads them:
    (table, query stride, row stride, channel or None, its query stride, its
    row stride).  With the channel, on rows narrower than a 32-byte sector, a
    [N, Q, C + 1] copy puts a source's state and channel for 8 queries in 64
    bytes (the [Q, N, C] tables cost a sector a query, and the channel as
    many more); on wider rows the channel alone goes to [N, Q], a sector for
    8 queries.  A copy's time counts as the kernel's."""
    Qn, N, C = state.shape
    if mch is None:
        return state, sq, C, None, 0, 0
    if C < SECTOR_FLOATS:
        table = torch.cat([state.transpose(0, 1), mch.t()[..., None]], dim=2)
        W = C + 1
        return table, W, Qn * W, table[:, :, C], W, Qn * W
    mq = query_stride(mch, "mch")
    if Qn > 1 and mq != 0:
        return state, sq, C, mch.t().contiguous(), 1, Qn
    return state, sq, C, mch, mq, 1


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
    sq, wq = query_stride(state, "state"), query_stride(w, "w")
    if mch is not None:
        _check(mch, "mch", torch.float32, (Qn, N), dev)
    out = torch.empty((Qn, V, C), dtype=torch.float32, device=dev)
    mout = torch.empty((Qn, V), dtype=torch.float32, device=dev) if mch is not None else None
    if V and Qn:
        vec = cols_vector_width(C, mch is not None, (state, sq), (w, wq))
        G = lane_group(E, V, C // vec)
        table, sq, rs, chan, mq, mrs = _source_table(state, sq, mch)
        err = build.load().hop_fused_cols(
            table.data_ptr(), sq, rs, N, C, src.data_ptr(), w.data_ptr(), wq, ptr.data_ptr(),
            V, Qn, vec, G, None if chan is None else chan.data_ptr(), mq, mrs, float(neutral),
            int(op_is_min), out.data_ptr(), None if mout is None else mout.data_ptr(),
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
    sq = query_stride(state, "state")
    wq, sbq, ebq = query_stride(w, "w"), query_stride(sb, "sb"), query_stride(eb, "eb")
    mq, mptr = 0, None
    if mch is not None:
        _check(mch, "mch", torch.float32, (Qn, N), dev)
        mq, mptr = query_stride(mch, "mch"), mch.data_ptr()
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
    cq = query_stride(contrib, "contrib")
    out = torch.empty((Qn, V) + ts, dtype=torch.float32, device=dev)
    if V and Qn:
        vec = vector_width(C, (contrib, cq))
        G = lane_group(E, V, C // vec)
        err = build.load().hop_scatter_cols(contrib.data_ptr(), cq, C, ptr.data_ptr(), V, Qn,
                                            vec, G, out.data_ptr(), _stream(dev))
        build.check(err, "hop_scatter_cols")
        LAUNCHES["scatter_cols"] += 1
    return out


def scatter_extremum(m_e, alive, ptr, neutral: float, op_is_min: bool) -> torch.Tensor:
    """Segment min/max of a gated per-edge channel; see
    ``scatter_extremum_plain``.  Two kernel launches a call: one that finds
    each tile's first destination (into a scratch of ``extremum_tiles(E) + 1``
    ints) and seeds the runs that cross a tile's edge with ``neutral``, then
    the tiles."""
    if not m_e.is_cuda:
        return scatter_extremum_plain(m_e, alive, ptr, neutral, op_is_min)
    dev = m_e.device
    Qn, E = m_e.shape
    V = ptr.shape[0] - 1
    _check_index(ptr, "ptr", dev)
    _check(m_e, "m_e", torch.float32, (Qn, E), dev)
    _check(alive, "alive", torch.float32, (Qn, E), dev)
    if E + EXT_TILE >= 2 ** 31:
        raise ValueError(f"scatter_extremum takes fewer than 2^31 edges, got {E}")
    mq, aq = query_stride(m_e, "m_e"), query_stride(alive, "alive")
    out = torch.empty((Qn, V), dtype=torch.float32, device=dev)
    if V and Qn:
        tile_lo = torch.empty(extremum_tiles(E) + 1, dtype=torch.int32, device=dev)
        vec = vector_width(VEC, (m_e, mq), (alive, aq))
        err = build.load().hop_scatter_extremum(
            m_e.data_ptr(), mq, alive.data_ptr(), aq, ptr.data_ptr(), V, E, Qn, vec,
            float(neutral), int(op_is_min), tile_lo.data_ptr(), tile_lo.numel(),
            out.data_ptr(), _stream(dev))
        build.check(err, "hop_scatter_extremum")
        LAUNCHES["scatter_extremum"] += 1
    return out
