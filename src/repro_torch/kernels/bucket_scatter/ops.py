"""The segment-sum kernel's wrapper, its layout and its launch count.

The counterpart of the reference's ``kernels/bucket_scatter/ops.py``.  The
TPU kernel tiles destinations into blocks and pads each block's edge range
so that the scatter becomes a one-hot matmul; on the card a segment is a
contiguous run of the sorted edges, so the only layout the kernel needs is
the CSR row pointer of ``seg_ids``.

``impl='torch'`` runs the plain version (``ref.bucket_scatter_plain``) on
any device.  ``impl='cuda'`` on CPU tensors also runs the plain version; on
CUDA tensors it launches ``csrc/bucket_scatter.cu`` or raises.  ``LAUNCHES``
counts kernel launches.  The lanes a segment of the kernel's narrow path (C
<= 8) are ``common.lane_group`` of the edges, one lane an edge, as for B1
and B3; ``ref.bucket_scatter_lanes_plain`` writes out that path's order of
summation.

The wrapper runs once per aggregation of every GNN layer, and at C <= 3 its
kernel takes a few microseconds, so the host's share counts: the layout's
pointer is proven once, when the ``ScatterLayout`` is made, and the C entry
point is looked up once.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import build
from ..common import check_impl, lane_group
from .ref import bucket_scatter_plain

LAUNCHES = {"bucket_scatter": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FWD: list = []


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class ScatterLayout:
    """The CSR row pointer of a sorted ``seg_ids``: segment v is the run of
    edges ``ptr[v]:ptr[v+1]``.  Its form (int64, contiguous, ``num_segments
    + 1`` entries) is checked here, once, not at every launch, and the
    narrow path's lanes a segment (``common.lane_group``, one lane an edge)
    are worked out here."""
    ptr: torch.Tensor        # int64 [num_segments + 1], on the edges' device
    n_edges: int
    num_segments: int
    lanes: int = dataclasses.field(init=False)

    def __post_init__(self):
        p = self.ptr
        if p.dtype != torch.int64 or tuple(p.shape) != (self.num_segments + 1,) \
                or not p.is_contiguous():
            raise ValueError(f"ptr must be a contiguous int64 [{self.num_segments + 1}] "
                             f"tensor, got {p.dtype} {tuple(p.shape)}")
        object.__setattr__(self, "lanes", lane_group(self.n_edges, self.num_segments, 1))


def build_layout(seg_ids: torch.Tensor, num_segments: int) -> ScatterLayout:
    """The layout of ``seg_ids`` (sorted ascending, each in
    ``[0, num_segments)``), built on its device by a binary search of every
    segment's first edge."""
    seg_ids = torch.as_tensor(seg_ids)
    E = seg_ids.shape[0]
    if E and not bool((seg_ids[0] >= 0) & (seg_ids[-1] < num_segments)
                      & (seg_ids[1:] >= seg_ids[:-1]).all()):
        raise ValueError("seg_ids must be sorted and within [0, num_segments)")
    bounds = torch.arange(num_segments + 1, device=seg_ids.device, dtype=seg_ids.dtype)
    ptr = torch.searchsorted(seg_ids, bounds).to(torch.int64)
    return ScatterLayout(ptr, E, num_segments)


def bucket_scatter(contrib: torch.Tensor, seg_ids: torch.Tensor, num_segments: int,
                   layout: Optional[ScatterLayout] = None,
                   impl: str = "cuda") -> torch.Tensor:
    """Segment-sum of contributions [E, C] by sorted ``seg_ids`` into
    [num_segments, C]; see ``ref.bucket_scatter_plain``.  ``layout`` (from
    ``build_layout``) saves rebuilding the pointer for every call over the
    same edges."""
    if check_impl(impl) == "torch" or not contrib.is_cuda:
        return bucket_scatter_plain(contrib, seg_ids, num_segments)
    dtype = _DTYPES.get(contrib.dtype)
    if dtype is None or contrib.dim() != 2 or not contrib.is_contiguous():
        raise ValueError("contrib must be a contiguous float32 or bfloat16 [E, C] tensor")
    if layout is None:
        layout = build_layout(seg_ids, num_segments)
    E, C = contrib.shape
    ptr = layout.ptr
    dev = contrib.get_device()
    if layout.n_edges != E or layout.num_segments != num_segments or ptr.get_device() != dev:
        raise ValueError(f"layout is for {layout.n_edges} edges into {layout.num_segments} "
                         f"segments on {ptr.device}; contrib has {E} edges on {contrib.device}")
    out = torch.empty((num_segments, C), dtype=contrib.dtype, device=contrib.device)
    if num_segments and C:
        if not _FWD:
            _FWD.append(build.load("bucket_scatter").bucket_scatter_fwd)
        err = _FWD[0](contrib.data_ptr(), dtype, C, ptr.data_ptr(), num_segments, layout.lanes,
                      out.data_ptr(), torch._C._cuda_getCurrentRawStream(dev))
        build.check(err, "bucket_scatter_fwd")
        LAUNCHES["bucket_scatter"] += 1
    return out
