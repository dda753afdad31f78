"""The TimeWarp kernel's wrapper and its launch count.

The counterpart of the reference's ``kernels/interval_warp/ops.py``; no path
of either package calls it, so this entry point is how it is reached.  The
card needs no padding of N to a block size.

``impl='torch'`` runs the plain version (``ref.interval_warp_plain``) on any
device.  ``impl='cuda'`` on CPU tensors also runs the plain version; on CUDA
tensors it launches ``csrc/interval_warp.cu`` or raises.  ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import check_impl
from .ref import interval_warp_plain

LAUNCHES = {"interval_warp": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BUCKETS = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def interval_warp(counts: torch.Tensor, ivl: torch.Tensor, bedges: torch.Tensor,
                  impl: str = "cuda") -> torch.Tensor:
    """counts [N, B] times the mask of the buckets each row's interval
    overlaps; see ``ref.interval_warp_plain``."""
    if check_impl(impl) == "torch" or not counts.is_cuda:
        return interval_warp_plain(counts, ivl, bedges)
    dev = counts.device
    if counts.dtype not in _DTYPES or counts.dim() != 2 or not counts.is_contiguous():
        raise ValueError("counts must be a contiguous float32 or bfloat16 [N, B] tensor")
    N, B = counts.shape
    if not 1 <= B <= MAX_BUCKETS:
        raise ValueError(f"the kernel takes 1 to {MAX_BUCKETS} buckets, got {B}")
    for t, name, shape in ((ivl, "ivl", (N, 2)), (bedges, "bedges", (B + 1,))):
        if (t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 {list(shape)} tensor on {dev}")
    out = torch.empty_like(counts)
    if N:
        lib = build.load("interval_warp")
        err = lib.interval_warp_fwd(counts.data_ptr(), _DTYPES[counts.dtype], ivl.data_ptr(),
                                    bedges.data_ptr(), N, B, out.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "interval_warp_fwd")
        LAUNCHES["interval_warp"] += 1
    return out
