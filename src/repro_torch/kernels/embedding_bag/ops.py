"""The EmbeddingBag kernel's wrapper, its plain version and its launch count.

``impl='torch'`` runs the plain version (``ref.embedding_bag_plain``) on any
device.  ``impl='cuda'`` on CPU tensors also runs the plain version; on CUDA
tensors it launches ``csrc/embedding_bag.cu`` or raises.  ``LAUNCHES``
counts kernel launches.
"""
from __future__ import annotations

import torch

from .. import build
from ..common import check_impl
from .ref import embedding_bag_plain

LAUNCHES = {"embedding_bag": 0}
_MODES = {"sum": 0, "mean": 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum",
                  impl: str = "cuda") -> torch.Tensor:
    """Sum or mean of ``table`` rows per bag; see ``ref.embedding_bag_plain``."""
    if mode not in _MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if check_impl(impl) == "torch" or not table.is_cuda:
        return embedding_bag_plain(table, indices, mode)
    dev = table.device
    if table.dtype != torch.float32 or table.dim() != 2 or not table.is_contiguous():
        raise ValueError("table must be a contiguous float32 [V, D] tensor")
    if (indices.device != dev or indices.dtype != torch.int32 or indices.dim() != 2
            or not indices.is_contiguous()):
        raise ValueError(f"indices must be a contiguous int32 [B, L] tensor on {dev}")
    V, D = table.shape
    B, L = indices.shape
    out = torch.empty((B, D), dtype=table.dtype, device=dev)
    if B:
        lib = build.load("embedding_bag")
        err = lib.embedding_bag_fwd(table.data_ptr(), V, D, indices.data_ptr(), B, L,
                                    _MODES[mode], out.data_ptr(),
                                    torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "embedding_bag_fwd")
        LAUNCHES["embedding_bag"] += 1
    return out
