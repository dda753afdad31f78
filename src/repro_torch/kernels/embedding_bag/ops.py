"""The EmbeddingBag kernel's wrappers, their plain versions and the launch count.

``embedding_bags`` looks up every one of F tables in one launch (DLRM's
forward); ``embedding_bag`` is its one-table call, the counterpart of the
reference's per-table function.  ``impl='torch'`` runs the plain version
(``ref.embedding_bags_plain`` / ``ref.embedding_bag_plain``) on any device.
``impl='cuda'`` on CPU tensors also runs the plain version; on CUDA tensors
it launches ``csrc/embedding_bag.cu`` or raises.  ``LAUNCHES`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from .. import build
from ..common import launches_kernel
from .ref import embedding_bag_plain, embedding_bags_plain

LAUNCHES = {"embedding_bag": 0}
_MODES = {"sum": 0, "mean": 1}
MAX_TABLES = 64


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check_mode(mode: str) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")


def _launch(dev: torch.device, ptrs: list, rows: list, D: int, indices: torch.Tensor,
            mode: str, out_ptr: int, out_stride: int) -> None:
    """One launch over the tables at ``ptrs`` (``rows`` each, D columns):
    ``indices`` [B, F, L] (or [B, L] for one table) into rows of D floats at
    ``out_ptr``, one bag every ``out_stride`` floats."""
    B, L = indices.shape[0], indices.shape[-1]
    if B:
        F = len(ptrs)
        lib = build.load("embedding_bag")
        err = lib.embedding_bags_fwd((ctypes.c_void_p * F)(*ptrs), (ctypes.c_longlong * F)(*rows),
                                     F, D, indices.data_ptr(), B, L, _MODES[mode], out_ptr,
                                     out_stride, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "embedding_bags_fwd")
        LAUNCHES["embedding_bag"] += 1


def embedding_bags(tables: Sequence[torch.Tensor], indices: torch.Tensor, mode: str = "sum",
                   out: Optional[torch.Tensor] = None, impl: str = "cuda") -> torch.Tensor:
    """Table f's sum or mean of rows per bag, for every table at once:
    ``tables`` F tensors [V_f, D], ``indices`` [B, F, L] int32 → [B, F, D]
    (written into ``out`` where given: a [B, F, D] view whose rows are
    contiguous, such as a slice of a larger buffer); see
    ``ref.embedding_bags_plain``."""
    _check_mode(mode)
    if not launches_kernel(impl, "embedding_bags", *tables):
        got = embedding_bags_plain(tables, indices, mode)
        return got if out is None else out.copy_(got)
    dev = tables[0].device
    if (indices.device != dev or indices.dtype != torch.int32 or indices.dim() != 3
            or not indices.is_contiguous()):
        raise ValueError(f"indices must be a contiguous int32 [B, F, L] tensor on {dev}")
    B, F, _ = indices.shape
    if len(tables) != F or not 1 <= F <= MAX_TABLES:
        raise ValueError(f"the kernel takes 1 to {MAX_TABLES} tables, one per column of "
                         f"indices; got {len(tables)} tables for {F} columns")
    D = tables[0].shape[-1]
    ptrs, rows = [], []
    for t in tables:
        if (t.dtype != torch.float32 or t.device != dev or t.dim() != 2 or t.shape[1] != D
                or t.shape[0] < 1 or not t.is_contiguous()):
            raise ValueError(f"tables must be contiguous float32 [V, {D}] tensors on {dev}, "
                             "V >= 1")
        ptrs.append(t.data_ptr())
        rows.append(t.shape[0])
    if out is None:
        out = torch.empty((B, F, D), dtype=torch.float32, device=dev)
    elif (out.device != dev or out.dtype != torch.float32 or tuple(out.shape) != (B, F, D)
            or out.stride(2) != 1 or out.stride(1) != D):
        raise ValueError(f"out must be a float32 [{B}, {F}, {D}] tensor on {dev} whose rows "
                         "are contiguous")
    _launch(dev, ptrs, rows, D, indices, mode, out.data_ptr(), out.stride(0))
    return out


def embedding_bag(table: torch.Tensor, indices: torch.Tensor, mode: str = "sum",
                  impl: str = "cuda") -> torch.Tensor:
    """Sum or mean of ``table`` rows per bag; see ``ref.embedding_bag_plain``.
    On the card, ``embedding_bags``'s launch with one table."""
    _check_mode(mode)
    if not launches_kernel(impl, "embedding_bag", table):
        return embedding_bag_plain(table, indices, mode)
    dev = table.device
    if (indices.device != dev or indices.dtype != torch.int32 or indices.dim() != 2
            or not indices.is_contiguous()):
        raise ValueError(f"indices must be a contiguous int32 [B, L] tensor on {dev}")
    if (table.dtype != torch.float32 or table.dim() != 2 or table.shape[0] < 1
            or not table.is_contiguous()):
        raise ValueError("table must be a contiguous float32 [V, D] tensor, V >= 1")
    V, D = table.shape
    out = torch.empty((indices.shape[0], D), dtype=torch.float32, device=dev)
    _launch(dev, [table.data_ptr()], [V], D, indices, mode, out.data_ptr(), D)
    return out
