"""The plain version of EmbeddingBag: gather, mask, reduce.

``embedding_bag_plain`` is the counterpart of the reference's
``kernels/embedding_bag/ref.py::embedding_bag_ref``; ``embedding_bags_plain``
is it once per table, stacked.  They are the CPU paths of ``embedding_bag``
and ``embedding_bags`` and the card's oracles for the kernel.
"""
from __future__ import annotations

from typing import Sequence

import torch


def embedding_bag_plain(table: torch.Tensor, indices: torch.Tensor,
                        mode: str = "sum") -> torch.Tensor:
    """table [V, D]; indices [B, L] int32 → [B, D] in ``table.dtype``.

    A negative index (−1 marks padding) is skipped and not counted; an index
    at or above V reads row V − 1 and is counted, as the reference's gather
    clamps it; ``mode='mean'`` divides by the count of the others, at least
    1.  Padding rows are dropped with ``where``, not multiplied by 0."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    V = table.shape[0]
    valid = indices >= 0
    rows = table[indices.clamp(0, V - 1).long()].float()           # [B, L, D]
    rows = torch.where(valid[..., None], rows, torch.zeros((), device=rows.device))
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_min(1).float()
    return out.to(table.dtype)


def embedding_bags_plain(tables: Sequence[torch.Tensor], indices: torch.Tensor,
                         mode: str = "sum") -> torch.Tensor:
    """tables: F tensors [V_f, D]; indices [B, F, L] int32 → [B, F, D]:
    ``embedding_bag_plain(tables[f], indices[:, f, :])`` for each f, stacked."""
    if len(tables) != indices.shape[1] or not tables:
        raise ValueError(f"one table per column of indices: got {len(tables)} tables "
                         f"for {indices.shape[1]} columns")
    return torch.stack([embedding_bag_plain(t, indices[:, f, :], mode)
                        for f, t in enumerate(tables)], dim=1)
