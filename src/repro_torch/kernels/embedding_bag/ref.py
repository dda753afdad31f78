"""The plain version of EmbeddingBag: gather, mask, reduce.

The counterpart of the reference's ``kernels/embedding_bag/ref.py::
embedding_bag_ref``.  It is the CPU path of ``embedding_bag`` and the card's
oracle for the kernel.
"""
from __future__ import annotations

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
