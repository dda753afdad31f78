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

    An index outside ``[0, V)`` (−1 marks padding) is skipped and not
    counted; ``mode='mean'`` divides by the count of the others, at least 1.
    Masked rows are dropped with ``where``, not multiplied by 0.

    An index at or above V departs from the reference on purpose: there
    XLA's gather (and the Pallas kernel in interpret mode) clamps it to row
    V − 1 and counts it, an artifact of out-of-bounds gathers rather than
    a meaning; the port neither reads past the table nor adds a row the
    caller did not name."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    V = table.shape[0]
    valid = (indices >= 0) & (indices < V)
    rows = table[torch.where(valid, indices, 0).long()].float()     # [B, L, D]
    rows = torch.where(valid[..., None], rows, torch.zeros((), device=rows.device))
    out = rows.sum(dim=1)
    if mode == "mean":
        out = out / valid.sum(dim=1, keepdim=True).clamp_min(1).float()
    return out.to(table.dtype)
