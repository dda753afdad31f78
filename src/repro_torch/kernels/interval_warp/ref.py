"""The plain version of TimeWarp bucket alignment.

The counterpart of the reference's ``kernels/interval_warp/ref.py::
interval_warp_ref``.  It is the CPU path of ``interval_warp`` and the card's
oracle for the kernel.
"""
from __future__ import annotations

import torch


def interval_warp_plain(counts: torch.Tensor, ivl: torch.Tensor,
                        bedges: torch.Tensor) -> torch.Tensor:
    """counts [N, B] float, ivl [N, 2] int32, bedges [B+1] int32 → [N, B].

    Zeroes the count of every bucket the entity's validity interval does not
    overlap, by multiplying with the mask as the reference does (so NaN,
    infinities and -0.0 come out as there)."""
    lo = bedges[:-1][None, :]
    hi = bedges[1:][None, :]
    mask = (ivl[:, 0:1] < hi) & (lo < ivl[:, 1:2])
    return counts * mask.to(counts.dtype)
