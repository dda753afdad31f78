"""The plain version of the sorted segment-sum (message delivery, GNN
aggregation).

The counterpart of the reference's ``kernels/bucket_scatter/ref.py::
bucket_scatter_ref``.  It is the CPU path of ``bucket_scatter`` and the
card's oracle for the kernel.
"""
from __future__ import annotations

import torch


def bucket_scatter_plain(contrib: torch.Tensor, seg_ids: torch.Tensor,
                         num_segments: int) -> torch.Tensor:
    """contrib [E, C] float, seg_ids [E] int (sorted) → [num_segments, C]:
    row v is the sum of the rows e with ``seg_ids[e] == v`` (0 where there is
    none), summed in float32 and cast back to ``contrib.dtype``."""
    out = torch.zeros((num_segments,) + tuple(contrib.shape[1:]), dtype=torch.float32,
                      device=contrib.device)
    return out.index_add_(0, seg_ids.long(), contrib.float()).to(contrib.dtype)
