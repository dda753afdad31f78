"""The plain versions of the sorted segment-sum (message delivery, GNN
aggregation).

``bucket_scatter_plain`` is the counterpart of the reference's
``kernels/bucket_scatter/ref.py::bucket_scatter_ref``.  It is the CPU path
of ``bucket_scatter`` and the card's oracle for the kernel.
``bucket_scatter_lanes_plain`` writes out the narrow kernel's order of
summation (G lanes a segment, then a butterfly), so that the CPU tests hold
that order to the JAX package.
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


def bucket_scatter_lanes_plain(contrib: torch.Tensor, ptr: torch.Tensor,
                               lanes: int) -> torch.Tensor:
    """contrib [E, C], ptr [V + 1] (segment v is edges ``ptr[v]:ptr[v+1]``)
    → [V, C], summed as the kernel's narrow path does with ``lanes`` (G)
    lanes a segment: lane j adds the edges e0 + j, e0 + j + G, ... in order
    from 0 in float32, then lane j + G/2 is added into lane j, and so on
    down to lane 0, whose sums are cast back to ``contrib.dtype``."""
    E, C = contrib.shape
    V = ptr.numel() - 1
    ptr = ptr.long()
    seg = torch.repeat_interleave(torch.arange(V), ptr[1:] - ptr[:-1])
    off = torch.arange(E) - ptr[seg]
    lane, step = off % lanes, off // lanes
    x = contrib.float()
    acc = torch.zeros((V, lanes, C), dtype=torch.float32)
    for t in range(int(step.max()) + 1 if E else 0):
        at = step == t                     # each (segment, lane) at most once a step
        acc[seg[at], lane[at]] += x[at]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0].to(contrib.dtype)
