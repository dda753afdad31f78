"""GPipe-style pipeline parallelism over the ranks of a process group.

The counterpart of the reference's ``training/pipeline.py``.  The layer
stack [L, ...] is cut into ``n_stages`` runs of L / n_stages layers; the
rank of index s in the group holds stage s.  The GPipe schedule runs
n_micro + n_stages − 1 ticks: at tick t stage s works on microbatch t − s
(stage 0 takes it from the queue, the others from the carry) and then every
stage hands its output to the next, a ring rotation (the reference's
``lax.ppermute``) made of ``torch.distributed`` isend/irecv pairs.  The
last stage keeps the finished microbatches; ``pipeline_loss`` sums their
losses there and all_reduces the sum, so every stage returns it.  The
bubble is (n_stages − 1) / ticks of the schedule.

With one stage (no process group, or a group of one) nothing is sent and
the schedule is the layers in order over each microbatch.  The exchange is
forward only: ``torch.distributed``'s point-to-point calls carry no
gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from . import tree as T
from .compression import world


@dataclasses.dataclass(frozen=True)
class PipelineCfg:
    n_microbatches: int = 8


def schedule_ticks(n_stages: int, n_micro: int) -> int:
    return n_micro + n_stages - 1


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Share of the schedule's stage-ticks a stage sits idle."""
    return (n_stages - 1) / schedule_ticks(n_stages, n_micro)


def _rotate(y: torch.Tensor, sidx: int, n_stages: int, group) -> torch.Tensor:
    """Stage s's ``y`` to stage s + 1 (mod n_stages); returns what stage
    s − 1 sent."""
    if n_stages == 1:
        return y
    peer = lambda s: dist.get_global_rank(group, s) if group is not None else s
    buf = torch.empty_like(y)
    ops = [dist.P2POp(dist.isend, y.contiguous(), peer((sidx + 1) % n_stages), group),
           dist.P2POp(dist.irecv, buf, peer((sidx - 1) % n_stages), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return buf


def pipeline_apply(layer_fn: Callable[[Any, torch.Tensor], torch.Tensor], stage_params,
                   x_micro: torch.Tensor, cfg: PipelineCfg, n_stages: int,
                   group=None) -> torch.Tensor:
    """This rank's part of the GPipe schedule.  ``stage_params``: this
    stage's stacked layers [L / n_stages, ...]; ``x_micro``: the whole
    microbatch queue [n_micro, B_mb, ...] (every stage holds it).  Returns
    the finished microbatches on the last stage (zeros on the others)."""
    n_micro = cfg.n_microbatches
    if x_micro.shape[0] != n_micro:
        raise ValueError(f"queue of {x_micro.shape[0]} microbatches, cfg says {n_micro}")
    size, sidx = world(group)
    if size != n_stages:
        raise ValueError(f"{n_stages} stages over a group of {size} ranks")
    n_layers = T.leaves(stage_params)[0].shape[0]

    def run_stage(x):
        for i in range(n_layers):
            x = layer_fn(T.tree_map(lambda a: a[i], stage_params), x)
        return x

    state = torch.zeros_like(x_micro[0])        # current in-flight activation
    outputs = torch.zeros_like(x_micro)         # completed microbatches
    for t in range(schedule_ticks(n_stages, n_micro)):
        m_in = t - sidx                         # microbatch this stage sees
        active = 0 <= m_in < n_micro
        y = run_stage(x_micro[m_in] if sidx == 0 else state) if active else state
        if active and sidx == n_stages - 1:     # last stage keeps its output
            outputs[m_in] = y
        state = _rotate(y, sidx, n_stages, group)
    return outputs


def make_pipelined_forward(layer_fn, n_stages: int, cfg: PipelineCfg, group=None):
    """Returns ``f(stacked_params [L, ...], x [n_micro, B_mb, ...])`` →
    outputs on the last stage: this rank runs stage ``rank`` of the group
    on rows [rank · L / n_stages, (rank + 1) · L / n_stages) of every
    stacked weight."""

    def forward(params_stacked, x):
        L = T.leaves(params_stacked)[0].shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not divide into {n_stages} stages")
        per = L // n_stages
        s = world(group)[1]
        stage = T.tree_map(lambda a: a[s * per:(s + 1) * per], params_stacked)
        return pipeline_apply(layer_fn, stage, x, cfg, n_stages, group)

    return forward


def pipeline_loss(outputs: torch.Tensor, targets: torch.Tensor,
                  loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                  n_stages: int, group=None) -> torch.Tensor:
    """Sum over microbatches of ``loss_fn(output, target)`` on the last
    stage, all_reduced over the group so every stage returns it."""
    _, sidx = world(group)
    total = torch.zeros((), dtype=torch.float32, device=outputs.device)
    if sidx == n_stages - 1:
        for m in range(outputs.shape[0]):
            total = total + loss_fn(outputs[m], targets[m]).float()
    if n_stages > 1:
        dist.all_reduce(total, group=group)
    return total
