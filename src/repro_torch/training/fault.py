"""Fault tolerance and elasticity: heartbeats, stragglers, checkpoint-restart.

The counterpart of the reference's ``training/fault.py``:

* ``HeartbeatMonitor`` / ``StragglerPolicy`` / ``mitigate_stragglers`` /
  ``backoff_delay`` — shared with the serving fault layer; the one
  implementation is ``repro_torch.faults_common``, re-exported here.
* ``FaultTolerantRunner`` — drives a step function; on an injected or real
  failure it restores the latest checkpoint and replays from its step
  (the data order is deterministic), or restarts from the beginning when
  there is none.  The restore lands on the device ``run`` names (the card
  unless the caller asks for the CPU), whatever the state was saved from.
* ``elastic_remesh`` — the largest mesh shape, of the same rank, that the
  surviving workers fill.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import checkpoint as ckpt
from ..faults_common import (  # noqa: F401  (re-exported names)
    HeartbeatMonitor,
    StragglerPolicy,
    backoff_delay,
    mitigate_stragglers,
)

__all__ = [
    "HeartbeatMonitor",
    "StragglerPolicy",
    "backoff_delay",
    "mitigate_stragglers",
    "FaultTolerantRunner",
    "elastic_remesh",
]


class FaultTolerantRunner:
    """Checkpoint-restart training driver with failure injection hooks."""

    def __init__(self, step_fn: Callable, state, ckpt_dir: str,
                 ckpt_every: int = 10, keep_last: int = 3):
        self.step_fn = step_fn
        self.state = state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.keep_last = keep_last
        self.step = 0
        self.recoveries = 0

    def run(self, batches: Sequence, fail_at: Optional[Dict[int, Exception]] = None,
            device: Optional[Union[str, torch.device]] = None) -> List[dict]:
        """Run ``state, metrics = step_fn(state, batch)`` over ``batches``;
        ``fail_at[step]`` raises at that step once (an injected failure) and
        the runner restores onto ``device`` (None: the card) and replays."""
        fail_at = fail_at or {}
        metrics: List[dict] = []
        i = 0
        injected = set()
        while i < len(batches):
            try:
                if self.step in fail_at and self.step not in injected:
                    injected.add(self.step)
                    raise fail_at[self.step]
                self.state, m = self.step_fn(self.state, batches[i])
                self.step += 1
                i += 1
                metrics.append(dict(step=self.step, **m))
                if self.step % self.ckpt_every == 0:
                    ckpt.save(self.state, self.step, self.ckpt_dir, self.keep_last)
            except Exception:  # any step failure: recover, as the reference does
                last = ckpt.latest_step(self.ckpt_dir)
                if last is None:
                    # no checkpoint yet: restart from scratch
                    self.step = 0
                    i = 0
                    self.recoveries += 1
                    continue
                self.state, self.step = ckpt.restore(self.state, self.ckpt_dir, device=device)
                i = self.step  # deterministic data order: replay from ckpt step
                self.recoveries += 1
        ckpt.save(self.state, self.step, self.ckpt_dir, self.keep_last)
        return metrics


def elastic_remesh(n_alive: int, want_shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Largest mesh shape (same rank) fitting the surviving workers —
    elastic scale-down policy: shrink the data axis first."""
    shape = list(want_shape)
    total = int(np.prod(shape))
    while total > n_alive and shape[0] > 1:
        shape[0] //= 2
        total = int(np.prod(shape))
    if total > n_alive:
        shape = [1] * (len(shape) - 1) + [n_alive]
    return tuple(shape)
