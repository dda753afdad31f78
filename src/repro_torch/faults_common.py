"""Shared fault-handling primitives: backoff math, liveness, stragglers.

The port's copy of the reference package's ``faults_common.py``.  One
implementation serves the fault-tolerant layers — the serving-side
chaos/retry machinery (``serving/faults.py``) and, once training is ported,
its checkpoint-restart loop — so backoff curves and straggler policy are
defined exactly once:

* ``backoff_delay`` — exponential backoff with a cap and optional seeded
  jitter.  Delays are *accounted*, never slept: both consumers run on
  virtual clocks, so a backoff is a number added to a deadline/latency
  budget, which keeps every retry schedule deterministic and testable.
* ``HeartbeatMonitor`` — workers report liveness; the monitor declares
  failure after ``timeout_s`` silence.
* ``StragglerPolicy`` / ``mitigate_stragglers`` — speculative re-execution:
  partitions slower than ``k × median`` are duplicated on the least-loaded
  other worker and the first result wins (the paper's Q3/Q4 weak-scaling
  stragglers motivate this).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


def backoff_delay(attempt: int, base_s: float = 0.01,
                  multiplier: float = 2.0, max_s: float = 1.0,
                  jitter_frac: float = 0.0,
                  rng: Optional[np.random.Generator] = None) -> float:
    """Exponential backoff for retry ``attempt`` (0-based): ``base ·
    multiplier^attempt`` capped at ``max_s``, with ±``jitter_frac``
    multiplicative jitter drawn from ``rng`` (deterministic when the caller
    seeds it — the serving retry tests pin exact schedules)."""
    d = min(float(base_s) * float(multiplier) ** int(attempt), float(max_s))
    if jitter_frac and rng is not None:
        d *= 1.0 + float(jitter_frac) * (2.0 * float(rng.random()) - 1.0)
    return d


class HeartbeatMonitor:
    def __init__(self, n_workers: int, timeout_s: float = 5.0):
        self.timeout = timeout_s
        self.last_beat: Dict[int, float] = {w: time.time()
                                            for w in range(n_workers)}
        self.dead: set = set()

    def beat(self, worker: int, t: Optional[float] = None):
        if worker not in self.dead:
            self.last_beat[worker] = time.time() if t is None else t

    def kill(self, worker: int):
        self.dead.add(worker)

    def check(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        failed = [
            w for w, t in self.last_beat.items()
            if w not in self.dead and now - t > self.timeout
        ]
        failed += [w for w in self.dead if now is not None]
        return sorted(set(failed))

    def alive(self) -> List[int]:
        now = time.time()
        return [w for w in self.last_beat
                if w not in self.dead
                and now - self.last_beat[w] <= self.timeout]


@dataclasses.dataclass
class StragglerPolicy:
    slowdown_factor: float = 3.0
    max_duplicates: int = 2


def mitigate_stragglers(
    part_times_ms: np.ndarray,
    part_worker: np.ndarray,
    policy: StragglerPolicy = StragglerPolicy(),
) -> Dict[int, int]:
    """Given per-partition times and placements, pick partitions to duplicate.

    Returns {partition_id: backup_worker}.  First-result-wins semantics are
    applied by the caller (the superstep barrier takes min(primary, backup)).
    """
    med = float(np.median(part_times_ms))
    worker_load = {}
    for p, w in enumerate(part_worker):
        worker_load[int(w)] = (worker_load.get(int(w), 0.0)
                               + float(part_times_ms[p]))
    slow = np.argsort(-part_times_ms)
    out: Dict[int, int] = {}
    for p in slow[: policy.max_duplicates]:
        if part_times_ms[p] > policy.slowdown_factor * max(med, 1e-9):
            # least-loaded worker that doesn't already own p
            cands = sorted(worker_load, key=worker_load.get)
            for w in cands:
                if w != int(part_worker[p]):
                    out[int(p)] = w
                    worker_load[w] += float(part_times_ms[p])
                    break
    return out
