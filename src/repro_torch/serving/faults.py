"""Deterministic chaos injection + retry policy for the serving stack.

The paper's headline robustness claim is *completion*: Granite answers 100%
of the 1600-query workload where the baselines finish 32–92% (§VI).  This
module supplies the two halves that make that claim testable here:

**FaultPlan** — a deterministic chaos-injection harness.  Production code
consults the plan at *named injection points* ("compile", "dispatch",
"worker", "straggler", "wal"); the plan decides — from a seeded RNG rate
and/or an explicit per-point schedule — whether that consultation fails,
and the caller raises the matching ``FaultError`` subclass.  Decisions are
keyed by ``(seed, point, k)`` where ``k`` is the per-point consultation
counter, so a plan replays identically regardless of how calls from
different points interleave — every failure mode is reproducible with zero
real compilation (the FakeDispatcher virtual clock consults the same
points as the real torch dispatch path).

Injection points (who consults, what failing means):

====================  ====================================================
``compile``           ``BatchScheduler._dispatch`` before lowering — the
                      group's executable build failed (``CompileError``).
``dispatch``          ``BatchScheduler._dispatch`` around the engine call —
                      a transient execution error (``TransientDispatchError``),
                      retryable with backoff.
``worker``            partitioned dispatches only — a designated partition
                      worker was lost (``WorkerLostError``); the scheduler
                      re-plans the group onto the dense executor and marks
                      the partitioned path unavailable until a probe
                      succeeds.
``straggler``         never raises — returns a multiplicative service-time
                      inflation (``straggler_factor``) accounted into the
                      virtual clock.
``wal``               ``EventLog`` WAL appends — the write is torn mid-line
                      (a prefix hits the disk, then ``TornWriteError``),
                      simulating a crash; recovery must truncate the tail.
====================  ====================================================

**RetryPolicy** — how the scheduler responds: exponential backoff with
seeded jitter (``faults_common.backoff_delay``; delays are accounted
into the virtual clock, never slept), a deadline-aware retry budget (a
retry that would land past the group's EDF deadline re-enters admission
instead of firing), and poison-query quarantine (a group that keeps
failing is bisected until the single poison query is isolated and rejected
with a structured error while the rest of the batch still answers).

The port's copy of the reference package's ``serving/faults.py``.  The
``wal`` point and ``TornWriteError`` serve the live-graph event log, which
is not ported yet (ROADMAP A8); the ``worker`` point serves the partitioned
engine (``core/engine_partitioned.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Set

import numpy as np

#: injection points a FaultPlan understands
FAULT_POINTS = ("compile", "dispatch", "worker", "straggler", "wal")


# --------------------------------------------------------------------- errors
class FaultError(RuntimeError):
    """Base of every injected (or injected-equivalent real) serving fault."""
    point = "fault"


class TransientDispatchError(FaultError):
    """A dispatch failed in a way a retry can fix."""
    point = "dispatch"


class CompileError(FaultError):
    """The group's executable failed to build."""
    point = "compile"


class WorkerLostError(FaultError):
    """A partition worker died mid-dispatch (partitioned engine only)."""
    point = "worker"

    def __init__(self, msg: str = "partition worker lost", worker: int = 0):
        super().__init__(msg)
        self.worker = int(worker)


class TornWriteError(FaultError):
    """A WAL append was cut mid-line — the simulated process crash."""
    point = "wal"


class PoisonQueryError(FaultError):
    """A query that fails deterministically no matter how it is dispatched."""
    point = "poison"


# ----------------------------------------------------------------- fault plan
@dataclasses.dataclass
class FaultPlan:
    """Deterministic fault schedule consulted at named injection points.

    ``rates[point]`` gives an independent per-consultation fault probability
    drawn from ``SeedSequence([seed, hash(point), k])`` — reproducible and
    interleaving-independent.  ``schedule[point]`` names exact consultation
    indices (0-based ``k``) that must fail, for surgical tests ("the second
    dispatch dies").  Both may be active; either firing injects.

    ``poison`` marks queries as deterministically bad: the scheduler raises
    ``PoisonQueryError`` whenever a dispatch group contains one, which is
    what drives the bisection/quarantine machinery.

    A plan never *raises* by itself — ``should_fail`` returns a bool and the
    consulting site raises the taxonomy error — so the same plan object can
    drive the FakeDispatcher harness, the real torch path, and the WAL.
    """
    seed: int = 0
    #: per-point independent fault probability in [0, 1)
    rates: Mapping[str, float] = dataclasses.field(default_factory=dict)
    #: per-point explicit consultation indices that must fail
    schedule: Mapping[str, Set[int]] = dataclasses.field(default_factory=dict)
    #: queries for which every dispatch fails (drives quarantine bisection)
    poison: Optional[Callable] = None
    #: service-time inflation applied when the "straggler" point fires
    straggler_factor: float = 3.0

    def __post_init__(self):
        for pt in list(self.rates) + list(self.schedule):
            if pt not in FAULT_POINTS:
                raise ValueError(f"unknown fault point {pt!r}; "
                                 f"expected one of {FAULT_POINTS}")
        self.consulted: Dict[str, int] = {}
        self.fired: Dict[str, int] = {}

    # ------------------------------------------------------------ consultation
    def _draw(self, point: str, k: int) -> float:
        # hash via a stable per-point integer (index in FAULT_POINTS) so the
        # stream is identical across processes (PYTHONHASHSEED-independent)
        pid = FAULT_POINTS.index(point)
        ss = np.random.SeedSequence([int(self.seed), pid, int(k)])
        return float(np.random.Generator(np.random.PCG64(ss)).random())

    def should_fail(self, point: str) -> bool:
        """Consult the plan at ``point``; advances that point's counter."""
        k = self.consulted.get(point, 0)
        self.consulted[point] = k + 1
        fail = k in self.schedule.get(point, ())
        rate = float(self.rates.get(point, 0.0))
        if not fail and rate > 0.0:
            fail = self._draw(point, k) < rate
        if fail:
            self.fired[point] = self.fired.get(point, 0) + 1
        return fail

    def straggle(self) -> float:
        """Service-time multiplier for this consultation (1.0 = no fault)."""
        return self.straggler_factor if self.should_fail("straggler") else 1.0

    def is_poison(self, qry) -> bool:
        return bool(self.poison is not None and self.poison(qry))

    # --------------------------------------------------------------- reporting
    def report(self) -> dict:
        return dict(seed=self.seed,
                    consulted=dict(self.consulted),
                    fired=dict(self.fired))


# --------------------------------------------------------------- retry policy
@dataclasses.dataclass
class RetryPolicy:
    """How ``BatchScheduler`` responds to a failed dispatch unit.

    Attempts are bounded by ``max_attempts``; between attempts the scheduler
    *accounts* (never sleeps) ``backoff_delay(attempt, ...)`` of virtual
    time.  A retry whose backoff would land past the group's EDF deadline
    does not fire — the group re-enters admission with its remaining budget
    and either gets one immediate (possibly degraded) retry or times out
    with a structured error.  A unit that accumulates ``max_group_failures``
    failures and still holds >1 query is bisected; a single query that
    exhausts its attempts is quarantined.  After a worker-loss fallback the
    partitioned path stays marked unavailable for ``probe_after`` flushes
    before a probe dispatch is attempted.
    """
    max_attempts: int = 3
    base_delay_s: float = 0.01
    multiplier: float = 2.0
    max_delay_s: float = 1.0
    jitter_frac: float = 0.1
    #: unit failures before bisection kicks in (the "fails twice" rule)
    max_group_failures: int = 2
    #: flushes the partitioned path stays down before probing it again
    probe_after: int = 2
    seed: int = 0

    def rng(self) -> np.random.Generator:
        """Fresh seeded jitter stream (one per flush keeps runs replayable)."""
        return np.random.Generator(np.random.PCG64(
            np.random.SeedSequence([int(self.seed), 0xB0FF])))
