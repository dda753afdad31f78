"""Deterministic serving test harness: synthetic dispatch on a virtual clock.

The SLO layer (admission control, EDF ordering, online θ refit, closed-loop
replay) is control logic — none of it needs a compiled engine to be tested,
and building one per test case would bury the logic under engine time
and host-timing noise.  ``FakeDispatcher`` plugs into
``BatchScheduler(dispatcher=...)`` and replaces the build-and-run step with:

  * a SYNTHETIC service time from an injected model (e.g. the planner's own
    feature rows dotted with a hidden "true" θ* — so refit convergence is a
    provable property, not a flaky timing assertion), and
  * deterministic fake outputs derived from each query's parameter row (so
    submission-order and permutation-invariance properties can check that
    every query got ITS OWN answer back through the grouping machinery).

Everything downstream — EDF ordering, chunking, telemetry recording,
admission backlog, replay accounting — runs EXACTLY the production code
path; only the engine call is swapped out.  No engine, virtual time.

Fault injection rides the same funnel: the scheduler consults its
``FaultPlan`` in ``BatchScheduler._dispatch`` BEFORE delegating here, so
chaos tests (``tests/test_serving_faults.py``) exercise retry, quarantine,
and worker-loss fallback against the virtual clock — backoff penalties are
accounted into service time, never slept.

The port's copy of the reference package's ``serving/testing.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from ..core import query as Q
from ..core.planner import coeff_vector
from .compile import PlanTensor


@dataclasses.dataclass
class FakeOutput:
    """Mimics the engines' batched output surface (total/per_vertex/minmax)."""
    total: np.ndarray
    per_vertex: Optional[np.ndarray] = None
    minmax: Optional[np.ndarray] = None


def fake_count(qry: Q.PathQuery) -> float:
    """Deterministic per-query 'result': a pure function of the parameter
    row, so tests can assert each query's answer survived grouping, EDF
    reordering, chunking, and permutation."""
    return float(int(np.abs(Q.query_params(qry)).sum()) % 9973)


def planner_service_model(true_coeffs: dict, scale: float = 1.0
                          ) -> Callable:
    """Service model: the group's batch-summed planner features dotted with
    a FROZEN 'true' θ* (ms → s).  Because the scheduler predicts with its
    LIVE θ, setting θ* ≠ θ creates a known prediction error that the online
    refit must provably shrink — the telemetry test's ground truth."""
    theta_star = None

    def model(sched, queries, split, mode, engine, impl,
              pt: PlanTensor) -> float:
        nonlocal theta_star
        if theta_star is None:
            theta_star = coeff_vector(true_coeffs)
        planner = sched._planner_for(engine)
        feats = planner.estimate_batch(queries, split, impl=impl).features
        if pt.n_pad:
            feats = feats + pt.n_pad * planner.estimate(
                queries[0], split, impl).features
        return float(feats @ theta_star) * scale / 1e3

    return model


def constant_service_model(per_query_s: float, overhead_s: float = 0.0
                           ) -> Callable:
    """Service = overhead + per_query · B_pad: the simplest closed-form for
    exact latency arithmetic in deadline/backlog tests."""
    def model(sched, queries, split, mode, engine, impl,
              pt: PlanTensor) -> float:
        return overhead_s + per_query_s * pt.params.shape[0]
    return model


@dataclasses.dataclass
class FakeCall:
    """One recorded dispatch (the harness's observability channel)."""
    queries: List[Q.PathQuery]
    split: int
    mode: int
    engine: str
    impl: str
    n_real: int
    n_pad: int
    service_s: float


class FakeDispatcher:
    """Drop-in for the scheduler's torch dispatch: synthetic service times,
    deterministic outputs, optional injected failures.

    ``fail``: predicate ``(queries, engine, impl) -> bool`` — a True return
    raises inside dispatch, exercising the scheduler's failing-group
    isolation and the replay harness's failed-group accounting without
    needing a real trace-time error.
    """

    def __init__(self, service_model: Optional[Callable] = None,
                 fail: Optional[Callable] = None,
                 per_vertex: bool = False):
        self.service_model = service_model or constant_service_model(1e-3)
        self.fail = fail
        self.per_vertex = per_vertex
        self.calls: List[FakeCall] = []

    def dispatch(self, sched, queries, split, mode, engine, impl,
                 pt: PlanTensor, warm: bool):
        if self.fail is not None and self.fail(queries, engine, impl):
            raise RuntimeError(
                f"injected dispatch failure (engine={engine}, impl={impl})")
        service_s = float(self.service_model(
            sched, queries, split, mode, engine, impl, pt))
        b_pad = pt.params.shape[0]
        total = np.zeros(b_pad, np.float64)
        for j, q in enumerate(queries):
            total[j] = fake_count(q)
        total[len(queries):] = total[0] if queries else 0.0  # pad rows
        pv = (np.zeros((b_pad, 1), np.float64) if self.per_vertex else None)
        self.calls.append(FakeCall(list(queries), split, mode, engine, impl,
                                   pt.n_real, pt.n_pad, service_s))
        return FakeOutput(total, pv), service_s
