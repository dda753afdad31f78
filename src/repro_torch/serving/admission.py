"""Deadline admission control: predict at the door, reject or degrade —
never queue unboundedly.

The paper's serving claim is *completion*: every admitted query finishes
within budget.  Under sustained overload an open-loop queue cannot deliver
that — latency grows without bound and the deadline is missed by everything.
This module closes the loop at admission time: each arriving query carries a
deadline, the fitted cost model (``Planner.estimate`` — the same θ the
serving telemetry refits online) predicts its service cost and the predicted
backlog already admitted ahead of it, and the controller decides:

  admit     predicted completion (wait + service) fits inside the deadline
            with ``headroom`` to spare;
  degrade   it does not fit as-is, but a rung of the degradation ladder
            makes it fit: a cheaper hop-delivery impl (the fitted per-impl
            θ_scatter slopes say which), a dense→sliced engine downgrade
            (smaller typed extents — same bit-identical answer), and a
            bounded dispatch quantum (``degrade_max_batch`` caps the group
            chunk the query rides in, so EDF can interleave urgent work
            instead of waiting out one huge batched call);
  reject    no rung fits — refuse NOW, at predicted cost zero, rather than
            burn service time on a query that will miss its deadline anyway
            (goodput over throughput).

Backlog accounting is intentionally simple and conservative: the sum of
predicted costs of everything admitted since the last flush (the scheduler
resets it via ``on_flush`` when the queue drains).  Predictions come from
the live planner coefficients, so an online θ refit (serving/telemetry.py)
tightens admission decisions as serving proceeds.

Every decision is deterministic given (queue state, θ) — the FakeDispatcher
test harness (serving/testing.py) pins exact admit/degrade/reject sequences
on a virtual clock.

The port's copy of the reference package's ``serving/admission.py``; the
impl rung names the port's lowerings (``impl=cuda`` / ``impl=torch``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from ..core import engine_sliced as ES
from ..core import query as Q
from ..core.planner import HOP_IMPL_CHOICES

ADMIT, DEGRADE, REJECT = "admit", "degrade", "reject"


@dataclasses.dataclass
class AdmissionPolicy:
    """Knobs of the admission controller (README: "degradation ladder")."""
    #: deadline assigned when submit() gives none (seconds, relative)
    default_deadline_s: float = 600.0
    #: admit when wait + service <= headroom · deadline — < 1.0 keeps slack
    #: for prediction error (the telemetry report says how much is needed)
    headroom: float = 0.8
    #: hard bound on predicted queued work (seconds); None = deadline-driven
    max_backlog_s: Optional[float] = None
    #: ladder rung 1 — sweep these impls for a cheaper lowering (fitted
    #: per-impl θ_scatter slopes); () disables the rung
    degrade_impls: Tuple[str, ...] = HOP_IMPL_CHOICES
    #: ladder rung 2 — dense→sliced downgrade when the query is sliceable
    allow_engine_downgrade: bool = True
    #: predicted-cost multiplier of the sliced downgrade (typed extents are
    #: strictly smaller than whole-graph extents; refit-calibrated hosts can
    #: tighten this)
    sliced_discount: float = 0.7
    #: ladder rung 3 — cap the dispatch quantum of degraded queries so EDF
    #: interleaves at finer grain; None disables the rung
    degrade_max_batch: Optional[int] = 8


@dataclasses.dataclass
class AdmissionDecision:
    """What the controller decided for one query, and why."""
    action: str                   # ADMIT | DEGRADE | REJECT
    reason: str
    deadline: float               # absolute deadline assigned (inf = none)
    predicted_s: float            # predicted service cost of this query
    predicted_wait_s: float       # predicted backlog ahead of it
    impl: Optional[str] = None    # degradation overrides (None = scheduler
    engine: Optional[str] = None  # defaults)
    max_batch: Optional[int] = None
    #: degradation-ladder rungs taken, in order (e.g. "impl=cuda",
    #: "engine=sliced") — the flight recorder's admit-span and
    #: admission-metric labels; empty for plain admits and rejects
    rungs: Tuple[str, ...] = ()

    @property
    def admitted(self) -> bool:
        return self.action != REJECT


class AdmissionController:
    """Stateful deadline admission for one BatchScheduler.

    Life of a decision (``decide``, called from ``BatchScheduler.submit``
    before anything is enqueued): resolve the query's engine/mode and the
    plan it *would* run at → predict its service cost with the scheduler's
    live (possibly refit) cost model → compare ``predicted wait + service``
    against ``headroom · deadline``.  If it fits, ADMIT; otherwise walk the
    degradation ladder (cheaper hop impl → dense→sliced downgrade → bounded
    dispatch quantum) and admit DEGRADEd at the first fitting rung; if no
    rung fits, REJECT at submit time — zero service cost spent, goodput
    over throughput.

    State is one number: ``backlog_ms``, the summed predicted cost admitted
    since the last flush (``on_flush`` zeroes it).  That makes decisions
    deterministic given the submission sequence — the property the
    virtual-clock SLO tests pin exact admit/degrade/reject traces on.

    The scheduler owns the planner and the plan cache; the controller only
    reads them (``peek`` — admission must not poison the batch-aware plan
    cache with single-query plans).  It holds no graph state at all: cost
    predictions track the scheduler's planner.
    """

    def __init__(self, policy: Optional[AdmissionPolicy] = None):
        self.policy = policy or AdmissionPolicy()
        self.backlog_ms = 0.0     # predicted cost queued since last flush
        self.n_admitted = 0
        self.n_degraded = 0
        self.n_rejected = 0

    # ------------------------------------------------------------- lifecycle
    def on_flush(self) -> None:
        """The scheduler drained its queue: predicted backlog is gone."""
        self.backlog_ms = 0.0

    # -------------------------------------------------------------- decision
    def _planned(self, sched, qry, engine: str, mode: int):
        """(split, impl) the group would run at — the cached batch-aware plan
        when one exists, the scheduler's defaults otherwise (admission never
        writes the plan cache)."""
        from .compile import bucket_key
        fixed = None if sched.impl == "auto" else sched.impl
        plan = sched.plan_cache.peek(
            sched._plan_key(bucket_key(qry), mode, engine, sched.impl))
        if plan is not None:
            return plan[0], plan[1]
        split = 0 if qry.agg_op != Q.AGG_NONE else qry.n_vertices - 1
        return split, fixed or "torch"

    def _cost_ms(self, sched, qry, engine: str, split: int, impl: str) -> float:
        return float(sched._planner_for(engine).estimate(qry, split, impl).t_ms)

    def decide(self, sched, inst, now: float,
               deadline_s: Optional[float]) -> AdmissionDecision:
        pol = self.policy
        rel = pol.default_deadline_s if deadline_s is None else float(deadline_s)
        deadline = math.inf if math.isinf(rel) else now + rel
        qry = inst.qry
        engine = sched._engine_for(qry)
        mode = sched._mode_for(qry)
        split, impl = self._planned(sched, qry, engine, mode)
        cost_ms = self._cost_ms(sched, qry, engine, split, impl)
        wait_s = self.backlog_ms / 1e3

        def fits(c_ms: float) -> bool:
            if (pol.max_backlog_s is not None
                    and wait_s + c_ms / 1e3 > pol.max_backlog_s):
                return False
            return wait_s + c_ms / 1e3 <= pol.headroom * rel

        if fits(cost_ms):
            self.n_admitted += 1
            self.backlog_ms += cost_ms
            return AdmissionDecision(ADMIT, "fits", deadline, cost_ms / 1e3,
                                     wait_s)

        # ---- degradation ladder: cheaper impl → sliced engine → bounded
        # dispatch quantum; taken cumulatively, first fitting rung wins
        deg_impl: Optional[str] = None
        deg_engine: Optional[str] = None
        best_ms = cost_ms
        rungs = []
        if pol.degrade_impls:
            for cand in pol.degrade_impls:
                if cand == impl:
                    continue
                c = self._cost_ms(sched, qry, engine, split, cand)
                if c < best_ms:
                    best_ms, deg_impl = c, cand
            if deg_impl is not None:
                rungs.append(f"impl={deg_impl}")
        if (pol.allow_engine_downgrade and engine == "dense"
                and ES.sliceable(qry)):
            best_ms *= pol.sliced_discount
            deg_engine = "sliced"
            rungs.append("engine=sliced")
        if fits(best_ms):
            if pol.degrade_max_batch is not None:
                rungs.append(f"quantum={pol.degrade_max_batch}")
            self.n_degraded += 1
            self.backlog_ms += best_ms
            return AdmissionDecision(
                DEGRADE, "degraded: " + ",".join(rungs), deadline,
                best_ms / 1e3, wait_s, impl=deg_impl, engine=deg_engine,
                max_batch=pol.degrade_max_batch, rungs=tuple(rungs))

        self.n_rejected += 1
        return AdmissionDecision(
            REJECT,
            f"predicted wait {wait_s:.3f}s + service {best_ms / 1e3:.3f}s "
            f"exceeds {pol.headroom:g}·deadline {rel:.3f}s",
            deadline, best_ms / 1e3, wait_s)

    # ------------------------------------------------------------- reporting
    def report(self) -> dict:
        return dict(n_admitted=self.n_admitted, n_degraded=self.n_degraded,
                    n_rejected=self.n_rejected,
                    backlog_ms=round(self.backlog_ms, 6))
