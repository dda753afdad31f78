"""LDBC workload replay through the batch scheduler — open- and closed-loop.

The paper's serving experiment (Table 5) drives 1600 LDBC queries and reports
latency and completion within a budget.  This harness reproduces that shape
in two load-generation modes:

  open    arrivals follow a Poisson process whose rate does NOT react to
          service times (the load generator never waits on the server), so
          queueing delay is part of measured latency — the honest way to
          report a serving system, and the mode where an overloaded queue
          grows without bound;
  closed  at most ``max_outstanding`` requests are in flight: a new query is
          issued only when a slot frees (completion, failure, or admission
          reject).  Backlog is bounded by construction — the control
          experiment against open-loop divergence.

Mechanics: a virtual clock advances over measured (or injected — see
serving/testing.py) batch service times.  At each dispatch point every
arrived query is submitted — through the admission controller when the
scheduler carries one, so rejects happen at the arrival instant — and the
scheduler drains its queue earliest-deadline-first; each query's latency is
its dispatch-chunk completion time minus its own arrival time.

Per-query deadlines: ``deadline_s`` may be a scalar (every query) or a
``(lo, hi)`` tuple (sampled uniformly per query from the replay seed —
reproducible).  The report separates COMPLETION (finished within budget)
from DEADLINE HIT (finished within its own deadline), and scores goodput as
deadline-hits per second — the SLO quantity admission control optimises.

A group that fails to dispatch (e.g. a non-sliceable query forced onto the
sliced engine) marks its queries FAILED: they are excluded from latency
percentiles and counted against completion — a failed query is not a
completed query.  An empty workload returns a well-formed all-zero report.

Structured failures: every non-done query carries its scheduler status
(FAILED / QUARANTINED / TIMEOUT — serving/faults.py) or admission verdict
(REJECTED, with the controller's reason), and the report's ``failures``
list gives (index, template, status, error) per query — never only
aggregate counts, so a silent failure cannot hide inside a rate.  Retry
backoff accounted by the fault layer rides inside ``GroupDispatch.
service_s``, so the virtual clock (and with it latency percentiles and
goodput) includes the waiting a retried query actually experienced.

The port's copy of the reference package's ``serving/replay.py``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..graphdata.queries import QueryInstance
from .scheduler import BatchScheduler

#: per-query terminal states in ``ReplayReport.statuses`` (the last two
#: come from the scheduler's fault layer — serving/faults.py)
DONE, FAILED, REJECTED = "done", "failed", "rejected"
QUARANTINED, TIMEOUT = "quarantined", "timeout"


def poisson_arrivals(n: int, rate_qps: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Cumulative arrival times (seconds) of an open-loop Poisson process."""
    assert rate_qps > 0
    return np.cumsum(rng.exponential(1.0 / rate_qps, size=n))


def _draw_deadlines(n: int, deadline_s, rng: np.random.Generator
                    ) -> np.ndarray:
    """Per-query relative deadlines: scalar, (lo, hi) uniform, or +inf."""
    if deadline_s is None:
        return np.full(n, math.inf)
    if isinstance(deadline_s, (tuple, list)):
        lo, hi = deadline_s
        return rng.uniform(float(lo), float(hi), size=n)
    return np.full(n, float(deadline_s))


@dataclasses.dataclass
class ReplayReport:
    n_queries: int
    rate_qps: float               # 0 in closed-loop mode (no external rate)
    seed: int
    wall_s: float                 # virtual makespan (arrival of first → last done)
    throughput_qps: float         # completed queries per second
    latency_ms_p50: float         # percentiles over COMPLETED queries
    latency_ms_p95: float
    latency_ms_p99: float
    latency_ms_mean: float
    completion_rate: float        # fraction of ALL queries done within budget
    budget_s: float
    mean_batch: float
    max_batch: int
    n_dispatches: int
    caches: dict
    # ---- SLO accounting (defaults describe a plain open-loop run)
    mode: str = "open"
    max_outstanding: int = 0      # closed-loop slot count (0 = open loop)
    n_completed: int = 0
    n_failed: int = 0             # dispatch raised: NOT completed
    n_rejected: int = 0           # admission refused at arrival
    n_quarantined: int = 0        # poison queries isolated by bisection
    n_timeout: int = 0            # retry budget exhausted vs EDF deadline
    n_degraded: int = 0
    reject_rate: float = 0.0
    deadline_hit_rate: float = 1.0  # fraction of ALL queries inside their own
                                    # deadline (rejects/failures are misses)
    goodput_qps: float = 0.0        # deadline hits per second
    slo: Optional[dict] = None      # scheduler.slo_report() (admission +
                                    # telemetry counters)
    latencies_ms: Optional[np.ndarray] = None   # per query, arrival order
                                                # (NaN = not completed)
    statuses: Optional[List[str]] = None        # DONE/FAILED/REJECTED/
                                                # QUARANTINED/TIMEOUT
    #: one structured record per NON-done query: {index, template, status,
    #: error} — the per-query story behind the aggregate counts
    failures: Optional[List[dict]] = None

    def as_dict(self, with_latencies: bool = False) -> dict:
        d = {k: v for k, v in dataclasses.asdict(self).items()
             if k not in ("latencies_ms", "statuses")}
        if with_latencies and self.latencies_ms is not None:
            d["latencies_ms"] = [round(float(x), 3) for x in self.latencies_ms]
        return d


def _percentile(x: np.ndarray, q: float) -> float:
    return float(np.percentile(x, q)) if x.size else 0.0


def _finish_report(
    *, n: int, mode: str, rate_qps: float, seed: int, budget: float,
    sched: BatchScheduler, t: float, arrivals: np.ndarray,
    rel_deadline: np.ndarray, latencies: np.ndarray, statuses: List[str],
    batch_sizes: List[int], n_dispatches: int, max_outstanding: int,
    errors: Optional[List[str]] = None,
    templates: Optional[List[str]] = None,
) -> ReplayReport:
    done = np.asarray([s == DONE for s in statuses], bool)
    lat_done = latencies[done]
    lat = np.where(done, latencies, np.inf)   # NaN-free for the comparisons
    completed = done & (lat <= budget * 1e3)
    hit = done & (lat <= rel_deadline * 1e3)
    wall = float(t)
    n_rejected = sum(s == REJECTED for s in statuses)
    failures = [
        dict(index=i, status=statuses[i],
             template=(templates[i] if templates is not None else ""),
             error=(errors[i] if errors is not None else ""))
        for i in range(n) if statuses[i] != DONE
    ]
    if getattr(sched, "metrics", None) is not None:
        mx = sched.metrics
        slack = mx.histogram("granite_deadline_slack_ms",
                             "per-completed-query slack vs its own deadline "
                             "(ms; finite deadlines only)")
        for i in range(n):
            if done[i] and math.isfinite(rel_deadline[i]):
                slack.observe(rel_deadline[i] * 1e3 - latencies[i])
        status_ctr = mx.counter("granite_replay_total",
                                "replayed queries by terminal status",
                                labelnames=("status",))
        for s in statuses:
            status_ctr.inc(status=s)
        mx.gauge("granite_goodput_qps",
                 "deadline hits per second, last replay").set(
            float(hit.sum()) / max(wall, 1e-12))
    return ReplayReport(
        n_queries=n,
        rate_qps=rate_qps,
        seed=seed,
        wall_s=wall,
        throughput_qps=int(done.sum()) / max(wall, 1e-12),
        latency_ms_p50=_percentile(lat_done, 50),
        latency_ms_p95=_percentile(lat_done, 95),
        latency_ms_p99=_percentile(lat_done, 99),
        latency_ms_mean=float(lat_done.mean()) if lat_done.size else 0.0,
        completion_rate=float(completed.sum()) / n if n else 0.0,
        budget_s=budget,
        mean_batch=float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        max_batch=int(np.max(batch_sizes)) if batch_sizes else 0,
        n_dispatches=n_dispatches,
        caches=sched.cache_report(),
        mode=mode,
        max_outstanding=max_outstanding,
        n_completed=int(done.sum()),
        n_failed=sum(s == FAILED for s in statuses),
        n_rejected=n_rejected,
        n_quarantined=sum(s == QUARANTINED for s in statuses),
        n_timeout=sum(s == TIMEOUT for s in statuses),
        n_degraded=sched.n_degraded,
        reject_rate=n_rejected / n if n else 0.0,
        deadline_hit_rate=float(hit.sum()) / n if n else 1.0,
        goodput_qps=float(hit.sum()) / max(wall, 1e-12),
        slo=sched.slo_report(),
        latencies_ms=latencies,
        statuses=statuses,
        failures=failures,
    )


def _drain(sched: BatchScheduler, t: float, admitted: List[int],
           latencies: np.ndarray, statuses: List[str],
           arrivals: np.ndarray, batch_sizes: List[int], warm: bool,
           errors: Optional[List[str]] = None) -> Tuple[float, int]:
    """One flush: advance the virtual clock over each dispatch's service
    time (EDF order — service_s includes any accounted retry backoff),
    record completions; every non-done query takes its scheduler status
    (FAILED / QUARANTINED / TIMEOUT) and structured error — such units
    consumed no measured service and must not count as completed."""
    results = sched.flush(warm=warm)
    assert len(results) == len(admitted)
    n_disp = 0
    for disp in sched.last_dispatches:
        t += disp.service_s
        batch_sizes.append(disp.n_real)
        n_disp += 1
        for pos in disp.indices:
            qi = admitted[pos]
            latencies[qi] = (t - arrivals[qi]) * 1e3
            statuses[qi] = DONE
    for pos, r in enumerate(results):
        if r is not None and r.status != DONE:
            qi = admitted[pos]
            statuses[qi] = r.status
            if errors is not None:
                errors[qi] = r.error
    return t, n_disp


def replay_workload(
    sched: BatchScheduler,
    workload: Sequence[QueryInstance],
    rate_qps: float = 0.0,
    seed: int = 0,
    budget_s: Optional[float] = None,
    warm: bool = False,
    mode: str = "open",
    max_outstanding: int = 0,
    deadline_s: Union[None, float, Tuple[float, float]] = None,
) -> ReplayReport:
    """Drive ``workload`` through ``sched`` on a virtual clock.

    ``mode='open'`` (default) draws Poisson arrivals at ``rate_qps``;
    ``mode='closed'`` keeps at most ``max_outstanding`` requests in flight
    and ignores ``rate_qps``.  ``deadline_s`` assigns per-query deadlines
    (scalar or uniform ``(lo, hi)``), threaded through ``sched.submit`` so
    an attached admission controller sees them.  ``warm=True`` makes every
    dispatch pre-run its executable untimed (use for the measured pass after
    a cold pass has populated the caches — or directly, to exclude compile
    time the way the paper excludes load time).
    """
    if mode not in ("open", "closed"):
        raise ValueError(f"mode must be 'open' or 'closed', got {mode!r}")
    n = len(workload)
    budget = budget_s if budget_s is not None else sched.budget_s
    rng = np.random.default_rng(seed)
    if mode == "open":
        assert rate_qps > 0, "open-loop replay needs an arrival rate"
        arrivals = poisson_arrivals(n, rate_qps, rng)
    else:
        assert max_outstanding >= 1, "closed-loop replay needs slots"
        arrivals = np.zeros(n)          # filled at issue time
        rate_qps = 0.0
    rel_deadline = _draw_deadlines(n, deadline_s, rng)

    latencies = np.full(n, np.nan)
    statuses: List[Optional[str]] = [None] * n
    errors: List[str] = [""] * n
    batch_sizes: List[int] = []
    n_dispatches = 0
    t = 0.0

    def _submit(j: int, now: float) -> bool:
        """Submit query j at virtual time ``now``; False = rejected.

        The deadline clock starts at ARRIVAL (that is what the report's hit
        accounting measures), so the relative deadline handed to admission
        is what REMAINS at the submission instant — a query that already
        queued past its deadline rejects outright."""
        if math.isinf(rel_deadline[j]):
            dl = None
        else:
            dl = float(rel_deadline[j] - (now - arrivals[j]))
        dec = sched.submit(workload[j], deadline_s=dl, now=now)
        if dec is not None and not dec.admitted:
            statuses[j] = REJECTED
            errors[j] = dec.reason
            return False
        return True

    if mode == "open":
        i = 0                   # next not-yet-admitted arrival
        while i < n:
            if t < arrivals[i]:
                t = float(arrivals[i])
            # admit everything that has arrived by the dispatch point
            admitted: List[int] = []
            j = i
            while j < n and arrivals[j] <= t:
                if _submit(j, t):
                    admitted.append(j)
                j += 1
            i = j
            t, nd = _drain(sched, t, admitted, latencies, statuses,
                           arrivals, batch_sizes, warm, errors)
            n_dispatches += nd
    else:
        # batch-synchronous closed loop: issue up to ``max_outstanding``,
        # wait for the whole wave (flush resolves every admitted entry —
        # completion, failure, or reject frees the slot), issue the next.
        issued = 0
        while issued < n:
            admitted = []
            while issued < n and len(admitted) < max_outstanding:
                arrivals[issued] = t
                if _submit(issued, t):
                    admitted.append(issued)
                issued += 1
            if not admitted:
                continue        # a wave of rejects; keep issuing
            t, nd = _drain(sched, t, admitted, latencies, statuses,
                           arrivals, batch_sizes, warm, errors)
            n_dispatches += nd

    return _finish_report(
        n=n, mode=mode, rate_qps=rate_qps, seed=seed, budget=budget,
        sched=sched, t=t, arrivals=arrivals, rel_deadline=rel_deadline,
        latencies=latencies, statuses=statuses, batch_sizes=batch_sizes,
        n_dispatches=n_dispatches, max_outstanding=max_outstanding,
        errors=errors,
        templates=[getattr(w, "template", "adhoc") for w in workload])
