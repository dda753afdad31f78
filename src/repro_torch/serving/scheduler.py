"""Shape-bucketed batch scheduler — the serving runtime's dispatch core.

Queries enter an admission queue (``submit``); ``flush`` drains it in three
moves:

  group     queued instances are bucketed by (shape bucket, temporal mode,
            engine) — everything in a group shares one query structure;
  plan      each group's split point comes from the batch-aware cost model
            (``Planner.choose_batch``: whole-batch cost, not the first
            instance's — per-instance selectivities differ), memoised in the
            PlanCache keyed by (bucket, graph fingerprint);
  dispatch  ONE batched engine call per group through the executable cache
            (the engines carry the query axis through every superstep, and
            the hop kernels walk it inside the kernel).  Aggregates
            (COUNT/MIN/MAX) batch exactly like plain counts — there is no
            per-query fallback path in this runtime.

Engines: ``dense`` / ``sliced`` (``core/engine.batch_executable``),
``partitioned`` (``core/engine_partitioned.batch_executable`` over
``n_workers`` workers, simulated on one device: one dispatch runs
batch × workers with the point-to-point boundary exchange between
supersteps), or ``auto`` (sliced when the query qualifies, dense otherwise —
resolved at admission so the group key is concrete).  ``pin_epoch`` serves a
live graph's sealed epochs (``serving/epochs.py``), pure edge-append windows
on the base+delta executable (``core/engine.batch_executable_delta``).

Hop-delivery lowering: the ``impl`` knob (``HOP_IMPLS``) pins every group on
one lowering — ``'cuda'``, the hand-written hop kernels (the default), or
``'torch'``, plain ops — or ``'auto'`` lets the batch-aware planner sweep
(split × impl) with the fitted per-impl θ_scatter slopes and dispatch each
group on the winner (with unfitted coefficients that ties to ``'torch'``,
as the reference ties to ``'xla'``).  The chosen impl and its launch-shape
signature are part of the executable key.

Device: resolved once at construction (``kernels.common.resolve_device``):
the card unless the caller passes ``device='cpu'``; with no GPU and no
``device='cpu'`` the constructor raises.  A dispatch waits for the card
(``torch.cuda.synchronize``) before the injected ``clock`` stops, and on the
card it also brackets the timed call with CUDA events
(``GroupDispatch.event_ms``).  Results copy to the host: ``total`` always,
``per_vertex`` and ``minmax`` only with ``keep_outputs`` (an aggregate's
per-vertex state is the size of the graph).

SLO layer (serving/admission.py, serving/telemetry.py):

  deadlines  every queue entry carries an absolute deadline (``submit``'s
             ``deadline_s`` is relative to ``now``); ``flush`` dispatches
             groups EARLIEST-DEADLINE-FIRST (group deadline = its most
             urgent member; ties keep arrival order, so the historical
             no-deadline behaviour is unchanged);
  admission  with an ``admission`` controller attached, ``submit`` predicts
             wait + service from the live cost model and returns an
             AdmissionDecision — rejected queries never enter the queue,
             degraded ones carry per-entry impl/engine/batch-cap overrides
             that join the group key (degraded groups dispatch separately,
             in bounded chunks the EDF order can interleave);
  telemetry  every timed dispatch records (features, predicted, measured)
             into the TelemetryBuffer; periodic online θ refit updates the
             planner's coefficients in place (and clears the plan cache so
             stale split choices are re-planned once).

The ``dispatcher`` hook swaps the build-and-run step for an injected one
(serving/testing.FakeDispatcher): all SLO control logic — grouping, EDF,
chunking, admission, telemetry — is testable on a virtual clock with no
engine call.

Fault layer (serving/faults.py): a ``fault_plan`` injects deterministic
failures at the named points inside ``_dispatch`` (compile / dispatch /
straggler), and a ``retry`` policy turns failures into completion instead
of errors — exponential-backoff retries whose delays are ACCOUNTED into the
virtual clock (never slept), a deadline-aware budget (a retry that would
land past the group's EDF deadline re-enters admission or times out with a
structured error), and bisection quarantine (a unit that keeps failing
splits in half until the single poison query is isolated and rejected
while the rest answer).  Without a ``retry`` policy one exception marks the
whole unit failed.

Observability (``obs``): with a ``tracer`` attached every submitted query
leaves one span tree — query → admit → plan → compile → dispatch →
superstep (per hop) → exchange — carrying the admission verdict/rungs, the
plan's candidate sweep, cache hits, EDF position, and predicted-vs-measured
ms at query, group, and hop granularity; a ``metrics`` registry mirrors the
counters (admission verdicts, cache events, refits, dispatch latency
histogram, queue depth).  The default ``NULL_TRACER`` makes the disabled
path a no-op attribute lookup, and all timing flows through the injected
``clock``, so under the FakeDispatcher virtual clock the exact span tree is
deterministic.

The port of the reference package's ``serving/scheduler.py``: the control
logic is the reference's line for line, so the same submissions give the
same groups, plans, decisions, counters and span trees.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from ..core import engine as E
from ..core import engine_partitioned as EP
from ..core import engine_sliced as ES
from ..core import query as Q
from ..core.planner import HOP_IMPL_CHOICES, Planner, coeff_vector
from ..core.stats import GraphStats
from ..faults_common import backoff_delay
from ..graphdata.queries import QueryInstance
from ..kernels.common import resolve_device
from ..obs.trace import NULL_TRACER
from .admission import AdmissionController, AdmissionDecision, AdmissionPolicy
from .cache import (ExecutableCache, PlanCache, graph_fingerprint,
                    layout_signature)
from .compile import bucket_key, compile_plan_tensor
from .faults import (CompileError, FaultError, FaultPlan, PoisonQueryError,
                     RetryPolicy, TransientDispatchError, WorkerLostError)
from .telemetry import TelemetryBuffer

ENGINES = ("auto", "dense", "sliced", "partitioned")
#: hop-delivery lowering knob: fixed, or "auto" = the batch-aware planner
#: picks per group from the fitted per-impl θ_scatter slopes
HOP_IMPLS = ("auto", "torch", "cuda")


@dataclasses.dataclass
class ServedResult:
    """Per-query serving outcome (one row of the paper's Table 5 bookkeeping)."""
    template: str
    engine: str
    split: int
    count: float
    latency_ms: float            # amortised share of the group service time
    ok: bool
    batch_size: int              # real instances in the dispatched group
    total: Optional[np.ndarray] = None       # kept when keep_outputs=True
    per_vertex: Optional[np.ndarray] = None
    minmax: Optional[np.ndarray] = None
    error: str = ""              # non-empty when the group dispatch failed
    deadline: float = math.inf   # absolute deadline the entry carried
    #: terminal disposition: "done" | "failed" | "quarantined" | "timeout"
    status: str = "done"


@dataclasses.dataclass
class QueueEntry:
    """One admitted query waiting in the scheduler's queue."""
    inst: QueryInstance
    deadline: float = math.inf   # absolute
    arrival: float = 0.0
    impl: Optional[str] = None   # admission-degradation overrides (None =
    engine: Optional[str] = None  # scheduler defaults)
    max_batch: Optional[int] = None
    span: object = None          # root "query" span (flight recorder)


@dataclasses.dataclass
class GroupDispatch:
    """One batched engine call: the scheduler's unit of work."""
    key: tuple                   # (bucket, mode, engine, impl override)
    engine: str
    split: int
    n_real: int
    n_pad: int
    service_s: float             # measured time of the batched call (clock)
    indices: List[int]           # queue positions served by this dispatch
    plan_cached: bool
    exec_cached: bool
    impl: str = "cuda"           # hop-delivery lowering the group ran on
    deadline: float = math.inf   # most urgent member's deadline (EDF key)
    predicted_ms: float = 0.0    # cost-model prediction (telemetry rows)
    n_retries: int = 0           # backoff retries the unit burned
    penalty_s: float = 0.0       # accounted retry backoff inside service_s
    delta: bool = False          # served on the base+delta executable path
    #: CUDA-event time of the timed call on the card (None on the CPU or
    #: with an injected dispatcher)
    event_ms: Optional[float] = None
    fallback_from: str = ""      # engine the unit was re-planned away from


def _host(x) -> np.ndarray:
    """A dispatch output field on the host as numpy."""
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class BatchScheduler:
    """The serving runtime's dispatch core (see the module docstring for the
    full control flow).

    Life of a query: ``submit`` admits it (optionally through the SLO
    admission controller) into the queue; ``flush`` groups the queue by
    (shape bucket, temporal mode, engine, impl override), plans each group
    once through the batch-aware cost model (memoised in ``plan_cache``),
    and dispatches ONE batched engine call per group through ``exec_cache``
    — earliest-deadline-first, results in submission order.

    Live graphs: ``pin_epoch(epoch)`` (driven by ``serving.epochs.
    EpochManager.advance``) switches the scheduler to a sealed-epoch
    snapshot without dropping warm state.  Between two compactions the
    *base* graph (``self.graph``) — planner stats, partitionings,
    executables — is immutable; an epoch whose delta window is pure edge
    appends serves eligible groups on the base+delta executable
    (``engine.batch_executable_delta``), so cache keys carrying the base
    fingerprint keep hitting across epochs.  Ineligible groups (ETR hops,
    impure windows, non-dense engines) serve from the epoch's merged graph
    under the epoch fingerprint.  Either way results are bit-identical to a
    from-scratch build of the pinned epoch's graph, and queries never see
    events sealed after their batch's pin.

    Key invariants:
      * plan keys carry the BASE fingerprint (splits are planned against
        base statistics; any split yields identical results);
      * executable keys carry the serving fingerprint — the base
        fingerprint for delta dispatches, the epoch fingerprint otherwise;
      * cache eviction at compaction is targeted (``evict`` of retired
        fingerprints), counted per entry in the metrics registry as
        ``granite_cache_total{event="invalidation"}``.
    """

    def __init__(
        self,
        graph,
        engine: str = "auto",
        mode: Optional[int] = None,
        n_buckets: int = 16,
        use_planner: bool = True,
        budget_s: float = 600.0,
        keep_outputs: bool = False,
        plan_cache: Optional[PlanCache] = None,
        exec_cache: Optional[ExecutableCache] = None,
        pad_batches: bool = True,
        impl: str = "cuda",
        admission=None,
        telemetry: Optional[TelemetryBuffer] = None,
        dispatcher=None,
        clock=time.perf_counter,
        tracer=None,
        metrics=None,
        fault_plan: Optional[FaultPlan] = None,
        retry: Optional[RetryPolicy] = None,
        device=None,
        n_workers: int = 4,
    ):
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}")
        if impl not in HOP_IMPLS:
            raise ValueError(f"impl must be one of {HOP_IMPLS}")
        self.device = resolve_device(device)
        self.graph = graph
        self.engine = engine
        self.impl = impl
        self.n_buckets = n_buckets
        self.n_workers = n_workers
        self.use_planner = use_planner
        self.budget_s = budget_s
        self.keep_outputs = keep_outputs
        self.pad_batches = pad_batches
        dynamic = bool(graph.meta.get("params", {}).get("dynamic", False))
        self.mode = mode if mode is not None else (
            E.MODE_BUCKET if dynamic else E.MODE_STATIC)
        self.fingerprint = graph_fingerprint(graph)
        self.plan_cache = plan_cache if plan_cache is not None else PlanCache()
        self.exec_cache = exec_cache if exec_cache is not None else ExecutableCache()
        self._stats = GraphStats(graph, n_time_buckets=n_buckets)
        self._planner = Planner(graph, self._stats)
        self._planner_part: Optional[Planner] = None  # built on first use
        # ---- epoch pinning (pin_epoch): base vs serving graph split.
        # self.graph stays the compaction BASE (planner stats, partition
        # tables, delta executables bind to it); _serve_graph is the pinned
        # epoch's merged graph (== graph until an epoch is pinned).
        self._serve_graph = graph
        self._base_fp = self.fingerprint    # compaction-base fingerprint
        self._plan_fp = self.fingerprint    # fingerprint slot of plan keys
        self._epoch = None
        self._delta = None                  # DeltaSpec.device() dict | None
        self._delta_capacity = 0
        self._warmed_delta = set()          # (ekey, capacity) pairs warmed
        self._last_used_delta = False
        self._queue: List[QueueEntry] = []
        self.last_dispatches: List[GroupDispatch] = []
        self.n_dispatched = 0
        # ---- SLO layer (all optional; None keeps the historical behaviour)
        if isinstance(admission, AdmissionPolicy):
            admission = AdmissionController(admission)
        self.admission: Optional[AdmissionController] = admission
        self.telemetry = telemetry
        self.dispatcher = dispatcher
        self._clock = clock
        self.n_rejected = 0
        self.n_degraded = 0
        # ---- fault layer (serving/faults.py; None keeps the historical
        # one-exception-fails-the-unit behaviour)
        self.fault_plan: Optional[FaultPlan] = fault_plan
        self.retry: Optional[RetryPolicy] = retry
        self.n_retries = 0
        self.n_quarantined = 0
        self.n_timeout = 0
        self.n_fallbacks = 0
        self._flush_count = 0
        self._part_down_until = -1   # flush count the partitioned probe waits for
        # ---- observability (tracer defaults to the no-op singleton)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        self._dispatch_seq = 0
        # per-query PlanEstimate memo: features are θ-INDEPENDENT structural
        # sums (GraphStats), so entries survive online refits — predictions
        # are recomputed as features @ live θ at use time
        self._est_memo: Dict[tuple, object] = {}
        if metrics is not None:
            self._mx_admission = metrics.counter(
                "granite_admission_total", "admission outcomes",
                labelnames=("verdict", "rung"))
            self._mx_queue = metrics.gauge(
                "granite_queue_depth", "entries queued for the next flush")
            self._mx_dispatch_ms = metrics.histogram(
                "granite_dispatch_ms",
                "measured wall time per group dispatch (ms)")
            self._mx_dispatched = metrics.counter(
                "granite_dispatched_total", "real queries dispatched")
            self._mx_cache = metrics.counter(
                "granite_cache_total", "serving cache events",
                labelnames=("cache", "event"))
            self._mx_refit = metrics.counter(
                "granite_refit_total", "online θ refits applied")
            self._mx_retries = metrics.counter(
                "granite_retries_total", "dispatch retries by fault kind",
                labelnames=("kind",))
            self._mx_quarantined = metrics.counter(
                "granite_quarantined_total",
                "queries rejected as poison after bisection")
            self._mx_degraded_disp = metrics.counter(
                "granite_degraded_dispatches_total",
                "units re-planned off the partitioned path",
                labelnames=("reason",))

    # ------------------------------------------------------------ admission
    def submit(self, inst: Union[QueryInstance, Q.PathQuery],
               deadline_s: Optional[float] = None,
               now: Optional[float] = None) -> Optional[AdmissionDecision]:
        """Enqueue a query.  ``deadline_s`` is relative to ``now`` (default:
        the scheduler's clock — replay harnesses pass their virtual time).
        With an admission controller attached, returns its decision — a
        rejected query never enters the queue; without one, every submit
        admits (deadlines still order the flush)."""
        if isinstance(inst, Q.PathQuery):
            inst = QueryInstance("adhoc", inst, {})
        if now is None:
            now = self._clock() if (deadline_s is not None
                                    or self.admission is not None) else 0.0
        tr = self.tracer
        root = tr.start("query", template=inst.template,
                        n_vertices=inst.qry.n_vertices,
                        deadline_s=deadline_s)
        if self.admission is not None:
            adm = tr.start("admit", parent=root)
            dec = self.admission.decide(self, inst, now, deadline_s)
            tr.end(adm, verdict=dec.action, rungs=list(dec.rungs),
                   reason=dec.reason, predicted_s=dec.predicted_s,
                   predicted_wait_s=dec.predicted_wait_s)
            if self.metrics is not None:
                self._mx_admission.inc(verdict=dec.action,
                                       rung=",".join(dec.rungs))
            if not dec.admitted:
                self.n_rejected += 1
                tr.end(root, status="rejected")
                return dec
            if dec.action == "degrade":
                self.n_degraded += 1
            self._queue.append(QueueEntry(inst, dec.deadline, now, dec.impl,
                                          dec.engine, dec.max_batch,
                                          span=root))
            if self.metrics is not None:
                self._mx_queue.set(len(self._queue))
            return dec
        if tr.enabled:
            adm = tr.start("admit", parent=root)
            tr.end(adm, verdict="admit", rungs=[],
                   reason="no admission controller")
        if self.metrics is not None:
            self._mx_admission.inc(verdict="admit", rung="")
        deadline = math.inf if deadline_s is None else now + float(deadline_s)
        self._queue.append(QueueEntry(inst, deadline, now, span=root))
        if self.metrics is not None:
            self._mx_queue.set(len(self._queue))
        return None

    @property
    def queued(self) -> int:
        return len(self._queue)

    def _mode_for(self, qry: Q.PathQuery) -> int:
        # aggregates in interval mode answer as bucket series (same policy as
        # the sequential server): the temporal aggregation operator is
        # defined per bucket.
        if qry.agg_op != Q.AGG_NONE and self.mode == E.MODE_INTERVAL:
            return E.MODE_BUCKET
        return self.mode

    def _engine_for(self, qry: Q.PathQuery) -> str:
        if self.engine != "auto":
            return self.engine
        # with a pinned pure-append delta window, ETR-free queries steer to
        # the dense engine: base+delta execution is dense-only (the sliced
        # engine binds type extents to one concrete graph) and reusing the
        # base executable beats rebuilding a sliced one on every epoch
        if self._delta is not None and all(
                ep.etr_op == -1 for ep in qry.e_preds):
            return "dense"
        return "sliced" if ES.sliceable(qry) else "dense"

    # ------------------------------------------------------------- planning
    def _planner_for(self, engine: str) -> Planner:
        """The planner a group on ``engine`` is costed with: the
        distribution-aware one (θ_net exchange terms from the partitioning
        the executor will run on) for the partitioned engine."""
        if engine != "partitioned":
            return self._planner
        if self._planner_part is None:
            _, arrays = EP.partition_for(self.graph, self.n_workers)
            self._planner_part = Planner(self.graph, self._stats,
                                         partitioning=arrays)
        return self._planner_part

    def _plan_key(self, bucket: tuple, mode: int, engine: str,
                  impl_choice: str) -> tuple:
        # plans are keyed by the BASE fingerprint: split choice comes from
        # base statistics and stays optimal-enough across edge-append epochs
        # (any split is result-identical); compaction retires the key
        return (bucket, self._plan_fp, mode, engine, self.n_buckets,
                self.n_workers if engine == "partitioned" else 0, impl_choice)

    def _plan_group(self, queries: List[Q.PathQuery], bucket: tuple,
                    mode: int, engine: str,
                    impl_override: Optional[str] = None):
        """(split, hop impl, plan_cached, candidates) for one group.  A
        fixed ``impl`` (the scheduler's, or a per-group admission-
        degradation override) pins the lowering and the planner only picks
        the split; ``'auto'`` sweeps (split × impl) with the fitted per-impl
        θ_scatter slopes.  ``candidates`` is the fresh sweep's candidate
        list (None on a cache hit or without the planner) — the plan span's
        audit payload."""
        qry = queries[0]
        default = 0 if qry.agg_op != Q.AGG_NONE else qry.n_vertices - 1
        impl_choice = impl_override or self.impl
        fixed_impl = None if impl_choice == "auto" else impl_choice
        if not self.use_planner:
            return default, fixed_impl or "torch", True, None
        key = self._plan_key(bucket, mode, engine, impl_choice)
        plan = self.plan_cache.get(key)
        if plan is not None:
            return plan[0], plan[1], True, None
        impls = HOP_IMPL_CHOICES if fixed_impl is None else (fixed_impl,)
        est = self._planner_for(engine).choose_batch(queries, impls=impls)
        split, impl = est.split, fixed_impl or est.impl
        self.plan_cache.put(key, (split, impl))
        return split, impl, False, est.candidates

    # ------------------------------------------------------------- dispatch
    def _build_executable(self, qry: Q.PathQuery, split: int, mode: int,
                          engine: str, impl: str):
        if engine == "partitioned":
            return EP.batch_executable(self._serve_graph, qry, split, mode,
                                       self.n_buckets, self.n_workers,
                                       impl=impl, device=self.device)
        return E.batch_executable(self._serve_graph, qry, split, mode,
                                  self.n_buckets,
                                  sliced=(engine == "sliced"), impl=impl,
                                  device=self.device)

    def _delta_eligible(self, qry: Q.PathQuery, engine: str) -> bool:
        """Can this group run on the base+delta executable?  Needs a pinned
        pure-append delta window, the dense engine (sliced/partitioned bind
        type extents / partition tables to a concrete graph), and no ETR
        hops (global rank tables)."""
        return (self._delta is not None and engine == "dense"
                and all(ep.etr_op == -1 for ep in qry.e_preds))

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _dispatch_torch(self, queries: List[Q.PathQuery], split: int,
                        mode: int, engine: str, impl: str, bucket: tuple, pt,
                        warm: bool):
        """The real build-and-run step: executable cache → one batched call,
        timed on the injected clock after the card has finished.  Swapped
        out wholesale by an injected ``dispatcher``.  Returns (output,
        seconds, exec_cached, CUDA-event ms or None).

        Delta-eligible groups run ``engine.batch_executable_delta`` against
        the compaction BASE: their cache key carries the base fingerprint
        (not the epoch's) and no capacity, so one cached executable serves
        every epoch of the window — the scheduler only re-warms when the
        padded delta capacity grows (new delta shapes: new first-call
        costs inside the same entry)."""
        use_delta = self._delta_eligible(queries[0], engine)
        self._last_used_delta = use_delta
        fp = ("delta", self._base_fp) if use_delta else self.fingerprint
        lay_graph = self.graph if use_delta else self._serve_graph
        n_workers = self.n_workers if engine == "partitioned" else 0
        ekey = (engine, fp, bucket, split, mode,
                self.n_buckets, n_workers, impl,
                layout_signature(lay_graph, engine, queries[0], impl,
                                 n_workers),
                pt.params.shape[0])
        exec_cached = ekey in self.exec_cache
        if use_delta:
            run0 = self.exec_cache.get_or_build(
                ekey, lambda: E.batch_executable_delta(
                    self.graph, queries[0], split, mode, self.n_buckets,
                    impl=impl, device=self.device))
            delta = self._delta
            run = lambda params: run0(params, delta)  # noqa: E731
            # a cached delta executable still meets new shapes when the
            # padded capacity grows — warm per (key, capacity), not per key
            warm_needed = (ekey, self._delta_capacity) not in self._warmed_delta
            if warm and warm_needed:
                self._warmed_delta.add((ekey, self._delta_capacity))
        else:
            run = self.exec_cache.get_or_build(
                ekey, lambda: self._build_executable(queries[0], split,
                                                     mode, engine, impl))
            warm_needed = not exec_cached
        if warm and warm_needed:
            # first dispatch at this key: run once untimed so first-call
            # costs (kernel loads, allocator growth) stay out of latency
            run(pt.params)
            self._sync()
        ev = None
        if self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
        # timing goes through the INJECTED clock (default time.perf_counter)
        # so dispatch durations — and with them telemetry rows and trace
        # spans — are deterministic under a test-injected step clock
        t0 = self._clock()
        if ev is not None:
            ev[0].record()
        res = run(pt.params)
        if ev is not None:
            ev[1].record()
        self._sync()
        dt = self._clock() - t0
        event_ms = None if ev is None else float(ev[0].elapsed_time(ev[1]))
        return res, dt, exec_cached, event_ms

    def _dispatch(self, queries: List[Q.PathQuery], split: int, mode: int,
                  engine: str, impl: str, bucket: tuple, pt, warm: bool):
        """One dispatch attempt with the named fault-injection points.

        This is the single funnel both the real torch path and an injected
        ``dispatcher`` (FakeDispatcher) run through, so a ``FaultPlan``
        exercises identical failure surfaces with no engine call.
        Consultation order: poison (deterministic per-query) → "compile" →
        "worker" (partitioned only) → "dispatch" → real call → "straggler"
        (service-time inflation, accounted not slept)."""
        plan = self.fault_plan
        if plan is not None:
            if plan.poison is not None and any(plan.is_poison(q)
                                               for q in queries):
                raise PoisonQueryError(
                    f"poison query in unit of {len(queries)}")
            if plan.should_fail("compile"):
                raise CompileError(
                    f"injected compile failure (engine={engine}, "
                    f"impl={impl}, split={split})")
            if engine == "partitioned" and plan.should_fail("worker"):
                raise WorkerLostError(
                    f"injected partition-worker loss "
                    f"(n_workers={self.n_workers})")
            if plan.should_fail("dispatch"):
                raise TransientDispatchError(
                    "injected transient dispatch error")
        if self.dispatcher is not None:
            res, dt = self.dispatcher.dispatch(
                self, queries, split, mode, engine, impl, pt, warm)
            exec_cached, event_ms = True, None
        else:
            res, dt, exec_cached, event_ms = self._dispatch_torch(
                queries, split, mode, engine, impl, bucket, pt, warm)
        if plan is not None:
            dt *= plan.straggle()
        return res, dt, exec_cached, event_ms

    # ------------------------------------------------------------ epochs
    def pin_epoch(self, epoch) -> None:
        """Pin serving to a sealed epoch (``serving.epochs.Epoch``).

        Until the next pin, every dispatch answers from this epoch's graph
        — queries never observe later (or unsealed) events, and results are
        bit-identical to a from-scratch build of the epoch's graph.  On a
        compacted epoch the scheduler REBASEs: planner statistics, the
        partitioned planner, and the estimate memo are rebuilt against the
        new base (cache eviction of retired fingerprints is the
        EpochManager's job, so its metrics can count what was dropped).
        Non-compacted epochs keep all warm state; delta-pure ones also
        attach the delta block, on the scheduler's device, for the
        base+delta dispatch path."""
        if epoch.base_fingerprint != self._base_fp:
            base = epoch.base_graph if epoch.base_graph is not None else epoch.graph
            self.graph = base
            self._stats = GraphStats(base, n_time_buckets=self.n_buckets)
            self._planner = Planner(base, self._stats)
            self._planner_part = None
            self._est_memo.clear()
            self._warmed_delta.clear()
        self._epoch = epoch
        self._base_fp = epoch.base_fingerprint
        self._plan_fp = epoch.base_fingerprint
        self.fingerprint = epoch.fingerprint
        self._serve_graph = epoch.graph
        if epoch.delta is not None:
            self._delta = epoch.delta.device(self.device)
            self._delta_capacity = epoch.delta.capacity
        else:
            self._delta = None
            self._delta_capacity = 0

    @property
    def pinned_epoch(self):
        """The currently pinned ``Epoch`` (None before any ``pin_epoch``)."""
        return self._epoch

    def _estimate_query(self, qry: Q.PathQuery, split: int, engine: str,
                        impl: str):
        """Memoised per-query PlanEstimate at a concrete (split, impl).

        Safe across refits: the estimate's FEATURES are θ-independent
        structural sums, and every prediction derived from a memo hit is
        recomputed as ``features @ live θ`` — only the stale ``t_ms`` on
        the cached object must not be read directly."""
        key = (Q.query_params(qry).tobytes(), qry.shape_key(), split,
               engine, impl)
        est = self._est_memo.get(key)
        if est is None:
            est = self._planner_for(engine).estimate(qry, split, impl)
            self._est_memo[key] = est
        return est

    def _group_features(self, queries: List[Q.PathQuery], split: int,
                        engine: str, impl: str, pt):
        """(batch-summed feature row, per-query estimates) for one dispatch
        — the same sums ``Planner.estimate_batch`` produces (identical
        np.sum reduction, so telemetry rows are bit-identical to the
        un-memoised path)."""
        ests = [self._estimate_query(q, split, engine, impl)
                for q in queries]
        feats = np.sum([e.features for e in ests], axis=0)
        if pt.n_pad:
            # padded rows run too: they repeat instance 0's parameters
            feats = feats + pt.n_pad * ests[0].features
        return feats, ests

    def _record_telemetry(self, feats: np.ndarray, engine: str,
                          dt: float) -> float:
        """One (features, predicted, measured) telemetry row per timed
        dispatch; periodic online θ refit updates the live planners (and
        clears the plan cache once, so stale split choices re-plan against
        the new coefficients)."""
        planner = self._planner_for(engine)
        predicted_ms = float(feats @ coeff_vector(planner.coeffs))
        self.telemetry.record(feats, predicted_ms, dt * 1e3)
        if self.telemetry.should_refit():
            new = self.telemetry.refit(planner.coeffs)
            self._planner.coeffs.update(new)
            if self._planner_part is not None:
                self._planner_part.coeffs.update(new)
            self.plan_cache.clear()
            if self.metrics is not None:
                self._mx_refit.inc()
                self._mx_cache.inc(cache="plan", event="invalidation")
        return predicted_ms

    def _trace_group(self, queue, idxs, ests, feats, split, engine, impl,
                     pt, dt, plan_cached, exec_cached, candidates, seq,
                     edf_pos, group_deadline, predicted_ms, out):
        """Emit one dispatched group's span set: for EVERY member query a
        plan → compile → dispatch → superstep (per hop) → exchange chain
        under its root, so each query's tree is complete on its own.
        Group-shared quantities (the telemetry row: batch-summed features,
        group predicted/measured ms) repeat on each member's dispatch span
        keyed by ``seq``.  Measured group time is apportioned to members
        (and to hops within a member) by predicted fractions."""
        tr = self.tracer
        theta = coeff_vector(self._planner_for(engine).coeffs)
        group_pred = (predicted_ms if self.telemetry is not None
                      else float(feats @ theta))
        cand_attrs = None
        if candidates is not None:
            cand_attrs = [dict(split=c["split"], impl=c["impl"],
                               t_ms=float(c["t_ms"]),
                               features=np.asarray(c["features"]).tolist())
                          for c in candidates]
        q_preds = [float(e.features @ theta) for e in ests]
        pred_sum = sum(q_preds)
        group_ms = dt * 1e3
        key_repr = repr((engine, impl, split, pt.params.shape[0]))
        for j, i in enumerate(idxs):
            root = queue[i].span
            est = ests[j]
            plan_span = tr.start("plan", parent=root, seq=seq, split=split,
                                 impl=impl, engine=engine,
                                 plan_cached=plan_cached,
                                 predicted_ms=q_preds[j],
                                 features=est.features)
            if cand_attrs is not None and j == 0:
                # the candidate sweep is one decision per GROUP — record it
                # once, on the first member's plan span; repeating the full
                # sweep on all members multiplies record volume ~batch-fold
                tr.annotate(plan_span, candidates=cand_attrs)
            tr.end(plan_span)
            comp = tr.start("compile", parent=root, seq=seq,
                            cache="hit" if exec_cached else "miss",
                            key=key_repr)
            tr.end(comp)
            share = (q_preds[j] / pred_sum if pred_sum > 0
                     else 1.0 / len(idxs))
            q_meas = group_ms * share
            disp = tr.start(
                "dispatch", parent=root, seq=seq, batch=pt.n_real,
                n_pad=pt.n_pad, edf_pos=edf_pos, engine=engine, impl=impl,
                split=split,
                deadline=(None if math.isinf(group_deadline)
                          else group_deadline),
                predicted_ms=q_preds[j], measured_ms=q_meas,
                features=est.features, group_features=feats,
                group_predicted_ms=group_pred, group_measured_ms=group_ms)
            hop_steps = [s for s in est.steps if s.channels is not None]
            hop_preds = [float(s.features @ theta) for s in hop_steps]
            hp_sum = sum(hop_preds)
            for h, s in enumerate(hop_steps):
                hshare = (hop_preds[h] / hp_sum if hp_sum > 0
                          else 1.0 / len(hop_steps))
                ss = tr.start("superstep", parent=disp, hop=h, etr=s.etr,
                              predicted_ms=hop_preds[h],
                              measured_ms=q_meas * hshare)
                ex = tr.start("exchange", parent=ss, hop=h,
                              state=s.channels[0],
                              extremum=s.channels[1], etr=s.channels[2])
                tr.end(ex)
                tr.end(ss)
            tr.end(disp)
            r = out[i]
            tr.end(root, status="done", ok=r.ok, count=r.count,
                   latency_ms=r.latency_ms)

    def flush(self, warm: bool = False) -> List[ServedResult]:
        """Drain the queue: one batched engine call per (bucket, mode,
        engine, impl-override) group chunk, dispatched EARLIEST-DEADLINE-
        FIRST (no-deadline entries all tie at +inf, so the historical
        arrival order is preserved); results return in submission order.
        ``warm=True`` runs each new executable once untimed first (first-
        call costs excluded from latency, as the paper excludes load
        time)."""
        queue, self._queue = self._queue, []
        if self.admission is not None:
            self.admission.on_flush()
        if self.metrics is not None:
            self._mx_queue.set(0)
        if not queue:
            self.last_dispatches = []
            return []
        groups: Dict[tuple, List[int]] = {}
        for i, entry in enumerate(queue):
            qry = entry.inst.qry
            key = (bucket_key(qry), self._mode_for(qry),
                   entry.engine or self._engine_for(qry), entry.impl)
            groups.setdefault(key, []).append(i)

        # EDF at dispatch-chunk granularity: each group's members sort by
        # deadline, split into bounded chunks when any member carries an
        # admission batch cap, and every chunk competes in one global
        # earliest-deadline order (seq breaks ties by arrival).
        units: List[tuple] = []
        seq = 0
        for key, idxs in groups.items():
            idxs = sorted(idxs, key=lambda i: (queue[i].deadline, i))
            caps = [queue[i].max_batch for i in idxs
                    if queue[i].max_batch is not None]
            cap = min(caps) if caps else len(idxs)
            for k in range(0, len(idxs), cap):
                chunk = idxs[k:k + cap]
                units.append((min(queue[i].deadline for i in chunk), seq,
                              key, chunk))
                seq += 1
        units.sort(key=lambda u: (u[0], u[1]))

        out: List[Optional[ServedResult]] = [None] * len(queue)
        dispatches: List[GroupDispatch] = []
        traced_groups: List[tuple] = []
        self._flush_count += 1
        # the retry state machine runs on the flush's VIRTUAL now: arrival
        # frame (what submit's ``now`` used) + accounted service so far —
        # deadline-aware retry budgets compare in the deadline's own frame
        flush_now = max((e.arrival for e in queue), default=0.0)
        retry_rng = self.retry.rng() if self.retry is not None else None
        for edf_pos, (group_deadline, _, key, idxs) in enumerate(units):
            self._serve_unit(queue, out, key, list(idxs), warm, edf_pos,
                             group_deadline, dispatches, traced_groups,
                             flush_now, retry_rng)
        for grp in traced_groups:
            self._trace_group(queue, *grp, out)
        self.last_dispatches = dispatches
        self.n_dispatched += len(queue)
        return out  # type: ignore[return-value]

    # ------------------------------------------------------- fault handling
    def _mark_unit(self, queue, out, idxs, engine: str, err,
                   status: str) -> None:
        """Terminal non-answer for every member of a unit: a structured
        per-query error (never an unhandled exception — the completion
        contract is answer-or-structured-reject)."""
        msg = str(err)
        for i in idxs:
            out[i] = ServedResult(
                template=queue[i].inst.template, engine=engine,
                split=-1, count=-1.0, latency_ms=0.0, ok=False,
                batch_size=len(idxs), error=msg,
                deadline=queue[i].deadline, status=status)
            self.tracer.end(queue[i].span, status=status, error=msg)

    def _trace_fault(self, e, action: str, attempt: int, idxs) -> None:
        """One flight-recorder span per fault-handling decision."""
        tr = self.tracer
        if not tr.enabled:
            return
        sp = tr.start("fault", point=getattr(type(e), "point", "fault"),
                      action=action, attempt=attempt, unit_size=len(idxs),
                      error=str(e))
        tr.end(sp)

    def _count_fallback(self, reason: str) -> None:
        self.n_fallbacks += 1
        if self.metrics is not None:
            self._mx_degraded_disp.inc(reason=reason)

    def _bisect(self, queue, out, key, idxs, warm, edf_pos, dispatches,
                traced_groups, flush_now, retry_rng, depth) -> None:
        """Split a repeatedly-failing unit in half and serve each half
        independently — recursion isolates a deterministic poison query
        down to a singleton, which quarantine then rejects while every
        other member still answers."""
        mid = len(idxs) // 2
        for half in (idxs[:mid], idxs[mid:]):
            gd = min(queue[i].deadline for i in half)
            self._serve_unit(queue, out, key, half, warm, edf_pos, gd,
                             dispatches, traced_groups, flush_now,
                             retry_rng, depth + 1)

    def _serve_unit(self, queue, out, key, idxs, warm, edf_pos,
                    group_deadline, dispatches, traced_groups, flush_now,
                    retry_rng, depth: int = 0) -> None:
        """Serve one EDF dispatch unit through the retry/quarantine state
        machine (the historical one-attempt behaviour when no ``retry``
        policy is attached)."""
        bucket, mode, engine, impl_over = key
        fallback_from = ""
        # partitioned-path availability: while the planner holds the path
        # down, units re-plan onto the dense executor (the same answers);
        # once the probe window elapses the next unit probes the
        # partitioned path for real
        if (engine == "partitioned" and self.retry is not None
                and not self._planner.engine_available("partitioned")
                and self._flush_count < self._part_down_until):
            fallback_from, engine = engine, "dense"
            self._count_fallback("path-down")
        insts = [queue[i].inst for i in idxs]
        queries = [x.qry for x in insts]
        self._last_used_delta = False
        penalty_s = 0.0
        n_retries = 0
        attempt = 0
        failures = 0
        readmitted = False
        while True:
            try:
                split, impl, plan_cached, candidates = self._plan_group(
                    queries, bucket, mode, engine, impl_override=impl_over)
                pt = compile_plan_tensor(queries, pad=self.pad_batches)
                res, dt_raw, exec_cached, event_ms = self._dispatch(
                    queries, split, mode, engine, impl, bucket, pt, warm)
                break
            except FaultError as e:
                if self.retry is None:
                    self._mark_unit(queue, out, idxs, engine, e, "failed")
                    return
                if isinstance(e, WorkerLostError) and engine == "partitioned":
                    # worker-loss degradation: mark the path down, re-plan
                    # this unit dense (the same answers, conformance-pinned)
                    self._planner.mark_unavailable("partitioned")
                    self._part_down_until = (self._flush_count
                                             + self.retry.probe_after)
                    fallback_from, engine = engine, "dense"
                    self._count_fallback("worker-loss")
                    self._trace_fault(e, "fallback", attempt, idxs)
                    continue
                failures += 1
                if (failures >= self.retry.max_group_failures
                        and len(idxs) > 1):
                    self._trace_fault(e, "bisect", attempt, idxs)
                    self._bisect(queue, out, key, idxs, warm, edf_pos,
                                 dispatches, traced_groups, flush_now,
                                 retry_rng, depth)
                    return
                if attempt + 1 >= self.retry.max_attempts:
                    if len(idxs) > 1:
                        self._trace_fault(e, "bisect", attempt, idxs)
                        self._bisect(queue, out, key, idxs, warm, edf_pos,
                                     dispatches, traced_groups, flush_now,
                                     retry_rng, depth)
                        return
                    self.n_quarantined += 1
                    if self.metrics is not None:
                        self._mx_quarantined.inc()
                    self._trace_fault(e, "quarantine", attempt, idxs)
                    self._mark_unit(
                        queue, out, idxs, engine,
                        f"quarantined after {attempt + 1} attempts: {e}",
                        "quarantined")
                    return
                delay = backoff_delay(
                    attempt, self.retry.base_delay_s, self.retry.multiplier,
                    self.retry.max_delay_s, self.retry.jitter_frac,
                    retry_rng)
                t_now = (flush_now + sum(d.service_s for d in dispatches)
                         + penalty_s)
                if t_now + delay > group_deadline:
                    # retry budget exhausted: a retry never fires past the
                    # EDF deadline — re-enter admission once with the
                    # remaining budget (an admit earns one immediate,
                    # possibly impl-degraded, attempt), else time out
                    if not readmitted and self.admission is not None:
                        i0 = min(idxs, key=lambda i: queue[i].deadline)
                        dec = self.admission.decide(
                            self, queue[i0].inst, t_now,
                            max(group_deadline - t_now, 0.0))
                        if dec.admitted:
                            readmitted = True
                            if dec.impl is not None:
                                impl_over = dec.impl
                            attempt += 1
                            self._trace_fault(e, "readmit", attempt, idxs)
                            continue
                    self.n_timeout += len(idxs)
                    self._trace_fault(e, "timeout", attempt, idxs)
                    self._mark_unit(
                        queue, out, idxs, engine,
                        f"timed out: retry at +{delay:.3f}s would pass the "
                        f"deadline: {e}", "timeout")
                    return
                penalty_s += delay
                n_retries += 1
                self.n_retries += 1
                if self.metrics is not None:
                    self._mx_retries.inc(kind=getattr(type(e), "point",
                                                      "fault"))
                self._trace_fault(e, "retry", attempt, idxs)
                attempt += 1
            except Exception as e:
                # a failing group (e.g. a non-sliceable query forced onto the
                # sliced engine) must not take the rest of the flush with it
                self._mark_unit(queue, out, idxs, engine, e, "failed")
                return
        if (engine == "partitioned"
                and not self._planner.engine_available("partitioned")):
            self._planner.mark_available("partitioned")  # probe succeeded
        seq = self._dispatch_seq
        self._dispatch_seq += 1
        feats = ests = None
        if self.telemetry is not None or self.tracer.enabled:
            feats, ests = self._group_features(queries, split, engine,
                                               impl, pt)
        predicted_ms = 0.0
        if self.telemetry is not None:
            # θ refit sees the RAW dispatch time: retry backoff is queueing
            # penalty, not service cost, and must not skew the cost model
            predicted_ms = self._record_telemetry(feats, engine, dt_raw)
        if self.metrics is not None:
            self._mx_dispatch_ms.observe(dt_raw * 1e3)
            self._mx_dispatched.inc(pt.n_real)
            self._mx_cache.inc(cache="plan",
                               event="hit" if plan_cached else "miss")
            self._mx_cache.inc(cache="executable",
                               event="hit" if exec_cached else "miss")
        # latency the CLIENT sees includes accounted retry backoff
        dt_total = dt_raw + penalty_s
        per_query_ms = dt_total * 1e3 / pt.n_real
        ok = per_query_ms <= self.budget_s * 1e3

        total = _host(res.total)
        keep = self.keep_outputs
        pv = (_host(res.per_vertex) if keep and res.per_vertex is not None
              else None)
        mm = _host(res.minmax) if keep and res.minmax is not None else None
        for j, i in enumerate(idxs):
            t_j = total[j]
            out[i] = ServedResult(
                template=insts[j].template, engine=engine, split=split,
                count=float(t_j.sum()) if t_j.ndim else float(t_j),
                latency_ms=per_query_ms, ok=ok, batch_size=pt.n_real,
                total=t_j if keep else None,
                per_vertex=None if pv is None else pv[j],
                minmax=None if mm is None else mm[j],
                deadline=queue[i].deadline,
            )
        if self.tracer.enabled:
            # span construction is DEFERRED to after the dispatch loop, so
            # building record dicts never sits between two timed calls
            traced_groups.append(
                (idxs, ests, feats, split, engine, impl, pt, dt_raw,
                 plan_cached, exec_cached, candidates, seq, edf_pos,
                 group_deadline, predicted_ms))
        dispatches.append(GroupDispatch(
            key, engine, split, pt.n_real, pt.n_pad, dt_total, list(idxs),
            plan_cached, exec_cached, impl, group_deadline, predicted_ms,
            n_retries=n_retries, penalty_s=penalty_s, event_ms=event_ms,
            fallback_from=fallback_from, delta=self._last_used_delta))

    def run(self, workload: Sequence[Union[QueryInstance, Q.PathQuery]],
            warm: bool = False) -> List[ServedResult]:
        """Submit a whole workload and drain it in one flush."""
        for inst in workload:
            self.submit(inst)
        return self.flush(warm=warm)

    # ------------------------------------------------------------- reporting
    def cache_report(self) -> dict:
        return dict(
            plan=self.plan_cache.stats.as_dict(),
            executable=self.exec_cache.stats.as_dict(),
            n_plans=len(self.plan_cache),
            n_executables=len(self.exec_cache),
        )

    def slo_report(self) -> dict:
        """Admission + telemetry counters (all zero without an SLO layer)."""
        d = dict(n_rejected=self.n_rejected, n_degraded=self.n_degraded)
        if self.admission is not None:
            d["admission"] = self.admission.report()
        if self.telemetry is not None:
            d["telemetry"] = self.telemetry.error_stats()
        return d

    def fault_report(self) -> dict:
        """Retry/quarantine/degradation counters (all zero without a fault
        layer) plus the fault plan's consultation ledger."""
        d = dict(n_retries=self.n_retries, n_quarantined=self.n_quarantined,
                 n_timeout=self.n_timeout, n_fallbacks=self.n_fallbacks,
                 partitioned_available=self._planner.engine_available(
                     "partitioned"))
        if self.fault_plan is not None:
            d["fault_plan"] = self.fault_plan.report()
        return d
