"""Workload-serving runtime — the subsystem that turns the engine stack into
a query *service* (heavy traffic, amortised traversals).

Layout:

  compile.py    plan-tensor compiler: same-shape instances → one padded
                parameter tensor per shape bucket (pow-2 size buckets bound
                the executables per bucket)
  cache.py      plan cache (shape bucket × graph fingerprint → split) and
                executable cache — steady-state serving neither re-plans
                nor rebuilds
  scheduler.py  admission queue + batch scheduler: groups by (shape bucket,
                mode, engine), plans each group with the batch-aware cost
                model, dispatches ONE batched engine call per group
                (aggregates included — no per-query fallback)
  replay.py     open-loop Poisson + closed-loop bounded-outstanding replay
                of the LDBC workload through the scheduler; p50/p95/p99
                latency, throughput, completion-rate, deadline-hit rate,
                goodput (the paper's Table 5 serving metrics, plus SLO
                accounting)
  admission.py  deadline admission control: cost-model-predicted wait +
                service vs deadline → admit / degrade (cheaper impl,
                dense→sliced, bounded dispatch quantum) / reject
  telemetry.py  (predicted, measured) dispatch-cost ring buffer + periodic
                online θ refit — prediction error shrinks during serving
  faults.py     deterministic chaos injection (FaultPlan: seeded rates /
                explicit schedules at named points in the dispatch path) +
                RetryPolicy (backoff retries accounted on the virtual clock,
                deadline-aware budgets, bisection quarantine)
  testing.py    FakeDispatcher: synthetic service times on a virtual clock,
                no engine call — the deterministic harness the SLO layer is
                tested on
  epochs.py     live graphs: EpochManager streams events into the
                append-only log (graphdata/ingest.py), seals immutable
                epochs, decides compaction, evicts retired fingerprints and
                pins the scheduler (``BatchScheduler.pin_epoch``); recovers
                from the log's WAL

The port of the reference package's ``serving/``.
"""
from .admission import (AdmissionController, AdmissionDecision,
                        AdmissionPolicy)
from .cache import (ExecutableCache, PlanCache, graph_fingerprint,
                    layout_signature)
from .compile import PlanTensor, bucket_key, compile_plan_tensor
from .epochs import Epoch, EpochManager
from .faults import (CompileError, FaultError, FaultPlan, PoisonQueryError,
                     RetryPolicy, TornWriteError, TransientDispatchError,
                     WorkerLostError)
from .replay import ReplayReport, replay_workload
from .scheduler import BatchScheduler, GroupDispatch, ServedResult
from .telemetry import TelemetryBuffer
from .testing import FakeDispatcher

__all__ = [
    "BatchScheduler", "ServedResult", "GroupDispatch", "PlanCache",
    "ExecutableCache", "graph_fingerprint", "layout_signature", "PlanTensor",
    "bucket_key", "compile_plan_tensor", "ReplayReport", "replay_workload",
    "AdmissionController", "AdmissionDecision", "AdmissionPolicy",
    "TelemetryBuffer", "FakeDispatcher",
    "FaultPlan", "RetryPolicy", "FaultError", "TransientDispatchError",
    "CompileError", "WorkerLostError", "TornWriteError", "PoisonQueryError",
    "Epoch", "EpochManager",
]
