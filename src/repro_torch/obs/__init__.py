"""Observability: the query flight recorder, metrics registry, and
cost-model audit pipeline.

  trace.py    hierarchical spans (query → admit → plan → compile → dispatch
              → superstep → exchange) with explicit parent handles and an
              injected clock; in-memory ring + optional JSONL sink; the
              NULL_TRACER default keeps the disabled path a no-op
  metrics.py  counter/gauge/histogram registry with fixed log-spaced latency
              buckets, Prometheus text exposition and JSON snapshot
  audit.py    predicted-vs-measured joins recomputed from trace data alone:
              telemetry replay, θ refit drift, and the paper's "% of queries
              within X% of the optimal plan" metric

Copies of the reference package's ``obs/`` modules (no framework code).  The
serving runtime (serving/scheduler.py, serving/replay.py, serving/epochs.py)
and the partitioned executor's profiler emit into these; ``launch/query.py
--trace-out/--metrics-out`` and ``scripts/torch_trace_report.py`` are the
operator surface.
"""
from . import audit  # noqa: F401
from .metrics import (DEFAULT_LATENCY_BUCKETS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (NULL_TRACER, NullTracer, Span, StepClock, Tracer,
                    load_jsonl, span_trees)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "StepClock",
    "load_jsonl", "span_trees", "audit",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_LATENCY_BUCKETS_MS",
]
