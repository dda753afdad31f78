"""Observability: the query flight recorder and the metrics registry.

  trace.py    hierarchical spans (query → admit → plan → compile → dispatch
              → superstep → exchange) with explicit parent handles and an
              injected clock; in-memory ring + optional JSONL sink; the
              NULL_TRACER default keeps the disabled path a no-op
  metrics.py  counter/gauge/histogram registry with fixed log-spaced latency
              buckets, Prometheus text exposition and JSON snapshot

Copies of the reference package's ``obs/`` modules (no framework code).  The
serving runtime (serving/scheduler.py, serving/replay.py) emits into these;
``launch/query.py --trace-out/--metrics-out`` is the operator surface.  The
reference's cost-model audit (``obs/audit.py``) is not ported yet.
"""
from .metrics import (DEFAULT_LATENCY_BUCKETS_MS, Counter, Gauge, Histogram,
                      MetricsRegistry)
from .trace import (NULL_TRACER, NullTracer, Span, StepClock, Tracer,
                    load_jsonl, span_trees)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "StepClock",
    "load_jsonl", "span_trees",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "DEFAULT_LATENCY_BUCKETS_MS",
]
