"""Query flight recorder: hierarchical trace spans with explicit parents.

The port's copy of the reference package's ``obs/trace.py`` (no framework
code).

Every query the serving runtime touches leaves one span TREE:

    query                       root: template, shape, deadline, final status
    ├─ admit                    verdict (admit/degrade/reject), ladder rungs
    └─ dispatch-side children, one set per member of the dispatched group:
       ├─ plan                  split, impl, plan-cache hit, predicted
       │                        features·θ (the cost model's commitment)
       ├─ compile               executable-cache hit/miss + dispatch key
       └─ dispatch              group seq, batch size, EDF position,
          │                     predicted vs measured ms (query and group)
          └─ superstep (×hop)   per-hop predicted/measured share
             └─ exchange        per-channel structural boundary volumes
                                (state / extremum / etr — the same rule as
                                engine_partitioned.query_exchange_volumes)

Design constraints, in order:

  determinism   the clock is INJECTED (``Tracer(clock=...)``) and span ids
                are a plain counter, so under the FakeDispatcher virtual
                clock (serving/testing.py) plus a ``StepClock`` the exact
                span tree — ids, parents, timestamps, attrs — is a pinnable
                test vector, not a flaky wall-clock artifact;
  zero-cost off the default is the module-level ``NULL_TRACER`` whose every
                operation is a constant no-op attribute lookup;
  append-only   completed spans go to a bounded in-memory ring (newest kept)
                and, when a ``sink`` path is given, one JSON line each —
                floats serialise via repr round-trip, so an offline audit
                recomputes EXACTLY what the live telemetry saw.
"""
from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np


def _json_default(o):
    """Numpy-to-JSON bridge: scalars to Python numbers, arrays to lists."""
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON serialisable: {type(o).__name__}")


def _clean(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Normalise attr values to JSON-native types at record time, so the
    ring and the JSONL sink hold the SAME values (ndarray → list, numpy
    scalar → Python scalar) and audit-from-ring == audit-from-file."""
    out = {}
    for k, v in attrs.items():
        if isinstance(v, np.ndarray):
            out[k] = v.tolist()
        elif isinstance(v, np.integer):
            out[k] = int(v)
        elif isinstance(v, np.floating):
            out[k] = float(v)
        elif isinstance(v, np.bool_):
            out[k] = bool(v)
        else:
            out[k] = v
    return out


@dataclasses.dataclass
class Span:
    """One node of a trace tree.  Mutable until ``Tracer.end`` seals it."""
    name: str
    span_id: int
    parent_id: Optional[int]
    trace_id: int
    t_start: float
    t_end: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def as_record(self) -> dict:
        return dict(name=self.name, span_id=self.span_id,
                    parent_id=self.parent_id, trace_id=self.trace_id,
                    t_start=self.t_start, t_end=self.t_end, attrs=self.attrs)


class _NullSpan:
    """The no-op span handed out by NullTracer: accepts everything."""
    __slots__ = ()
    name = ""
    span_id = -1
    parent_id = None
    trace_id = -1
    attrs: Dict[str, Any] = {}


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled-path tracer: every call is a constant-time no-op.

    ``enabled`` is False so instrumentation sites can skip building attr
    payloads entirely (``if tracer.enabled: ...``) — the overhead the bench
    gate pins is the residual start/end call cost when a site does not
    guard."""
    enabled = False

    def start(self, name: str, parent=None, **attrs) -> _NullSpan:
        return _NULL_SPAN

    def end(self, span, **attrs) -> None:
        return None

    def annotate(self, span, **attrs) -> None:
        return None

    def records(self) -> List[dict]:
        return []

    def export_jsonl(self, path: str) -> int:
        return 0

    def close(self) -> None:
        return None


#: the module-level default: share one instance so the disabled check is an
#: attribute lookup on a singleton, never an allocation
NULL_TRACER = NullTracer()


class Tracer:
    """Recording tracer: explicit-parent spans → ring buffer (+ JSONL sink).

    ``clock`` is any zero-arg callable returning seconds; tests inject a
    ``StepClock`` so t_start/t_end are exact.  ``sink`` (a path) appends one
    JSON line per COMPLETED span, in completion order — a crashed run keeps
    every span that finished.
    """
    enabled = True

    def __init__(self, clock=time.perf_counter, capacity: int = 65536,
                 sink: Optional[str] = None):
        self._clock = clock
        self._ring: Deque[dict] = deque(maxlen=capacity)
        self._next_id = 0
        self._sink_path = sink
        self._sink = open(sink, "w") if sink else None
        self.n_started = 0
        self.n_completed = 0

    # ---------------------------------------------------------------- spans
    def start(self, name: str, parent=None, **attrs) -> Span:
        sid = self._next_id
        self._next_id += 1
        if parent is None or parent is _NULL_SPAN:
            parent_id, trace_id = None, sid
        else:
            parent_id, trace_id = parent.span_id, parent.trace_id
        self.n_started += 1
        return Span(name, sid, parent_id, trace_id, self._clock(),
                    attrs=_clean(attrs))

    def annotate(self, span, **attrs) -> None:
        if span is _NULL_SPAN:
            return
        span.attrs.update(_clean(attrs))

    def end(self, span, **attrs) -> None:
        if span is _NULL_SPAN or not isinstance(span, Span):
            return
        if attrs:
            span.attrs.update(_clean(attrs))
        span.t_end = self._clock()
        rec = span.as_record()
        self._ring.append(rec)
        self.n_completed += 1
        if self._sink is not None:
            self._sink.write(json.dumps(rec, default=_json_default) + "\n")

    # ------------------------------------------------------------- querying
    def records(self) -> List[dict]:
        """Completed spans (completion order), newest ``capacity`` kept."""
        return list(self._ring)

    def export_jsonl(self, path: str) -> int:
        """Write the ring to ``path`` (one span per line); returns count."""
        recs = self.records()
        with open(path, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, default=_json_default) + "\n")
        return len(recs)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.flush()
            self._sink.close()
            self._sink = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StepClock:
    """Deterministic clock for span tests: each call returns start, then
    advances by ``step`` — two consecutive reads differ by exactly one step,
    so measured-duration assertions are equalities, not tolerances."""

    def __init__(self, start: float = 0.0, step: float = 1.0):
        self.t = float(start)
        self.step = float(step)

    def __call__(self) -> float:
        t, self.t = self.t, self.t + self.step
        return t


# ---------------------------------------------------------------- tree utils
def load_jsonl(path: str) -> List[dict]:
    """Read a trace JSONL sink back into span records."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def span_trees(records: List[dict]) -> Dict[int, dict]:
    """Group span records into trees: trace_id → root record, with a
    ``children`` list (start order) attached to every record."""
    by_id: Dict[int, dict] = {}
    for rec in records:
        rec = dict(rec)
        rec["children"] = []
        by_id[rec["span_id"]] = rec
    roots: Dict[int, dict] = {}
    for rec in by_id.values():
        pid = rec["parent_id"]
        if pid is not None and pid in by_id:
            by_id[pid]["children"].append(rec)
        else:
            roots[rec["trace_id"]] = rec
    for rec in by_id.values():
        rec["children"].sort(key=lambda r: r["span_id"])
    return roots
