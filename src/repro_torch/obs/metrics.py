"""Serving metrics registry: counters, gauges, log-bucketed histograms.

The port's copy of the reference package's ``obs/metrics.py``.

What the serving stack exposes (names are stable API — the README's span/
metric schema table documents them):

    granite_admission_total{verdict,rung}   admission outcomes by ladder rung
    granite_rejected_total / granite_degraded_total
    granite_queue_depth                     queued entries after each submit
    granite_dispatch_ms                     per-group measured dispatch time
    granite_dispatched_total                real queries dispatched
    granite_cache_total{cache,event}        plan/executable hit/miss/invalidation
    granite_refit_total                     online θ refits applied
    granite_deadline_slack_ms               per-completed-query slack vs its
                                            own deadline (replay harness)
    granite_replay_total{status}            done/failed/rejected per replay
    granite_goodput_qps                     deadline hits per second (gauge)

Exposition is dependency-free in two formats: ``to_prometheus()`` renders
the text format a Prometheus scrape expects (histograms as cumulative
``_bucket{le=...}`` + ``_sum``/``_count``), ``snapshot()`` a plain JSON
dict (what ``launch/query.py --metrics-out`` writes).  Histogram buckets
are FIXED log-spaced latency edges (2^-4 … 2^16 ms) so two runs — or a run
and its committed baseline — are always bucket-comparable.

Everything is deterministic given the observation stream: no timestamps,
no background threads, plain dict state.
"""
from __future__ import annotations

import bisect
import json
from typing import Dict, List, Optional, Sequence, Tuple

#: fixed log-spaced latency bucket upper edges (ms): 62.5 µs … ~65.5 s
DEFAULT_LATENCY_BUCKETS_MS: Tuple[float, ...] = tuple(
    2.0 ** k for k in range(-4, 17))


def _label_key(labelnames: Sequence[str], labels: Dict[str, str]) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"labels {sorted(labels)} != declared {sorted(labelnames)}")
    return tuple(str(labels[n]) for n in labelnames)


def _fmt_labels(labelnames: Sequence[str], key: tuple,
                extra: str = "") -> str:
    parts = [f'{n}="{v}"' for n, v in zip(labelnames, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class Counter:
    """Monotonic counter, optionally labelled."""

    kind = "counter"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._vals: Dict[tuple, float] = {}

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        key = _label_key(self.labelnames, labels)
        self._vals[key] = self._vals.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(self.labelnames, labels), 0.0)

    def collect(self) -> List[Tuple[tuple, float]]:
        return sorted(self._vals.items())


class Gauge:
    """Set-to-current-value metric, optionally labelled."""

    kind = "gauge"

    def __init__(self, name: str, help: str = "",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._vals: Dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        self._vals[_label_key(self.labelnames, labels)] = float(v)

    def inc(self, n: float = 1.0, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        self._vals[key] = self._vals.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._vals.get(_label_key(self.labelnames, labels), 0.0)

    def collect(self) -> List[Tuple[tuple, float]]:
        return sorted(self._vals.items())


class Histogram:
    """Fixed-bucket histogram (cumulative exposition, Prometheus-style)."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                 labelnames: Sequence[str] = ()):
        if list(buckets) != sorted(buckets):
            raise ValueError("bucket edges must be sorted")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(float(b) for b in buckets)
        # per label-key: (per-bucket counts incl. +Inf overflow, sum, count)
        self._series: Dict[tuple, list] = {}

    def observe(self, v: float, **labels) -> None:
        key = _label_key(self.labelnames, labels)
        s = self._series.get(key)
        if s is None:
            s = [[0] * (len(self.buckets) + 1), 0.0, 0]
            self._series[key] = s
        s[0][bisect.bisect_left(self.buckets, float(v))] += 1
        s[1] += float(v)
        s[2] += 1

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(self.labelnames, labels))
        return 0 if s is None else s[2]

    def sum(self, **labels) -> float:
        s = self._series.get(_label_key(self.labelnames, labels))
        return 0.0 if s is None else s[1]

    def collect(self) -> List[Tuple[tuple, list]]:
        return sorted(self._series.items())


class MetricsRegistry:
    """Name → metric, memoised: asking twice returns the SAME object, so
    scattered instrumentation sites share series without plumbing."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, kwargs: dict):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> Counter:
        return self._get(Counter, name,
                         dict(help=help, labelnames=labelnames))

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._get(Gauge, name, dict(help=help, labelnames=labelnames))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_MS,
                  labelnames: Sequence[str] = ()) -> Histogram:
        return self._get(Histogram, name,
                         dict(help=help, buckets=buckets,
                              labelnames=labelnames))

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __getitem__(self, name: str):
        return self._metrics[name]

    # ------------------------------------------------------------ exposition
    def to_prometheus(self) -> str:
        """Prometheus text exposition format (histograms cumulative)."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, Histogram):
                for key, (counts, total, n) in m.collect():
                    cum = 0
                    for edge, c in zip(m.buckets, counts):
                        cum += c
                        lab = _fmt_labels(m.labelnames, key,
                                          extra=f'le="{edge:g}"')
                        lines.append(f"{name}_bucket{lab} {cum}")
                    cum += counts[-1]
                    lab = _fmt_labels(m.labelnames, key, extra='le="+Inf"')
                    lines.append(f"{name}_bucket{lab} {cum}")
                    lab = _fmt_labels(m.labelnames, key)
                    lines.append(f"{name}_sum{lab} {total:g}")
                    lines.append(f"{name}_count{lab} {n}")
            else:
                for key, v in m.collect():
                    lab = _fmt_labels(m.labelnames, key)
                    lines.append(f"{name}{lab} {v:g}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-native dump: metric name → {kind, series} (label tuples
        joined with ',' as keys; '' for the unlabelled series)."""
        out: dict = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                series = {
                    ",".join(k): dict(buckets=list(counts), sum=total,
                                      count=n)
                    for k, (counts, total, n) in m.collect()}
                out[name] = dict(kind=m.kind, labelnames=list(m.labelnames),
                                 bucket_edges_ms=list(m.buckets),
                                 series=series)
            else:
                series = {",".join(k): v for k, v in m.collect()}
                out[name] = dict(kind=m.kind, labelnames=list(m.labelnames),
                                 series=series)
        return out

    def write(self, path: str) -> None:
        """Write the registry to ``path``: JSON when it ends in .json,
        Prometheus text format otherwise."""
        if path.endswith(".json"):
            with open(path, "w") as f:
                json.dump(self.snapshot(), f, indent=2)
        else:
            with open(path, "w") as f:
                f.write(self.to_prometheus())
