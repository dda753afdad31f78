"""Cost-model audit: predicted-vs-measured joins computed from trace data
alone.

The serving telemetry (serving/telemetry.py) already records one
(features, predicted_ms, measured_ms) row per timed group dispatch and
refits θ online.  This module recomputes the SAME quantities offline from a
flight-recorder trace — a JSONL file, a live ``Tracer``'s ring, or a plain
record list — with no access to the scheduler that produced it:

  replay_telemetry   rebuild the telemetry buffer from the trace's dispatch
                     spans (deduped by dispatch ``seq`` — member spans of
                     one group share the group row); its ``error_stats``
                     reproduce the live buffer's EXACTLY, float for float
                     (the tracer serialises via repr round-trip);
  refit_from_trace   run the production ``TelemetryBuffer.refit`` over the
                     replayed rows — the drift signal: what θ the online
                     machinery would converge to given this trace;
  coefficient_drift  per-coefficient incumbent-vs-trace-refit delta;
  plan_accuracy      the paper's §VI metric — "% of queries whose chosen
                     plan is within X% of the optimal plan" — scored by
                     re-costing every candidate the planner swept (recorded
                     on the plan span) under the trace-refit θ̂;
  audit_report       all of the above in one dict
                     (scripts/torch_trace_report.py --audit renders it).

Import discipline: ``TelemetryBuffer`` (and with it the planner stack) is
imported inside functions, so ``obs`` stays importable without the serving
layer and the serving layer can import ``obs.trace`` freely.

The port's copy of the reference package's ``obs/audit.py``: the same
joins over the port's telemetry buffer and planner coefficients (whose
per-impl columns are ``theta_scatter_torch`` / ``theta_scatter_cuda``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .trace import Tracer, load_jsonl, span_trees

TraceLike = Union[str, Tracer, Sequence[dict]]


def load_trace(source: TraceLike) -> List[dict]:
    """Normalise a trace source to a span-record list: a JSONL path, a live
    Tracer (its ring), or an already-loaded record sequence."""
    if isinstance(source, str):
        return load_jsonl(source)
    if isinstance(source, Tracer):
        return source.records()
    return list(source)


def spans_named(trace: TraceLike, name: str) -> List[dict]:
    return [r for r in load_trace(trace) if r["name"] == name]


def dispatch_records(trace: TraceLike) -> List[dict]:
    """One record per GROUP dispatch, in dispatch order.

    Every member query of a group carries its own dispatch span with the
    shared group attrs (seq, group_features, group_predicted_ms,
    group_measured_ms); the group row appears once here, keyed by ``seq`` —
    exactly the row the live TelemetryBuffer recorded.
    """
    by_seq: Dict[int, dict] = {}
    for rec in spans_named(trace, "dispatch"):
        a = rec["attrs"]
        if "seq" in a and a["seq"] not in by_seq:
            by_seq[a["seq"]] = a
    return [by_seq[s] for s in sorted(by_seq)]


def replay_telemetry(trace: TraceLike, **buffer_kw):
    """Rebuild a TelemetryBuffer from the trace's group dispatch rows.

    Defaults to a pure recorder (``refit=False``): replaying must not
    re-refit, because the recorded predictions already embed whatever θ was
    live when each dispatch ran.  The returned buffer's ``error_stats``
    match the live scheduler's float for float.
    """
    from ..serving.telemetry import TelemetryBuffer
    buffer_kw.setdefault("refit", False)
    tb = TelemetryBuffer(**buffer_kw)
    for a in dispatch_records(trace):
        tb.record(np.asarray(a["group_features"], float),
                  float(a["group_predicted_ms"]),
                  float(a["group_measured_ms"]))
    return tb


def error_report(trace: TraceLike, tail: Optional[int] = None) -> dict:
    """The live telemetry's prediction-error stats, recomputed from trace."""
    return replay_telemetry(trace).error_stats(tail=tail)


def refit_from_trace(trace: TraceLike, coeffs: Optional[dict] = None,
                     blend: float = 1.0) -> dict:
    """θ̂ the production refit converges to on this trace (the drift signal).

    ``coeffs`` is the incumbent θ to blend against (package defaults when
    omitted); ``blend=1.0`` jumps straight to the trace's least-squares
    solution — the audit wants the trace's own verdict, not a smoothed one.
    """
    from ..core.planner import load_coeffs
    rows = dispatch_records(trace)
    incumbent = dict(coeffs) if coeffs is not None else load_coeffs()
    if len(rows) < 2:
        return incumbent
    tb = replay_telemetry(trace, capacity=max(len(rows), 2),
                          min_samples=2, blend=blend)
    return tb.refit(incumbent)


def coefficient_drift(trace: TraceLike,
                      coeffs: Optional[dict] = None) -> dict:
    """Per-coefficient drift: incumbent θ vs the trace-refit θ̂.

    ``rel`` is |θ̂-θ|/max(|θ|, ε) — large values on a column say the live
    model's slope for that term no longer matches measured dispatch times
    (the signal that should trigger — or explain — an online refit).
    """
    from ..core.planner import COEFF_KEYS, load_coeffs
    incumbent = dict(coeffs) if coeffs is not None else load_coeffs()
    fitted = refit_from_trace(trace, incumbent)
    out = {}
    for k in COEFF_KEYS:
        old = float(incumbent.get(k, 0.0))
        new = float(fitted.get(k, old))
        out[k] = dict(incumbent=old, refit=new, abs_delta=abs(new - old),
                      rel=abs(new - old) / max(abs(old), 1e-12))
    return out


def plan_accuracy(trace: TraceLike, within: float = 0.10,
                  coeffs: Optional[dict] = None) -> dict:
    """The paper's plan-quality metric from trace data alone.

    The candidate sweep the batch planner ran (split × impl, with each
    candidate's feature row) is one decision per dispatched GROUP — the
    scheduler records it once, on the first member's plan span, and every
    member's plan span carries the group ``seq``.  Re-costing those
    candidates under the trace-refit θ̂ — the best post-hoc estimate of true
    cost — scores the planner the way the paper's §VI does: the fraction of
    planning decisions whose chosen plan costs at most (1+within)× the
    optimal candidate, weighted per QUERY (each decision counts once per
    group member), matching "% of queries".
    """
    from ..core.planner import coeff_vector
    theta = coeff_vector(refit_from_trace(trace, coeffs))
    # re-join the group decision to its members by seq
    groups: dict = {}
    for rec in spans_named(trace, "plan"):
        a = rec["attrs"]
        if a.get("seq") is None:
            continue
        grp = groups.setdefault(
            a["seq"], dict(cands=None, chosen=(a["split"], a["impl"]), n=0))
        grp["n"] += 1
        if a.get("candidates"):
            grp["cands"] = a["candidates"]
    n_q = n_within = n_decisions = 0
    ratios = []
    for grp in groups.values():
        cands = grp["cands"]
        if not cands:
            continue
        n_decisions += 1
        costs = {(c["split"], c["impl"]):
                 float(np.asarray(c["features"], float) @ theta)
                 for c in cands}
        best = min(costs.values())
        chosen = costs.get(grp["chosen"])
        if chosen is None or best <= 0:
            continue
        ratio = chosen / best
        ratios.extend([ratio] * grp["n"])  # weight accuracy per member query
        n_q += grp["n"]
        if ratio <= 1.0 + within:
            n_within += grp["n"]
    return dict(
        n_queries=n_q,
        n_decisions=n_decisions,
        within=within,
        frac_within=(n_within / n_q) if n_q else 1.0,
        mean_ratio=float(np.mean(ratios)) if ratios else 1.0,
        worst_ratio=float(np.max(ratios)) if ratios else 1.0,
    )


def audit_report(trace: TraceLike, within: float = 0.10,
                 tail: Optional[int] = None,
                 coeffs: Optional[dict] = None) -> dict:
    """The full cost-model audit: error stats, refit drift, plan accuracy."""
    trace = load_trace(trace)
    return dict(
        n_spans=len(trace),
        n_dispatches=len(dispatch_records(trace)),
        error=error_report(trace, tail=tail),
        drift=coefficient_drift(trace, coeffs),
        plan=plan_accuracy(trace, within=within, coeffs=coeffs),
    )


def query_summaries(trace: TraceLike) -> List[dict]:
    """Per-query rollup rows (scripts/torch_trace_report.py's table): one dict per
    root 'query' span with its admit verdict and dispatch timings joined."""
    roots = span_trees(load_trace(trace))
    out = []
    for tid in sorted(roots):
        root = roots[tid]
        row = dict(trace_id=tid,
                   template=root["attrs"].get("template", "?"),
                   status=root["attrs"].get("status", "?"),
                   t_start=root["t_start"], t_end=root["t_end"],
                   verdict=None, rungs=None, predicted_ms=None,
                   measured_ms=None, seq=None)
        stack = list(root["children"])
        while stack:
            rec = stack.pop()
            stack.extend(rec["children"])
            a = rec["attrs"]
            if rec["name"] == "admit":
                row["verdict"] = a.get("verdict")
                row["rungs"] = a.get("rungs")
            elif rec["name"] == "dispatch":
                row["predicted_ms"] = a.get("predicted_ms")
                row["measured_ms"] = a.get("measured_ms")
                row["seq"] = a.get("seq")
        out.append(row)
    return out
