#!/usr/bin/env python
"""Render a query flight-recorder trace of the PyTorch port (JSONL from
``python -m repro_torch.launch.query --trace-out`` or ``chip_smoke.py``) as
per-query text waterfalls plus a workload rollup, and optionally the
cost-model audit.

    python scripts/torch_trace_report.py trace.jsonl
    python scripts/torch_trace_report.py trace.jsonl --limit 5 --audit

Waterfall: one indented line per span, with its duration bar positioned
inside the root span's window and its headline attrs.  Rollup: per-template
counts and predicted-vs-measured dispatch error, admission verdicts, hop
exchange volumes per channel, and — when the run was not clean — a failures
section (rejected/quarantined/timed-out queries with their structured
errors, plus injected-fault action counts).  ``--audit`` appends
obs/audit.audit_report
(telemetry replay, coefficient drift, plan-accuracy metric).

The counterpart of ``scripts/trace_report.py`` over the port's ``obs``
package: the same text for the same trace, with the port's coefficient
names.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from collections import Counter, defaultdict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.obs import audit  # noqa: E402
from repro_torch.obs.trace import load_jsonl, span_trees  # noqa: E402

BAR_W = 32

#: headline attrs per span kind (everything else stays in the JSONL)
_HEADLINE = {
    "query": ("template", "status", "latency_ms"),
    "admit": ("verdict", "rungs"),
    "plan": ("split", "impl", "plan_cached", "predicted_ms"),
    "compile": ("cache", "key"),
    "dispatch": ("seq", "batch", "edf_pos", "predicted_ms", "measured_ms"),
    "superstep": ("hop", "etr", "predicted_ms", "measured_ms"),
    "exchange": ("state", "extremum", "etr"),
    "measure_supersteps": ("n_workers", "n_hops", "impl"),
}


def _fmt_val(v):
    if isinstance(v, float):
        return f"{v:.4g}"
    if isinstance(v, list):
        return ",".join(str(x) for x in v) or "-"
    return str(v)


def _bar(t0: float, t1: float, lo: float, span: float) -> str:
    if span <= 0:
        return "[" + "#" * BAR_W + "]"
    a = int((t0 - lo) / span * BAR_W)
    b = max(int((t1 - lo) / span * BAR_W), a + 1)
    a, b = min(a, BAR_W - 1), min(b, BAR_W)
    return "[" + " " * a + "#" * (b - a) + " " * (BAR_W - b) + "]"


def _walk(rec: dict, depth: int, lo: float, span: float, out: list):
    attrs = rec.get("attrs", {})
    heads = _HEADLINE.get(rec["name"], ())
    shown = " ".join(f"{k}={_fmt_val(attrs[k])}" for k in heads
                     if k in attrs and attrs[k] is not None)
    t0, t1 = rec["t_start"], rec.get("t_end") or rec["t_start"]
    out.append(f"  {_bar(t0, t1, lo, span)} {'  ' * depth}"
               f"{rec['name']:<12s} {shown}")
    for child in rec.get("children", []):
        _walk(child, depth + 1, lo, span, out)


def waterfall(root: dict) -> str:
    lo = root["t_start"]
    hi = root.get("t_end") or lo
    stack, recs = [root], []
    while stack:
        rec = stack.pop()
        recs.append(rec)
        stack.extend(rec.get("children", []))
    hi = max([hi] + [r.get("t_end") or lo for r in recs])
    lines = [f"trace {root['trace_id']} "
             f"({root['attrs'].get('template', '?')}, "
             f"{(hi - lo) * 1e3:.3f} ms window)"]
    _walk(root, 0, lo, hi - lo, lines)
    return "\n".join(lines)


def rollup(records: list) -> str:
    lines = ["== workload rollup =="]
    rows = audit.query_summaries(records)
    by_template = defaultdict(list)
    verdicts = Counter()
    for row in rows:
        by_template[row["template"]].append(row)
        if row["verdict"]:
            verdicts[row["verdict"]] += 1
    lines.append(f"queries: {len(rows)}   spans: {len(records)}   "
                 f"group dispatches: {len(audit.dispatch_records(records))}")
    if verdicts:
        lines.append("admission: " + "  ".join(
            f"{k}={v}" for k, v in sorted(verdicts.items())))
    lines.append(f"{'template':<12s} {'n':>4s} {'done':>5s} "
                 f"{'pred ms':>10s} {'meas ms':>10s} {'abs rel err':>12s}")
    for t in sorted(by_template):
        rws = by_template[t]
        done = [r for r in rws if r["status"] == "done"
                and r["predicted_ms"] is not None]
        if done:
            pred = sum(r["predicted_ms"] for r in done) / len(done)
            meas = sum(r["measured_ms"] for r in done) / len(done)
            errs = [abs(r["predicted_ms"] - r["measured_ms"])
                    / max(abs(r["measured_ms"]), 1e-9) for r in done]
            err = sum(errs) / len(errs)
            lines.append(f"{t:<12s} {len(rws):>4d} {len(done):>5d} "
                         f"{pred:>10.4g} {meas:>10.4g} {err:>12.4g}")
        else:
            lines.append(f"{t:<12s} {len(rws):>4d} {0:>5d} "
                         f"{'-':>10s} {'-':>10s} {'-':>12s}")
    chan = Counter()
    for rec in records:
        if rec["name"] == "exchange":
            for ch in ("state", "extremum", "etr"):
                chan[ch] += rec["attrs"].get(ch, 0) or 0
    lines.append("exchange volume: " + "  ".join(
        f"{ch}={int(chan[ch])}" for ch in ("state", "extremum", "etr")))
    return "\n".join(lines)


def failures(records: list, sample: int = 5) -> str:
    """Rollup of non-done terminal statuses plus injected-fault actions.

    Queries that were rejected at admission, quarantined as poison, or timed
    out on their retry budget each leave a root 'query' span with a non-done
    status and a structured error; fault-injection/retry decisions leave
    parentless 'fault' spans (point, action).  Empty when the run was clean.
    """
    roots = span_trees(records)
    bad = [r for r in sorted(roots.values(), key=lambda r: r["t_start"])
           if r["name"] == "query"
           and r["attrs"].get("status", "done") != "done"]
    actions = Counter()
    for rec in records:
        if rec["name"] == "fault":
            a = rec["attrs"]
            actions[(a.get("point", "?"), a.get("action", "?"))] += 1
    if not bad and not actions:
        return ""
    lines = ["== failures =="]
    by_status = Counter(r["attrs"]["status"] for r in bad)
    lines.append("terminal: " + ("  ".join(
        f"{k}={v}" for k, v in sorted(by_status.items())) or "none"))
    if actions:
        lines.append("fault actions: " + "  ".join(
            f"{pt}/{ac}={n}" for (pt, ac), n in sorted(actions.items())))
    for r in bad[:sample]:
        a = r["attrs"]
        lines.append(f"  {a.get('template', '?'):<12s} "
                     f"{a['status']:<12s} {a.get('error', '')}")
    if len(bad) > sample:
        lines.append(f"  ... and {len(bad) - sample} more")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="trace JSONL path")
    ap.add_argument("--limit", type=int, default=3,
                    help="waterfalls to print (0 = none, -1 = all)")
    ap.add_argument("--audit", action="store_true",
                    help="append the cost-model audit report")
    ap.add_argument("--within", type=float, default=0.10,
                    help="--audit plan-accuracy tolerance (default 10%%)")
    args = ap.parse_args()

    records = load_jsonl(args.trace)
    if not records:
        print("empty trace")
        return 1
    roots = span_trees(records)
    queries = [roots[t] for t in sorted(roots)
               if roots[t]["name"] in ("query", "measure_supersteps")]
    n = len(queries) if args.limit < 0 else min(args.limit, len(queries))
    for root in queries[:n]:
        print(waterfall(root))
        print()
    print(rollup(records))
    fail = failures(records)
    if fail:
        print()
        print(fail)
    if args.audit:
        print("\n== cost-model audit ==")
        rep = audit.audit_report(records, within=args.within)
        print(json.dumps(rep, indent=2, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
