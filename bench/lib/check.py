"""The check that decides ``correct``: served answers against the reference.

Numbers compared, each against its limit in ``bench/checks/<cell>.json``:

* ``count_rel_err``: the largest ``|served - reference| / max(|reference|, 1)``
  over every judged answer's count and, where the server returns them
  (``keep_outputs``), its total (a count, or one per bucket) and an
  aggregate's per-first-vertex counts.  Exact integers in float64 on the
  reference's side; the server counts in float32, exact below 2**24.
* ``minmax_mismatches``: judged MIN/MAX entries that differ from the
  reference's (an exact comparison; +-inf where no path starts).
* ``unanswered``: queries that failed or got no answer.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..ref.engine import Reference, answer


def _rel_err(got, want: torch.Tensor) -> float:
    got = torch.as_tensor(np.asarray(got), device=want.device).to(torch.float64)
    if tuple(got.shape) != tuple(want.shape):
        return float("inf")
    want = want.to(torch.float64)
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    err = torch.where(torch.isnan(err), torch.full_like(err, float("inf")), err)
    return float(err.max()) if err.numel() else 0.0


def _mismatches(got, want: torch.Tensor) -> int:
    got = torch.as_tensor(np.asarray(got), device=want.device).to(torch.float64)
    if tuple(got.shape) != tuple(want.shape):
        return int(max(want.numel(), 1))
    return int((got != want.to(torch.float64)).sum())


def compare(answers: Iterable[Tuple[dict, str, dict]], ref: Reference,
            outputs: bool = True) -> Dict[str, float]:
    """``answers``: (query, mode, served) with ``served`` holding ``count``
    and, where the server returns them (``outputs``), ``total`` and an
    aggregate's ``per_vertex`` and ``minmax``."""
    rel, mism, n, top = 0.0, 0, 0, 0.0
    for q, mode, served in answers:
        r = answer(ref, q, mode)
        top = max(top, float(r["total"].abs().max()))
        rel = max(rel, _rel_err(served["count"], r["total"].sum()))
        if outputs:
            tot = served.get("total")
            rel = max(rel, float("inf") if tot is None else _rel_err(tot, r["total"]))
        if q["agg"] is not None and outputs:
            pv = served.get("per_vertex")
            rel = max(rel, float("inf") if pv is None else _rel_err(pv, r["per_vertex"]))
        if q["agg"] in ("min", "max") and outputs:
            mm = served.get("minmax")
            mism += (int(r["minmax"].numel()) if mm is None
                     else _mismatches(mm, r["minmax"]))
        n += 1
    return dict(count_rel_err=rel, minmax_mismatches=float(mism), judged=float(n),
                largest_total=top)


def judge(judged: List, mode_of, g, n_buckets: int, device, n_failed: int,
          limits: Dict[str, float], outputs: bool) -> Tuple[bool, Dict, float]:
    """(correct, {name: {value, limit}}, reference seconds) of a run whose
    server returns aggregates' outputs when ``outputs``."""
    t0 = time.perf_counter()
    ref = Reference(g, n_buckets, device=device)
    got = compare(((j.query, mode_of(j.query),
                    dict(count=j.count, total=j.total, per_vertex=j.per_vertex,
                         minmax=j.minmax))
                   for j in judged), ref, outputs)
    del ref
    numbers = dict(count_rel_err=got["count_rel_err"],
                   minmax_mismatches=got["minmax_mismatches"],
                   unanswered=float(n_failed))
    checks = {k: dict(value=v, limit=limits[k]) for k, v in numbers.items()}
    ok = got["judged"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    print(f"judged {got['judged']:.0f} answers, largest total {got['largest_total']:.0f}",
          file=sys.stderr, flush=True)
    return ok, checks, time.perf_counter() - t0


def control(stream_queries: List[dict], mode_of, g, n_buckets: int, device,
            outputs: bool, dtype: torch.dtype = torch.bfloat16) -> Dict[str, float]:
    """The control: the reference computed in ``dtype`` put in the server's
    place, judged like a run's answers."""
    low = Reference(g, n_buckets, device=device, dtype=dtype)
    ref = Reference(g, n_buckets, device=device)
    served = []
    for q in stream_queries:
        a = {k: v.to(torch.float32).cpu().numpy() for k, v in answer(low, q, mode_of(q)).items()}
        a["count"] = float(a["total"].sum())
        served.append((q, mode_of(q), a))
    return compare(served, ref, outputs)
