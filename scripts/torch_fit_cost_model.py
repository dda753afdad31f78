"""Fit the port's cost-model coefficients on the card.

    python3 scripts/torch_fit_cost_model.py [--persons 20000 100000]
        [--workers 2 4 8] [--device cuda] [--out PATH]

The port of the reference's ``benchmarks/fit_cost_model.py``, timing the
port's executors instead of the JAX ones.  Every row's features are the
planner's own (``Planner.estimate(...).features`` over ``COEFF_KEYS``), so
``features @ θ`` is exactly what the planner will predict for that row.

* **Compute terms and the impl difference** (θ0, θ_init = θ_v, θ_e,
  θ_etr, θ_m, θ_scatter_torch, θ_scatter_cuda): what the server dispatches
  — each template's group of 8 from ``make_workload(n_per_template=8,
  seed=61)`` on the main path's kind of graph at each ``--persons`` size
  (zipf degrees, dynamic properties, seed 6) in bucket mode (what
  ``--serve`` picks for such a graph), at split 0 and n - 1, featured by
  ``Planner.estimate_batch`` and timed whole through
  ``core/engine.execute_batch_out`` on BOTH lowerings (``impl='torch'`` and
  ``'cuda'``) as the serving runtime times a dispatch: the host clock after
  the card has finished, median of 3 after a first call.  (Single static
  queries at 2,000 and 20,000 persons take 2–5 ms whatever their size on
  the card, host time, and leave every per-edge cost at 0.)  The planner
  costs a plain hop at θ_e per edge on ``'torch'`` and
  θ_e + θ_scatter_cuda − θ_scatter_torch on ``'cuda'``; the fit solves for
  those two per-edge costs as separate unknowns, with every coefficient,
  and so each impl's per-edge cost, constrained ≥ 0 (non-negative least
  squares on unit-scaled columns), then writes θ_scatter_torch and
  θ_scatter_cuda as the smallest non-negative pair with that difference.
* **Exchange terms** (θ_net, θ_net_etr), as the reference fits them: the
  port's ``engine_partitioned.measure_supersteps`` (Q1, Q2, Q4 and a MIN
  variant of Q2, seed 62/63, at each ``--workers`` on the largest graph,
  bucket mode, kernel lowering) gives each query's summed per-hop
  makespan; the compute share the fitted θ predicts from the
  distribution-aware planner's features (per-worker extents; the untimed
  init and vertex columns zeroed) is taken off, and the two channel volumes
  (state + extremum, ETR rank summaries) explain the residual by
  non-negative least squares.

The script refuses (exit 1, nothing written) when any of its own timed rows
would be predicted at ≤ 0 ms, and prints the lowest and highest
predicted/measured ratio over the rows.  Otherwise it writes the port's
coefficient file (``src/repro_torch/configs/cost_coeffs.json``, gitignored;
never the reference's) and prints one JSON line: the coefficients, the fit's
r², the ratio range, and the card's name and power limit.  ``--out`` also
writes the report, with every timed row, to a file.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.optimize import nnls  # noqa: E402

from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import engine_partitioned as EP  # noqa: E402
from repro_torch.core import query as Q  # noqa: E402
from repro_torch.core.planner import (COEFF_KEYS, DEFAULT_COEFFS, Planner,  # noqa: E402
                                      save_coeffs)
from repro_torch.core.stats import GraphStats  # noqa: E402
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc  # noqa: E402
from repro_torch.graphdata.queries import make_workload, to_minmax  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402

K = {k: i for i, k in enumerate(COEFF_KEYS)}
#: the unknowns of the compute fit, each >= 0: the planner's compute
#: columns, with θ_e split into the per-edge cost of a plain hop on each impl
COMPUTE = ("theta0", "theta_v", "theta_e", "theta_etr", "theta_m", "edge_cuda")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_call(fn, dev, repeats: int = 3) -> float:
    """ms of ``fn``, the host clock after the card has finished: median of
    ``repeats`` after a first call."""
    fn()
    _sync(dev)
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def compute_columns(f: np.ndarray) -> np.ndarray:
    """A planner feature row → the compute fit's columns (``COMPUTE``).
    ``f[θ_scatter_cuda]`` is a cuda row's plain-hop edges (the planner adds
    +e/w there and −e/w on θ_scatter_torch, so a torch row has 0): those
    edges cost ``edge_cuda``, every other edge θ_e."""
    plain_cuda = f[K["theta_scatter_cuda"]]
    return np.asarray([f[K["theta0"]], f[K["theta_init"]] + f[K["theta_v"]],
                       f[K["theta_e"]] - plain_cuda, f[K["theta_etr"]], f[K["theta_m"]],
                       plain_cuda])


def coeffs_from(sol: dict, net=(None, None)) -> dict:
    """The planner's coefficients from the fitted unknowns: θ_init = θ_v,
    and the smallest non-negative θ_scatter pair whose difference
    θ_scatter_cuda − θ_scatter_torch = edge_cuda − θ_e."""
    d = sol["edge_cuda"] - sol["theta_e"]
    c = dict(theta0=sol["theta0"], theta_init=sol["theta_v"], theta_v=sol["theta_v"],
             theta_e=sol["theta_e"], theta_etr=sol["theta_etr"], theta_m=sol["theta_m"],
             theta_scatter_torch=max(0.0, -d), theta_scatter_cuda=max(0.0, d))
    if net[0] is not None:
        c.update(theta_net=float(net[0]), theta_net_etr=float(net[1]))
    return c


def scaled_nnls(A: np.ndarray, y: np.ndarray) -> np.ndarray:
    """min ||A x - y|| subject to x >= 0, on unit-norm columns (the columns
    span edges, vertices and step counts: seven orders of magnitude)."""
    norm = np.linalg.norm(A, axis=0)
    norm[norm == 0] = 1.0
    x, _ = nnls(A / norm, y)
    return x / norm


MODE = E.MODE_BUCKET
BATCH = 8


def query_rows(persons, dev) -> tuple:
    """Whole-group rows on both impls: (planner features, ms, description)."""
    rows, graphs = [], []
    for n in persons:
        g = generate_ldbc(LdbcParams(n_persons=n, degree_dist="zipf", dynamic=True,
                                     align=16, seed=6))
        graphs.append(g)
        planner = Planner(g, GraphStats(g), coeffs=dict(DEFAULT_COEFFS))
        wl = make_workload(g, n_per_template=BATCH, seed=61)
        for t in sorted({i.template for i in wl}):
            qs = [i.qry for i in wl if i.template == t]
            for split in sorted({0, qs[0].n_vertices - 1}):
                for impl in ("torch", "cuda"):
                    ms = time_call(lambda: E.execute_batch_out(
                        g, qs, split=split, mode=MODE, impl=impl, device=dev), dev)
                    rows.append((planner.estimate_batch(qs, split, impl).features, ms,
                                 dict(persons=n, template=t, split=split, impl=impl,
                                      batch=len(qs))))
    return rows, graphs


def superstep_rows(g, workers, dev) -> list:
    """Partitioned rows: the planner's distribution-aware features of the
    profiled plan (init and vertex columns zeroed: measure_supersteps times
    only the hops' local compute) and the summed per-hop makespan."""
    wl = make_workload(g, templates=("Q1", "Q2", "Q4"), n_per_template=2, seed=62)
    qmm = to_minmax(make_workload(g, templates=("Q2",), n_per_template=1, seed=63)[0], g)
    stats = GraphStats(g)
    rows = []
    for w in workers:
        _, arrays = EP.partition_for(g, w)
        planner = Planner(g, stats, coeffs=dict(DEFAULT_COEFFS), partitioning=arrays)
        for inst in wl + [qmm]:
            qry = inst.qry
            prof = EP.measure_supersteps(g, qry, n_workers=w, mode=MODE, repeats=2,
                                         impl="cuda", device=dev)
            split = 0 if qry.agg_op != Q.AGG_NONE else qry.n_vertices - 1
            f = planner.estimate(qry, split, "cuda").features.copy()
            f[K["theta_init"]] = f[K["theta_v"]] = 0.0
            rows.append((f, float(prof.makespan_s.sum()) * 1e3,
                         dict(persons=int(g.meta.get("params", {}).get("n_persons", 0)),
                              template=inst.template, workers=w, impl="cuda",
                              channels=prof.channel_totals(),
                              balance_eff=prof.balance_eff)))
    return rows


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "not measured (no nvidia-smi)"


def fit(persons, workers, dev) -> dict:
    qrows, graphs = query_rows(persons, dev)
    A = np.stack([compute_columns(f) for f, _, _ in qrows])
    y = np.asarray([ms for _, ms, _ in qrows])
    sol = dict(zip(COMPUTE, scaled_nnls(A, y)))
    pred_q = A @ np.asarray([sol[k] for k in COMPUTE])
    r2 = 1 - np.sum((y - pred_q) ** 2) / max(np.sum((y - y.mean()) ** 2), 1e-9)

    prows = superstep_rows(graphs[-1], workers, dev)
    theta_c = coeffs_from(sol)
    comp = lambda f: sum(f[K[k]] * v for k, v in theta_c.items())
    resid = np.asarray([ms - comp(f) for f, ms, _ in prows])
    M = np.stack([[f[K["theta_net"]], f[K["theta_net_etr"]]] for f, _, _ in prows])
    net = scaled_nnls(M, resid)
    coeffs = coeffs_from(sol, net)

    report_rows, ratios = [], []
    for f, ms, info in qrows + prows:
        p = float(sum(f[K[k]] * coeffs.get(k, DEFAULT_COEFFS[k]) for k in COEFF_KEYS))
        ratios.append(p / ms)
        report_rows.append(dict(info, features=f.tolist(), ms=ms, predicted_ms=p))
    return dict(coeffs=coeffs, r2=float(r2), n_rows=len(report_rows),
                n_query_rows=len(qrows), n_superstep_rows=len(prows),
                persons=list(persons), workers=list(workers),
                edge_cost_ms=dict(torch=sol["theta_e"], cuda=sol["edge_cuda"]),
                ratio_min=float(min(ratios)), ratio_max=float(max(ratios)),
                min_predicted_ms=float(min(r["predicted_ms"] for r in report_rows)),
                rows=report_rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--persons", type=int, nargs="+", default=[20000, 100000])
    ap.add_argument("--workers", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rep = fit(args.persons, args.workers, dev)
    rep.update(device=str(dev), card=card() if dev.type == "cuda" else "cpu",
               torch=torch.__version__, wall_s=time.perf_counter() - t0)
    ok = rep["min_predicted_ms"] > 0.0
    rep["written"] = ok
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rep, indent=1))
    print(f"predicted/measured over {rep['n_rows']} timed rows: "
          f"{rep['ratio_min']:.4g} .. {rep['ratio_max']:.4g}")
    if not ok:
        print(f"refused: a timed row is predicted at {rep['min_predicted_ms']:.4g} ms "
              "(<= 0); no coefficient file written")
        return 1
    save_coeffs(rep["coeffs"])
    print(json.dumps({k: v for k, v in rep.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
