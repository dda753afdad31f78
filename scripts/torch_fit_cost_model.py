"""Fit the port's cost-model coefficients on the card.

    python3 scripts/torch_fit_cost_model.py [--persons 2000 20000]
        [--device cuda] [--out PATH]

The port of the reference's ``benchmarks/fit_cost_model.py``, timing the
port's executors instead of the JAX ones:

* **Compute terms** (θ0, θ_init = θ_v, θ_e, θ_etr, θ_m): every template of
  ``make_workload(n_per_template=3, seed=61)`` on LDBC graphs of each
  ``--persons`` size (facebook degrees, seed 6, static mode), at split 0
  and n - 1, through ``core/engine.execute`` on the plain lowering
  (``impl='torch'``: θ_e folds the plain delivery in, as the reference's
  folds the XLA one), timed as the serving runtime times a dispatch — the
  host clock after the card has finished, median of 3 after a first call —
  and fitted by least squares over the reference's per-query features
  (``[n_vertices, Σ V_slice, Σ E_slice, Σ etr·E_slice, 0.05 Σ E_slice]``),
  clamped non-negative.
* **Per-impl hop-delivery slopes** (θ_scatter_torch, θ_scatter_cuda): one
  hop's delivery on each graph's traversal arrays in static and bucket mode
  (8 buckets), timed as the plain gather → mask → segment sum and as the
  fused hop kernel (B1), the two held equal, best of 5; an origin-
  constrained least squares over the edge counts gives ms per edge each.
* The distribution-aware terms (θ_net, θ_net_etr) need the partitioned
  executor (ROADMAP A7) and keep their defaults.

Writes the port's coefficient file (``src/repro_torch/configs/
cost_coeffs.json``, gitignored; never the reference's) and prints one JSON
line: the coefficients, the fit's r², the hop-delivery timings, and the
card's name and power limit.  ``--out`` also writes the report, with every
timed row, to a file.
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

from repro_torch.core import engine as E  # noqa: E402
from repro_torch.core import intervals as iv  # noqa: E402
from repro_torch.core import superstep as SS  # noqa: E402
from repro_torch.core.planner import fit_linear, save_coeffs  # noqa: E402
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc  # noqa: E402
from repro_torch.graphdata.queries import make_workload  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trav_by_type(g):
    """Traversal arrivals per vertex type (same derivation as Planner)."""
    deg = g.in_degree.astype(np.int64) + g.out_degree.astype(np.int64)
    out = np.zeros(g.n_vertex_types, np.int64)
    np.add.at(out, g.v_type, deg)
    return out


def _query_features(g, qry, trav_by_type):
    """The reference's per-query feature row over (θ0, θ_v, θ_e, θ_etr, θ_m)."""
    V, E2 = g.n_vertices, 2 * g.n_edges
    n = qry.n_vertices
    v_s, e_s, etrs = [], [], []
    for i, vp in enumerate(qry.v_preds):
        v_s.append(g.type_counts[vp.vtype] if vp.vtype >= 0 else V)
        nxt = qry.v_preds[i + 1].vtype if i + 1 < n else -1
        e_s.append(trav_by_type[nxt] if nxt >= 0 else E2)
        etrs.append(1.0 if i < len(qry.e_preds) and qry.e_preds[i].etr_op != -1 else 0.0)
    v_s, e_s, etrs = (np.asarray(x, float) for x in (v_s, e_s, etrs))
    return np.asarray([n, v_s.sum(), e_s[:-1].sum(), (etrs[:-1] * e_s[:-1]).sum(),
                       e_s[:-1].sum() * 0.05])


def time_query(g, qry, split, dev, repeats: int = 3) -> float:
    """ms of one ``execute`` on the plain lowering, the host clock after the
    card has finished: median of ``repeats`` after a first call."""
    def run():
        E.execute(g, qry, split=split, impl="torch", device=dev)
        _sync(dev)

    run()
    ts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def hop_delivery_times(g, mode: int, dev, n_buckets: int = 8, repeats: int = 5) -> dict:
    """Best-of ms of one hop's delivery on ``g``'s traversal arrays: the plain
    gather → edge mask → segment sum, and the fused hop kernel (B1) — held
    equal (integer-valued state keeps them bit-identical)."""
    gdev = E.prepare_gdev(g, dev)
    t_src, ptr = gdev["t_src_l"], gdev["arr_ptr"]
    V, E2 = g.n_vertices, int(t_src.shape[0])
    bedges = torch.from_numpy(iv.bucket_edges(g.lifespan[0], g.lifespan[1], n_buckets)).to(dev)
    gen = torch.Generator(device="cpu").manual_seed(7)
    ts = () if mode == SS.MODE_STATIC else (n_buckets,)
    state = torch.randint(0, 8, (1, V) + ts, generator=gen).float().to(dev)
    wmask = (torch.rand((1, E2), generator=gen) < 0.6).to(dev)
    evalid = (None if mode == SS.MODE_STATIC
              else (torch.rand((1, E2, n_buckets), generator=gen) < 0.7).to(dev))

    def plain():
        cnt = SS.apply_edge(state[:, t_src], wmask, evalid, mode, bedges)
        return SS.deliver(cnt, ptr, V, impl="torch")

    def fused():
        return SS.fused_hop_deliver(state, gdev["t_src"], wmask, evalid, mode, ptr, V,
                                    bedges)[0]

    if not torch.equal(plain(), fused()):
        raise AssertionError("the fused hop drifted off the plain delivery")

    def best_of(fn):
        best = np.inf
        for _ in range(repeats):
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3

    return dict(torch_ms=best_of(plain), cuda_ms=best_of(fused), edges=E2)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "not measured (no nvidia-smi)"


def fit(persons, dev) -> dict:
    rows, times, graphs = [], [], []
    for n in persons:
        g = generate_ldbc(LdbcParams(n_persons=n, degree_dist="facebook", seed=6))
        graphs.append(g)
        trav = _trav_by_type(g)
        for inst in make_workload(g, n_per_template=3, seed=61):
            for split in (0, inst.qry.n_vertices - 1):
                rows.append(_query_features(g, inst.qry, trav))
                times.append(time_query(g, inst.qry, split, dev))
    X, y = np.asarray(rows), np.asarray(times)
    theta = np.maximum(fit_linear(X, y), 0.0)
    pred = X @ theta
    r2 = 1 - np.sum((y - pred) ** 2) / max(np.sum((y - y.mean()) ** 2), 1e-9)

    hops = [dict(persons=n, mode=md, **hop_delivery_times(g, md, dev))
            for n, g in zip(persons, graphs) for md in (E.MODE_STATIC, E.MODE_BUCKET)]
    ee = np.asarray([h["edges"] for h in hops], float)
    denom = max(float(np.sum(ee * ee)), 1e-9)
    slope = {impl: float(np.sum(np.asarray([h[f"{impl}_ms"] for h in hops]) * ee) / denom)
             for impl in ("torch", "cuda")}
    coeffs = dict(theta0=float(theta[0]), theta_init=float(theta[1]),
                  theta_v=float(theta[1]), theta_e=float(theta[2]),
                  theta_etr=float(theta[3]), theta_m=float(theta[4]),
                  theta_scatter_torch=slope["torch"], theta_scatter_cuda=slope["cuda"])
    return dict(coeffs=coeffs, r2=float(r2), n_rows=len(y), persons=list(persons),
                rows=[dict(features=r.tolist(), ms=t) for r, t in zip(rows, times)],
                hop_delivery=hops)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--persons", type=int, nargs="+", default=[2000, 20000])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    t0 = time.perf_counter()
    rep = fit(args.persons, dev)
    rep.update(device=str(dev), card=card() if dev.type == "cuda" else "cpu",
               torch=torch.__version__, wall_s=time.perf_counter() - t0)
    save_coeffs(rep["coeffs"])
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rep, indent=1))
    print(json.dumps({k: v for k, v in rep.items() if k != "rows"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
