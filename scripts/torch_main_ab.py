"""Time the PyTorch/CUDA port's main path on an NVIDIA H100 for two checkouts
in turns, in one run: A, B, B, A.

    python3 scripts/torch_main_ab.py --trees DIR_A DIR_B [--reps 5] [--out PATH]

Each turn is a fresh process that imports ``chip_smoke.py`` and the port
(``src/repro_torch``) from its checkout, builds that checkout's kernels,
makes the main path's graph (``LdbcParams(n_persons=100_000, dynamic=True,
degree_dist="zipf", align=16, seed=1)``) and its jobs as ``chip_smoke.py``'s
main phase does (Q1-Q8 at two splits and the MIN/MAX shapes, static and
bucket with 8 queries a batch, interval with 1), then times every job: one
warm-up call, then the median of ``--reps`` CUDA-event timings of one
``execute_batch_out`` each.  The hop kernels' launch counts of each job are
kept.  The summary gives, per job, each turn's median and the ratio of B's
mean to A's; the full record goes to ``--out``.  Both checkouts must hold
``chip_smoke.py`` with ``run_job`` and ``minmax_shapes``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(tree: Path, reps: int, out: Path) -> None:
    sys.path.insert(0, str(tree))
    import chip_smoke as CS  # that checkout's: it puts its own src/ first on the path
    import numpy as np
    import torch
    from repro_torch.core import engine as E
    from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
    from repro_torch.graphdata.queries import TEMPLATES, make_workload
    from repro_torch.kernels import build
    from repro_torch.kernels import hop_scatter as HK

    if not (Path(CS.__file__).resolve().parent == tree and
            Path(HK.__file__).resolve().is_relative_to(tree)):
        raise AssertionError(f"imported the port from outside {tree}")
    build.load()
    g = generate_ldbc(LdbcParams(n_persons=CS.PERSONS, dynamic=True, degree_dist="zipf",
                                 align=16, seed=CS.SEED))
    E.prepare_gdev(g, "cuda")
    wl = make_workload(g, n_per_template=CS.N_BATCH, seed=CS.SEED)
    jobs = []
    for t in TEMPLATES:
        qs = [i.qry for i in wl if i.template == t]
        n = qs[0].n_vertices
        for mode in (E.MODE_STATIC, E.MODE_BUCKET, E.MODE_INTERVAL):
            for split in sorted({n - 1, n // 2}):
                jobs.append((t, mode, split, qs if mode != E.MODE_INTERVAL else qs[:1]))
    for name, q in CS.minmax_shapes(g).items():
        for mode in (E.MODE_STATIC, E.MODE_BUCKET, E.MODE_INTERVAL):
            jobs.append((name, mode, 0, [q] * (CS.N_BATCH if mode != E.MODE_INTERVAL else 1)))
    rows = []
    for job in jobs:
        t, mode, split, batch = job
        CS.run_job(g, job)
        before = dict(HK.LAUNCHES)
        times = []
        for _ in range(reps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            CS.run_job(g, job)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        launches = {k: (HK.LAUNCHES[k] - before[k]) // reps for k in HK.LAUNCHES}
        rows.append(dict(template=t, mode=["static", "bucket", "interval"][mode], split=split,
                         Q=len(batch), ms=times, median_ms=float(np.median(times)),
                         launches=launches))
    out.write_text(json.dumps(dict(tree=str(tree), rows=rows)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "build" / "torch_main_ab.json"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--worker-out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(Path(args.worker).resolve(), args.reps, Path(args.worker_out))
        return 0
    trees = [Path(t).resolve() for t in args.trees]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    turns = []
    for i, which in enumerate((0, 1, 1, 0)):
        part = out.with_name(f"{out.stem}.turn{i}.json")
        subprocess.run([sys.executable, __file__, "--trees", *args.trees, "--reps",
                        str(args.reps), "--worker", str(trees[which]), "--worker-out",
                        str(part)], check=True)
        turns.append((which, json.loads(part.read_text())["rows"]))
    summary = []
    for r, row in enumerate(turns[0][1]):
        med = {0: [], 1: []}
        for which, rows in turns:
            med[which].append(rows[r]["median_ms"])
        a, b = sum(med[0]) / 2, sum(med[1]) / 2
        summary.append(dict(template=row["template"], mode=row["mode"], split=row["split"],
                            Q=row["Q"], a_ms=med[0], b_ms=med[1], b_over_a=b / a,
                            launches_a=row["launches"], launches_b=turns[1][1][r]["launches"]))
        print(f"ab: {row['template']:13s} {row['mode']:8s} split={row['split']:<8d} "
              f"Q={row['Q']} A {med[0][0]:9.3f} {med[0][1]:9.3f}  B {med[1][0]:9.3f} "
              f"{med[1][1]:9.3f}  B/A {b / a:.3f}", flush=True)
    out.write_text(json.dumps(dict(trees=[str(t) for t in trees], order="ABBA",
                                   reps=args.reps, rows=summary), indent=1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
