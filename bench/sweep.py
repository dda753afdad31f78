"""Find an open-loop cell's knee: the highest offered rate it sustains.

    python3 bench/sweep.py --workload zd100k.bucket.open \\
        --config ldbc-snb-100k-zipf-dynamic --traffic q1-q8-bucket-open \\
        --seed 7 --seconds 20 --rates 80 120 160 200 --out build/sweep.json

(``--config`` and ``--traffic`` name a cell that ``BENCHMARK.json`` does not
hold yet.)  One set-up, then one window a rate, lowest first.  A rate is sustained when
the backlog does not grow over its window: the queue left when the arrivals
stop drains within two flushes, and the last third of the window's queries
wait no longer than the first third's (p95, within 1.5 times).  The mix's
``rate_qps`` is then set, by hand, to 0.8 times the highest sustained rate.
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config", help="with --traffic: a cell that BENCHMARK.json does not hold")
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import numpy as np
    import torch

    from bench import harness as H
    from bench.gen import traffic as TR
    from bench.lib import loop as LP
    from bench.lib import spec as SP

    w = SP.cell(args.workload, entry=None if args.config is None else dict(
        name=args.workload, config=args.config, traffic=args.traffic, chips=1))
    if w["mix"]["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    dev = torch.device("cuda", 0)
    top = dict(w, mix=dict(w["mix"], rate_qps=max(args.rates)))
    c = H.prepare(top, args.seed, args.seconds, False, dev)
    print(f"setup {json.dumps(c['setup'])}", file=sys.stderr, flush=True)
    rng = np.random.default_rng(args.seed)
    rows = []
    for rate in sorted(args.rates):
        offsets = TR.arrivals(dict(w["mix"], rate_qps=rate), args.seconds, rng)
        judge = LP.Reservoir(1, rng)
        win = LP.run_open(c["server"], c["instances"], c["stream"], offsets,
                          c["cap"], args.seconds, judge)
        idx = sorted(win.status)
        lat = np.asarray([(win.done[i] - win.due[i]) * 1e3 for i in idx])
        third = max(1, len(idx) // 3)
        fl = np.asarray([f["end"] - f["start"] for f in win.flushes])
        t_end = win.t0 + args.seconds
        drain = max(0.0, win.t_last - t_end)
        p95_first = float(np.percentile(lat[:third], 95))
        p95_last = float(np.percentile(lat[-third:], 95))
        row = dict(rate=rate, offered=len(offsets), answered=win.n_done,
                   failed=win.n_failed, qps=win.n_done / win.elapsed_s,
                   p50_ms=float(np.percentile(lat, 50)),
                   p95_ms=float(np.percentile(lat, 95)),
                   p95_first_third_ms=p95_first, p95_last_third_ms=p95_last,
                   drain_s=drain, mean_flush_s=float(fl.mean()),
                   mean_flush_n=float(np.mean([f["n"] for f in win.flushes])),
                   sustained=bool(drain <= 2 * fl.mean() and p95_last <= 1.5 * p95_first))
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    sustained = [r["rate"] for r in rows if r["sustained"]]
    out = dict(workload=args.workload, seed=args.seed, seconds=args.seconds,
               device=torch.cuda.get_device_name(dev), rows=rows,
               knee=max(sustained) if sustained else None)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(dict(knee=out["knee"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
