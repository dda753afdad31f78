"""The check's control: the reference in bfloat16 put in the server's place.

    python3 bench/control.py --workload <cell> --seeds 1 2 3 --out build/control.json

For each seed it makes the cell's graph and query stream as a run does, takes
as many queries of each template as a run judges (the first of each in the
stream), answers them with the reference computed in bfloat16 instead of the
program, and judges those answers with the float64 reference as a run judges
the server's.  The control must come out not correct: its numbers set the
upper end of each limit in ``bench/checks/<cell>.json``.  The benchmark's own
runs never run it.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def control_numbers(w, seed: int, dev) -> dict:
    """The control's compared numbers for one seed of the cell ``w``."""
    import numpy as np

    from bench import harness as H
    from bench.gen import ldbc as G
    from bench.gen import traffic as TR
    from bench.lib import check as CK

    cfg, mix = w["config_spec"], w["mix"]
    mode = mix.get("mode") or cfg["server"]["mode"]
    ss_graph, ss_stream, _, _ = H._seed_sequence(seed).spawn(4)
    g = G.generate(G.params_of(cfg), np.random.default_rng(ss_graph))
    names = TR.templates(mix, g)
    k = int(mix["judge_per_template"])
    stream = TR.build_stream(mix, g, 4 * k * sum(names.values()), np.random.default_rng(ss_stream))
    chosen, per = [], {}
    for q in stream:
        if per.get(q["template"], 0) < k:
            per[q["template"]] = per.get(q["template"], 0) + 1
            chosen.append(q)

    def mode_of(q):
        return "bucket" if (q["agg"] is not None and mode == "interval") else mode

    t0 = time.perf_counter()
    got = CK.control(chosen, mode_of, g, cfg["server"]["n_buckets"], dev,
                     cfg["server"]["keep_outputs"])
    got["seconds"] = time.perf_counter() - t0
    got["seed"] = seed
    return got


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config", help="with --traffic: a cell that BENCHMARK.json does not hold")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    import torch

    from bench.lib import spec as SP

    w = SP.cell(args.workload, entry=None if args.config is None else dict(
        name=args.workload, config=args.config, traffic=args.traffic, chips=1))
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    rows = []
    for seed in args.seeds:
        row = control_numbers(w, seed, dev)
        row["limits"] = w["limits"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(workload=args.workload, rows=rows), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
