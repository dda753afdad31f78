"""Gated segment min/max (B4), TimeWarp (B6), EmbeddingBag (B8) and the
DLRM-RM2 serve path, for one or more checkouts of the port, on one card.

    python3 scripts/torch_b6_b8_ab.py --trees <parent checkout> . [--out PATH]

Each tree runs in a process of its own (this script with ``--child``, the
tree's ``src`` first on the path, so that each imports and builds its own
``repro_torch``), in turns A B B A for two trees, and every tree is timed by
the timers of this checkout's ``chip_smoke.py``.  On inputs made on the card
from a seed at the shapes ``chip_smoke.py`` uses:

  b4_min_sliced, b4_max_sliced, b4_min_dense, b4_max_dense
                   ``scatter_extremum`` on ``chip_smoke.b4_operands``: the
                   CSR of the largest main-path ETR delivery (Q = 8,
                   2,781,395 edges into 100,000 destinations) and the
                   100,000-person graph's global arrival CSR (6,881,632
                   edges into 1,380,000), each with its seed-0 channel and
                   gate, held ``torch.equal`` to the tree's plain version.
                   On every run a first process of this checkout builds the
                   graph, re-runs the main path's static jobs to capture
                   that delivery and writes Q and the two CSRs to
                   ``--b4-operands`` (default ``build/b4_operands.pt``)
  b6_f32, b6_bf16  ``interval_warp`` on [1,380,000, 16] counts (small
                   integers, float32 and cast to bfloat16), random
                   lifespans and 16 bucket edges
  b8_one           ``embedding_bag`` on one 1,000,000 x 64 table, 262,144
                   bags of one index
  bags_512, bags_262144
                   ``models.dlrm._bags``: every table's bags of a DLRM-RM2
                   forward (26 tables of 1,000,000 x 64), as the tree's
                   forward calls it (one wrapper call a table, or one for
                   all)
  serve_p99, serve_bulk, retrieval_cand
                   ``serve_score`` at batch 512 and 262,144, and
                   ``retrieval_score`` of one query against 1,000,000
                   candidates (top 128)

and per call: ``ms`` (``time_ms``: one call on an idle card, host time to
the launch included), ``b2b_ms`` (``b2b_ms``), and for the kernel rows
``host_us`` (``host_us``) and ``device_ms`` (``device_mean_ms``); the B4
rows also ``equal``.  Prints
the card's name and power limit, one JSON line per turn, and writes them all
to ``--out`` (default ``build/torch_b6_b8_ab.json``).  Needs the card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def make_b4_operands(path: Path) -> None:
    """Build the main path's graph, capture its largest static ETR delivery
    (as ``chip_smoke.py``'s recorder does) and save its Q and B4's CSRs."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    import torch
    from repro_torch.core import engine as E
    from repro_torch.kernels import hop_scatter as HK

    g, _ = CS.main_graph()
    E.prepare_gdev(g, "cuda")
    jobs = CS.main_jobs(g)
    rec = CS.Recorder(HK)
    with rec:
        for j, job in enumerate(jobs):
            if job[1] == E.MODE_STATIC:   # the C = 1 deliveries
                rec.job = j
                CS.run_job(g, job)
    rec.capture(lambda j: CS.run_job(g, jobs[j]))
    contrib, ptr = rec.inputs[("scatter_cols", 1, False)][1]
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(dict(Q=contrib.shape[0], ptr=ptr.cpu(),
                    arr_ptr=torch.from_numpy(g.traversal["arr_ptr"])), path)


def b4_rows(CS, path: Path) -> dict:
    """B4's four rows on the saved operands, with the tree's wrapper."""
    import torch
    from repro_torch.kernels import hop_scatter as HK

    dev = torch.device("cuda")
    saved = torch.load(path)
    ops = CS.b4_operands(saved["Q"], saved["ptr"].to(dev), saved["arr_ptr"].to(dev))
    rows = {}
    for tag, (m, a, p) in ops.items():
        for op in (True, False):
            n = float("inf") if op else float("-inf")
            fn = lambda m=m, a=a, p=p, n=n, op=op: HK.scatter_extremum(m, a, p, n, op)
            equal = torch.equal(fn(), HK.scatter_extremum_plain(m, a, p, n, op))
            rows[f"b4_{'min' if op else 'max'}_{tag}"] = dict(
                host_us=CS.host_us(fn), ms=CS.time_ms(fn), b2b_ms=CS.b2b_ms(fn),
                device_ms=CS.device_mean_ms(fn), equal=equal)
    return rows


def child(b4_operands: Path) -> dict:
    """The timings of the ``repro_torch`` first on the path."""
    import repro_torch
    from repro_torch.configs.dlrm_rm2 import CONFIG, SHAPES
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import interval_warp as IW
    from repro_torch.models import dlrm as DM

    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS     # its timers; repro_torch stays the tree's, imported above
    import torch

    def kernel_row(fn):
        return dict(host_us=CS.host_us(fn), ms=CS.time_ms(fn), b2b_ms=CS.b2b_ms(fn),
                    device_ms=CS.device_mean_ms(fn))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = dict(package=repro_torch.__file__)
    out.update(b4_rows(CS, b4_operands))
    N, B = 1_380_000, 16
    counts = torch.randint(0, 8, (N, B), generator=gen, device=dev).float()
    start = torch.randint(-50, 1000, (N,), generator=gen, device=dev)
    ivl = torch.stack([start, start + torch.randint(0, 200, (N,), generator=gen, device=dev)],
                      1).to(torch.int32)
    bedges = torch.linspace(0, 1100, B + 1, device=dev).to(torch.int32)
    for tag, c in (("f32", counts), ("bf16", counts.to(torch.bfloat16))):
        out[f"b6_{tag}"] = kernel_row(lambda c=c: IW.interval_warp(c, ivl, bedges))
    del counts, ivl, bedges

    cfg = CONFIG
    params = DM.init_params(cfg, gen, device=dev)

    def batch(n):
        return (torch.randn(n, cfg.n_dense, generator=gen, device=dev),
                torch.randint(0, cfg.vocabs()[0], (n, cfg.n_sparse, cfg.multi_hot),
                              generator=gen, device=dev, dtype=torch.int32))

    calls = {name: batch(SHAPES[name]["batch"]) for name in ("serve_p99", "serve_bulk")}
    calls["retrieval_cand"] = batch(1)
    cand = torch.randn(CS.DLRM_CANDIDATES, cfg.embed_dim, generator=gen, device=dev)
    col = calls["serve_bulk"][1][:, 0, :].contiguous()
    out["b8_one"] = kernel_row(lambda: EB.embedding_bag(params["tables"][0], col, "sum"))
    for name in ("serve_p99", "serve_bulk"):
        sparse = calls[name][1]
        out[f"bags_{sparse.shape[0]}"] = kernel_row(lambda s=sparse: DM._bags(cfg, params, s))
    for name, (dense, sparse) in calls.items():
        if name == "retrieval_cand":
            fn = lambda d=dense, s=sparse: DM.retrieval_score(cfg, params, d, s, cand,
                                                              top_k=CS.DLRM_TOP_K)
        else:
            fn = lambda d=dense, s=sparse: DM.serve_score(cfg, params, d, s)
        out[name] = dict(ms=CS.time_ms(fn), b2b_ms=CS.b2b_ms(fn))
    out["device"] = torch.cuda.get_device_name(0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", nargs="+", help="checkouts to time, in order")
    ap.add_argument("--out", default=str(ROOT / "build" / "torch_b6_b8_ab.json"))
    ap.add_argument("--b4-operands", default=str(ROOT / "build" / "b4_operands.pt"),
                    help="where the first process saves B4's CSRs for the others")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--make-b4-operands", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    b4 = Path(args.b4_operands).resolve()
    if args.child:
        print(json.dumps(child(b4)))
        return 0
    if args.make_b4_operands:
        make_b4_operands(b4)
        return 0
    if not args.trees:
        ap.error("--trees is required")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, str(Path(__file__).resolve()), "--make-b4-operands",
                    "--b4-operands", str(b4)], cwd=ROOT, env=env, check=True)
    trees = [Path(t).resolve() for t in args.trees]
    order = trees + trees[::-1] if len(trees) == 2 else trees
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    turns = []
    for tree in order:
        env = dict(os.environ, PYTHONPATH=str(tree / "src"))
        res = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                              "--b4-operands", str(b4)],
                             cwd=tree, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            sys.stderr.write(res.stderr)
            raise SystemExit(f"torch_b6_b8_ab: {tree} failed")
        rec = dict(tree=str(tree), **json.loads(res.stdout.strip().splitlines()[-1]))
        if not rec["package"].startswith(str(tree)):
            raise SystemExit(f"torch_b6_b8_ab: {tree} imported {rec['package']}")
        turns.append(rec)
        print(json.dumps(rec), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(nvidia_smi=smi, turns=turns), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
