"""Multi-pod dry run: trace every (arch × shape) cell on the ``meta`` device
and write its roofline on each production mesh.

The port's counterpart of the reference's ``launch/dryrun.py``.  Where the
reference lowers and compiles each cell over 512 placeholder XLA devices,
the port runs the cell's step on ``meta`` tensors (shapes and dtypes, never
allocated) under ``roofline.analysis.count_program``, which counts its
FLOPs and bytes op by op.  That proves every cell's shapes and specs
coherent without hardware.  The global program is the same on both meshes,
so each (arch × shape) is traced once; the per-chip division, the memory
blocks and the collective model of each mesh come from that one trace.

One JSON record a cell and mesh goes to ``--out`` (default
``build/dryrun/``): the reference's keys (``roofline.RooflineReport``) and
``status`` ok, or ``skipped`` with the reason, or ``error`` with the trace.
The last line is ``DRYRUN SUMMARY: ok=… skipped=… errors=…``; the exit
code is 1 on any error.  ``--jobs N`` traces the cells in N worker
processes (one cell at a time each, the largest first as listed); the
records and the summary are the same.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--skip-existing] [--jobs 4]
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
import traceback
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

from ..configs import ARCH_IDS, load_arch
from ..roofline.analysis import analyze_counts, count_program
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {"single": False, "multi": True}      # mesh kind → multi_pod


def model_flops_for(arch_id: str, shape: str, spec) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) for training; 2·N·D inference."""
    meta = spec.meta
    n = meta.get("active_params") or meta.get("params")
    if n is None:
        return None
    from ..configs import common
    if shape in common.LM_SHAPES:
        info = common.LM_SHAPES[shape]
        tokens = info["batch"] * (info["seq"] if info["kind"] != "decode" else 1)
        mult = 6.0 if info["kind"] == "train" else 2.0
        return mult * float(n) * tokens
    return None


def _write(out_dir: Path, rec: dict) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
    path.write_text(json.dumps(rec, indent=2))
    return rec


def run_cell(arch_id: str, shape: str, mesh_kinds=("single",), skip_existing: bool = False,
             out_dir: Path = OUT_DIR) -> list:
    """The records of one (arch × shape) on each of ``mesh_kinds``, traced
    once, each written to ``out_dir``."""
    out_dir = Path(out_dir)
    paths = {mk: out_dir / f"{arch_id}__{shape}__{mk}.json" for mk in mesh_kinds}
    if skip_existing and all(p.exists() for p in paths.values()):
        return [json.loads(p.read_text()) for p in paths.values()]
    spec = load_arch(arch_id)
    if shape in spec.skip:
        return [_write(out_dir, dict(arch=arch_id, shape=shape, mesh=mk, status="skipped",
                                     reason=spec.skip[shape])) for mk in mesh_kinds]
    recs = []
    counts = output = None
    t_trace = 0.0
    for mk in mesh_kinds:
        tag = f"{arch_id}__{shape}__{mk}"
        mesh = make_production_mesh(multi_pod=MESHES[mk])
        t0 = time.time()
        try:
            cell = spec.shapes[shape](mesh)
            if counts is None:              # one trace serves every mesh
                counts, output = count_program(cell.fn, cell.args, return_output=True)
                t_trace = counts.seconds
                print(f"[{tag}] counted {counts.ops} ops in {t_trace:.1f}s: flops "
                      f"{counts.flops} bytes={counts.bytes:.3e}", flush=True)
            rep = analyze_counts(counts, cell, mesh, arch_id, shape, mk,
                                 model_flops=model_flops_for(arch_id, shape, spec),
                                 output=output)
            rec = rep.to_json()
            rec.update(status="ok", t_lower_s=time.time() - t0, t_compile_s=None,
                       t_trace_s=t_trace, kind=cell.kind, note=cell.note)
        except Exception as e:  # a failing cell is a bug — record it loudly
            rec = dict(arch=arch_id, shape=shape, mesh=mk, status="error",
                       error=f"{type(e).__name__}: {e}",
                       trace=traceback.format_exc()[-2000:])
            print(f"[{tag}] FAILED: {rec['error']}", flush=True)
        recs.append(_write(out_dir, rec))
    return recs


def all_cells():
    for arch_id in ARCH_IDS:
        spec = load_arch(arch_id)
        for shape in list(spec.shapes) + list(spec.skip):
            yield arch_id, shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR), help="directory of the JSON records")
    ap.add_argument("--jobs", type=int, default=1, help="worker processes tracing cells")
    args = ap.parse_args(argv)

    meshes = list(MESHES) if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(all_cells())
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    results = []
    t0 = time.time()
    work = [(arch_id, shape, meshes, args.skip_existing, args.out) for arch_id, shape in cells]
    if args.jobs > 1:
        pool = ProcessPoolExecutor(args.jobs, mp_context=multiprocessing.get_context("spawn"))
        done = pool.map(run_cell, *zip(*work))
    else:
        pool, done = None, (run_cell(*w) for w in work)
    for (arch_id, shape, *_), recs in zip(work, done):
        for rec in recs:
            results.append(rec)
            s = rec.get("status")
            extra = (f"bottleneck={rec.get('bottleneck')}" if s == "ok"
                     else rec.get("reason", rec.get("error", "")))
            print(f"== {arch_id:16s} {shape:14s} {rec['mesh']:6s} {s:8s} {extra}", flush=True)
    if pool is not None:
        pool.shutdown()
    n_ok = sum(r.get("status") == "ok" for r in results)
    n_skip = sum(r.get("status") == "skipped" for r in results)
    n_err = sum(r.get("status") == "error" for r in results)
    print(f"dryrun: wall {time.time() - t0:.1f}s, records in {os.path.abspath(args.out)}")
    print(f"DRYRUN SUMMARY: ok={n_ok} skipped={n_skip} errors={n_err}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
