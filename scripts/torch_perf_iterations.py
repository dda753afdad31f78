"""The roofline ladder of the PyTorch port: baseline and optimised iterations
of three cells, each traced on the ``meta`` device and counted by the port's
dry run on the single-pod mesh.  The counterpart of ``perf_iterations.py``.

Cells and their rungs (the reference's):
  1. llama3-405b × decode_32k  — baseline, gqa_native, decode_kv_constraint,
     kv_cache_quant
  2. mixtral-8x22b × train_4k  — baseline, moe_group_map='scan', gqa_native,
     remat_inner
  3. granite-ldbc × q3hop_etr and warp_2hop — the dense plan against the
     type-sliced one (synthetic slice bounds at 100k:F scale)

Each LM rung is ``configs.common.lm_cell`` of the config with the rung's
overrides, counted by ``roofline.analysis.count_program`` and reported by
``analyze_counts`` at the H100's peaks, beside ``launch.dryrun.
model_flops_for``.  A rung whose knob the port does not have (an XLA
sharding constraint or a ``lax.scan`` choice) prints ``no counterpart:
<reason>``; a later rung that inherits such a knob keeps its other
overrides and records the knob it dropped.  Nothing here touches a card:
every tensor is on ``meta``, so it runs on any host.

One JSON record an iteration goes to ``--out`` (default
``build/perf_iterations/<arch>__<shape>__<iteration>.json``) and one line
to stdout: the compute, memory and collective terms in ms, the bottleneck,
and the argument and temp bytes a device (temp: none on ``meta``, which has
no buffer assignment).

    PYTHONPATH=src python scripts/torch_perf_iterations.py [all|llama|llama2|llama3|mixtral|mixtral2|granite]
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.configs import common, load_arch  # noqa: E402
from repro_torch.configs import granite_ldbc as GL  # noqa: E402
from repro_torch.launch.dryrun import model_flops_for  # noqa: E402
from repro_torch.launch.mesh import P, make_production_mesh  # noqa: E402
from repro_torch.roofline.analysis import analyze_counts, count_program  # noqa: E402

OUT = ROOT / "build" / "perf_iterations"
MESH = "single"

#: the reference's rung knobs that the port's TransformerCfg does not have
NO_COUNTERPART = {
    "decode_kv_constraint": "an XLA sharding constraint on the decode step's KV cache "
                            "(with_sharding_constraint); the port runs eager ops on one "
                            "card and its cells carry the cache's specs as they are",
    "moe_group_map": "the choice between vmap and lax.scan over the MoE token groups; "
                     "the port maps every group at once, always",
}

#: group -> rungs: (arch, shape, iteration, the port's overrides or None
#: where the rung's own knob has no counterpart, the reference's overrides
#: that have none)
LM_LADDER = {
    "llama": [
        ("llama3-405b", "decode_32k", "it0_baseline", {}, {}),
        ("llama3-405b", "decode_32k", "it1_gqa_native", dict(gqa_native=True), {}),
    ],
    "llama2": [
        ("llama3-405b", "decode_32k", "it2_kv_constraint", None,
         dict(decode_kv_constraint="dh")),
    ],
    "llama3": [
        ("llama3-405b", "decode_32k", "it3_kv_quant",
         dict(gqa_native=True, kv_cache_quant=True), {}),
    ],
    "mixtral": [
        ("mixtral-8x22b", "train_4k", "it0_baseline", {}, {}),
        ("mixtral-8x22b", "train_4k", "it1_moe_scan", None, dict(moe_group_map="scan")),
        ("mixtral-8x22b", "train_4k", "it2_gqa_native", dict(gqa_native=True),
         dict(moe_group_map="scan")),
    ],
    "mixtral2": [
        ("mixtral-8x22b", "train_4k", "it3_remat_inner",
         dict(gqa_native=True, remat_inner=True), dict(moe_group_map="scan")),
    ],
}
GROUPS = ("llama", "llama2", "llama3", "mixtral", "mixtral2", "granite")


def _gb(x) -> str:
    return "none" if x is None else f"{x / 1e9:.1f}GB"


def _write(out_dir: Path, rec: dict) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{rec['tag']}.json").write_text(json.dumps(rec, indent=2))
    return rec


def _where(exc: BaseException) -> str:
    """The innermost frame of the port's own code in ``exc``'s traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__) if "repro_torch" in f.filename]
    if not frames:
        return "outside the port"
    f = frames[-1]
    return f"{Path(f.filename).relative_to(ROOT)}:{f.lineno} {f.name}: {f.line}"


def record(tag: str, arch: str, shape: str, cell, mesh, model_flops=None,
           out_dir: Path = OUT, **extra) -> dict:
    """Count ``cell`` on ``meta``, write its record and print its line; a
    cell that cannot be traced is recorded as an error with the op that
    stopped it."""
    t0 = time.time()
    try:
        counts, output = count_program(cell.fn, cell.args, return_output=True)
    except Exception as e:  # noqa: BLE001  (a failing rung is a finding: record it loudly)
        rec = dict(tag=tag, arch=arch, shape=shape, mesh=MESH, status="error",
                   error=f"{type(e).__name__}: {e}", at=_where(e), **extra)
        print(f"[{tag}] error: {rec['error'].splitlines()[0]} (at {rec['at']})", flush=True)
        return _write(out_dir, rec)
    rep = analyze_counts(counts, cell, mesh, arch, shape, MESH, model_flops=model_flops,
                         output=output)
    rec = rep.to_json()
    rec.update(tag=tag, status="ok", t_trace_s=counts.seconds, t_record_s=time.time() - t0,
               **extra)
    m = rec["memory_per_device"]
    dropped = "".join(f" (the reference's {k}={v!r}: no counterpart)"
                      for k, v in extra.get("dropped", {}).items())
    print(f"[{tag}] tc={rec['t_compute']*1e3:.2f}ms tm={rec['t_memory']*1e3:.2f}ms "
          f"tx={rec['t_collective']*1e3:.2f}ms bott={rec['bottleneck']} "
          f"temp={_gb(m['temp_bytes'])} arg={_gb(m['argument_bytes'])}{dropped}", flush=True)
    return _write(out_dir, rec)


def no_counterpart(tag: str, arch: str, shape: str, knobs: dict, out_dir: Path = OUT) -> dict:
    reason = "; ".join(f"{k}={v!r}: {NO_COUNTERPART[k]}" for k, v in knobs.items())
    print(f"[{tag}] no counterpart: {reason}", flush=True)
    return _write(out_dir, dict(tag=tag, arch=arch, shape=shape, mesh=MESH,
                                status="no counterpart", reason=reason))


# ---------------------------------------------------------------- LM cells
def lm_iter(arch_id: str, shape: str, itname: str, overrides, dropped, mesh,
            out_dir: Path = OUT) -> dict:
    tag = f"{arch_id}__{shape}__{itname}"
    if overrides is None:
        return no_counterpart(tag, arch_id, shape, dropped, out_dir)
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    cfg = dataclasses.replace(mod.CONFIG, **overrides)
    cell = common.lm_cell(cfg, shape, mesh)
    mf = model_flops_for(arch_id, shape, load_arch(arch_id))
    return record(tag, arch_id, shape, cell, mesh, model_flops=mf, out_dir=out_dir,
                  overrides=overrides, dropped=dropped)


# ------------------------------------------------------------ granite cells
def slice_bounds():
    """Synthetic type-sliced bounds at 100k:F scale: the reference's
    fractions of V (person, post, comment, forum) and of the traversal
    arrivals (paper Table 4's arrival mix)."""
    from repro_torch.core import engine_sliced as ES

    V, E2 = GL.V_FULL, 2 * GL.E_FULL
    fr_v = [0.002, 0.243, 0.736, 0.019]
    fr_e = [0.20, 0.35, 0.40, 0.05]
    v_bounds, e_bounds = [], []
    va = ea = 0
    for i, (fv, fe) in enumerate(zip(fr_v, fr_e)):
        vb = V if i == 3 else int(va + fv * V)
        eb = E2 if i == 3 else int(ea + fe * E2)
        v_bounds.append((va, vb))
        e_bounds.append((ea, eb))
        va, ea = vb, eb
    return ES.SliceBounds(tuple(v_bounds), tuple(e_bounds))


def granite_sliced_cell(shape_name: str, mesh) -> common.ShapeCell:
    """Type-sliced variant of a granite dry-run cell: ``granite_ldbc._cell``'s
    arguments and specs, the plan through ``engine_sliced.execute_plan_sliced``
    with ``impl='torch'``."""
    from repro_torch.core import engine_sliced as ES
    from repro_torch.core import query as Q

    sb = slice_bounds()
    info = GL.SHAPES[shape_name]
    qry = info["qf"]()
    split, mode = info["split"], info["mode"]
    n_buckets = 16
    V, E2 = GL.V_FULL, 2 * GL.E_FULL

    def run(gdev, params, bedges):
        # the port's plan runs a batch of queries: this one as a batch of 1
        out = ES.execute_plan_sliced(gdev, qry, split, mode, n_buckets, params[None],
                                     bedges, sb, impl="torch")
        if info["agg"]:
            return out.total[0], out.per_vertex[0]
        return out.total[0]

    if info["agg"]:
        # per-vertex output lives on the first type's slice: replicated
        out_specs = (P(), P(None) if mode == 0 else P(None, None))
    else:
        out_specs = P() if mode == 0 else P(None)
    return common.ShapeCell(
        run, (GL._gdev_sds(V, E2, n_buckets),
              common.sds(Q.query_params(qry).shape, torch.int32),
              common.sds((n_buckets + 1,), torch.int32)),
        (GL._gdev_shardings(mesh, V, E2), P(None, None), P(None)),
        out_specs, "query", note=f"split={split} mode={mode} sliced",
        analytic_flops=GL.analytic_flops(shape_name))


def granite(mesh, out_dir: Path = OUT) -> list:
    spec = load_arch("granite-ldbc")
    recs = []
    for shape in ("q3hop_etr", "warp_2hop"):
        recs.append(record(f"granite-ldbc__{shape}__it0_baseline", "granite-ldbc", shape,
                           spec.shapes[shape](mesh), mesh, out_dir=out_dir))
        recs.append(record(f"granite-ldbc__{shape}__it1_sliced", "granite-ldbc", shape,
                           granite_sliced_cell(shape, mesh), mesh, out_dir=out_dir))
    return recs


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("which", nargs="?", default="all", choices=("all",) + GROUPS)
    ap.add_argument("--out", default=str(OUT), help="directory of the JSON records")
    args = ap.parse_args(argv)
    out_dir = Path(args.out)
    mesh = make_production_mesh(multi_pod=False)
    titles = {"llama": "=== cell 1: llama3-405b decode_32k ===",
              "mixtral": "=== cell 2: mixtral-8x22b train_4k ===",
              "granite": "=== cell 3: granite-ldbc q3hop_etr (+ warp_2hop) ==="}
    recs = []
    for group in GROUPS:
        if args.which not in ("all", group):
            continue
        if group in titles:
            print(titles[group], flush=True)
        if group == "granite":
            recs += granite(mesh, out_dir)
            continue
        for rung in LM_LADDER[group]:
            recs.append(lm_iter(*rung, mesh, out_dir=out_dir))
    return recs


if __name__ == "__main__":
    main()
