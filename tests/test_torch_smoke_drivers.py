"""The port's developer drivers (``scripts/torch_smoke_{engine,workload}.py``,
``scripts/torch_perf_iterations.py``) on the CPU.

smoke_engine: the reference's and the port's drivers in one process; every
printed line (the got/part/want lines among them) must be equal and both
must pass.  smoke_workload: the port's driver passes; its oracle is the
port's ``RefEngine``, which ``test_torch_engine.py`` holds to the
reference's.  perf_iterations: llama3-405b decode_32k's baseline record
equals ``launch.dryrun.run_cell``'s on the single mesh; the rungs whose
knob has no counterpart say so; the granite rungs, dense and type-sliced,
count on ``meta``.  Without ``--device cpu`` the smoke drivers raise on a
host with no GPU."""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str):
    path = ROOT / rel
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_engine_prints_the_reference_lines(capsys):
    _load("scripts/smoke_engine.py").main()
    want = capsys.readouterr().out.splitlines()
    _load("scripts/torch_smoke_engine.py").main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert want[-1] == "ALL SMOKE CHECKS PASSED"
    # q1-q3 at 3 splits and q4 interval at 2 with got/part/want; q4 bucket at 2
    assert sum(" part=" in ln for ln in want) == 11
    assert sum(ln.startswith("q4 bucket split=") for ln in want) == 2


def test_smoke_workload_passes():
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "torch_smoke_workload.py"),
                          "--device", "cpu"], capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines[-1] == "WORKLOAD SMOKE PASSED"
    assert sum(ln.startswith("  scheduler[") and ln.endswith("counts OK") for ln in lines) == 6
    # a plan line per query of the static and the dynamic graph's workload
    n_queries = [int(ln.rsplit(", ", 1)[1].split()[0]) for ln in lines if ln.startswith("--- ")]
    assert len(n_queries) == 2
    assert sum(ln.startswith("Q") and "plan=" in ln for ln in lines) == sum(n_queries)


@pytest.fixture(scope="module")
def ladder():
    return _load("scripts/torch_perf_iterations.py")


KEYS = ("flops_by_dtype", "hlo_flops", "hlo_bytes", "collective_bytes", "coll_by_kind",
        "t_compute", "t_memory", "t_collective", "bottleneck", "model_flops",
        "useful_flops_frac", "memory_per_device", "kernel_regions", "chips")


def test_perf_baseline_equals_the_dry_run_record(ladder, tmp_path, capsys):
    mesh = make_production_mesh(multi_pod=False)
    rung = ladder.LM_LADDER["llama"][0]
    assert rung[:3] == ("llama3-405b", "decode_32k", "it0_baseline")
    got = ladder.lm_iter(*rung, mesh, out_dir=tmp_path / "ladder")
    line = capsys.readouterr().out
    want, = dryrun.run_cell("llama3-405b", "decode_32k", ("single",), out_dir=tmp_path / "dry")
    assert got["status"] == want["status"] == "ok"
    assert {k: got[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert got["flops_by_dtype"]["bf16"] > 0 and got["hlo_bytes"] > 0
    on_disk = json.loads((tmp_path / "ladder" / f"{got['tag']}.json").read_text())
    assert {k: on_disk[k] for k in KEYS} == {k: want[k] for k in KEYS}
    assert line.startswith(f"[{got['tag']}] tc=") and f"bott={want['bottleneck']}" in line


@pytest.mark.parametrize("group,index,knob", [("llama2", 0, "decode_kv_constraint"),
                                              ("mixtral", 1, "moe_group_map")])
def test_rungs_without_a_counterpart_say_so(ladder, group, index, knob, tmp_path, capsys):
    rung = ladder.LM_LADDER[group][index]
    rec = ladder.lm_iter(*rung, make_production_mesh(multi_pod=False), out_dir=tmp_path)
    out = capsys.readouterr().out
    assert rec["status"] == "no counterpart" and knob in rec["reason"]
    assert out.startswith(f"[{rec['tag']}] no counterpart: {knob}=")
    # the later rungs keep their other overrides and name the knob they drop
    for later in ladder.LM_LADDER[group][index + 1:] + ladder.LM_LADDER.get(group + "2", []):
        overrides, dropped = later[3], later[4]
        if knob == "moe_group_map":
            assert overrides and "gqa_native" in overrides and knob in dropped
        assert knob not in overrides


def test_granite_rungs_count_dense_and_sliced(ladder, tmp_path, capsys):
    recs = ladder.main(["granite", "--out", str(tmp_path)])
    lines = capsys.readouterr().out.splitlines()
    assert [r["tag"].split("__", 1)[1] for r in recs] == [
        "q3hop_etr__it0_baseline", "q3hop_etr__it1_sliced",
        "warp_2hop__it0_baseline", "warp_2hop__it1_sliced"]
    assert all(r["status"] == "ok" for r in recs), [r.get("error") for r in recs]
    for dense, sliced in (recs[:2], recs[2:]):
        # the sliced plan reads only its types' slices of the same arguments
        assert 0 < sliced["hlo_bytes"] < dense["hlo_bytes"]
        assert (sliced["memory_per_device"]["argument_bytes"]
                == dense["memory_per_device"]["argument_bytes"])
    assert len([ln for ln in lines if ln.startswith("[granite-ldbc__")]) == 4


@pytest.mark.parametrize("script", ["torch_smoke_engine.py", "torch_smoke_workload.py"])
def test_smoke_driver_raises_without_a_gpu(script):
    if torch.cuda.is_available():
        pytest.skip("the check is of a host with no GPU")
    proc = subprocess.run([sys.executable, str(ROOT / "scripts" / script)],
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr, proc.stderr[-1000:]
    assert "graph:" not in proc.stdout and "---" not in proc.stdout
