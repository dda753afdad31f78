"""The shape of a run's last line, and the refusals before any run."""
import ast
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from bench import harness as H
from bench.lib import spec as SP
from bench.tests.bench_cells import small_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(trace):
    w = small_cell("fs100k.static.closed64", persons=20)
    line = H.run_cell(w, SP.benchmark(), 2**31 + 7, 1.5, bool(trace),
                      torch.device("cpu"), time.perf_counter())
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in SP.metrics_for(w["name"], kind)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(line))


def _run_py(args, cwd, env_extra=None):
    env = {"PATH": "/usr/bin:/bin", "HOME": str(cwd), "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300, env=env)


def test_no_card_no_result():
    r = _run_py(["bench/run.py", "--workload", "fs100k.static.closed64", "--seed", "1",
                 "--seconds", "1", "--trace", "0"], ROOT)
    assert r.returncode != 0 and r.stdout.strip() == ""
    assert "CUDA device" in r.stderr


def test_padded_sizes():
    assert H.padded_sizes(1) == [1]
    assert H.padded_sizes(8) == [1, 2, 4, 8]
    assert H.padded_sizes(12) == [1, 2, 4, 8, 16]


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert "repro" not in H.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in H.forbidden_modules()


def test_jax_loaded_by_a_reader_means_no_line(monkeypatch, tmp_path):
    """A metric reader (a file later cells add) that loads a module named
    ``jax`` after the window has closed: the run prints no result."""
    (tmp_path / "jax.py").write_text("STUB = True\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    real = SP.reader

    def loading(name):
        read = real(name)

        def read_and_load(run):
            importlib.import_module("jax")   # the stub above
            return read(run)
        return read_and_load

    monkeypatch.setattr(SP, "reader", loading)
    w = small_cell("fs100k.static.closed64", persons=20)
    try:
        line = H.run_cell(w, SP.benchmark(), 5, 1.0, False, torch.device("cpu"),
                          time.perf_counter())
    finally:
        sys.modules.pop("jax", None)
    assert line is None


def test_bench_imports_no_jax():
    """No module under bench/ imports jax, jaxlib, flax, the JAX package
    (``repro``) or the JAX package's benchmarks, by whole top-level name;
    the reference imports nothing of the program either."""
    banned = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    for path in sorted((ROOT / "bench").rglob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not banned.intersection(tops), (path, tops)
            if "ref" in path.parts:
                assert "repro_torch" not in tops, (path, tops)
