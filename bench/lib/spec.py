"""The benchmark's data files, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell names a
configuration (``bench/configs/<config>.json``, the file ``configs`` points
at) and a traffic mix (``bench/traffic/<mix>.json``); the limits its check
holds answers to are in ``bench/checks/<cell>.json``; every metric is read by
``bench/metrics/<metric>.py``, a module with ``read(run)`` that returns a
number, or None when the run holds nothing to read.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench"


def _load(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return _load(ROOT / "BENCHMARK.json")


def cell(name: str, bench: Dict = None, entry: Dict = None) -> Dict:
    """A cell with its ``config``, ``mix`` and ``limits`` loaded; ``entry``
    stands for a ``workloads`` entry that ``BENCHMARK.json`` does not hold
    (a cell whose files wait for a later benchmark)."""
    bench = bench or benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if entry is None and name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = dict(entry or cells[name])
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    w["config_spec"] = _load(ROOT / cfg["file"])
    w["mix"] = _load(BENCH / "traffic" / f"{w['traffic']}.json")
    w["limits"] = _load(BENCH / "checks" / f"{name}.json")
    return w


def metrics_for(name: str, kind: str, bench: Dict = None) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    bench = bench or benchmark()
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def reader(metric: str) -> Callable:
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
