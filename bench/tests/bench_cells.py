"""Shared helpers of the benchmark's tests: small cells (the benchmark's own
files, cut to a few dozen persons) and the import path of the program.

Run the tests from the root of the checkout:
``PYTHONPATH=src python -m pytest -q bench/tests``; the tests marked ``gpu``
run on the card with ``-m gpu``."""
import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from bench.gen import ldbc as G  # noqa: E402
from bench.lib import spec as SP  # noqa: E402


#: cells whose files are kept for a later benchmark, not in BENCHMARK.json
LATER = {"zd100k.bucket.open": dict(
    name="zd100k.bucket.open", config="ldbc-snb-100k-zipf-dynamic",
    traffic="q1-q8-bucket-open", chips=1)}


def small_cell(name: str, persons: int = 20, rate: float = 20.0) -> dict:
    w = copy.deepcopy(SP.cell(name, entry=LATER.get(name)))
    w["config_spec"]["n_persons"] = persons
    if w["mix"]["loop"] == "open":
        w["mix"]["rate_qps"] = rate
    return w


def small_graph(persons: int = 400, dist: str = "zipf", dynamic: bool = True,
                seed: int = 3) -> G.GraphData:
    return G.generate(G.LdbcParams(n_persons=persons, degree_dist=dist, dynamic=dynamic),
                      np.random.default_rng(seed))
