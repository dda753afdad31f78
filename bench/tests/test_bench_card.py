"""On the card: a small run through the CUDA kernels is correct and
launches the hop kernels.  ``python -m pytest -q -m gpu bench/tests``"""
import time

import pytest
import torch

from bench import harness as H
from bench.lib import spec as SP
from bench.tests.bench_cells import small_cell

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    if torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("cell", ["fs100k.static.closed64", "zd100k.interval.closed1"])
def test_small_run_on_the_card(dev, cell):
    w = small_cell(cell, persons=100, rate=200.0)
    line = H.run_cell(w, SP.benchmark(), 11, 2.0, True, dev, time.perf_counter())
    assert line["correct"] is True, line["checks"]
    launches = line["launches"]
    if cell == "zd100k.interval.closed1":
        assert launches["fused_hop_interval"] > 0 and launches["scatter_cols"] > 0
    else:
        assert launches["fused_hop_cols"] > 0 and launches["scatter_cols"] > 0
    assert line["device"]["busy_s"] > 0
