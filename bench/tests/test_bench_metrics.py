"""Every metric reader on a hand-made run record."""
import math

import pytest

from bench.lib import loop as LP
from bench.lib import spec as SP


def _row(n_real, service_s, event_ms=None, predicted_ms=0.0):
    return dict(template="Q1", engine="sliced", split=0, impl="cuda", n_real=n_real,
                n_pad=0, service_s=service_s, event_ms=event_ms,
                predicted_ms=predicted_ms, exec_cached=True)


def _run(trace=None, event=True):
    win = LP.Window(t0=100.0, seconds=2.0)
    # two flushes: 3 queries in 0.5 s (dispatches 0.2 + 0.1 s), 1 in 0.25 s
    win.flushes = [
        dict(start=100.0, end=100.5, n=3,
             dispatches=[_row(2, 0.2, 150.0 if event else None, 100.0),
                         _row(1, 0.1, 80.0 if event else None, 120.0)]),
        dict(start=101.0, end=101.25, n=1,
             dispatches=[_row(1, 0.2, 190.0 if event else None, 190.0)]),
    ]
    for i, (due, done) in enumerate([(100.0, 100.5), (100.1, 100.5), (100.2, 100.5),
                                     (100.9, 101.25), (100.95, 101.25)]):
        win.due[i], win.done[i] = due, done
        win.status[i] = "done" if i < 4 else "failed"
    win.t_last = 101.25
    win.wake_late_s = [0.001, 0.002, 0.0005]
    return dict(window=win, setup=dict(gen_s=1.0, tables_s=2.0, server_s=3.0, warm_s=4.0),
                setup_s=12.5, trace=trace,
                launches=dict(fused_hop_cols=6, fused_hop_interval=0, scatter_cols=2,
                              scatter_extremum=0))


def _trace():
    return dict(busy_s=0.3, window_s=1.2, flushes=(1, 2), idle_gaps=[],
                kernels=[("void narrow_kernel<LoadState<4>, false, 4>(...)", 0.004, 3),
                         ("interval_warp_kernel<17, false>(IntervalArgs)", 0.002, 1),
                         ("void at::native::vectorized_elementwise_kernel<...>", 0.1, 9),
                         ("Memcpy DtoH (Device -> Pageable)", 0.05, 2)])


def read(name, run):
    return SP.reader(name)(run)


def test_end_to_end():
    run = _run()
    lat = sorted([500.0, 400.0, 300.0, 350.0])       # the four answered
    assert read("query_p50_ms", run) == pytest.approx((350 + 400) / 2)
    p95 = lat[2] + 0.85 * (lat[3] - lat[2])
    assert read("query_p95_ms", run) == pytest.approx(p95)
    assert read("queries_per_s", run) == pytest.approx(4 / 1.25)
    assert read("setup_s", run) == 12.5


def test_server_and_planner():
    run = _run()
    # host: (0.5 - 0.3) + (0.25 - 0.2) = 0.25 s over 4 queries
    assert read("server.host_ms_per_query", run) == pytest.approx(62.5)
    assert read("server.mean_batch", run) == pytest.approx(4 / 3)
    err = (50 / 150 + 40 / 80 + 0 / 190) / 3
    assert read("planner.pred_abs_rel_err", run) == pytest.approx(err)
    assert read("executor.event_ms_per_query", run) == pytest.approx(420 / 4)
    assert read("kernels.hop_launches_per_query", run) == pytest.approx(8 / 4)
    assert read("client.gen_late_ms", run) == pytest.approx(
        1.0 + 0.9 * (2.0 - 1.0))


def test_trace_readers():
    run = _run(trace=_trace())
    # hop kernels 6 ms over the traced flush's 1 query
    assert read("kernels.hop_ms_per_query", run) == pytest.approx(6.0)
    assert read("device.idle_share", run) == pytest.approx(0.75)


def test_setup_readers():
    run = _run()
    assert read("setup.tables_s", run) == 2.0
    assert read("setup.server_s", run) == 3.0
    assert read("setup.warm_s", run) == 4.0


def test_nothing_to_read_reads_nothing():
    run = _run(event=False)
    for name in ("planner.pred_abs_rel_err", "executor.event_ms_per_query",
                 "kernels.hop_ms_per_query", "device.idle_share"):
        assert read(name, run) is None
    run["window"].wake_late_s = []
    assert read("client.gen_late_ms", run) is None
    empty = _run()
    empty["window"] = LP.Window(t0=0.0, seconds=1.0)
    for name in ("query_p95_ms", "query_p50_ms", "queries_per_s",
                 "server.host_ms_per_query", "server.mean_batch"):
        assert read(name, empty) is None


def test_every_metric_has_a_reader():
    bench = SP.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(SP.reader(m["name"]))
    assert not math.isnan(read("setup_s", _run()))
