"""The serving runtime on the port's partitioned engine, on the CPU.

* **Real dispatch.**  The serving leg of the conformance matrix on the
  partitioned engine (``conformance.serving_engines``: the case's first
  worker count at smoke scale): a same-shape batch dispatched as ONE group
  equals the sequential partitioned calls, field by field, on both impls;
  and the JAX scheduler's partitioned aggregate group equals the port's.
* **Virtual clock** (``serving_parity``): the worker-loss fallback (a lost
  partition worker re-plans the unit dense, the path stays down until a
  probe), a traced partitioned drain (the exchange spans carry the
  partitioner's channel volumes) and a planner-costed partitioned replay run
  in both packages and observe the same decisions, dispatches, counters and
  spans, floats included.
* **The CLI**: ``--engine partitioned --serve --verify`` on the CPU.
"""
import dataclasses

import numpy as np
import pytest

import conformance as C
import serving_parity as SP
from serving_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.graphdata.queries import make_workload as j_make_workload
from repro.serving import BatchScheduler as JBatchScheduler
from repro_torch import interop
from repro_torch.core import engine_partitioned as TEP
from repro_torch.graphdata import ldbc as TL
from repro_torch.launch import query as TLQ
from repro_torch.serving import BatchScheduler

FIELDS = ("total", "per_vertex", "minmax")
CASE_NAMES = ["plain-2hop", "plain-bidir", "etr-before", "etr-overlaps",
              "agg-count", "agg-min", "agg-max", "agg-min-2hop", "etr-agg-count",
              "empty-result", "single-vertex"]


@pytest.fixture(scope="module")
def dyn(small_dynamic_graph):
    return interop.graph_from_arrays(small_dynamic_graph)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    return C.case_matrix(small_dynamic_graph)


@pytest.fixture(scope="module")
def graphs(medium_static_graph):
    return {"ref": medium_static_graph,
            "port": TL.generate_ldbc(TL.LdbcParams(n_persons=200, seed=9, dynamic=False))}


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("name", CASE_NAMES)
def test_partitioned_serving_leg_batched_equals_sequential(dyn, matrix, name, mode):
    case = matrix[name]
    queries = [interop.query_from_dict(dataclasses.asdict(q))
               for q in C.perturbed_batch(case.qry, 3)]
    engines = [e for e in C.serving_engines(case) if e[0] == "partitioned"]
    assert engines
    for _, w in engines:
        for impl in ("torch", "cuda"):
            ctx = (name, mode, w, impl)
            sched = BatchScheduler(dyn, engine="partitioned", mode=mode,
                                   n_buckets=C.N_BUCKETS, n_workers=w,
                                   keep_outputs=True, impl=impl, device="cpu")
            res = sched.run(queries)
            assert len(sched.last_dispatches) == 1, ctx
            disp = sched.last_dispatches[0]
            assert disp.engine == "partitioned" and disp.n_real == len(queries), ctx
            eff_mode = sched._mode_for(queries[0])
            for q, r in zip(queries, res):
                out = TEP.execute(dyn, q, split=r.split, mode=eff_mode,
                                  n_buckets=C.N_BUCKETS, n_workers=w, impl=impl,
                                  device="cpu")
                for f in FIELDS:
                    want, got = getattr(out, f), getattr(r, f)
                    assert (want is None) == (got is None), (ctx, f)
                    if want is not None:
                        assert np.array_equal(want.numpy(), got), (ctx, f)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_aggregate_partitioned_group_equals_reference(small_dynamic_graph, dyn, impl):
    """An aggregate group on the partitioned engine dispatches as one group,
    with the JAX scheduler's splits, totals and per-vertex states."""
    wl = j_make_workload(small_dynamic_graph, templates=("Q3",), n_per_template=4,
                         seed=6, aggregate=True)
    ref = JBatchScheduler(small_dynamic_graph, engine="partitioned", n_workers=2,
                          keep_outputs=True)
    ref_res = ref.run(wl)
    sched = BatchScheduler(dyn, engine="partitioned", n_workers=2, keep_outputs=True,
                           impl=impl, device="cpu")
    res = sched.run([dataclasses.replace(i, qry=interop.query_from_dict(
        dataclasses.asdict(i.qry))) for i in wl])
    assert len(sched.last_dispatches) == 1
    assert sched.last_dispatches[0].engine == "partitioned"
    assert sched.last_dispatches[0].n_real == 4
    for a, b in zip(ref_res, res):
        assert (a.split, a.count, a.engine) == (b.split, b.count, b.engine)
        assert np.array_equal(np.asarray(a.total), b.total)
        assert np.array_equal(np.asarray(a.per_vertex), b.per_vertex)


# ================================================================ virtual clock
def _sched(ns, graph, **kw):
    kw.setdefault("dispatcher", ns.FakeDispatcher(
        service_model=ns.constant_service_model(1e-3)))
    kw.setdefault("retry", ns.RetryPolicy())
    return ns.BatchScheduler(graph, **kw)


def sc_worker_loss_falls_back_dense_then_probes(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=4, seed=26)
    expect = [ns.fake_count(i.qry) for i in wl]
    mx = ns.MetricsRegistry()
    sched = _sched(ns, g, engine="partitioned", metrics=mx,
                   retry=ns.RetryPolicy(probe_after=2),
                   fault_plan=ns.FaultPlan(schedule={"worker": {0}}))
    obs = []
    res1 = sched.run(wl)                      # worker dies mid-dispatch
    assert [r.engine for r in res1] == ["dense"] * len(wl)
    assert [r.count for r in res1] == expect
    assert sched.last_dispatches[0].fallback_from == "partitioned"
    assert not sched.fault_report()["partitioned_available"]
    obs.append((SP.results(res1), SP.dispatches(sched), SP.fault_report(sched)))
    res2 = sched.run(wl)                      # down window: no probe yet
    assert [r.engine for r in res2] == ["dense"] * len(wl)
    assert not sched.fault_report()["partitioned_available"]
    obs.append((SP.results(res2), SP.dispatches(sched), SP.fault_report(sched)))
    res3 = sched.run(wl)                      # probe fires and succeeds
    assert [r.engine for r in res3] == ["partitioned"] * len(wl)
    assert [r.count for r in res3] == expect
    assert sched.fault_report()["partitioned_available"]
    deg = mx.counter("granite_degraded_dispatches_total", labelnames=("reason",))
    assert deg.value(reason="worker-loss") == 1
    assert deg.value(reason="path-down") == 1
    obs.append((SP.results(res3), SP.dispatches(sched), SP.fault_report(sched)))
    return obs, mx.snapshot()


def sc_partitioned_spans_carry_exchange_volumes(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=44)
    wl += ns.make_workload(g, templates=("Q4",), n_per_template=2, seed=45,
                           aggregate=True)
    tr = ns.Tracer(clock=ns.StepClock())
    sched = _sched(ns, g, engine="partitioned", n_workers=4, tracer=tr)
    res = sched.run(wl)
    ex = [r for r in tr.records() if r["name"] == "exchange"]
    assert ex and any(r["attrs"]["state"] > 0 for r in ex)
    return tr.records(), SP.results(res), SP.dispatches(sched)


def sc_partitioned_planner_costed_replay(ns, g):
    wl = ns.make_workload(g, templates=("Q1", "Q2", "Q4"), n_per_template=3, seed=46)
    probe = _sched(ns, g, engine="partitioned", n_workers=2)
    sched = _sched(ns, g, engine="partitioned", n_workers=2,
                   telemetry=ns.TelemetryBuffer(refit_every=4, min_samples=4),
                   dispatcher=ns.FakeDispatcher(service_model=ns.planner_service_model(
                       probe._planner_for("partitioned").coeffs)))
    rep = ns.replay_workload(sched, wl, rate_qps=200.0, seed=47, mode="open")
    return SP.report(rep), SP.dispatches(sched), sched.slo_report()


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_worker_loss_falls_back_dense_then_probes,
    sc_partitioned_spans_carry_exchange_volumes,
    sc_partitioned_planner_costed_replay)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_partitioned_scenario_matches_reference(graphs, name):
    SP.assert_same(SCENARIOS[name], graphs)


def test_cli_partitioned_serves_and_verifies_on_the_cpu(capsys):
    TLQ.main(["--device", "cpu", "--persons", "300", "--queries", "2",
              "--engine", "partitioned", "--workers", "4", "--serve", "--verify"])
    out = capsys.readouterr().out
    assert "verification vs oracle: OK" in out
    assert "avg latency per template:" in out
