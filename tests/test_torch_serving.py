"""The port's serving runtime against the reference package's.

Three legs, all on the CPU:

* **Real dispatch.**  A mixed workload (every template, COUNT aggregates,
  MIN/MAX variants) through the port's ``BatchScheduler`` on
  ``impl='torch'`` and ``impl='cuda'`` (the kernels' plain versions on CPU
  tensors) gives ``np.array_equal`` totals, per-vertex states and extrema to
  the JAX ``BatchScheduler`` (``impl='xla'``), with the same groups, splits,
  batch sizes and cache behaviour; batched equals sequential on the
  conformance matrix (the serving leg of ``tests/conformance.py``, on the
  port's engines); steady state neither re-plans nor rebuilds.
* **Virtual clock.**  Every scenario of the reference's
  ``test_serving_slo.py``, ``test_serving_faults.py`` and
  ``test_serving_properties.py`` that needs no live graph (ROADMAP A8)
  runs through ``FakeDispatcher`` in both
  packages (``serving_parity``): the same admit/degrade/reject sequences,
  results, dispatches and counters, floats included.
* **The CLI and the device rule.**  ``python -m repro_torch.launch.query``
  on the CPU, its refusals, and the constructor's refusal without a GPU.
"""
import dataclasses
import math
import time
import types

import numpy as np
import pytest
import torch

import conformance as C
import serving_parity as SP
from serving_parity import one_torch_thread  # noqa: F401  (autouse)
from repro.graphdata.queries import make_workload as j_make_workload
from repro.graphdata.queries import to_minmax as j_to_minmax
from repro.serving import BatchScheduler as JBatchScheduler
from repro.serving import PlanCache as JPlanCache
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_sliced as TES
from repro_torch.graphdata import ldbc as TL
from repro_torch.graphdata.queries import QueryInstance
from repro_torch.launch import query as TLQ
from repro_torch.obs import StepClock
from repro_torch.serving import (AdmissionPolicy, BatchScheduler,
                                 ExecutableCache, PlanCache, TelemetryBuffer,
                                 compile_plan_tensor, graph_fingerprint,
                                 layout_signature, replay_workload)
from repro_torch.serving.compile import pad_batch_size
from repro_torch.serving.replay import FAILED

GRAPHS = {
    "small_static_graph": dict(n_persons=60, seed=3, dynamic=False),
    "small_dynamic_graph": dict(n_persons=40, seed=5, dynamic=True),
    "medium_static_graph": dict(n_persons=200, seed=9, dynamic=False),
}
FIELDS = ("total", "per_vertex", "minmax")


@pytest.fixture(scope="module")
def port_graph(request):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = TL.generate_ldbc(TL.LdbcParams(**GRAPHS[name]))
        return cache[name]
    return get


@pytest.fixture(scope="module")
def graphs(medium_static_graph, port_graph):
    return {"ref": medium_static_graph, "port": port_graph("medium_static_graph")}


def mixed_workload(ref_graph):
    """Reference instances: plain templates with and without ETR hops (Q8 on
    the dynamic graph only), three each so that batches pad, a COUNT
    aggregate, and the MIN and MAX variants of the ETR-free template (Q2)."""
    wl = j_make_workload(ref_graph, templates=("Q1", "Q2", "Q4", "Q8"),
                         n_per_template=3, seed=3)
    wl += j_make_workload(ref_graph, templates=("Q4",), n_per_template=2,
                          seed=4, aggregate=True)
    for op in (1, 2):
        wl += [j_to_minmax(i, ref_graph, op) for i in
               j_make_workload(ref_graph, templates=("Q2",), n_per_template=3,
                               seed=5)]
    return wl


def to_port(ref_workload):
    return [QueryInstance(i.template,
                          interop.query_from_dict(dataclasses.asdict(i.qry)),
                          dict(i.params)) for i in ref_workload]


# ========================================================== real dispatch
@pytest.fixture(scope="module")
def reference_runs(small_static_graph, small_dynamic_graph):
    """The JAX scheduler on each graph's mixed workload (keep_outputs)."""
    out = {}
    for name, g in (("small_static_graph", small_static_graph),
                    ("small_dynamic_graph", small_dynamic_graph)):
        wl = mixed_workload(g)
        sched = JBatchScheduler(g, keep_outputs=True)
        out[name] = (wl, sched.run(wl), sched.last_dispatches,
                     sched.cache_report())
    return out


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("name", ["small_static_graph", "small_dynamic_graph"])
def test_mixed_workload_equals_reference(reference_runs, port_graph, name, impl):
    wl, ref_res, ref_disp, ref_caches = reference_runs[name]
    g = port_graph(name)
    sched = BatchScheduler(g, keep_outputs=True, impl=impl, device="cpu")
    res = sched.run(to_port(wl))
    assert len(res) == len(ref_res) == len(wl)
    for a, b in zip(ref_res, res):
        ctx = (name, impl, a.template)
        assert b.status == a.status == "done" and b.ok and b.error == "", ctx
        assert (b.template, b.engine, b.split, b.batch_size, b.count) == \
            (a.template, a.engine, a.split, a.batch_size, a.count), ctx
        for f in FIELDS:
            want, got = getattr(a, f), getattr(b, f)
            assert (want is None) == (got is None), (ctx, f)
            if want is not None:
                assert np.array_equal(np.asarray(want), got), (ctx, f)
    assert [(d.key, d.engine, d.split, d.n_real, d.n_pad, d.indices,
             d.plan_cached, d.exec_cached) for d in sched.last_dispatches] == \
        [(d.key, d.engine, d.split, d.n_real, d.n_pad, d.indices,
          d.plan_cached, d.exec_cached) for d in ref_disp]
    assert {d.impl for d in sched.last_dispatches} == {impl}
    assert {d.event_ms for d in sched.last_dispatches} == {None}   # CPU
    assert sched.cache_report() == ref_caches
    # the host copy of per-vertex state is opt-in
    lean = BatchScheduler(g, impl=impl, device="cpu").run(to_port(wl))
    assert [r.count for r in lean] == [r.count for r in res]
    assert all(r.total is None and r.per_vertex is None and r.minmax is None
               for r in lean)


@pytest.fixture(scope="module")
def matrix(small_dynamic_graph):
    return C.case_matrix(small_dynamic_graph)


@pytest.mark.parametrize("mode", C.ALL_MODES)
@pytest.mark.parametrize("name", [
    "plain-2hop", "plain-bidir", "etr-before", "etr-overlaps", "agg-count",
    "agg-min", "agg-max", "agg-min-2hop", "etr-agg-count", "empty-result",
    "single-vertex"])
def test_serving_leg_batched_equals_sequential(matrix, port_graph, name, mode):
    """The conformance matrix's serving leg on the port: a same-shape batch
    through the scheduler, dispatched as ONE group on each engine and impl,
    is bit-identical to the sequential per-query loop."""
    g = port_graph("small_dynamic_graph")
    queries = [interop.query_from_dict(dataclasses.asdict(q))
               for q in C.perturbed_batch(matrix[name].qry, 3)]
    engines = ["dense"] + (["sliced"] if TES.sliceable(queries[0]) else [])
    for engine in engines:
        for impl in ("torch", "cuda"):
            ctx = (name, mode, engine, impl)
            sched = BatchScheduler(g, engine=engine, mode=mode,
                                   n_buckets=C.N_BUCKETS, keep_outputs=True,
                                   impl=impl, device="cpu")
            res = sched.run(queries)
            assert len(sched.last_dispatches) == 1, ctx
            disp = sched.last_dispatches[0]
            assert disp.engine == engine and disp.n_real == len(queries), ctx
            eff_mode = sched._mode_for(queries[0])
            for q, r in zip(queries, res):
                out = TE.execute(g, q, split=r.split, mode=eff_mode,
                                 n_buckets=C.N_BUCKETS,
                                 sliced=(engine == "sliced"), impl=impl,
                                 device="cpu")
                for f in FIELDS:
                    want, got = getattr(out, f), getattr(r, f)
                    assert (want is None) == (got is None), (ctx, f)
                    if want is not None:
                        assert np.array_equal(want.numpy(), got), (ctx, f)


def test_steady_state_no_replan_no_rebuild(medium_static_graph, port_graph):
    """Second flush of the same workload shape: every plan and executable
    lookup hits — and the counters equal the reference's."""
    wl = j_make_workload(medium_static_graph, templates=("Q2", "Q4"),
                         n_per_template=4, seed=3)
    g = port_graph("medium_static_graph")
    plan_cache, exec_cache = PlanCache(), ExecutableCache()
    first = BatchScheduler(g, plan_cache=plan_cache, exec_cache=exec_cache,
                           device="cpu").run(to_port(wl))
    assert plan_cache.stats.hits == 0
    p_miss, e_miss = plan_cache.stats.misses, exec_cache.stats.misses
    again = BatchScheduler(g, plan_cache=plan_cache, exec_cache=exec_cache,
                           device="cpu").run(to_port(wl))
    assert plan_cache.stats.misses == p_miss
    assert exec_cache.stats.misses == e_miss
    assert plan_cache.stats.hits > 0 and exec_cache.stats.hits > 0
    for a, b in zip(first, again):
        assert a.count == b.count and a.split == b.split
    # the reference's plan cache counts the same hits and misses
    jpc = JPlanCache()
    for _ in range(2):
        JBatchScheduler(medium_static_graph, plan_cache=jpc,
                        dispatcher=_NoEngine()).run(wl)
    assert (plan_cache.stats.as_dict(), len(plan_cache)) == \
        (jpc.stats.as_dict(), len(jpc))


class _NoEngine:
    """A dispatcher that answers zeros without an engine call: the
    reference's side of the plan-cache comparison."""

    def dispatch(self, sched, queries, split, mode, engine, impl, pt, warm):
        return types.SimpleNamespace(total=np.zeros(pt.params.shape[0]),
                                     per_vertex=None, minmax=None), 0.0


def test_failing_group_isolated(port_graph):
    """A group that cannot build (MIN forced onto the sliced engine) returns
    error results without dropping the other groups in the flush."""
    g = port_graph("medium_static_graph")
    from repro_torch.graphdata.queries import make_workload, to_minmax
    wl = make_workload(g, templates=("Q2",), n_per_template=3, seed=10)
    bad = to_minmax(wl[0], g)
    sched = BatchScheduler(g, engine="sliced", device="cpu")
    res = sched.run(wl + [bad])
    assert sched.queued == 0
    good, err = res[:3], res[3]
    assert all(r.ok and r.error == "" for r in good)
    assert not err.ok and err.status == "failed" and "sliceable" in err.error
    for inst, r in zip(wl, good):
        assert r.count == TE.count_results(g, inst.qry, split=r.split,
                                           device="cpu")


def test_slo_layer_and_tracer_leave_answers_bit_identical(port_graph):
    """Real dispatch: admission + telemetry + deadlines, a forced dense →
    sliced degrade, and the flight recorder never change an answer."""
    from repro_torch.graphdata.queries import make_workload
    from repro_torch.obs import MetricsRegistry, Tracer
    g = port_graph("small_static_graph")
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=27)
    plain = BatchScheduler(g, keep_outputs=True, device="cpu").run(wl, warm=True)
    slo = BatchScheduler(g, keep_outputs=True, device="cpu",
                         admission=AdmissionPolicy(headroom=1.0),
                         telemetry=TelemetryBuffer(refit=False))
    for inst in wl:
        slo.submit(inst, deadline_s=600.0, now=0.0)
    tr = Tracer(clock=StepClock())
    traced = BatchScheduler(g, engine="dense", keep_outputs=True, device="cpu",
                            tracer=tr, metrics=MetricsRegistry()).run(wl, warm=True)
    for a, b, c in zip(plain, slo.flush(warm=True), traced):
        assert a.ok and b.ok and c.ok
        assert np.array_equal(a.total, b.total)
        assert np.array_equal(a.total, c.total)
    assert len([r for r in tr.records() if r["name"] == "query"]) == len(wl)
    probe = BatchScheduler(g, engine="dense", device="cpu")
    deg = BatchScheduler(g, engine="dense", keep_outputs=True, device="cpu",
                         admission=AdmissionPolicy(
                             headroom=1.0, degrade_impls=(),
                             allow_engine_downgrade=True, sliced_discount=0.25,
                             degrade_max_batch=None))
    sl = [inst for inst in wl if TES.sliceable(inst.qry)]
    for inst in sl:
        deg.admission.on_flush()
        cost = probe._planner.estimate(inst.qry, inst.qry.n_vertices - 1,
                                       probe.impl).t_ms / 1e3
        assert deg.submit(inst, deadline_s=0.5 * cost, now=0.0).engine == "sliced"
    want = {id(inst): r for inst, r in zip(wl, plain)}
    for inst, r in zip(sl, deg.flush(warm=True)):
        assert r.ok and r.engine == "sliced"
        assert np.array_equal(r.total, want[id(inst)].total)


def test_real_dispatch_times_on_the_injected_clock(port_graph):
    """Every recorded dispatch time is exactly one clock step: the torch
    dispatch reads the injected clock, never the wall clock."""
    from repro_torch.graphdata.queries import make_workload
    g = port_graph("small_static_graph")
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=61)
    for impl in ("torch", "cuda"):
        sched = BatchScheduler(g, clock=StepClock(step=0.125), impl=impl,
                               device="cpu")
        assert all(r.ok for r in sched.run(wl, warm=True))
        assert sched.last_dispatches
        assert all(d.service_s == 0.125 for d in sched.last_dispatches)


def test_replay_failed_group_real_sliced_engine(port_graph):
    from repro_torch.graphdata.queries import make_workload, to_minmax
    g = port_graph("small_static_graph")
    wl = make_workload(g, templates=("Q2",), n_per_template=3, seed=17)
    bad = to_minmax(wl[0], g)
    sched = BatchScheduler(g, engine="sliced", device="cpu")
    rep = replay_workload(sched, wl + [bad], rate_qps=1000.0, seed=18, warm=True)
    assert rep.n_failed == 1 and rep.n_completed == 3
    assert rep.statuses[3] == FAILED and np.isnan(rep.latencies_ms[3])
    assert rep.completion_rate == 0.75


# ========================================================= host pieces
def test_compiler_and_fingerprint_equal_reference(medium_static_graph,
                                                  small_static_graph, port_graph):
    from repro.serving import compile_plan_tensor as j_compile
    from repro.serving import graph_fingerprint as j_fp
    assert [pad_batch_size(n) for n in (1, 2, 3, 4, 5, 8, 9)] == \
        [1, 2, 4, 4, 8, 8, 16]
    wl = j_make_workload(medium_static_graph, templates=("Q2",),
                         n_per_template=3, seed=1)
    a = j_compile([i.qry for i in wl])
    b = compile_plan_tensor([i.qry for i in to_port(wl)])
    assert np.array_equal(a.params, b.params) and b.params.dtype == np.int32
    assert (b.n_real, b.n_pad, b.key) == (a.n_real, a.n_pad, a.key)
    wl2 = j_make_workload(medium_static_graph, templates=("Q2", "Q4"),
                          n_per_template=1, seed=2)
    with pytest.raises(ValueError):
        compile_plan_tensor([i.qry for i in to_port(wl2)])
    for name, ref in (("medium_static_graph", medium_static_graph),
                      ("small_static_graph", small_static_graph)):
        assert graph_fingerprint(port_graph(name)) == j_fp(ref)
    assert graph_fingerprint(port_graph("small_static_graph")) != \
        graph_fingerprint(port_graph("medium_static_graph"))


def test_layout_signature_keys_the_kernels_launch_shapes(port_graph):
    from repro_torch.graphdata.queries import make_workload
    from repro_torch.kernels.common import lane_group
    g = port_graph("small_dynamic_graph")
    qry = make_workload(g, templates=("Q2",), n_per_template=1, seed=1)[0].qry
    assert layout_signature(g, "dense", qry, "torch") == ()
    assert layout_signature(g, "sliced", qry, "torch") == ()
    E2 = 2 * g.n_edges
    assert layout_signature(g, "dense", qry, "cuda") == \
        ("arrival_csr", (E2,), (g.n_vertices + 1,), lane_group(E2, g.n_vertices, 1))
    sb = TES.SliceBounds.from_graph(g)
    sig = layout_signature(g, "sliced", qry, "cuda")
    assert [s[0] for s in sig] == sorted({vp.vtype for vp in qry.v_preds})
    for vt, vb, eb, grp in sig:
        assert (vb, eb) == (sb.v[vt], sb.e[vt])
        assert grp == lane_group(eb[1] - eb[0], vb[1] - vb[0], 1)
    assert layout_signature(g, "partitioned", qry, "torch", 4) == ()
    from repro_torch.core import engine_partitioned as TEP
    _, arrays = TEP.partition_for(g, 4)
    n_dst = 4 * arrays.v_max
    assert layout_signature(g, "partitioned", qry, "cuda", 4) == \
        ("worker_csr", 4, (E2,), (n_dst + 1,), lane_group(E2, n_dst, 1))
    assert layout_signature(g, "partitioned", qry, "cuda", 2) != \
        layout_signature(g, "partitioned", qry, "cuda", 4)


def test_unported_paths_raise_naming_their_items(port_graph):
    """Every serving path is ported: the partitioned engine serves, live
    graphs pin epochs (ROADMAP A8), and only a name the port does not have
    (the reference's ``'xla'``) is refused."""
    from repro_torch.graphdata.ingest import log_from_graph
    from repro_torch.serving import EpochManager

    g = port_graph("small_static_graph")
    assert BatchScheduler(g, engine="partitioned", device="cpu").n_workers == 4
    with pytest.raises(ValueError):
        BatchScheduler(g, impl="xla", device="cpu")
    sched = BatchScheduler(g, device="cpu")
    log, _ = log_from_graph(g)
    mgr = EpochManager(log)
    mgr.attach(sched)
    assert sched.pinned_epoch is mgr.current and sched.pinned_epoch.id == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="the rule is for a host without a GPU")
def test_without_a_gpu_the_entry_points_raise(port_graph):
    g = port_graph("small_static_graph")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchScheduler(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLQ.GraniteServer(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLQ.main(["--persons", "60", "--queries", "1", "--serve"])
    sched = BatchScheduler(g, device="cpu")
    assert sched.device == torch.device("cpu") and sched.impl == "cuda"


# ================================================================== CLI
@pytest.mark.parametrize("flags", [["--serve", "--verify"],
                                   ["--dynamic", "--serve", "--verify"],
                                   ["--verify"]])
def test_cli_serves_and_verifies_on_the_cpu(capsys, tmp_path, flags):
    trace, metrics = str(tmp_path / "t.jsonl"), str(tmp_path / "m.json")
    TLQ.main(["--device", "cpu", "--persons", "300", "--queries", "2",
              "--trace-out", trace, "--metrics-out", metrics] + flags)
    out = capsys.readouterr().out
    assert "verification vs oracle: OK" in out
    assert "avg latency per template:" in out
    if "--serve" in flags:
        assert f"-> {trace}" in out and f"metrics -> {metrics}" in out


def test_cli_replay_on_the_cpu(capsys):
    TLQ.main(["--device", "cpu", "--persons", "300", "--queries", "1",
              "--replay", "--rate", "50"])
    out = capsys.readouterr().out
    assert "completion_rate: 1.0" in out and "n_failed: 0" in out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the rule is for a host without a GPU")
@pytest.mark.parametrize("flags,item", [(["--live"], "device='cpu'"),
                                        (["--wal", "x.wal"], "device='cpu'")])
def test_cli_refuses_unported_modes(flags, item):
    """``--live`` and ``--wal`` are ported (ROADMAP A8); like every mode
    they refuse to serve without a GPU unless ``--device cpu`` is given."""
    with pytest.raises(RuntimeError, match=item):
        TLQ.main(["--persons", "60"] + flags)


# ==================================================== virtual clock (SLO)
def _sched(ns, graph, **kw):
    kw.setdefault("dispatcher", ns.FakeDispatcher(
        service_model=ns.constant_service_model(1e-3)))
    return ns.BatchScheduler(graph, **kw)


def _plain_cost_s(sched, qry):
    split = 0 if qry.agg_op != -1 else qry.n_vertices - 1
    return sched._planner_for(sched._engine_for(qry)).estimate(
        qry, split, sched.impl).t_ms / 1e3


def sc_edf_dispatch_order(ns, g):
    wl2 = ns.make_workload(g, templates=("Q2",), n_per_template=3, seed=1)
    wl4 = ns.make_workload(g, templates=("Q4",), n_per_template=3, seed=2)
    sched = _sched(ns, g)
    for inst in wl2:
        sched.submit(inst, deadline_s=50.0, now=0.0)
    for inst in wl4:
        sched.submit(inst, deadline_s=5.0, now=0.0)
    res = sched.flush()
    assert [d.deadline for d in sched.last_dispatches] == [5.0, 50.0]
    assert [r.count for r in res] == [ns.fake_count(i.qry) for i in wl2 + wl4]
    return SP.results(res), SP.dispatches(sched)


def sc_edf_ties_preserve_arrival_order(ns, g):
    wl2 = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=3)
    wl4 = ns.make_workload(g, templates=("Q4",), n_per_template=2, seed=4)
    fd = ns.FakeDispatcher()
    sched = ns.BatchScheduler(g, dispatcher=fd)
    sched.run([wl4[0], wl2[0], wl4[1], wl2[1]])
    assert fd.calls[0].queries[0] is wl4[0].qry
    assert fd.calls[1].queries[0] is wl2[0].qry
    assert all(d.deadline == math.inf for d in sched.last_dispatches)
    return SP.calls(ns, fd), SP.dispatches(sched)


def sc_mixed_deadline_and_plain(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=5)
    sched = _sched(ns, g)
    for inst in wl[:2]:
        sched.submit(inst)
    for inst in wl[2:]:
        sched.submit(inst, deadline_s=1.0, now=0.0)
    sched.flush()
    assert [d.deadline for d in sched.last_dispatches] == [1.0, math.inf]
    return SP.dispatches(sched)


def sc_admission_admit_then_reject(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=8, seed=6)
    rel = 3.49 * _plain_cost_s(_sched(ns, g), wl[0].qry)
    pol = ns.AdmissionPolicy(headroom=1.0, degrade_impls=(),
                             allow_engine_downgrade=False)
    sched = _sched(ns, g, admission=pol)
    decs = [sched.submit(inst, deadline_s=rel, now=0.0) for inst in wl]
    actions = [d.action for d in decs]
    n_admit = actions.count("admit")
    assert 1 <= n_admit < len(wl)
    assert actions == ["admit"] * n_admit + ["reject"] * (len(wl) - n_admit)
    res = sched.flush()
    again = sched.submit(wl[0], deadline_s=rel, now=1.0)
    assert again.action == "admit"
    return ([SP.decision(d) for d in decs], SP.results(res),
            SP.decision(again), sched.slo_report())


def sc_admission_degrades_to_sliced(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=5, seed=7)
    fd = ns.FakeDispatcher()
    sched = ns.BatchScheduler(g, engine="dense", dispatcher=fd)
    cost = _plain_cost_s(sched, wl[0].qry)
    sched.admission = ns.AdmissionController(ns.AdmissionPolicy(
        headroom=1.0, degrade_impls=(), allow_engine_downgrade=True,
        sliced_discount=0.5, degrade_max_batch=2))
    decs = []
    for inst in wl:
        sched.admission.on_flush()
        decs.append(sched.submit(inst, deadline_s=0.75 * cost, now=0.0))
    assert all(d.action == "degrade" and d.engine == "sliced" for d in decs)
    res = sched.flush()
    assert all(c.engine == "sliced" and c.n_real <= 2 for c in fd.calls)
    assert [r.count for r in res] == [ns.fake_count(i.qry) for i in wl]
    return [SP.decision(d) for d in decs], SP.results(res), SP.calls(ns, fd)


def sc_admission_rejects_hopeless(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=1, seed=8)
    sched = _sched(ns, g, admission=ns.AdmissionPolicy())
    dec = sched.submit(wl[0], deadline_s=0.0, now=0.0)
    assert dec.action == "reject" and "exceeds" in dec.reason
    assert sched.queued == 0 and sched.flush() == []
    return SP.decision(dec)


def sc_admission_never_writes_plan_cache(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=4, seed=9)
    sched = _sched(ns, g, admission=ns.AdmissionPolicy())
    decs = [sched.submit(inst, deadline_s=600.0, now=0.0) for inst in wl]
    assert len(sched.plan_cache) == 0 and sched.plan_cache.stats.lookups == 0
    sched.flush()
    assert len(sched.plan_cache) == 1 and sched.plan_cache.stats.misses == 1
    return [SP.decision(d) for d in decs], sched.cache_report()


def sc_max_backlog_cap(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=6, seed=10)
    cost = _plain_cost_s(_sched(ns, g), wl[0].qry)
    pol = ns.AdmissionPolicy(headroom=1.0, max_backlog_s=2.5 * cost,
                             degrade_impls=(), allow_engine_downgrade=False)
    sched = _sched(ns, g, admission=pol)
    decs = [sched.submit(inst, deadline_s=600.0, now=0.0) for inst in wl]
    assert [d.action for d in decs] == ["admit"] * 2 + ["reject"] * 4
    return [SP.decision(d) for d in decs]


def sc_online_refit_converges(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=4, seed=11)
    base = ns.BatchScheduler(g)._planner.coeffs

    def run(refit):
        tb = ns.TelemetryBuffer(refit_every=4, min_samples=4, blend=1.0,
                                refit=refit)
        sched = ns.BatchScheduler(g, telemetry=tb, dispatcher=ns.FakeDispatcher(
            service_model=ns.planner_service_model(
                {k: 3.0 * v for k, v in base.items()})))
        for _ in range(8):
            for inst in wl:
                sched.submit(inst)
            assert all(r.ok for r in sched.flush())
        return tb, sched

    (on, s_on), (off, s_off) = run(True), run(False)
    e_on, e_off = on.error_stats(tail=4), off.error_stats(tail=4)
    assert e_on["n_refits"] >= 1 and e_off["n_refits"] == 0
    assert e_off["tail_mean_abs_rel_err"] == pytest.approx(2 / 3, rel=1e-3)
    assert e_on["tail_mean_abs_rel_err"] < 0.05
    return e_on, e_off, on.errors, dict(s_on._planner.coeffs), s_on.cache_report()


def sc_refit_updates_planner(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=4, seed=12)
    tb = ns.TelemetryBuffer(refit_every=3, min_samples=3, blend=1.0)
    base = ns.BatchScheduler(g)._planner.coeffs
    sched = ns.BatchScheduler(g, telemetry=tb, dispatcher=ns.FakeDispatcher(
        service_model=ns.planner_service_model({k: 2.0 * v for k, v in base.items()})))
    theta_before = dict(sched._planner.coeffs)
    for _ in range(2):
        sched.run(wl)
    assert tb.n_refits == 0 and len(sched.plan_cache) == 1
    sched.run(wl)
    assert tb.n_refits == 1 and len(sched.plan_cache) == 0
    assert sched._planner.coeffs != theta_before
    misses = sched.plan_cache.stats.misses
    sched.run(wl)
    assert sched.plan_cache.stats.misses == misses + 1
    return dict(sched._planner.coeffs), sched.cache_report(), tb.errors


def sc_telemetry_pure_recorder(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=13)
    tb = ns.TelemetryBuffer(refit=False, refit_every=1, min_samples=2)
    sched = _sched(ns, g, telemetry=tb)
    for _ in range(4):
        sched.run(wl)
    assert len(tb) == 4 and tb.n_refits == 0
    return tb.error_stats(), [s.predicted_ms for s in tb._rows], sched.slo_report()


def sc_replay_empty(ns, g):
    rep = ns.replay_workload(_sched(ns, g), [], rate_qps=10.0)
    assert rep.n_queries == 0 and rep.n_dispatches == 0
    assert rep.latency_ms_p50 == rep.latency_ms_p99 == 0.0
    assert rep.completion_rate == 0.0 and rep.deadline_hit_rate == 1.0
    return SP.report(rep)


def sc_replay_single(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=1, seed=14)
    rep = ns.replay_workload(_sched(ns, g), wl, rate_qps=10.0)
    assert rep.n_queries == rep.n_completed == 1 and rep.completion_rate == 1.0
    assert rep.latency_ms_p50 == rep.latency_ms_p99 > 0
    return SP.report(rep)


def sc_replay_failed_group(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=15)
    n_last = wl[-1].qry.n_vertices
    fd = ns.FakeDispatcher(fail=lambda queries, engine, impl:
                           queries[0].n_vertices == n_last)
    rep = ns.replay_workload(ns.BatchScheduler(g, dispatcher=fd), wl,
                             rate_qps=1000.0, seed=16)
    assert rep.n_failed == 3 and rep.n_completed == 3
    assert rep.completion_rate == 0.5
    assert [i for i, s in enumerate(rep.statuses) if s == ns.FAILED] == [3, 4, 5]
    return SP.report(rep)


def sc_replay_deadline_hits(ns, g):
    wl2 = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=19)
    wl4 = ns.make_workload(g, templates=("Q4",), n_per_template=2, seed=20)
    sched = _sched(ns, g, dispatcher=ns.FakeDispatcher(
        service_model=ns.constant_service_model(0.0, overhead_s=0.05)))
    rep = ns.replay_workload(sched, wl2 + wl4, mode="closed", max_outstanding=4,
                             deadline_s=0.08)
    assert rep.n_completed == 4 and rep.n_dispatches == 2
    assert rep.deadline_hit_rate == 0.5
    assert sorted(np.round(rep.latencies_ms, 6)) == [50.0, 50.0, 100.0, 100.0]
    return SP.report(rep)


def sc_open_loop_diverges(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=21) * 30
    model = ns.constant_service_model(0.02)
    open_rep = ns.replay_workload(
        _sched(ns, g, dispatcher=ns.FakeDispatcher(service_model=model)),
        wl, rate_qps=500.0, seed=22, mode="open")
    closed_rep = ns.replay_workload(
        _sched(ns, g, dispatcher=ns.FakeDispatcher(service_model=model)),
        wl, mode="closed", max_outstanding=4)
    assert open_rep.n_completed == closed_rep.n_completed == len(wl)
    assert open_rep.latencies_ms[-1] > 3 * open_rep.latencies_ms[0]
    assert open_rep.latency_ms_p99 > 3 * closed_rep.latency_ms_p99
    assert closed_rep.max_batch <= 4
    return SP.report(open_rep), SP.report(closed_rep)


def sc_admission_holds_deadlines(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=23) * 25
    probe = _sched(ns, g)
    c = float(np.mean([_plain_cost_s(probe, inst.qry) for inst in wl]))

    def run(admission):
        sched = _sched(ns, g, admission=admission, pad_batches=False,
                       dispatcher=ns.FakeDispatcher(service_model=(
                           ns.planner_service_model(probe._planner.coeffs))))
        return ns.replay_workload(sched, wl, rate_qps=5.0 / c, seed=24,
                                  mode="open", deadline_s=4.0 * c)

    plain = run(None)
    slo = run(ns.AdmissionPolicy(headroom=0.5, degrade_impls=(),
                                 allow_engine_downgrade=False))
    assert plain.deadline_hit_rate < 0.5 and slo.n_rejected > 0
    assert slo.deadline_hit_rate > plain.deadline_hit_rate
    assert slo.goodput_qps > plain.goodput_qps
    return SP.report(plain), SP.report(slo)


def sc_replay_rejected_excluded(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=25) * 10
    probe = _sched(ns, g)
    c = float(np.mean([_plain_cost_s(probe, inst.qry) for inst in wl]))
    fd = ns.FakeDispatcher(service_model=ns.planner_service_model(
        probe._planner.coeffs))
    sched = _sched(ns, g, dispatcher=fd, pad_batches=False,
                   admission=ns.AdmissionPolicy(headroom=1.0, degrade_impls=(),
                                                allow_engine_downgrade=False))
    rep = ns.replay_workload(sched, wl, rate_qps=10.0 / c, seed=26, mode="open",
                             deadline_s=2.0 * c)
    assert rep.n_rejected > 0
    assert sum(c.n_real for c in fd.calls) == rep.n_completed
    return SP.report(rep), SP.calls(ns, fd)


def sc_closed_loop_frees_rejected_slots(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=6, seed=31)
    sched = _sched(ns, g, admission=ns.AdmissionPolicy(
        headroom=1.0, degrade_impls=(), allow_engine_downgrade=False))
    rep = ns.replay_workload(sched, wl, mode="closed", max_outstanding=2,
                             deadline_s=0.0)
    assert rep.n_rejected == len(wl) and rep.n_dispatches == 0
    return SP.report(rep)


def sc_flush_any_permutation(ns, g):
    base = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=4, seed=28)
    base += ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=29,
                             aggregate=True)
    rng = np.random.default_rng(30)
    obs, ref = [], None
    for _ in range(5):
        perm = rng.permutation(len(base))
        fd = ns.FakeDispatcher()
        res = ns.BatchScheduler(g, dispatcher=fd).run([base[i] for i in perm])
        assert [r.count for r in res] == [ns.fake_count(base[i].qry) for i in perm]
        counts = sorted(c.n_real for c in fd.calls)
        ref = counts if ref is None else ref
        assert counts == ref
        obs.append((SP.results(res), SP.calls(ns, fd)))
    return obs


def sc_fake_duration_exact(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=60)
    fd = ns.FakeDispatcher(service_model=ns.constant_service_model(
        2e-3, overhead_s=5e-3))
    sched = ns.BatchScheduler(g, dispatcher=fd)
    res = sched.run(wl)
    for d in sched.last_dispatches:
        assert d.service_s == 5e-3 + 2e-3 * (d.n_real + d.n_pad)
    return SP.results(res), SP.dispatches(sched)


def sc_error_stats_edges(ns, g):
    empty = ns.TelemetryBuffer().error_stats()
    assert empty == dict(n=0, mean_abs_rel_err=0.0, p90_abs_rel_err=0.0,
                         tail_mean_abs_rel_err=0.0, n_refits=0)
    tb = ns.TelemetryBuffer(refit=False)
    for _ in range(3):
        tb.record(np.ones(10), 1.0, 2.0)
    obs = [tb.error_stats(), tb.error_stats(tail=100), tb.error_stats(tail=0)]
    assert obs[1] == tb.error_stats(tail=3)
    assert obs[2]["tail_mean_abs_rel_err"] == 0.0
    tb.record(np.ones(10), 1.0, 1.0)
    obs += [tb.error_stats(tail=1), tb.error_stats(tail=2)]
    assert obs[-1]["tail_mean_abs_rel_err"] == pytest.approx(0.25)
    return obs


# ================================================== virtual clock (faults)
def _fsched(ns, g, **kw):
    kw.setdefault("retry", ns.RetryPolicy())
    return _sched(ns, g, **kw)


def sc_fault_plan_deterministic(ns, g):
    kw = dict(seed=42, rates={"dispatch": 0.4, "compile": 0.2})
    a, b = ns.FaultPlan(**kw), ns.FaultPlan(**kw)
    seq_a = [a.should_fail("dispatch") for _ in range(50)]
    seq_b = []
    for _ in range(50):
        b.should_fail("compile")
        seq_b.append(b.should_fail("dispatch"))
    assert seq_a == seq_b and any(seq_a) and not all(seq_a)
    plan = ns.FaultPlan(schedule={"wal": {0, 2}})
    sched = [plan.should_fail("wal") for _ in range(4)]
    assert sched == [True, False, True, False]
    with pytest.raises(ValueError, match="unknown fault point"):
        ns.FaultPlan(rates={"disk": 0.5})
    return seq_a, a.report(), b.report(), sched


def sc_transient_retried(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=21)
    ref = _fsched(ns, g, retry=None).run(wl)
    mx = ns.MetricsRegistry()
    sched = _fsched(ns, g, metrics=mx,
                    fault_plan=ns.FaultPlan(schedule={"dispatch": {0}}))
    res = sched.run(wl)
    assert [r.status for r in res] == ["done"] * len(wl)
    assert [r.count for r in res] == [r.count for r in ref]
    assert SP.fault_report(sched)["n_retries"] == 1
    hit = [d for d in sched.last_dispatches if d.n_retries][0]
    assert hit.penalty_s > 0 and hit.service_s > hit.penalty_s
    return (SP.results(res), SP.dispatches(sched), SP.fault_report(sched),
            mx.snapshot())


def sc_backoff_accounted_not_slept(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=22)
    sched = _fsched(ns, g, retry=ns.RetryPolicy(base_delay_s=30.0,
                                                max_delay_s=30.0, jitter_frac=0.0),
                    fault_plan=ns.FaultPlan(schedule={"dispatch": {0}}))
    t0 = time.perf_counter()
    res = sched.run(wl)
    assert time.perf_counter() - t0 < 5.0
    assert all(r.status == "done" and r.latency_ms > 1e3 for r in res)
    return SP.results(res), SP.dispatches(sched)


def sc_retry_respects_deadline(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=3, seed=23)
    sched = _fsched(ns, g, retry=ns.RetryPolicy(base_delay_s=10.0, jitter_frac=0.0,
                                                max_group_failures=99),
                    fault_plan=ns.FaultPlan(rates={"dispatch": 1.0}))
    for inst in wl:
        sched.submit(inst, deadline_s=1.0, now=0.0)
    res = sched.flush()
    assert [r.status for r in res] == ["timeout"] * len(wl)
    assert all(not r.ok and "deadline" in r.error for r in res)
    return SP.results(res), SP.fault_report(sched)


def sc_deadline_breach_reenters_admission(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=3, seed=24)
    sched = _fsched(ns, g, admission=ns.AdmissionPolicy(),
                    retry=ns.RetryPolicy(base_delay_s=10.0, jitter_frac=0.0),
                    fault_plan=ns.FaultPlan(schedule={"dispatch": {0}}))
    decs = [sched.submit(inst, deadline_s=1.0, now=0.0) for inst in wl]
    res = sched.flush()
    assert [r.status for r in res] == ["done"] * len(wl)
    assert [r.count for r in res] == [ns.fake_count(i.qry) for i in wl]
    return [SP.decision(d) for d in decs], SP.results(res), SP.fault_report(sched)


def sc_quarantine_bisects(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=8, seed=25)
    bad = wl[3].qry
    mx = ns.MetricsRegistry()
    tr = ns.Tracer(clock=ns.StepClock())
    sched = _fsched(ns, g, metrics=mx, tracer=tr,
                    fault_plan=ns.FaultPlan(poison=lambda q: q is bad))
    res = sched.run(wl)
    assert [r.status for r in res] == ["done"] * 3 + ["quarantined"] + ["done"] * 4
    assert "quarantined" in res[3].error
    return (SP.results(res), SP.dispatches(sched), SP.fault_report(sched),
            mx.snapshot(), tr.records())


def _completion_case(ns, g, wl, seed, rates):
    sched = _fsched(ns, g, fault_plan=ns.FaultPlan(seed=seed, rates=rates))
    for inst in wl:
        sched.submit(inst)
    res = sched.flush()
    for inst, r in zip(wl, res):
        assert r.status in ("done", "quarantined", "timeout"), r.error
        if r.status == "done":
            assert r.count == ns.fake_count(inst.qry)
        else:
            assert not r.ok and r.error
    return SP.results(res), SP.fault_report(sched)


def sc_seeded_chaos_sweep(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4", "Q6"), n_per_template=3, seed=27)
    obs = [_completion_case(ns, g, wl, seed,
                            {"dispatch": 0.3, "compile": 0.15, "straggler": 0.2})
           for seed in range(6)]
    assert any(r[9] == "done" for o in obs for r in o[0])
    return obs


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_edf_dispatch_order, sc_edf_ties_preserve_arrival_order,
    sc_mixed_deadline_and_plain, sc_admission_admit_then_reject,
    sc_admission_degrades_to_sliced, sc_admission_rejects_hopeless,
    sc_admission_never_writes_plan_cache, sc_max_backlog_cap,
    sc_online_refit_converges, sc_refit_updates_planner,
    sc_telemetry_pure_recorder, sc_replay_empty, sc_replay_single,
    sc_replay_failed_group, sc_replay_deadline_hits, sc_open_loop_diverges,
    sc_admission_holds_deadlines, sc_replay_rejected_excluded,
    sc_closed_loop_frees_rejected_slots, sc_flush_any_permutation,
    sc_fake_duration_exact, sc_error_stats_edges,
    sc_fault_plan_deterministic, sc_transient_retried,
    sc_backoff_accounted_not_slept, sc_retry_respects_deadline,
    sc_deadline_breach_reenters_admission, sc_quarantine_bisects,
    sc_seeded_chaos_sweep)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_virtual_clock_scenario_matches_reference(graphs, name):
    SP.assert_same(SCENARIOS[name], graphs)


# ============================================ properties (hypothesis)
# The reference's property tests, deepened with hypothesis where it is
# installed (requirements-dev.txt); the seeded scenarios above run always.
TEMPLATES, POOL = ("Q1", "Q2", "Q4"), 4


def _pool(ns, g):
    return {t: ns.make_workload(g, templates=(t,), n_per_template=POOL, seed=101)
            for t in TEMPLATES}


def sc_submission_order(ns, g, picks, perm):
    pool = _pool(ns, g)
    wl = [pool[t][i] for t, i in picks]
    submitted = [wl[i] for i in perm]
    fd = ns.FakeDispatcher()
    res = ns.BatchScheduler(g, dispatcher=fd).run(submitted)
    assert [r.count for r in res] == [ns.fake_count(i.qry) for i in submitted]

    def profile(order):
        f = ns.FakeDispatcher()
        ns.BatchScheduler(g, dispatcher=f).run(order)
        return sorted((c.engine, c.n_real, tuple(sorted(ns.fake_count(q)
                                                        for q in c.queries)))
                      for c in f.calls)

    assert profile(wl) == profile(submitted)
    return SP.results(res), SP.calls(ns, fd)


def sc_edf_property(ns, g, picks, deadlines):
    pool = _pool(ns, g)
    sched = ns.BatchScheduler(g, dispatcher=ns.FakeDispatcher())
    for (t, i), dl in zip(picks, deadlines):
        sched.submit(pool[t][i], deadline_s=dl, now=0.0)
    res = sched.flush()
    dls = [d.deadline for d in sched.last_dispatches]
    assert dls == sorted(dls)
    return SP.results(res), SP.dispatches(sched)


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # the seeded scenarios still run
    given = None

if given is not None:
    @st.composite
    def workload_and_order(draw):
        picks = draw(st.lists(st.tuples(st.sampled_from(TEMPLATES),
                                        st.integers(0, POOL - 1)),
                              min_size=1, max_size=10))
        return picks, draw(st.permutations(range(len(picks))))


    @settings(max_examples=15, deadline=None)
    @given(wo=workload_and_order())
    def test_property_submission_order_and_grouping(graphs, wo):
        SP.assert_same(sc_submission_order, graphs, *wo)


    @settings(max_examples=15, deadline=None)
    @given(deadlines=st.lists(st.floats(0.1, 100.0), min_size=2, max_size=6),
           data=st.data())
    def test_property_edf_order(graphs, deadlines, data):
        picks = data.draw(st.lists(st.tuples(st.sampled_from(TEMPLATES),
                                             st.integers(0, POOL - 1)),
                                   min_size=len(deadlines), max_size=len(deadlines)))
        SP.assert_same(sc_edf_property, graphs, picks, deadlines)


    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2 ** 16), rate=st.floats(0.0, 0.9),
           point=st.sampled_from(["compile", "dispatch", "straggler"]))
    def test_property_chaos_completion(graphs, seed, rate, point):
        def sc(ns, g):
            wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=28)
            return _completion_case(ns, g, wl, seed, {point: rate})
        SP.assert_same(sc, graphs)
