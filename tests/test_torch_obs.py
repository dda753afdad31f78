"""The port's flight recorder and metrics registry against the reference
package's.

Every scenario of the reference's ``test_obs.py`` that needs neither the
cost-model audit (``obs/audit.py``) nor ``scripts/trace_report.py`` (both
held in ``test_torch_audit.py``) runs in both packages
(``serving_parity``): the span trees — ids, parents, ticks and
attributes — the metric snapshots and the Prometheus text must be equal,
with the impl names mapped.  The real-dispatch leg runs the port alone: its
answers with the recorder attached equal its answers without it, and each
group's compile span reads the executable cache.  The partitioned
executor's profiler (``measure_supersteps``) records the reference's span
tree: the same nodes, workers and per-hop exchange volumes (its times are
measured, so they differ)."""
import json

import numpy as np
import pytest

import serving_parity as SP
from serving_parity import one_torch_thread  # noqa: F401  (autouse)
from repro_torch.graphdata import ldbc as TL
from repro_torch.graphdata.queries import make_workload
from repro_torch.obs import MetricsRegistry, StepClock, Tracer, span_trees
from repro_torch.serving import BatchScheduler


@pytest.fixture(scope="module")
def graphs(medium_static_graph):
    port = TL.generate_ldbc(TL.LdbcParams(n_persons=200, seed=9, dynamic=False))
    return {"ref": medium_static_graph, "port": port}


def _fake_sched(ns, g, **kw):
    kw.setdefault("dispatcher", ns.FakeDispatcher(
        service_model=ns.constant_service_model(1e-3)))
    return ns.BatchScheduler(g, **kw)


def _tree_names(root):
    out, stack = [], [root]
    while stack:
        rec = stack.pop(0)
        out.append(rec["name"])
        stack = rec["children"] + stack
    return out


# ================================================================= tracer
def sc_step_clock_span_tree(ns, g):
    t = ns.Tracer(clock=ns.StepClock(start=10.0, step=0.5))
    root = t.start("query", template="Q1")
    a = t.start("admit", parent=root)
    t.end(a, verdict="admit")
    b = t.start("plan", parent=root)
    t.end(b)
    t.end(root, status="done")
    recs = t.records()
    assert [r["span_id"] for r in recs] == [1, 2, 0]
    assert [(r["t_start"], r["t_end"]) for r in recs] == [
        (10.5, 11.0), (11.5, 12.0), (10.0, 12.5)]
    trees = ns.span_trees(recs)
    assert _tree_names(trees[0]) == ["query", "admit", "plan"]
    return recs, _tree_names(trees[0])


def sc_ring_and_jsonl_sink(ns, g, tmp_path):
    p = str(tmp_path / f"{ns.name}.jsonl")
    t = ns.Tracer(clock=ns.StepClock(), sink=p)
    root = t.start("query", feats=np.array([1.5, 0.25]), n=np.int64(3),
                   flag=np.bool_(True))
    t.end(root, err=np.float64(1 / 3))
    t.close()
    ring, disk = t.records(), ns.load_jsonl(p)
    assert ring == disk
    p2 = str(tmp_path / f"{ns.name}2.jsonl")
    assert t.export_jsonl(p2) == 1 and ns.load_jsonl(p2) == disk
    with open(p) as f:
        text = f.read()
    return ring, text


def sc_ring_capacity(ns, g):
    t = ns.Tracer(clock=ns.StepClock(), capacity=3)
    for i in range(5):
        t.end(t.start(f"s{i}"))
    assert [r["name"] for r in t.records()] == ["s2", "s3", "s4"]
    return t.records(), t.n_completed, t.n_started


def sc_null_tracer(ns, g):
    nt = ns.NULL_TRACER
    span = nt.start("query", template="Q1")
    assert nt.enabled is False and span is ns.NULL_SPAN
    assert nt.start("other") is span
    nt.annotate(span, a=1)
    nt.end(span, b=2)
    assert isinstance(nt, ns.NullTracer)
    t = ns.Tracer(clock=ns.StepClock())
    root = t.start("plan", parent=ns.NULL_SPAN)
    assert root.parent_id is None and root.trace_id == root.span_id
    t.end(ns.NULL_SPAN)
    t.annotate(ns.NULL_SPAN, x=1)
    return nt.records(), nt.export_jsonl("unused"), t.records()


# ================================================================ metrics
def sc_counter_gauge_histogram(ns, g):
    mx = ns.MetricsRegistry()
    c = mx.counter("granite_admission_total", "outcomes",
                   labelnames=("verdict", "rung"))
    c.inc(verdict="admit", rung="")
    c.inc(2, verdict="reject", rung="")
    with pytest.raises(ValueError):
        c.inc(-1, verdict="admit", rung="")
    with pytest.raises(ValueError):
        c.inc(verdict="admit")
    g_ = mx.gauge("granite_queue_depth")
    g_.set(7)
    g_.set(3)
    h = mx.histogram("granite_dispatch_ms")
    for v in (0.05, 1.0, 1.5, 100.0, 1e9):
        h.observe(v)
    assert h.count() == 5
    text = mx.to_prometheus()
    assert 'granite_dispatch_ms_bucket{le="1"} 2' in text
    a = mx.counter("x_total")
    assert mx.counter("x_total") is a and "x_total" in mx and mx["x_total"] is a
    with pytest.raises(ValueError):
        mx.gauge("x_total")
    return (c.value(verdict="admit", rung=""), c.value(verdict="reject", rung=""),
            c.value(verdict="degrade", rung="x"), g_.value(), h.sum(), text,
            mx.snapshot())


def sc_snapshot_round_trip(ns, g, tmp_path):
    mx = ns.MetricsRegistry()
    mx.counter("c_total", labelnames=("k",)).inc(k="v")
    mx.histogram("h_ms").observe(2.0)
    p = str(tmp_path / f"{ns.name}.json")
    mx.write(p)
    with open(p) as f:
        snap = json.load(f)
    assert snap == mx.snapshot()
    prom = str(tmp_path / f"{ns.name}.prom")
    mx.write(prom)
    with open(prom) as f:
        text = f.read()
    assert "# TYPE h_ms histogram" in text
    return snap, text


# ==================================================== scheduler span trees
def sc_every_query_one_tree(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=4, seed=40) * 3
    tr = ns.Tracer(clock=ns.StepClock())
    probe = _fake_sched(ns, g)
    sched = _fake_sched(
        ns, g, tracer=tr, pad_batches=False,
        admission=ns.AdmissionPolicy(headroom=0.5, degrade_impls=(),
                                     allow_engine_downgrade=False),
        dispatcher=ns.FakeDispatcher(
            service_model=ns.planner_service_model(probe._planner.coeffs)))
    c = 2e-3
    rep = ns.replay_workload(sched, wl, rate_qps=20.0 / c, seed=41, mode="open",
                             deadline_s=4.0 * c)
    assert rep.n_rejected > 0 and rep.n_completed > 0
    roots = [t for t in ns.span_trees(tr.records()).values() if t["name"] == "query"]
    assert len(roots) == len(wl)
    for root in roots:
        kinds = set(_tree_names(root))
        if root["attrs"]["status"] == "rejected":
            assert kinds == {"query", "admit"}
        else:
            assert {"admit", "plan", "compile", "dispatch", "superstep",
                    "exchange"} <= kinds
    return tr.records(), SP.report(rep)


def sc_span_tree_pinned(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=1, seed=42)
    n_hops = len(wl[0].qry.e_preds)
    tr = ns.Tracer(clock=ns.StepClock())
    sched = _fake_sched(ns, g, tracer=tr)
    res = sched.run(wl)
    recs = {r["span_id"]: r for r in tr.records()}
    assert recs[2]["attrs"]["candidates"] and recs[3]["attrs"]["cache"] == "hit"
    assert recs[4]["t_end"] == 8.0 + 4 * n_hops
    assert recs[0]["t_end"] == 9.0 + 4 * n_hops
    a = recs[4]["attrs"]
    assert a["measured_ms"] == a["group_measured_ms"] == 1.0
    return tr.records(), SP.results(res)


def sc_failed_group_seals_roots(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=43)
    tr = ns.Tracer(clock=ns.StepClock())
    fd = ns.FakeDispatcher(fail=lambda queries, engine, impl: True)
    res = ns.BatchScheduler(g, dispatcher=fd, tracer=tr).run(wl)
    roots = [r for r in tr.records() if r["name"] == "query"]
    assert len(roots) == 2
    assert all(r["attrs"]["status"] == "failed"
               and "injected dispatch failure" in r["attrs"]["error"] for r in roots)
    return tr.records(), SP.results(res)


def sc_traced_flush_unchanged(ns, g):
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=44)
    plain = _fake_sched(ns, g).run(wl)
    mx = ns.MetricsRegistry()
    traced = _fake_sched(ns, g, tracer=ns.Tracer(ns.StepClock()), metrics=mx).run(wl)
    assert SP.results(plain) == SP.results(traced)
    return SP.results(traced), mx.snapshot()


# =========================================================== ladder rungs
def sc_rung_admit(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=3, seed=45)
    mx, tr = ns.MetricsRegistry(), ns.Tracer(clock=ns.StepClock())
    sched = _fake_sched(ns, g, metrics=mx, tracer=tr,
                        admission=ns.AdmissionPolicy(headroom=1.0))
    for inst in wl:
        sched.submit(inst, deadline_s=600.0, now=0.0)
    assert mx["granite_admission_total"].value(verdict="admit", rung="") == 3
    assert mx["granite_queue_depth"].value() == 3
    depth = mx.snapshot()
    sched.flush()
    assert mx["granite_queue_depth"].value() == 0
    assert mx["granite_cache_total"].value(cache="plan", event="miss") == 1
    return depth, mx.snapshot(), tr.records()


def sc_rung_cheaper_impl(ns, g):
    """Rung 1: with the plain lowering's θ_scatter inflated, the kernel
    lowering is strictly cheaper, and a deadline between the two costs
    degrades with exactly the impl rung."""
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=46)
    mx, tr, fd = ns.MetricsRegistry(), ns.Tracer(clock=ns.StepClock()), ns.FakeDispatcher()
    pol = ns.AdmissionPolicy(headroom=1.0, degrade_impls=(ns.PALLAS,),
                             allow_engine_downgrade=False, degrade_max_batch=None)
    sched = ns.BatchScheduler(g, dispatcher=fd, metrics=mx, tracer=tr, admission=pol)
    sched._planner.coeffs[f"theta_scatter_{ns.XLA}"] = 10.0
    qry = wl[0].qry
    split = qry.n_vertices - 1
    c_plain = sched._planner.estimate(qry, split, ns.XLA).t_ms / 1e3
    c_kern = sched._planner.estimate(qry, split, ns.PALLAS).t_ms / 1e3
    assert c_kern < c_plain
    decs = []
    for inst in wl:
        sched.admission.on_flush()
        decs.append(sched.submit(inst, deadline_s=0.9 * c_plain, now=0.0))
    assert all(d.action == "degrade" and d.rungs == (f"impl={ns.PALLAS}",)
               for d in decs)
    res = sched.flush()
    assert all(c.impl == ns.PALLAS for c in fd.calls)
    return ([SP.decision(d) for d in decs], SP.results(res), SP.calls(ns, fd),
            mx.snapshot(), tr.records())


def sc_rung_engine_downgrade_quantum(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=5, seed=47)
    mx, tr, fd = ns.MetricsRegistry(), ns.Tracer(clock=ns.StepClock()), ns.FakeDispatcher()
    sched = ns.BatchScheduler(g, engine="dense", dispatcher=fd, metrics=mx, tracer=tr)
    probe_cost = sched._planner.estimate(
        wl[0].qry, wl[0].qry.n_vertices - 1, ns.XLA).t_ms / 1e3
    sched.admission = ns.AdmissionController(ns.AdmissionPolicy(
        headroom=1.0, degrade_impls=(), allow_engine_downgrade=True,
        sliced_discount=0.5, degrade_max_batch=2))
    decs = []
    for inst in wl:
        sched.admission.on_flush()
        decs.append(sched.submit(inst, deadline_s=0.75 * probe_cost, now=0.0))
    assert all(d.rungs == ("engine=sliced", "quantum=2") for d in decs)
    res = sched.flush()
    assert all(c.engine == "sliced" and c.n_real <= 2 for c in fd.calls)
    assert mx["granite_dispatch_ms"].count() == len(fd.calls) == 3
    disp = [r for r in tr.records() if r["name"] == "dispatch"]
    assert sorted({r["attrs"]["edf_pos"] for r in disp}) == [0, 1, 2]
    return ([SP.decision(d) for d in decs], SP.results(res), mx.snapshot(),
            mx.to_prometheus(), tr.records())


def sc_rung_reject(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=48)
    mx, tr = ns.MetricsRegistry(), ns.Tracer(clock=ns.StepClock())
    sched = _fake_sched(ns, g, metrics=mx, tracer=tr, admission=ns.AdmissionPolicy(
        headroom=1.0, degrade_impls=(), allow_engine_downgrade=False))
    decs = [sched.submit(inst, deadline_s=0.0, now=0.0) for inst in wl]
    assert all(d.action == "reject" for d in decs) and sched.queued == 0
    roots = [r for r in tr.records() if r["name"] == "query"]
    assert len(roots) == 2 and all(r["attrs"]["status"] == "rejected" for r in roots)
    return [SP.decision(d) for d in decs], mx.snapshot(), tr.records()


def sc_refit_and_invalidation_counters(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=4, seed=49)
    mx = ns.MetricsRegistry()
    tb = ns.TelemetryBuffer(refit_every=3, min_samples=3, blend=1.0)
    base = ns.BatchScheduler(g)._planner.coeffs
    tr = ns.Tracer(clock=ns.StepClock())
    sched = ns.BatchScheduler(g, telemetry=tb, metrics=mx, tracer=tr,
                              dispatcher=ns.FakeDispatcher(service_model=(
                                  ns.planner_service_model(
                                      {k: 2.0 * v for k, v in base.items()}))))
    for _ in range(3):
        sched.run(wl)
    assert tb.n_refits == 1 and mx["granite_refit_total"].value() == 1
    assert mx["granite_cache_total"].value(cache="plan", event="invalidation") == 1
    return mx.snapshot(), tr.records(), dict(sched._planner.coeffs)


def sc_replay_metrics(ns, g):
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=4, seed=50)
    mx = ns.MetricsRegistry()
    sched = _fake_sched(ns, g, metrics=mx, dispatcher=ns.FakeDispatcher(
        service_model=ns.constant_service_model(0.0, overhead_s=0.05)))
    rep = ns.replay_workload(sched, wl, mode="closed", max_outstanding=4,
                             deadline_s=0.08)
    assert mx["granite_replay_total"].value(status="done") == rep.n_completed == 4
    assert mx["granite_goodput_qps"].value() == pytest.approx(rep.goodput_qps)
    assert mx["granite_deadline_slack_ms"].count() == rep.n_completed
    return mx.snapshot(), SP.report(rep)


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_step_clock_span_tree, sc_ring_capacity, sc_null_tracer,
    sc_counter_gauge_histogram, sc_every_query_one_tree, sc_span_tree_pinned,
    sc_failed_group_seals_roots, sc_traced_flush_unchanged, sc_rung_admit,
    sc_rung_cheaper_impl, sc_rung_engine_downgrade_quantum, sc_rung_reject,
    sc_refit_and_invalidation_counters, sc_replay_metrics)}
FILE_SCENARIOS = {f.__name__[3:]: f for f in (sc_ring_and_jsonl_sink,
                                              sc_snapshot_round_trip)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_recorder_scenario_matches_reference(graphs, name):
    SP.assert_same(SCENARIOS[name], graphs)


@pytest.mark.parametrize("name", sorted(FILE_SCENARIOS))
def test_recorder_files_match_reference(graphs, tmp_path, name):
    SP.assert_same(FILE_SCENARIOS[name], graphs, tmp_path)


def test_real_dispatch_span_trees_and_cache_spans(graphs):
    """Real dispatch on the CPU (both lowerings): every query leaves one
    complete tree, the first flush's compile spans miss the executable
    cache and the second's hit, and the answers equal the untraced run."""
    g = graphs["port"]
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=57)
    for impl in ("torch", "cuda"):
        plain = BatchScheduler(g, keep_outputs=True, impl=impl,
                               device="cpu").run(wl, warm=True)
        tr, mx = Tracer(clock=StepClock()), MetricsRegistry()
        sched = BatchScheduler(g, keep_outputs=True, impl=impl, device="cpu",
                               tracer=tr, metrics=mx)
        first = sched.run(wl, warm=True)
        second = sched.run(wl, warm=True)
        for a, b, c in zip(plain, first, second):
            assert a.ok and b.ok and c.ok
            assert np.array_equal(a.total, b.total)
            assert np.array_equal(a.total, c.total)
        roots = [t for t in span_trees(tr.records()).values() if t["name"] == "query"]
        assert len(roots) == 2 * len(wl)
        comp = [r["attrs"]["cache"] for r in tr.records() if r["name"] == "compile"]
        assert comp == ["miss"] * len(wl) + ["hit"] * len(wl)
        assert mx["granite_cache_total"].value(cache="executable", event="miss") == 2
        assert mx["granite_cache_total"].value(cache="executable", event="hit") == 2
        assert {r["attrs"]["impl"] for r in tr.records()
                if r["name"] == "dispatch"} == {impl}


# ==================================================== measure_supersteps
@pytest.mark.parametrize("template,aggregate", [("Q2", False), ("Q4", False),
                                                ("Q4", True)])
def test_measure_supersteps_traced_exchange_channels(graphs, template, aggregate):
    """The profiler's span tree (measure_supersteps → superstep per hop →
    exchange) has the reference's nodes and per-hop channel volumes, which
    follow the canonical ``hop_exchange_channels`` rule and sum to
    ``query_exchange_volumes``."""
    from repro.core import engine_partitioned as JEP
    from repro.graphdata.queries import make_workload as j_make_workload
    from repro.obs import StepClock as JStepClock, Tracer as JTracer
    from repro.obs import span_trees as j_span_trees
    from repro_torch.core import engine_partitioned as TEP

    def tree(ns_span_trees, tr):
        trees = ns_span_trees(tr.records())
        assert len(trees) == 1
        root = next(iter(trees.values()))
        rows = []
        for ss in root["children"]:
            (ex,) = [c for c in ss["children"] if c["name"] == "exchange"]
            assert ss["attrs"]["measured_ms"] > 0
            rows.append((ss["name"], ss["attrs"]["hop"], ss["attrs"]["etr"],
                         len(ss["attrs"]["per_worker_ms"]),
                         {k: ex["attrs"][k] for k in ("state", "extremum", "etr")}))
        a = root["attrs"]
        return (root["name"], a["n_workers"], a["n_hops"], a["mode"], a["backward"],
                a["total"], rows)

    jq = j_make_workload(graphs["ref"], templates=(template,), n_per_template=1,
                         seed=55, aggregate=aggregate)[0].qry
    tq = make_workload(graphs["port"], templates=(template,), n_per_template=1,
                       seed=55, aggregate=aggregate)[0].qry
    jt, tt = JTracer(clock=JStepClock()), Tracer(clock=StepClock())
    JEP.measure_supersteps(graphs["ref"], jq, n_workers=2, repeats=1, tracer=jt)
    TEP.measure_supersteps(graphs["port"], tq, n_workers=2, repeats=1, tracer=tt,
                           device="cpu")
    got, want = tree(span_trees, tt), tree(j_span_trees, jt)
    assert got == want
    if aggregate:   # the profile runs the reversed segment; the rule below is
        return      # stated for the query's own hop order
    _, arrays = TEP.partition_for(graphs["port"], 2)
    rows = TEP.hop_exchange_channels(tq, arrays)
    assert [r[-1] for r in got[-1]] == rows
    total = dict(state=0, extremum=0, etr=0)
    for r in rows:
        for k in total:
            total[k] += r[k]
    assert total == TEP.query_exchange_volumes(tq, arrays)
