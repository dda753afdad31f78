"""The port's cost-model audit (``obs/audit.py``) and trace report
(``scripts/torch_trace_report.py``) against the reference package's.

The five audit scenarios of the reference's ``test_obs.py`` run in both
packages (``serving_parity``) on a virtual clock: telemetry replayed from
the ring and from the JSONL file, dispatch rows deduplicated by ``seq``,
coefficient drift and the trace refit, plan accuracy and the per-query
rollup must equal the JAX audit's float for float (the reference's
coefficient and impl names mapped onto the port's).  Then both trace
reports render one trace of the port's scheduler to the same text."""
import os
import subprocess
import sys

import numpy as np
import pytest

import repro.obs.audit as JA
import repro_torch.obs.audit as TA
import serving_parity as SP
from repro_torch.core.planner import COEFF_KEYS, coeff_vector
from repro_torch.graphdata import ldbc as TL
from repro_torch.graphdata.queries import make_workload
from repro_torch.obs import StepClock, Tracer
from repro_torch.serving import AdmissionPolicy, BatchScheduler, TelemetryBuffer
from repro_torch.serving.testing import FakeDispatcher, constant_service_model
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIT = {"ref": JA, "port": TA}


@pytest.fixture(scope="module")
def graphs(medium_static_graph):
    port = TL.generate_ldbc(TL.LdbcParams(n_persons=200, seed=9, dynamic=False))
    return {"ref": medium_static_graph, "port": port}


def _fake_sched(ns, g, **kw):
    kw.setdefault("dispatcher", ns.FakeDispatcher(
        service_model=ns.constant_service_model(1e-3)))
    return ns.BatchScheduler(g, **kw)


def _base_coeffs(ns, g):
    return dict(ns.BatchScheduler(g)._planner.coeffs)


def _traced_refit_run(ns, graph, wl, refit, sink):
    tb = ns.TelemetryBuffer(refit_every=4, min_samples=4, blend=1.0,
                            refit=refit)
    tr = ns.Tracer(clock=ns.StepClock(), sink=sink)
    sched = ns.BatchScheduler(
        graph, telemetry=tb, tracer=tr,
        dispatcher=ns.FakeDispatcher(service_model=ns.planner_service_model(
            {k: 3.0 * v for k, v in _base_coeffs(ns, graph).items()})))
    for _ in range(8):
        for inst in wl:
            sched.submit(inst)
        assert all(r.ok for r in sched.flush())
    tr.close()
    return tb, tr


# ================================================================ scenarios
def sc_audit_reproduces_live_telemetry_exactly(ns, g, tmp_path):
    """The acceptance property: the audit reproduces the refit-error
    improvement from trace data ALONE — error stats equal to the live
    TelemetryBuffer float for float, from the ring and the JSONL file."""
    audit = AUDIT[ns.name]
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=4, seed=11)
    p_on = str(tmp_path / f"{ns.name}-online.jsonl")
    p_off = str(tmp_path / f"{ns.name}-static.jsonl")
    tb_on, tr_on = _traced_refit_run(ns, g, wl, True, p_on)
    tb_off, tr_off = _traced_refit_run(ns, g, wl, False, p_off)
    out = []
    for tb, tr, path in ((tb_on, tr_on, p_on), (tb_off, tr_off, p_off)):
        live = tb.error_stats(tail=4)
        for src in (tr, path, ns.load_jsonl(path)):
            rep = audit.error_report(src, tail=4)
            assert rep["n"] == live["n"] == 16
            # float for float: repr round trip through the JSONL sink
            for k in ("mean_abs_rel_err", "p90_abs_rel_err",
                      "tail_mean_abs_rel_err"):
                assert rep[k] == live[k], k
            out.append(rep)
    e_off = audit.error_report(p_off, tail=4)["tail_mean_abs_rel_err"]
    e_on = audit.error_report(p_on, tail=4)["tail_mean_abs_rel_err"]
    assert e_off == pytest.approx(2 / 3, rel=1e-3)
    assert e_on < 0.05 and e_on < 0.2 * e_off
    out.append(audit.audit_report(p_on, tail=4))
    return out


def sc_audit_dispatch_records_dedupe_by_seq(ns, g):
    audit = AUDIT[ns.name]
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=51)
    tr = ns.Tracer(clock=ns.StepClock())
    sched = _fake_sched(ns, g, tracer=tr)
    sched.run(wl)
    rows = audit.dispatch_records(tr)
    assert len(rows) == len(sched.last_dispatches) == 2
    assert [r["seq"] for r in rows] == [0, 1]
    # 6 member dispatch spans collapse to 2 group rows
    assert len(audit.spans_named(tr, "dispatch")) == 6
    for row, d in zip(rows, sorted(sched.last_dispatches,
                                   key=lambda d: d.predicted_ms == 0)):
        assert row["batch"] == d.n_real
    return rows


def sc_audit_drift_flags_perturbed_coefficient(ns, g):
    """Feed service times from θ* = 3θ and the trace-refit θ̂ must drift
    toward θ* on the exercised columns."""
    audit = AUDIT[ns.name]
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=4, seed=52)
    tr = ns.Tracer(clock=ns.StepClock())
    base = _base_coeffs(ns, g)
    sched = ns.BatchScheduler(
        g, tracer=tr, telemetry=ns.TelemetryBuffer(refit=False),
        dispatcher=ns.FakeDispatcher(service_model=ns.planner_service_model(
            {k: 3.0 * v for k, v in base.items()})))
    for _ in range(4):
        sched.run(wl)
    drift = audit.coefficient_drift(tr, coeffs=base)
    moved = {k: v for k, v in drift.items() if v["abs_delta"] > 0}
    assert moved, "no coefficient drifted"
    fitted = audit.refit_from_trace(tr, coeffs=base)
    rows = audit.dispatch_records(tr)
    X = np.stack([np.asarray(r["group_features"]) for r in rows])
    y = np.asarray([r["group_measured_ms"] for r in rows])
    theta = np.asarray([float(fitted[k]) for k in drift])
    if ns.name == "port":
        assert np.array_equal(theta, coeff_vector(fitted))
    err_hat = np.abs(X @ theta - y) / y
    inc = np.asarray([base[k] for k in drift])
    err_inc = np.abs(X @ inc - y) / y
    # θ̂ explains the measured times far better than the incumbent
    assert err_hat.mean() < 0.1 * err_inc.mean()
    return drift, fitted, [float(x) for x in err_hat]


def sc_audit_plan_accuracy_from_consistent_trace(ns, g):
    """Service times ARE the planner's own model (θ* = θ): every chosen plan
    is optimal under the trace-refit θ̂, so the paper's within-X% metric
    comes out at 1.0."""
    audit = AUDIT[ns.name]
    wl = ns.make_workload(g, templates=("Q2", "Q4"), n_per_template=3, seed=53)
    tr = ns.Tracer(clock=ns.StepClock())
    base = _base_coeffs(ns, g)
    sched = ns.BatchScheduler(
        g, tracer=tr,
        dispatcher=ns.FakeDispatcher(service_model=ns.planner_service_model(base)))
    sched.run(wl)
    acc = audit.plan_accuracy(tr, within=0.10, coeffs=base)
    assert acc["n_decisions"] == 2
    assert acc["n_queries"] == len(wl)
    assert acc["frac_within"] == 1.0
    assert acc["mean_ratio"] == pytest.approx(1.0, abs=0.05)
    rep = audit.audit_report(tr, coeffs=base)
    assert rep["n_dispatches"] == 2
    assert rep["plan"]["frac_within"] == 1.0
    assert rep["error"]["n"] == 2
    assert rep["error"]["mean_abs_rel_err"] < 1e-6
    return acc, rep


def sc_query_summaries_rollup(ns, g):
    audit = AUDIT[ns.name]
    wl = ns.make_workload(g, templates=("Q2",), n_per_template=2, seed=54)
    tr = ns.Tracer(clock=ns.StepClock())
    sched = _fake_sched(ns, g, tracer=tr,
                        admission=ns.AdmissionPolicy(headroom=1.0))
    for inst in wl:
        sched.submit(inst, deadline_s=600.0, now=0.0)
    sched.flush()
    rows = audit.query_summaries(tr)
    assert len(rows) == 2
    for row in rows:
        assert row["template"] == "Q2" and row["status"] == "done"
        assert row["verdict"] == "admit" and row["seq"] == 0
        assert row["predicted_ms"] > 0 and row["measured_ms"] > 0
    return rows


def test_audit_reproduces_live_telemetry_exactly(graphs, tmp_path):
    SP.assert_same(sc_audit_reproduces_live_telemetry_exactly, graphs, tmp_path)


@pytest.mark.parametrize("scenario", [
    sc_audit_dispatch_records_dedupe_by_seq,
    sc_audit_drift_flags_perturbed_coefficient,
    sc_audit_plan_accuracy_from_consistent_trace,
    sc_query_summaries_rollup,
], ids=lambda f: f.__name__[3:])
def test_audit_scenario_equals_reference(graphs, scenario):
    SP.assert_same(scenario, graphs)


def test_audit_names_the_ports_coefficients(graphs):
    tr = Tracer(clock=StepClock())
    wl = make_workload(graphs["port"], templates=("Q2",), n_per_template=2, seed=5)
    _fake_sched(SP.PORT, graphs["port"], tracer=tr).run(wl)
    assert tuple(TA.coefficient_drift(tr)) == COEFF_KEYS
    assert "theta_scatter_cuda" in COEFF_KEYS


# =========================================================== trace report
def test_trace_report_equals_reference(graphs, tmp_path):
    """Both scripts render one trace of the port's scheduler (admission,
    telemetry, a failed group) to the same text, audit included."""
    g = graphs["port"]
    wl = make_workload(g, templates=("Q2", "Q4"), n_per_template=2, seed=56)
    p = str(tmp_path / "trace.jsonl")
    tr = Tracer(clock=StepClock(), sink=p)
    sched = BatchScheduler(g, tracer=tr, telemetry=TelemetryBuffer(refit=False),
                           admission=AdmissionPolicy(headroom=1.0),
                           dispatcher=FakeDispatcher(
                               service_model=constant_service_model(1e-3)),
                           device="cpu", impl="torch")
    for inst in wl:
        sched.submit(inst, deadline_s=600.0, now=0.0)
    sched.flush()
    tr.close()
    outs = {}
    for name in ("trace_report.py", "torch_trace_report.py"):
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "scripts", name), p,
             "--limit", "-1", "--audit"],
            capture_output=True, text=True, timeout=300,
            env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert out.returncode == 0, out.stderr
        outs[name] = out.stdout
    got = outs["torch_trace_report.py"]
    assert got == SP.to_port_names(outs["trace_report.py"])
    for s in ("workload rollup", "queries: 4", "cost-model audit",
              "frac_within", "theta_scatter_cuda"):
        assert s in got
