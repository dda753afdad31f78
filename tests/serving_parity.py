"""Run one serving scenario in the reference package and in the port, and
compare what each observed.

A scenario is a function ``scenario(ns, graph)`` written once against a
namespace ``ns`` that names one package's serving stack (``REF`` or
``PORT``).  It drives the scheduler exactly as a reference test does,
asserts the reference test's own properties, and returns its observations:
decision sequences, results, dispatches, counters, metric snapshots and
span records.  ``assert_same`` runs it in both packages, maps the
reference's impl names onto the port's (``xla`` → ``torch``, ``pallas`` →
``cuda``) and requires the two observations to be equal, floats included.
"""
import math
import types

import numpy as np
import pytest
import torch

import repro.core.engine_sliced as JES
import repro.core.query as JQ
import repro.graphdata.queries as JW
import repro.obs as JO
import repro.obs.trace as JOT
import repro.serving as JS
import repro.serving.faults as JSF
import repro.serving.replay as JSR
import repro.serving.testing as JST
import repro_torch.core.engine_sliced as TES
import repro_torch.core.query as TQ
import repro_torch.graphdata.queries as TW
import repro_torch.obs as TO
import repro_torch.obs.trace as TOT
import repro_torch.serving as TS
import repro_torch.serving.faults as TSF
import repro_torch.serving.replay as TSR
import repro_torch.serving.testing as TST

IMPL_NAMES = {"xla": "torch", "pallas": "cuda"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small tensors: faster here, and
    the suite runs test files in parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _namespace(name, S, ST, SF, SR, O, OT, W, Q, ES, xla, pallas, sched_kw):
    def scheduler(graph, **kw):
        for k, v in sched_kw.items():
            kw.setdefault(k, v)
        return S.BatchScheduler(graph, **kw)

    return types.SimpleNamespace(
        name=name, XLA=xla, PALLAS=pallas, BatchScheduler=scheduler,
        AdmissionPolicy=S.AdmissionPolicy,
        AdmissionController=S.AdmissionController,
        TelemetryBuffer=S.TelemetryBuffer, replay_workload=S.replay_workload,
        FaultPlan=S.FaultPlan, RetryPolicy=S.RetryPolicy,
        FAULT_POINTS=SF.FAULT_POINTS, DONE=SR.DONE, FAILED=SR.FAILED,
        REJECTED=SR.REJECTED,
        FakeDispatcher=ST.FakeDispatcher,
        constant_service_model=ST.constant_service_model,
        planner_service_model=ST.planner_service_model,
        fake_count=ST.fake_count,
        Tracer=O.Tracer, StepClock=O.StepClock,
        MetricsRegistry=O.MetricsRegistry, span_trees=O.span_trees,
        load_jsonl=O.load_jsonl, NULL_TRACER=O.NULL_TRACER,
        NullTracer=O.NullTracer, NULL_SPAN=OT._NULL_SPAN,
        make_workload=W.make_workload, QueryInstance=W.QueryInstance,
        Q=Q, sliceable=ES.sliceable)


#: the reference package (its default impl 'xla')
REF = _namespace("ref", JS, JST, JSF, JSR, JO, JOT, JW, JQ, JES,
                 "xla", "pallas", {})
#: the port on the CPU, on its plain lowering (the reference's default)
PORT = _namespace("port", TS, TST, TSF, TSR, TO, TOT, TW, TQ, TES,
                  "torch", "cuda", dict(device="cpu", impl="torch"))


def to_port_names(x):
    """The reference's observations with its impl names replaced by the
    port's, everywhere a string holds them (rung labels, cache-key reprs,
    error messages, coefficient names)."""
    if isinstance(x, str):
        for a, b in IMPL_NAMES.items():
            x = x.replace(a, b)
        return x
    if isinstance(x, dict):
        return {to_port_names(k): to_port_names(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(to_port_names(v) for v in x)
    return x


def canon(x):
    """Observations as plain comparable values: arrays to lists, NaN to a
    marker (NaN != NaN), numpy scalars to Python numbers."""
    if isinstance(x, np.ndarray):
        return canon(x.tolist())
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, float) and math.isnan(x):
        return "NaN"
    if isinstance(x, dict):
        return {canon(k): canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(canon(v) for v in x)
    return x


def assert_same(scenario, graphs, *args):
    want = to_port_names(canon(scenario(REF, graphs["ref"], *args)))
    got = canon(scenario(PORT, graphs["port"], *args))
    assert got == want


# ------------------------------------------------------------ observations
def results(res):
    return [(r.template, r.engine, r.split, r.count, r.latency_ms, r.ok,
             r.batch_size, r.error, r.deadline, r.status) for r in res]


def dispatches(sched):
    return [(d.key, d.engine, d.split, d.n_real, d.n_pad, d.service_s,
             d.indices, d.plan_cached, d.exec_cached, d.impl, d.deadline,
             d.predicted_ms, d.n_retries, d.penalty_s, d.fallback_from,
             d.delta)
            for d in sched.last_dispatches]


def calls(ns, fd):
    return [(c.split, c.mode, c.engine, c.impl, c.n_real, c.n_pad,
             c.service_s, [ns.fake_count(q) for q in c.queries])
            for c in fd.calls]


def decision(dec):
    if dec is None:
        return None
    return (dec.action, dec.reason, dec.deadline, dec.predicted_s,
            dec.predicted_wait_s, dec.impl, dec.engine, dec.max_batch,
            dec.rungs)


def report(rep):
    d = rep.as_dict()
    d["latencies_ms"] = rep.latencies_ms
    d["statuses"] = rep.statuses
    return d


def fault_report(sched):
    """The fault counters both packages keep."""
    rep = sched.fault_report()
    return {k: rep[k] for k in ("n_retries", "n_quarantined", "n_timeout",
                                "n_fallbacks", "partitioned_available",
                                "fault_plan") if k in rep}
