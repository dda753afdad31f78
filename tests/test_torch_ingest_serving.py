"""Live-graph serving in the port (``serving/epochs.py``, the scheduler's
``pin_epoch`` and delta dispatch, ``launch/query.py --live/--wal``) against
the reference package's.

  * the epoch-pinning and cache-metric scenario of the reference's
    ``test_ingest.py`` runs in both packages on the same event stream: the
    cache counters, delta dispatches, fingerprints and answers are equal;
  * the conformance matrix's ingestion leg (plain-2hop, plain-bidir and
    agg-min-2hop × 3 modes, on dense, sliced and partitioned): each epoch's
    answers equal a scheduler built from scratch on the port's
    ``materialize`` of that epoch AND the JAX package's pinned scheduler,
    and unsealed events never change a pinned epoch's answers;
  * the two WAL scenarios of the reference's ``test_serving_faults.py``
    (clean recovery, a torn tail then continued ingestion), with recovered
    fingerprints equal to the reference's;
  * the CLI's ``--live --wal`` fresh and then recovering, printing the JAX
    CLI's fingerprint lines.

Every comparison of answers is ``np.array_equal``."""
import dataclasses
import sys
import types

import numpy as np
import pytest

import conformance as C
import serving_parity as SP
from repro.graphdata import ingest as J
from repro.launch import query as JLQ
from repro.serving import EpochManager as JEpochManager
from repro.serving import TornWriteError as JTornWriteError
from repro_torch import interop
from repro_torch.graphdata import ingest as T
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
from repro_torch.launch import query as TLQ
from repro_torch.serving import BatchScheduler, EpochManager, TornWriteError
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("total", "per_vertex", "minmax")


def _ns(base, M, Mgr, Torn):
    return types.SimpleNamespace(**vars(base), ingest=M, EpochManager=Mgr,
                                 TornWriteError=Torn)


REF = _ns(SP.REF, J, JEpochManager, JTornWriteError)
PORT = _ns(SP.PORT, T, EpochManager, TornWriteError)


@pytest.fixture(scope="module")
def graphs(small_dynamic_graph, small_static_graph):
    return {
        "dynamic": {"ref": small_dynamic_graph, "port": generate_ldbc(
            LdbcParams(n_persons=40, seed=5, dynamic=True))},
        "static": {"ref": small_static_graph, "port": generate_ldbc(
            LdbcParams(n_persons=60, seed=3, dynamic=False))},
    }


def _np(x):
    return None if x is None else np.asarray(x)


def _answers(res):
    return [tuple(_np(getattr(r, f)) for f in FIELDS) for r in res]


def _assert_answers_equal(a, b, ctx):
    assert len(a) == len(b), ctx
    for i, (x, y) in enumerate(zip(a, b)):
        for f, u, v in zip(FIELDS, x, y):
            assert (u is None) == (v is None), (ctx, i, f)
            if u is not None:
                assert np.array_equal(u, v), (ctx, i, f)


# =========================================================================
# the scheduler: epoch pinning, delta dispatch, cache metrics
# =========================================================================
def sc_epoch_pinning_and_cache_metrics(ns, g):
    M = ns.ingest
    log, held = M.log_from_graph(g, holdout_edges=30, seed=7)
    mx = ns.MetricsRegistry()
    mgr = ns.EpochManager(log, compact_every=10, metrics=mx)
    e0 = mgr.seal()
    wl = [i.qry for i in ns.make_workload(e0.graph, n_per_template=1, seed=11)]
    sched = ns.BatchScheduler(e0.graph, metrics=mx, keep_outputs=True)
    mgr.attach(sched)
    assert sched.pinned_epoch is e0 and e0.compacted

    cache = mx.counter("granite_cache_total", "serving cache events",
                       labelnames=("cache", "event"))

    def counts(ev):
        return cache.value(cache="executable", event=ev)

    obs = dict(fps=[e0.fingerprint], answers=[])
    obs["answers"].append(_answers(sched.run(wl)))
    miss0 = counts("miss")
    assert miss0 > 0 and counts("invalidation") == 0

    # epoch 1: pure edge appends — delta dispatch, no invalidation
    mgr.ingest(held[:15])
    ep1 = mgr.advance(sched)
    assert not ep1.compacted and ep1.delta is not None
    obs["answers"].append(_answers(sched.run(wl)))
    nd1 = sum(1 for d in sched.last_dispatches if d.delta)
    assert nd1 > 0
    assert counts("invalidation") == 0
    obs["delta_dispatches"] = [nd1]

    # epoch 2: same shape groups — the delta executable must now HIT
    hits1 = counts("hit")
    mgr.ingest(held[15:])
    ep2 = mgr.advance(sched)
    assert not ep2.compacted
    obs["answers"].append(_answers(sched.run(wl)))
    assert sum(1 for d in sched.last_dispatches if d.delta) == nd1
    assert counts("hit") > hits1

    # part fingerprints evolve only for touched types
    touched = {t for ev in log.epoch_events(2)
               for t in (int(g.v_type[ev.data[0]]), int(g.v_type[ev.data[1]]))}
    for t, fp in ep2.part_fingerprints.items():
        if t in touched:
            assert fp != ep1.part_fingerprints[t], t
        else:
            assert fp == ep1.part_fingerprints[t], t

    # snapshot isolation: unsealed events don't perturb pinned results
    before = _answers(sched.run(wl))
    mgr.ingest([M.add_vertex(g.n_vertices, 0, g.lifespan)])
    after = _answers(sched.run(wl))
    _assert_answers_equal(before, after, "snapshot isolation")

    # compaction: retired fingerprints evicted and counted
    ep3 = mgr.advance(sched, compact=True)
    assert ep3.compacted and counts("invalidation") > 0
    assert ep3.base_fingerprint != ep1.base_fingerprint
    sched.run(wl)
    ref = _answers(ns.BatchScheduler(M.materialize(log, log.n_epochs),
                                     keep_outputs=True).run(wl))
    got = _answers(sched.run(wl))
    _assert_answers_equal(got, ref, "compacted vs from scratch")
    obs["answers"].append(got)
    for ep in (ep1, ep2, ep3):
        obs["fps"].append((ep.id, ep.fingerprint, ep.base_fingerprint,
                           sorted(ep.part_fingerprints.items()), ep.compacted,
                           ep.n_delta_edges, ep.n_events))
    obs["cache"] = {ev: counts(ev) for ev in ("hit", "miss", "invalidation")}
    obs["plan_cache"] = {ev: cache.value(cache="plan", event=ev)
                         for ev in ("hit", "miss", "invalidation")}
    obs["dispatch_delta"] = [d.delta for d in sched.last_dispatches]
    obs["epochs"] = mx["granite_epochs_total"].value()
    obs["compactions"] = mx["granite_compactions_total"].value()
    obs["delta_edges"] = mx["granite_delta_edges"].value()
    obs["events"] = mx["granite_ingest_events_total"].value()
    return obs


def test_scheduler_epoch_pinning_and_cache_metrics(graphs):
    """The reference's scenario in both packages on the same event stream:
    every counter, delta dispatch, fingerprint and answer is equal."""
    g = graphs["dynamic"]
    ref = sc_epoch_pinning_and_cache_metrics(REF, g["ref"])
    got = sc_epoch_pinning_and_cache_metrics(PORT, g["port"])
    answers = (ref.pop("answers"), got.pop("answers"))
    assert SP.canon(got) == SP.canon(ref)
    for k, (a, b) in enumerate(zip(*answers)):
        _assert_answers_equal(b, a, ("epoch", k))
    assert got["cache"]["invalidation"] > 0 and got["delta_dispatches"][0] > 0


def test_delta_block_lives_on_the_schedulers_device(graphs):
    g = graphs["dynamic"]["port"]
    log, held = T.log_from_graph(g, holdout_edges=10, seed=3)
    mgr = EpochManager(log)
    sched = BatchScheduler(mgr.seal().graph, device="cpu", impl="torch")
    mgr.attach(sched)
    assert sched._delta is None
    mgr.ingest(held)
    ep = mgr.advance(sched)
    assert sched._delta is ep.delta.device("cpu")
    assert all(v.device == sched.device for k, v in sched._delta.items()
               if k != "eprops_t")


# =========================================================================
# conformance ingestion leg: all three engines, serving during ingestion
# =========================================================================
INGEST_SEEDS = {"plain-2hop": 11, "plain-bidir": 12, "agg-min-2hop": 13}


def _ingestion_leg(ns, graph, qry, mode, engine, n_workers, seed,
                   n_epochs=2, frozen_and_scratch=True):
    """One package's live leg: each epoch's (before, after) answers, the
    from-scratch and frozen schedulers' answers (port only) and the pinned
    fingerprints."""
    M = ns.ingest
    held_n = max(6, 3 * n_epochs)
    log, held = M.log_from_graph(graph, holdout_edges=held_n, seed=seed)
    per = len(held) // n_epochs
    chunks = [held[i * per:(i + 1) * per] for i in range(n_epochs - 1)]
    chunks.append(held[(n_epochs - 1) * per:])
    kw = dict(engine=engine, mode=mode, n_buckets=C.N_BUCKETS,
              n_workers=max(n_workers, 1), keep_outputs=True)
    mgr = ns.EpochManager(log)
    ep = mgr.seal()
    sched = ns.BatchScheduler(ep.graph, **kw)
    mgr.attach(sched)
    out = []
    for k, chunk in enumerate(chunks, start=1):
        mgr.ingest(chunk)
        before = sched.run([qry])[0]
        mgr.advance(sched)
        after = sched.run([qry])[0]
        row = dict(before=_answers([before]), after=_answers([after]),
                   fp=mgr.current.fingerprint,
                   delta=[d.delta for d in sched.last_dispatches])
        if frozen_and_scratch:
            ref_graph = M.materialize(mgr.log, k + 1)
            row["scratch"] = _answers(ns.BatchScheduler(ref_graph, **kw).run([qry]))
            row["frozen"] = _answers(ns.BatchScheduler(ep.graph, **kw).run([qry]))
        out.append(row)
        ep = mgr.current
    return out


@pytest.mark.parametrize("case_name", ["plain-2hop", "plain-bidir",
                                       "agg-min-2hop"])
@pytest.mark.parametrize("mode", C.ALL_MODES)
def test_conformance_ingestion_leg(graphs, case_name, mode):
    g = graphs["dynamic"]
    case = C.case_matrix(g["ref"])[case_name]
    qry = interop.query_from_dict(dataclasses.asdict(case.qry))
    engines = C.serving_engines(case)
    assert {e for e, _ in engines} >= {"dense", "partitioned"}
    for engine, n_workers in engines:
        ctx = (case_name, mode, engine, n_workers)
        seed = INGEST_SEEDS[case_name]
        port = _ingestion_leg(PORT, g["port"], qry, mode, engine, n_workers, seed)
        ref = _ingestion_leg(REF, g["ref"], case.qry, mode, engine, n_workers,
                             seed, frozen_and_scratch=False)
        for k, (p, r) in enumerate(zip(port, ref), start=1):
            assert p["fp"] == r["fp"], (ctx, k)
            assert p["delta"] == r["delta"], (ctx, k)
            _assert_answers_equal(p["after"], p["scratch"], (ctx, k, "scratch"))
            _assert_answers_equal(p["after"], r["after"], (ctx, k, "jax"))
            # snapshot isolation: the pinned epoch ignores unsealed events
            _assert_answers_equal(p["before"], p["frozen"], (ctx, k, "isolation"))
            _assert_answers_equal(p["before"], r["before"], (ctx, k, "jax before"))


# =========================================================================
# WAL recovery
# =========================================================================
def _build_epochs(ns, graph, path, holdout=60, fault_plan=None):
    log, held = ns.ingest.log_from_graph(graph, holdout_edges=holdout, seed=7)
    log.attach_wal(path, fault_plan=fault_plan)
    mgr = ns.EpochManager(log, compact_every=2)
    mgr.seal()
    mgr.ingest(held[:20])
    mgr.seal()
    mgr.ingest(held[20:40])
    mgr.seal()
    return mgr, held


def sc_wal_clean_recovery(ns, g, tmp_path):
    wal = str(tmp_path / f"{ns.name}-clean.wal")
    mgr, _ = _build_epochs(ns, g, wal)
    pre = mgr.current
    mgr.log.close_wal()
    mx = ns.MetricsRegistry()
    mgr2 = ns.EpochManager.recover(wal, compact_every=2, metrics=mx)
    assert mgr2.current.fingerprint == pre.fingerprint
    assert mgr2.current.compacted == pre.compacted
    assert mgr2.log.n_epochs == 3 and mgr2.log.n_open == 0
    assert mx.counter("granite_recovery_epochs").value() == 3
    fp = {t: f for t, f in pre.part_fingerprints.items()}
    assert mgr2.current.part_fingerprints == fp
    mgr2.log.close_wal()
    with open(wal, "rb") as f:
        data = f.read()
    return (pre.fingerprint, pre.base_fingerprint, pre.compacted,
            sorted(fp.items()), data)


def test_wal_clean_recovery_bit_identical(graphs, tmp_path):
    """Recovering a cleanly written WAL replays every sealed epoch to the
    exact pre-crash pinned fingerprint — the reference's, from a WAL equal
    to the reference's byte for byte."""
    g = graphs["static"]
    ref = sc_wal_clean_recovery(REF, g["ref"], tmp_path)
    got = sc_wal_clean_recovery(PORT, g["port"], tmp_path)
    assert got == ref


def sc_wal_torn_tail(ns, g, tmp_path):
    wal = str(tmp_path / f"{ns.name}-torn.wal")
    mgr, held = _build_epochs(ns, g, wal)
    pre_fp = mgr.current.fingerprint
    # re-attach with a plan that tears the 3rd post-attach append mid-line
    mgr.log.close_wal()
    mgr.log.attach_wal(wal, fault_plan=ns.FaultPlan(schedule={"wal": {2}}))
    with pytest.raises(ns.TornWriteError):
        mgr.ingest(held[40:])
    del mgr                                    # the crash
    with open(wal, "rb") as f:
        torn = f.read()

    mgr2 = ns.EpochManager.recover(wal, compact_every=2)
    assert mgr2.current.fingerprint == pre_fp  # sealed state fully intact
    assert mgr2.log.n_epochs == 3
    survivors = mgr2.log.n_open                # appends before the tear
    assert survivors == 2
    # ingestion continues where it left off: same final graph as a run
    # that never crashed
    mgr2.ingest(held[40 + survivors:])
    ep = mgr2.seal()
    ref_mgr, _ = _build_epochs(ns, g, str(tmp_path / f"{ns.name}-ref.wal"))
    ref_mgr.ingest(held[40:])
    want = ref_mgr.seal()
    assert ep.fingerprint == want.fingerprint
    mgr2.log.close_wal()
    ref_mgr.log.close_wal()
    with open(wal, "rb") as f:
        continued = f.read()
    return pre_fp, survivors, ep.fingerprint, ep.base_fingerprint, torn, continued


def test_wal_torn_tail_recovery(graphs, tmp_path):
    """A write torn mid-line is truncated at recovery, every sealed epoch
    replays, and ingestion continues on the re-attached WAL — with the
    reference's fingerprints and the reference's file bytes at each step."""
    g = graphs["static"]
    ref = sc_wal_torn_tail(REF, g["ref"], tmp_path)
    got = sc_wal_torn_tail(PORT, g["port"], tmp_path)
    assert got == ref


# =========================================================================
# the CLI
# =========================================================================
LIVE_ARGS = ["--persons", "300", "--queries", "1", "--live", "--holdout", "24",
             "--epochs", "3"]


def _fp_lines(out: str) -> list:
    """The lines that name fingerprints, with the latency figures cut."""
    keep = []
    for line in out.splitlines():
        if "fp=" in line:
            keep.append(line.split(" avg=")[0].strip())
        elif line.startswith("recovered "):
            keep.append(line)
    return keep


def test_cli_live_wal_fresh_then_recovering(capsys, tmp_path, monkeypatch):
    """``--live --wal``: a fresh start journals and serves four epochs; the
    second start on the same path recovers them and pins the first run's
    last fingerprint.  Both runs print the JAX CLI's fingerprint lines."""
    outs = {}
    for name in ("ref", "port"):
        wal = str(tmp_path / f"{name}.wal")
        runs = []
        for _ in range(2):
            if name == "port":
                TLQ.main(["--device", "cpu", "--wal", wal] + LIVE_ARGS)
            else:
                monkeypatch.setattr(sys, "argv", ["query", "--wal", wal] + LIVE_ARGS)
                JLQ.main()
            runs.append(capsys.readouterr().out)
        outs[name] = [_fp_lines(r.replace(wal, "<wal>")) for r in runs]
    fresh, recovered = outs["port"]
    assert fresh == outs["ref"][0] and recovered == outs["ref"][1]
    n = fresh[0].split("done=")[1].split("/")[1]
    assert len(fresh) == 4 and all(f"done={n}/{n}" in line for line in fresh)
    last_fp = fresh[-1].split("fp=")[1].split()[0]
    assert recovered[0].startswith("recovered 4 sealed epoch(s)")
    assert f"pinned fp {last_fp}" in recovered[0]
    assert recovered[1].startswith(f"epoch 3: fp={last_fp}")


@pytest.mark.skipif(__import__("torch").cuda.is_available(),
                    reason="the rule is for a host without a GPU")
def test_cli_live_without_a_gpu_raises(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLQ.main(["--persons", "60", "--live", "--wal", str(tmp_path / "x.wal")])
    assert not (tmp_path / "x.wal").exists()
