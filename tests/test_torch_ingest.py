"""The port's streaming ingestion (``graphdata/ingest.py``) and base+delta
execution (``core/engine.batch_executable_delta``) against the reference
package's.

The reference's ``test_ingest.py`` scenarios that need no scheduler run on
the port, and each also holds the port to the JAX package on the same
input: the events ``log_from_graph`` writes, every epoch's ``Materializer``
and ``materialize`` arrays, the ``DeltaSpec`` arrays, the fingerprints, the
WAL file byte for byte, the delta executable's answers (3 modes × impl
torch/cuda, the kernels' plain versions on the CPU) and the partition
carried over an epoch.  Every comparison is ``np.array_equal``.  The
serving scenarios are in ``test_torch_ingest_serving.py``."""
import dataclasses

import numpy as np
import pytest

import conformance as C
from repro.core import engine as JE
from repro.core import engine_partitioned as JEP
from repro.core import query as JQ
from repro.graphdata import ingest as J
from repro.serving import EpochManager as JEpochManager
from repro.serving.cache import graph_fingerprint as j_fingerprint
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import engine_partitioned as TEP
from repro_torch.graphdata import ingest
from repro_torch.graphdata.ingest import (EventLog, add_edge, add_vertex,
                                          close_edge, close_vertex,
                                          events_fingerprint, log_from_graph,
                                          materialize, set_vprop)
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
from repro_torch.serving import EpochManager
from repro_torch.serving.cache import graph_fingerprint
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

GRAPH_FIELDS = ("v_type", "v_life", "e_src", "e_dst", "e_type", "e_life")
TRAVERSAL = ("t_src", "t_dst", "t_life", "t_type", "t_isfwd", "t_eid",
             "arr_ptr")


@pytest.fixture(scope="module")
def port_graph():
    """The port's build of the reference's ``small_dynamic_graph``."""
    return generate_ldbc(LdbcParams(n_persons=40, seed=5, dynamic=True))


@pytest.fixture(scope="module")
def port_static_graph():
    """The port's build of the reference's ``small_static_graph``."""
    return generate_ldbc(LdbcParams(n_persons=60, seed=3, dynamic=False))


def _events(evs):
    return [(e.kind, e.key, e.data) for e in evs]


def assert_graphs_equal(ref, got, ctx):
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(ref, f), getattr(got, f)), (ctx, f)
    for f in TRAVERSAL:
        assert np.array_equal(ref.traversal[f], got.traversal[f]), (ctx, f)
    for name in ("vprops", "eprops"):
        a, b = getattr(ref, name), getattr(got, name)
        assert sorted(a) == sorted(b), (ctx, name)
        for k in a:
            assert np.array_equal(a[k].vals, b[k].vals), (ctx, name, k)
            assert np.array_equal(a[k].life, b[k].life), (ctx, name, k)
    assert (ref.n_vertex_types, ref.n_edge_types, tuple(ref.lifespan)) == \
        (got.n_vertex_types, got.n_edge_types, tuple(got.lifespan)), ctx


# =========================================================================
# event-log validation
# =========================================================================
def test_event_log_validation():
    log = EventLog(2, 1, (0, 100))
    log.append(add_vertex(0, 0, (0, 50)))
    log.append(add_vertex(1, 1, (10, 100)))
    with pytest.raises(ValueError, match="duplicate vertex"):
        log.append(add_vertex(0, 0, (0, 50)))
    with pytest.raises(ValueError, match="type .* out of range"):
        log.append(add_vertex(2, 5, (0, 50)))
    with pytest.raises(ValueError, match="empty vertex lifespan"):
        log.append(add_vertex(2, 0, (30, 30)))
    with pytest.raises(ValueError, match="unknown vertex"):
        log.append(add_edge(0, 0, 9, 0, (10, 40)))
    with pytest.raises(ValueError, match="outside vertex"):
        log.append(add_edge(0, 0, 1, 0, (5, 40)))   # starts before v1
    log.append(add_edge(0, 0, 1, 0, (10, 40)))
    with pytest.raises(ValueError, match="duplicate edge"):
        log.append(add_edge(0, 1, 0, 0, (10, 40)))
    with pytest.raises(ValueError, match="truncates a live incident edge"):
        log.append(close_vertex(0, 20))
    log.append(close_edge(0, 30))
    # the incident-edge bound is conservative: it tracks the max lifespan
    # any incident edge was ADDED with, so the vertex close must clear 40
    log.append(close_vertex(0, 40))
    with pytest.raises(ValueError, match="unknown entity"):
        log.append(set_vprop(7, 0, 1, (0, 10)))
    assert log.n_open == len(log)
    log.seal()
    assert log.n_open == 0 and log.n_epochs == 1
    g = materialize(log)
    assert g.n_vertices == 2 and g.n_edges == 1
    assert tuple(g.e_life[0]) == (10, 30)
    assert tuple(g.v_life[0]) == (0, 40)


def test_epoch0_rebuilds_source_graph(port_graph):
    g = port_graph
    log, held = log_from_graph(g)
    assert held == []
    g0 = materialize(log)
    assert np.array_equal(g0.v_type, g.v_type)
    assert np.array_equal(g0.v_life, g.v_life)
    assert g0.n_edges == g.n_edges

    # edges re-sort into canonical key order; compare as row sets
    def rows(gg):
        return {tuple(r) for r in np.stack(
            [gg.e_src, gg.e_dst, gg.e_type, gg.e_life[:, 0], gg.e_life[:, 1]],
            axis=1)}
    assert rows(g0) == rows(g)
    # property columns may re-pivot slot order; compare populated row sets
    for pk, col in g.vprops.items():
        want = {(int(e), int(col.vals[e, s]), *map(int, col.life[e, s]))
                for e, s in zip(*np.nonzero(col.vals != ingest.NO_VALUE))}
        c0 = g0.vprops[pk]
        got = {(int(e), int(c0.vals[e, s]), *map(int, c0.life[e, s]))
               for e, s in zip(*np.nonzero(c0.vals != ingest.NO_VALUE))}
        assert got == want, pk


@pytest.mark.parametrize("graph_name", ["small_dynamic_graph",
                                        "small_static_graph"])
@pytest.mark.parametrize("holdout,seed", [(0, 0), (37, 5)])
def test_log_from_graph_events_equal_reference(request, port_graph,
                                               port_static_graph, graph_name,
                                               holdout, seed):
    """The port's column-wise decomposition writes the reference's events,
    element for element and in order, held-out edges included."""
    ref_graph = request.getfixturevalue(graph_name)
    g = port_graph if graph_name == "small_dynamic_graph" else port_static_graph
    for f in GRAPH_FIELDS:
        assert np.array_equal(getattr(ref_graph, f), getattr(g, f)), f
    jlog, jheld = J.log_from_graph(ref_graph, holdout_edges=holdout, seed=seed)
    tlog, theld = log_from_graph(g, holdout_edges=holdout, seed=seed)
    assert _events(tlog.epoch_events(0)) == _events(jlog.epoch_events(0))
    assert _events(theld) == _events(jheld)
    assert len(theld) == holdout and tlog.n_epochs == jlog.n_epochs == 1
    assert all(type(x) is int for e in theld for x in (e.key,) + e.data)
    assert_graphs_equal(J.materialize(jlog), materialize(tlog), graph_name)


# =========================================================================
# incremental == from-scratch, across epoch varieties
# =========================================================================
def _mixed_epochs(g, held, M):
    """Three epochs: pure edge appends; vertex adds + props + an edge to a
    new vertex; closes on both base and appended entities (``M`` is either
    package's ingest module)."""
    V, EE = g.n_vertices, g.n_edges
    person = g.meta["builder"].v_type_ids["person"]
    lo, hi = g.lifespan
    yield held[: len(held) // 2]
    nv = [M.add_vertex(V, person, (lo, hi)), M.add_vertex(V + 1, person, (lo, hi))]
    pk = sorted(g.vprops)[0]
    yield nv + [M.set_vprop(V, pk, 7, (lo, hi)),
                M.add_edge(EE, V, V + 1, 0, (lo + 1, hi)),
                *held[len(held) // 2:]]
    # close just after the edge's start — always valid, truncates its life
    yield [M.close_edge(held[0].key, int(held[0].data[3]) + 1)]


def test_incremental_matches_materialize(small_dynamic_graph, port_graph):
    """Every epoch's incremental graph equals the port's from-scratch build
    and the JAX package's incremental and from-scratch builds; the delta
    blocks and fingerprints equal the reference's."""
    jlog, jheld = J.log_from_graph(small_dynamic_graph, holdout_edges=12, seed=3)
    log, held = log_from_graph(port_graph, holdout_edges=12, seed=3)
    mat, jmat = ingest.Materializer(log), J.Materializer(jlog)
    assert_graphs_equal(jmat.apply_next(), mat.apply_next(), 1)
    purity = []
    for k, (events, jevents) in enumerate(
            zip(_mixed_epochs(port_graph, held, ingest),
                _mixed_epochs(small_dynamic_graph, jheld, J)), start=2):
        assert _events(events) == _events(jevents)
        log.extend(events)
        log.seal()
        jlog.extend(jevents)
        jlog.seal()
        inc, jinc = mat.apply_next(), jmat.apply_next()
        ref = materialize(log, k)
        assert graph_fingerprint(inc) == graph_fingerprint(ref), k
        assert_graphs_equal(ref, inc, k)
        assert_graphs_equal(jinc, inc, k)
        assert_graphs_equal(J.materialize(jlog, k), ref, k)
        assert graph_fingerprint(inc) == j_fingerprint(jinc), k
        assert events_fingerprint("fp", log.epoch_events(k - 1)) == \
            J.events_fingerprint("fp", jlog.epoch_events(k - 1))
        assert mat.delta_pure == jmat.delta_pure, k
        purity.append(mat.delta_pure)
        spec, jspec = mat.delta_spec(), jmat.delta_spec()
        assert (spec is None) == (jspec is None), k
        if spec is not None:
            assert (spec.n_edges, spec.capacity, spec.eprop_slots) == \
                (jspec.n_edges, jspec.capacity, jspec.eprop_slots)
            assert sorted(spec.arrays) == sorted(jspec.arrays)
            for f in spec.arrays:
                assert np.array_equal(spec.arrays[f], jspec.arrays[f]), (k, f)
        assert np.array_equal(mat._remap_from_base, jmat._remap_from_base), k
    # the close on an appended edge keeps the window delta-pure; the
    # vertex/prop epoch broke it earlier
    assert purity == [True, False, False] and not mat.delta_pure


def test_delta_purity_tracking(port_graph):
    log, held = log_from_graph(port_graph, holdout_edges=8, seed=1)
    mat = ingest.Materializer(log)
    mat.apply_next()
    log.extend(held[:4])
    log.seal()
    mat.apply_next()
    assert mat.delta_pure and mat.delta_spec() is not None
    # close on an APPENDED edge keeps purity; close on a BASE edge breaks it
    log.append(close_edge(held[0].key, int(held[0].data[3]) + 1))
    log.seal()
    mat.apply_next()
    assert mat.delta_pure
    base_key = next(k for k in range(port_graph.n_edges)
                    if k not in {h.key for h in held})
    log.append(close_edge(base_key, int(log._e[base_key][2]) + 1))
    log.seal()
    mat.apply_next()
    assert not mat.delta_pure and mat.delta_spec() is None
    mat.compact()
    assert mat.delta_pure


def test_delta_spec_device_is_a_gdev(port_graph):
    """``DeltaSpec.device(device)`` gives torch tensors on the device it is
    asked for, cached per device, shaped like the engines' ``gdev``."""
    import torch

    log, held = log_from_graph(port_graph, holdout_edges=10, seed=2)
    mat = ingest.Materializer(log)
    mat.apply_next()
    log.extend(held)
    log.seal()
    mat.apply_next()
    spec = mat.delta_spec()
    dev = spec.device("cpu")
    assert spec.device(torch.device("cpu")) is dev
    n = 2 * spec.capacity
    for k, a in spec.arrays.items():
        assert dev[k].device.type == "cpu" and dev[k].shape[0] == n
        assert np.array_equal(dev[k].numpy(), a), k
    assert dev["t_src_l"].dtype == torch.int64
    assert torch.equal(dev["t_dst_l"], dev["t_dst"].long())
    assert int(dev["valid"].sum()) == 2 * spec.n_edges == 20
    assert sorted(dev["eprops_t"]) == sorted(port_graph.eprops)


# =========================================================================
# replay order-insensitivity (the satellite property test)
# =========================================================================
def _permuted_fingerprints(graph, perm_seed: int, M=ingest, fp=graph_fingerprint):
    log, held = M.log_from_graph(graph, holdout_edges=10, seed=2)
    base_events = log.epoch_events(0)
    rng = np.random.default_rng(perm_seed)
    log2 = M.EventLog(graph.n_vertex_types, graph.n_edge_types, graph.lifespan,
                      meta=dict(graph.meta), validate=False)
    log2.extend([base_events[i] for i in rng.permutation(len(base_events))])
    log2.seal()
    for lg, evs in ((log, held), (log2,
                                  [held[i]
                                   for i in rng.permutation(len(held))])):
        lg.extend(evs)
        lg.seal()
    fp1 = fp(M.materialize(log, 2))
    fp2 = fp(M.materialize(log2, 2))
    e1 = M.events_fingerprint("seed", log.epoch_events(1))
    e2 = M.events_fingerprint("seed", log2.epoch_events(1))
    return fp1, fp2, e1, e2


def test_replay_order_insensitive_seeded(small_dynamic_graph, port_graph):
    for seed in (0, 1, 2, 3):
        fp1, fp2, e1, e2 = _permuted_fingerprints(port_graph, seed)
        assert fp1 == fp2, seed
        assert e1 == e2, seed
        # the same fingerprints as the reference's on the same permutation
        assert (fp1, fp2, e1, e2) == _permuted_fingerprints(
            small_dynamic_graph, seed, J, j_fingerprint), seed


def test_replay_order_insensitive_hypothesis(port_graph):
    pytest.importorskip(
        "hypothesis", reason="property tests need the optional hypothesis "
        "dep (pip install hypothesis)")
    from hypothesis import given, settings
    from hypothesis import strategies as st

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1))
    def prop(seed):
        fp1, fp2, e1, e2 = _permuted_fingerprints(port_graph, seed)
        assert fp1 == fp2 and e1 == e2

    prop()


# =========================================================================
# the WAL, byte for byte
# =========================================================================
def _journaled_history(M, graph, path):
    """A WAL'd history: epoch 0 from the graph, two sealed epochs of held
    edges with compaction notes, a close, and an open suffix."""
    log, held = M.log_from_graph(graph, holdout_edges=20, seed=7)
    log.attach_wal(path)
    log.extend(held[:8])
    log.seal()
    log.wal_note(1, compacted=False)
    log.extend(held[8:16])
    log.append(M.close_edge(held[0].key, int(held[0].data[3]) + 1))
    log.seal()
    log.wal_note(2, compacted=True)
    log.extend(held[16:])
    log.close_wal()
    return log


def test_wal_byte_identical_to_reference(small_dynamic_graph, port_graph, tmp_path):
    """The port writes the reference's WAL for the same history built from
    the same graph — header (meta included), events, seals, notes and the
    chained fingerprints — and each package recovers the other's file."""
    jp, tp = str(tmp_path / "ref.wal"), str(tmp_path / "port.wal")
    _journaled_history(J, small_dynamic_graph, jp)
    log = _journaled_history(ingest, port_graph, tp)
    with open(jp, "rb") as a, open(tp, "rb") as b:
        ref, got = a.read(), b.read()
    assert got == ref and len(got) > 10_000
    back, notes = EventLog.from_wal(jp)
    jback, jnotes = J.EventLog.from_wal(tp)
    back.close_wal()
    jback.close_wal()
    assert notes == jnotes == [dict(k="note", epoch=1, compacted=False),
                               dict(k="note", epoch=2, compacted=True)]
    assert _events(back._events) == _events(jback._events) == _events(log._events)
    assert back._seals == jback._seals == log._seals
    assert back.n_open == 4
    assert back._wal_fp == jback._wal_fp


# =========================================================================
# delta execution == merged execution == the reference's delta execution
# =========================================================================
DELTA_CASES = ("plain-2hop", "plain-bidir", "agg-count", "agg-min-2hop")


@pytest.fixture(scope="module")
def delta_setup(small_dynamic_graph, port_graph):
    """Both packages' base, merged epoch and delta block for 20 held-out
    edges, and the JAX delta executable's answers per mode (computed once)."""
    out = {}
    for name, M, g in (("ref", J, small_dynamic_graph), ("port", ingest, port_graph)):
        log, held = M.log_from_graph(g, holdout_edges=20, seed=4)
        mat = M.Materializer(log)
        base = mat.apply_next()
        log.extend(held)
        log.seal()
        merged = mat.apply_next()
        spec = mat.delta_spec()
        assert spec is not None and spec.n_edges == len(held) == 20
        out[name] = (base, merged, spec)
    out["cases"] = C.case_matrix(small_dynamic_graph)
    out["jax"] = {}
    return out


def _jax_delta(setup, mode, name):
    key = (mode, name)
    if key not in setup["jax"]:
        base, _, spec = setup["ref"]
        qry = setup["cases"][name].qry
        batch = C.perturbed_batch(qry, 3)
        split = 0 if qry.agg_op != JQ.AGG_NONE else qry.n_vertices - 1
        run = JE.batch_executable_delta(base, qry, split=split, mode=mode)
        params = np.stack([JQ.query_params(q) for q in batch])
        setup["jax"][key] = (batch, split, params, run(params, spec.device()))
    return setup["jax"][key]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("mode", C.ALL_MODES)
def test_delta_executable_matches_merged(delta_setup, mode, impl):
    base, merged, spec = delta_setup["port"]
    for name in DELTA_CASES:
        batch, split, params, jgot = _jax_delta(delta_setup, mode, name)
        qs = [interop.query_from_dict(dataclasses.asdict(q)) for q in batch]
        run = TE.batch_executable_delta(base, qs[0], split=split, mode=mode,
                                        impl=impl, device="cpu")
        got = run(params, spec.device("cpu"))
        want = TE.execute_batch_out(merged, qs, split=split, mode=mode,
                                    sliced=False, impl=impl, device="cpu")
        for field in ("total", "per_vertex", "minmax"):
            w, o, j = getattr(want, field), getattr(got, field), getattr(jgot, field)
            if w is None and o is None:
                assert j is None, (name, field)
                continue
            assert np.array_equal(w.numpy(), o.numpy()), (name, field)
            assert np.array_equal(np.asarray(j), o.numpy()), (name, field, "jax")


def test_delta_executable_rejects_etr(port_graph, small_dynamic_graph):
    case = next(c for n, c in C.case_matrix(small_dynamic_graph).items()
                if n.startswith("etr-"))
    qry = interop.query_from_dict(dataclasses.asdict(case.qry))
    with pytest.raises(ValueError, match="ETR"):
        TE.batch_executable_delta(port_graph, qry, device="cpu")


def test_delta_execution_refuses_etr_and_minmax_across_etr(port_graph,
                                                           small_dynamic_graph):
    """Below the executable, the dense segment refuses an ETR hop under a
    delta, and MIN/MAX across an ETR hop, as the reference's does."""
    import torch

    cases = C.case_matrix(small_dynamic_graph)
    etr = interop.query_from_dict(dataclasses.asdict(next(
        c for n, c in cases.items() if n.startswith("etr-")).qry))
    log, held = log_from_graph(port_graph, holdout_edges=6, seed=1)
    mat = ingest.Materializer(log)
    base = mat.apply_next()
    log.extend(held)
    log.seal()
    mat.apply_next()
    delta = mat.delta_spec().device("cpu")
    gdev = TE.prepare_gdev(base, "cpu")
    bedges = TE.bucket_edges_for(base, 8, "cpu")
    params = torch.as_tensor(np.stack([JQ.query_params(
        next(c for n, c in cases.items() if n.startswith("etr-")).qry)]))
    with pytest.raises(NotImplementedError, match="delta execution across ETR"):
        TE.execute_plan(gdev, etr, etr.n_vertices - 1, TE.MODE_STATIC, 8,
                        params, bedges, impl="torch", delta=delta)
    minmax = dataclasses.replace(etr, agg_op=JQ.AGG_MIN,
                                 agg_key=sorted(base.vprops)[0])
    with pytest.raises(NotImplementedError, match="min/max aggregation across ETR"):
        TE.execute_plan(gdev, minmax, 0, TE.MODE_STATIC, 8, params, bedges,
                        impl="torch")


# =========================================================================
# partition extension
# =========================================================================
def test_partition_extension_consistent(small_dynamic_graph, port_graph):
    """An epoch's partitioning extends the base's through the hint, keeps
    every base vertex's part, and equals the reference's extension."""
    out = {}
    for name, M, Mgr, part_for, g in (
            ("ref", J, JEpochManager, lambda gr: JEP.partition_for(gr, 2)[0],
             small_dynamic_graph),
            ("port", ingest, EpochManager, lambda gr: TEP.partition_for(gr, 2)[0],
             port_graph)):
        log, held = M.log_from_graph(g, holdout_edges=10, seed=9)
        mgr = Mgr(log)
        e0 = mgr.seal()
        # warm the base partitioning cache, as the serving path would
        base_part = part_for(e0.graph)
        mgr.ingest(held)
        ep = mgr.seal()
        assert getattr(ep.graph, "_partition_hint", None) is not None
        part = part_for(ep.graph)
        # extension: every base vertex keeps its part assignment
        remap = mgr.mat._remap_from_base
        assert np.array_equal(part.part_of[remap], base_part.part_of)
        assert part.n_parts == base_part.n_parts
        out[name] = (base_part, part, ep.graph)
    for i in (0, 1):
        assert np.array_equal(out["port"][i].part_of, out["ref"][i].part_of)
        assert np.array_equal(out["port"][i].worker_of_part,
                              out["ref"][i].worker_of_part)
    _, arrays = TEP.partition_for(out["port"][2], 2)
    assert arrays.setup_s["path"] == "hint"
    _, arrays0 = TEP.partition_for(port_graph, 2)
    assert arrays0.setup_s["path"] == "fresh"
