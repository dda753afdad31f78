"""Host data of the torch port against the reference package: the LDBC
generator, traversal/CSR/ETR tables, property columns, the Q1-Q8 workload
and its parameter rows, the interop round trip, and the interval algebra."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import intervals as jiv
from repro.core import query as JQ
from repro.graphdata import queries as JW
from repro.graphdata.ldbc import LdbcParams, graph_name
from repro_torch import interop
from repro_torch.core import intervals as tiv
from repro_torch.core import query as TQ
from repro_torch.graphdata import ldbc as TL
from repro_torch.graphdata import queries as TW

# (conftest fixture, its generator parameters)
GRAPHS = {
    "small_static_graph": dict(n_persons=60, seed=3, dynamic=False),
    "small_dynamic_graph": dict(n_persons=40, seed=5, dynamic=True),
    "medium_static_graph": dict(n_persons=200, seed=9, dynamic=False),
}


def _assert_graph_arrays_equal(ref, port):
    for f in ("v_type", "v_life", "e_src", "e_dst", "e_type", "e_life"):
        assert np.array_equal(getattr(ref, f), getattr(port, f)), f
    assert (ref.n_vertex_types, ref.n_edge_types, ref.lifespan) == \
        (port.n_vertex_types, port.n_edge_types, port.lifespan)
    for name in ("vprops", "eprops"):
        a, b = getattr(ref, name), getattr(port, name)
        assert sorted(a) == sorted(b), name
        for k in a:
            assert np.array_equal(a[k].vals, b[k].vals), (name, k)
            assert np.array_equal(a[k].life, b[k].life), (name, k)
    for k, v in ref.traversal.items():
        assert np.array_equal(v, port.traversal[k]), k
    ra, pa = ref.etr_tables, port.etr_tables
    for f in ("perm_start", "perm_end", "dep_ranks", "arr_ranks"):
        assert np.array_equal(getattr(ra, f), getattr(pa, f)), f
    assert np.array_equal(ref.type_ranges, port.type_ranges)


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_generator_gives_the_reference_graph(request, name):
    ref = request.getfixturevalue(name)
    port = TL.generate_ldbc(TL.LdbcParams(**GRAPHS[name]))
    _assert_graph_arrays_equal(ref, port)
    for k in ("v_type_ids", "e_type_ids", "key_ids", "key_ordered", "value_dicts",
              "params"):
        assert ref.meta[k] == port.meta[k], k
    assert TL.graph_name(TL.LdbcParams(**GRAPHS[name])) == graph_name(LdbcParams(**GRAPHS[name]))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_from_arrays_round_trips(request, name):
    ref = request.getfixturevalue(name)
    port = interop.graph_from_arrays(ref)
    _assert_graph_arrays_equal(ref, port)
    # tuple-shaped property columns are accepted too
    tup = types.SimpleNamespace(
        **{f: getattr(ref, f) for f in ("v_type", "v_life", "e_src", "e_dst", "e_type",
                                        "e_life", "n_vertex_types", "n_edge_types",
                                        "lifespan")},
        vprops={k: (c.vals, c.life) for k, c in ref.vprops.items()},
        eprops={k: (c.vals, c.life) for k, c in ref.eprops.items()})
    _assert_graph_arrays_equal(ref, interop.graph_from_arrays(tup))
    # device views equal the host arrays
    g = port.device_arrays("cpu")
    assert torch.equal(g["t_src"], torch.from_numpy(ref.traversal["t_src"]))
    assert g["t_src"].dtype == torch.int32
    assert torch.equal(g["etr_arr_ranks"], torch.from_numpy(ref.etr_tables.arr_ranks))
    assert port.device_arrays("cpu") is g


@pytest.mark.parametrize("aggregate", [False, True])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_workload_rows_equal(request, name, aggregate):
    ref = request.getfixturevalue(name)
    port = TL.generate_ldbc(TL.LdbcParams(**GRAPHS[name]))
    via = interop.graph_from_arrays(ref)
    want = JW.make_workload(ref, n_per_template=6, seed=11, aggregate=aggregate)
    for g in (port, via):
        got = TW.make_workload(g, n_per_template=6, seed=11, aggregate=aggregate)
        assert [i.template for i in got] == [i.template for i in want]
        for a, b in zip(want, got):
            assert dataclasses.asdict(a.qry) == dataclasses.asdict(b.qry)
            assert a.params == b.params
            assert a.qry.shape_key() == b.qry.shape_key()
            assert np.array_equal(JQ.query_params(a.qry), TQ.query_params(b.qry))
            assert JQ.format_query(a.qry) == TQ.format_query(b.qry)
            assert dataclasses.asdict(a.qry.reversed()) == dataclasses.asdict(b.qry.reversed())
            mm_a = JW.to_minmax(a, ref, JQ.AGG_MAX)
            mm_b = TW.to_minmax(b, g, TQ.AGG_MAX)
            assert dataclasses.asdict(mm_a.qry) == dataclasses.asdict(mm_b.qry)
            assert mm_a.template == mm_b.template


def test_query_from_dict_round_trips(small_dynamic_graph):
    for inst in JW.make_workload(small_dynamic_graph, n_per_template=2, seed=4):
        q = interop.query_from_dict(dataclasses.asdict(inst.qry))
        assert isinstance(q, TQ.PathQuery)
        assert dataclasses.asdict(q) == dataclasses.asdict(inst.qry)
        assert q.shape_key() == inst.qry.shape_key()


def test_constants_match_the_reference():
    for name in ("FULLY_BEFORE", "STARTS_BEFORE", "FULLY_AFTER", "STARTS_AFTER",
                 "DURING", "EQUALS", "DURING_EQ", "OVERLAPS", "TIME_CMP_NAMES"):
        assert getattr(tiv, name) == getattr(jiv, name), name
    for name in ("K_PROP", "K_TIME", "P_EQ", "P_NEQ", "P_CONTAINS", "AND", "OR",
                 "DIR_OUT", "DIR_IN", "DIR_BOTH", "ETR_OPS", "AGG_NONE", "AGG_COUNT",
                 "AGG_MIN", "AGG_MAX", "PROP_CMP_NAMES", "AGG_NAMES"):
        assert getattr(TQ, name) == getattr(JQ, name), name


def _ivals(rng, shape, lo=0, hi=40):
    s = rng.integers(lo, hi, size=shape)
    e = s + rng.integers(-5, 20, size=shape)
    return np.stack([s, e], axis=-1).astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interval_ops_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    a = _ivals(rng, (7, 9))
    b = _ivals(rng, (7, 9))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    for fn in ("intersect", "span", "overlaps", "is_empty"):
        args_t = (ta,) if fn == "is_empty" else (ta, tb)
        args_j = (ja,) if fn == "is_empty" else (ja, jb)
        assert np.array_equal(getattr(tiv, fn)(*args_t).numpy(),
                              np.asarray(getattr(jiv, fn)(*args_j))), fn
    for op in range(8):
        assert np.array_equal(tiv.compare(op, ta, tb).numpy(),
                              np.asarray(jiv.compare(op, ja, jb))), op
    for t0, t1, nb in ((0, 1096, 16), (0, 40, 8), (5, 17, 3), (0, 10, 32)):
        edges = tiv.bucket_edges(t0, t1, nb)
        assert np.array_equal(edges, jiv.bucket_edges(t0, t1, nb))
        te = torch.from_numpy(edges)
        assert np.array_equal(tiv.interval_to_bucket_mask(ta, te).numpy(),
                              np.asarray(jiv.interval_to_bucket_mask(ja, jnp.asarray(edges))))
        pts = rng.integers(t0 - 3, t1 + 5, size=(11,)).astype(np.int32)
        assert np.array_equal(tiv.bucket_id(torch.from_numpy(pts), te).numpy(),
                              np.asarray(jiv.bucket_id(jnp.asarray(pts), jnp.asarray(edges))))
