"""Superstep primitives of the torch port against the reference package's,
on the same inputs, in all three temporal modes.

The port carries an explicit leading query axis Q; the reference primitive is
``jax.vmap``-ed over it.  Counts are small integers in float32, so every
comparison is ``np.array_equal``.  The fused hop (``impl='cuda'`` on CPU
tensors runs the kernels' plain versions) is held against the reference's
``fused_hop_deliver(impl='pallas')`` in interpret mode."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import intervals as jiv
from repro.core import query as JQ
from repro.core import superstep as JSS
from repro_torch import interop
from repro_torch.core import engine as TE
from repro_torch.core import superstep as TSS

MODES = (0, 1, 2)
NQ = 3
B = 8


@pytest.fixture(scope="module")
def env(small_dynamic_graph):
    g = small_dynamic_graph
    tg = interop.graph_from_arrays(g)
    edges = jiv.bucket_edges(g.lifespan[0], g.lifespan[1], B)
    return dict(g=g, jg=JE._prepare_gdev(g), tg=TE.prepare_gdev(tg, "cpu"),
                jb=jnp.asarray(edges), tb=torch.from_numpy(edges),
                b=g.meta["builder"])


def _np(x):
    return None if x is None else np.asarray(x)


def _eq(port, ref, what=""):
    if port is None or ref is None:
        assert port is None and ref is None, what
        return
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert p.shape == np.asarray(ref).shape, (what, p.shape, np.asarray(ref).shape)
    assert np.array_equal(p, np.asarray(ref)), what


def _clause_sets(b):
    k = b.key_ids
    P, T = JQ.prop_clause, JQ.time_clause
    return {
        "eq": (P(k["country"], "==", 0),),
        "neq": (P(k["gender"], "!=", 0),),
        "contains": (P(k["hasInterest"], "in", 0),),
        "time": (T("overlaps", (0, 1)),),
        "and": (P(k["worksAt"], "==", 0), T(">", (0, 1), conj=JQ.AND)),
        "or": (P(k["country"], "==", 0), P(k["gender"], "==", 0, conj=JQ.OR)),
        "or-time": (T("<", (0, 1)), P(k["worksAt"], "==", 0, conj=JQ.OR)),
        "none": (),
    }


def _params(rng, clauses, b):
    """[Q, n, 3] parameter rows: values drawn from each key's dictionary,
    intervals from the time horizon."""
    rows = np.zeros((NQ, max(1, len(clauses)), 3), np.int32)
    for q in range(NQ):
        for i, c in enumerate(clauses):
            if c.kind == JQ.K_PROP:
                rows[q, i, 0] = rng.integers(0, max(1, len(b.value_dicts.get(c.key, {})) or 3))
            lo = int(rng.integers(0, 900))
            rows[q, i, 1:] = (lo, lo + int(rng.integers(1, 400)))
    return rows


def _eval_both(env, vtype, clauses, params, mode, ent="v"):
    jg, tg = env["jg"], env["tg"]
    if ent == "v":
        jargs = (jg["vprops"], jg["v_type"], jg["v_life"])
        targs = (tg["vprops"], tg["v_type"], tg["v_life"])
    else:
        jargs = (jg["eprops_t"], jg["t_type"], jg["t_life"])
        targs = (tg["eprops_t"], tg["t_type"], tg["t_life"])
    with JSS.bucket_scope(env["jb"]):
        jm, jv = jax.vmap(lambda p: JSS.eval_predicate(
            *jargs, vtype, clauses, p, 0, mode, env["jb"]))(jnp.asarray(params))
    tm, tv = TSS.eval_predicate(*targs, vtype, clauses, torch.from_numpy(params), 0,
                                mode, env["tb"])
    return (jm, jv), (tm, tv)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("cset", ["eq", "neq", "contains", "time", "and", "or",
                                  "or-time", "none"])
def test_eval_predicate(env, mode, cset):
    rng = np.random.default_rng(hash(cset) % 1000 + mode)
    clauses = _clause_sets(env["b"])[cset]
    params = _params(rng, clauses, env["b"])
    person = env["b"].v_type_ids["person"]
    for vtype in (person, -1):
        (jm, jv), (tm, tv) = _eval_both(env, vtype, clauses, params, mode)
        _eq(tm, jm, ("match", cset, vtype))
        _eq(tv, jv, ("validity", cset, vtype))


def _random_state(rng, n, mode):
    if mode == 0:
        return rng.integers(0, 4, size=(NQ, n)).astype(np.float32)
    if mode == 1:
        return rng.integers(0, 4, size=(NQ, n, B)).astype(np.float32)
    cells = rng.integers(0, 3, size=(NQ, n, B, B + 1)).astype(np.float32)
    return cells * np.triu(np.ones((B, B + 1), np.float32), 1)


@pytest.mark.parametrize("mode", MODES)
def test_state_algebra(env, mode):
    rng = np.random.default_rng(10 + mode)
    b = env["b"]
    clauses = _clause_sets(b)["and"]
    params = _params(rng, clauses, b)
    (jm, jv), (tm, tv) = _eval_both(env, b.v_type_ids["person"], clauses, params, mode)
    V = env["g"].n_vertices
    st = _random_state(rng, V, mode)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    with JSS.bucket_scope(env["jb"]):
        vmap = jax.vmap
        _eq(TSS.init_state(tm, tv, mode, B, env["tb"]),
            vmap(lambda m, v: JSS.init_state(m, v, mode, B))(jm, jv), "init_state")
        _eq(TSS.apply_validity(tst, tm, tv, mode, env["tb"]),
            vmap(lambda s, m, v: JSS.apply_validity(s, m, v, mode))(jst, jm, jv),
            "apply_validity")
        _eq(TSS.state_total(tst, mode), vmap(lambda s: JSS.state_total(s, mode))(jst),
            "state_total")
        _eq(TSS.state_alive(tst, mode), vmap(lambda s: JSS.state_alive(s, mode))(jst),
            "state_alive")
        col = env["g"].vprops[b.key_ids["length"]].vals
        op = JQ.AGG_MAX if mode == 1 else JQ.AGG_MIN
        _eq(TSS.minmax_seed(tst, torch.from_numpy(col), op, mode),
            vmap(lambda s: JSS.minmax_seed(s, jnp.asarray(col), op, mode))(jst),
            "minmax_seed")
        if mode == 2:
            _eq(TSS.cells_to_buckets(tst), vmap(JSS.cells_to_buckets)(jst), "cells")
            st2 = _random_state(rng, V, mode)
            _eq(TSS.join_interval_counts(tst, torch.from_numpy(st2)),
                vmap(JSS.join_interval_counts)(jst, jnp.asarray(st2)), "join")
        # edge step: edge predicate weights ∧ direction, then apply_edge
        ep = JQ.EdgePredicate(b.e_type_ids["follows"], JQ.DIR_OUT)
        jw, jev = vmap(lambda p: JSS.edge_predicate_weights(
            env["jg"], ep, p, 0, mode, env["jb"]))(jnp.asarray(params))
        tw, tev = TSS.edge_predicate_weights(env["tg"], ep, torch.from_numpy(params), 0,
                                             mode, env["tb"])
        _eq(tw, jw, "edge weights")
        _eq(tev, jev, "edge validity")
        E2 = 2 * env["g"].n_edges
        sv = _random_state(rng, E2, mode)
        _eq(TSS.apply_edge(torch.from_numpy(sv), tw, tev, mode, env["tb"]),
            vmap(lambda s, w, v: JSS.apply_edge(s, w, v, mode))(jnp.asarray(sv), jw, jev),
            "apply_edge")
        mch = rng.integers(1, 99, size=(NQ, E2)).astype(np.float32)
        _eq(TSS.minmax_edge(torch.from_numpy(mch), torch.from_numpy(sv), op, mode),
            vmap(lambda m, c: JSS.minmax_edge(m, c, op, mode))(jnp.asarray(mch),
                                                               jnp.asarray(sv)),
            "minmax_edge")


@pytest.mark.parametrize("use_arr", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("op", JQ.ETR_OPS)
def test_etr_weighted(env, op, backward, use_arr):
    rng = np.random.default_rng(op * 4 + 2 * backward + use_arr)
    E2 = 2 * env["g"].n_edges
    for mode in MODES:
        cnt = _random_state(rng, E2, mode)
        want = jax.vmap(lambda c: JSS.etr_weighted(env["jg"], c, op, backward, use_arr))(
            jnp.asarray(cnt))
        got = TSS.etr_weighted(env["tg"], torch.from_numpy(cnt), op, backward, use_arr)
        _eq(got, want, ("etr", op, backward, use_arr, mode))
    assert TSS.etr_needs_end(op, backward) == JSS.etr_needs_end(op, backward)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("mode", MODES)
def test_deliver_and_extremum(env, mode, impl):
    rng = np.random.default_rng(20 + mode)
    g = env["g"]
    V, E2 = g.n_vertices, 2 * g.n_edges
    cnt = _random_state(rng, E2, mode)
    t_dst = jnp.asarray(g.traversal["t_dst"])
    want = jax.vmap(lambda c: jax.ops.segment_sum(c, t_dst, num_segments=V,
                                                  indices_are_sorted=True))(jnp.asarray(cnt))
    got = TSS.deliver(torch.from_numpy(cnt), env["tg"]["arr_ptr"], V, impl=impl)
    _eq(got, want, "deliver")
    m = rng.integers(1, 99, size=(NQ, E2)).astype(np.float32)
    m[rng.random((NQ, E2)) < 0.3] = np.inf
    for op, red in ((JQ.AGG_MIN, jax.ops.segment_min), (JQ.AGG_MAX, jax.ops.segment_max)):
        mm = np.where(np.isinf(m), -np.inf if op == JQ.AGG_MAX else np.inf, m).astype(np.float32)
        want = jax.vmap(lambda x: red(x, t_dst, num_segments=V, indices_are_sorted=True))(
            jnp.asarray(mm))
        got = TSS.deliver_extremum(torch.from_numpy(mm), env["tg"]["arr_ptr"], V, op,
                                   impl=impl)
        _eq(got, want, ("extremum", op))


@pytest.mark.parametrize("extremum", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_fused_hop_deliver(env, mode, extremum):
    """Port fused hop (plain kernel versions) vs the reference Pallas hop."""
    rng = np.random.default_rng(30 + mode + 3 * extremum)
    g, b = env["g"], env["b"]
    V = g.n_vertices
    lay = JE.hop_layout_for(g)
    params = _params(rng, (), b)
    ep = JQ.EdgePredicate(b.e_type_ids["follows"], JQ.DIR_BOTH)
    sv = _random_state(rng, V, mode)
    mch = rng.integers(1, 99, size=(NQ, V)).astype(np.float32)
    op = JQ.AGG_MAX if mode == 1 else JQ.AGG_MIN
    with JSS.bucket_scope(env["jb"]):
        jw, jev = jax.vmap(lambda p: JSS.edge_predicate_weights(
            env["jg"], ep, p, 0, mode, env["jb"]))(jnp.asarray(params))

        def ref(s, w, v, m):
            return JSS.fused_hop_deliver(s, env["jg"]["t_src"], w, v, mode, lay.tables,
                                         lay.block_v, V, impl="pallas",
                                         mch=m if extremum else None, minmax_op=op)

        jev_in = jev if jev is not None else jnp.zeros((NQ,))
        want, want_m = jax.vmap(ref)(jnp.asarray(sv), jw, jev_in, jnp.asarray(mch))
    tw, tev = TSS.edge_predicate_weights(env["tg"], ep, torch.from_numpy(params), 0, mode,
                                         env["tb"])
    assert tw.stride(0) == 0   # a query-independent weight row is shared
    got, got_m = TSS.fused_hop_deliver(
        torch.from_numpy(sv), env["tg"]["t_src"], tw, tev, mode, env["tg"]["arr_ptr"], V,
        env["tb"], mch=torch.from_numpy(mch) if extremum else None, minmax_op=op)
    _eq(got, want, "arrivals")
    _eq(got_m, want_m if extremum else None, "extremum")
    # the plain three-step hop gives the same arrivals
    cnt = TSS.apply_edge(torch.from_numpy(sv)[:, env["tg"]["t_src_l"]], tw, tev, mode,
                         env["tb"])
    _eq(TSS.deliver(cnt, env["tg"]["arr_ptr"], V), want, "unfused")
