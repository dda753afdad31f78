"""The port's statistics and cost-model planner against the reference
package's, float for float, on the three fixture graphs.

``core/stats.py`` and ``core/planner.py`` are numpy in both packages, so the
port must build the same tables (tiles, clusters, histograms, degree table,
sampled ETR selectivities), give the same estimates and feature rows, and
sweep the same candidate lists, with the impl names mapped (``xla`` →
``torch``, ``pallas`` → ``cuda``).  The reference's wall-clock plan ranking
(``test_cost_model_discriminates``) is not ported: it is a timing assertion,
not a property of the model."""
import dataclasses
import os

import numpy as np
import pytest

from repro.core import planner as JP
from repro.core import stats as JS
from repro.graphdata.queries import make_workload, to_minmax
from repro_torch import interop
from repro_torch.core import planner as TP
from repro_torch.core import query as TQ
from repro_torch.core import stats as TS
from repro_torch.graphdata import ldbc as TL
from serving_parity import one_torch_thread  # noqa: F401  (autouse)

# (conftest fixture, its generator parameters)
GRAPHS = {
    "small_static_graph": dict(n_persons=60, seed=3, dynamic=False),
    "small_dynamic_graph": dict(n_persons=40, seed=5, dynamic=True),
    "medium_static_graph": dict(n_persons=200, seed=9, dynamic=False),
}
IMPLS = (("xla", "torch"), ("pallas", "cuda"))
# non-default coefficients, so every column (and the impl delta) weighs in
COEFFS = dict(theta0=0.31, theta_init=1.7e-5, theta_v=2.3e-5, theta_e=5.9e-5,
              theta_etr=9.1e-5, theta_m=1.3e-5, theta_net=8.0e-5,
              theta_net_etr=8.0e-5, theta_scatter_xla=4.0e-5,
              theta_scatter_pallas=1.1e-5)


def port_coeffs(coeffs):
    return {k.replace("xla", "torch").replace("pallas", "cuda"): v
            for k, v in coeffs.items()}


@pytest.fixture(scope="module")
def pair(request):
    """name -> (reference graph, port graph, reference stats, port stats)."""
    cache = {}

    def get(name):
        if name not in cache:
            ref = request.getfixturevalue(name)
            port = TL.generate_ldbc(TL.LdbcParams(**GRAPHS[name]))
            cache[name] = (ref, port, JS.GraphStats(ref, n_time_buckets=16),
                           TS.GraphStats(port, n_time_buckets=16))
        return cache[name]
    return get


def workload(ref_graph):
    """Every template at two instances, their COUNT aggregates, and the MIN
    and MAX variants of the ETR-free template: (reference, port) queries."""
    wl = make_workload(ref_graph, n_per_template=2, seed=11)
    wl += make_workload(ref_graph, n_per_template=1, seed=12, aggregate=True)
    for op in (1, 2):
        wl += [to_minmax(i, ref_graph, op) for i in
               make_workload(ref_graph, templates=("Q2",), n_per_template=2, seed=13)]
    return [(i.qry, interop.query_from_dict(dataclasses.asdict(i.qry))) for i in wl]


def _tiles(ks):
    return [dataclasses.astuple(t) for t in ks.tree.tiles]


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_graph_stats_equal_reference(pair, name):
    _, _, js, ts = pair(name)
    for f in ("bedges", "type_life_hist", "etype_life_hist", "degree_table"):
        assert np.array_equal(getattr(js, f), getattr(ts, f)), f
    assert js.etr_select == ts.etr_select and ts.etr_select
    for f in ("vkey_stats", "ekey_stats"):
        a, b = getattr(js, f), getattr(ts, f)
        assert sorted(a) == sorted(b), f
        for k in a:
            assert _tiles(a[k]) == _tiles(b[k]), (f, k)
            assert a[k].cluster_of == b[k].cluster_of, (f, k)
            assert np.array_equal(a[k].cluster_size, b[k].cluster_size), (f, k)
            assert a[k].n_rows == b[k].n_rows, (f, k)
            assert np.array_equal(a[k].tree.starts, b[k].tree.starts), (f, k)
            assert np.array_equal(a[k].tree.maxend, b[k].tree.maxend), (f, k)
    assert js.size_report() == ts.size_report()
    g = js.g
    intervals = (None, (0, 300), (200, 700), (650, 1096))
    for is_edge, keys in ((False, js.vkey_stats), (True, js.ekey_stats)):
        for k, ks in keys.items():
            for v in list(ks.cluster_of)[:6] + [10 ** 6]:
                for ivl in intervals:
                    a = js.h_lookup(k, v, ivl, is_edge=is_edge)
                    b = ts.h_lookup(k, v, ivl, is_edge=is_edge)
                    assert dataclasses.astuple(a) == dataclasses.astuple(b), (k, v, ivl)
    for t in range(-1, g.n_vertex_types):
        for ivl in intervals:
            assert js.lifespan_frac(t, ivl) == ts.lifespan_frac(t, ivl)
    for t in range(-1, g.n_edge_types):
        for ivl in intervals:
            assert js.lifespan_frac(t, ivl, is_edge=True) == \
                ts.lifespan_frac(t, ivl, is_edge=True)
        for vt in range(-1, g.n_vertex_types):
            for d in (TQ.DIR_OUT, TQ.DIR_IN, TQ.DIR_BOTH):
                assert js.degree(vt, t, d) == ts.degree(vt, t, d)


def _same_estimate(a, b, ctx):
    assert a.split == b.split and a.t_ms == b.t_ms, ctx
    assert np.array_equal(a.features, b.features), ctx
    assert len(a.steps) == len(b.steps), ctx
    for sa, sb in zip(a.steps, b.steps):
        fa = {f.name: getattr(sa, f.name) for f in dataclasses.fields(sa)}
        fb = {f.name: getattr(sb, f.name) for f in dataclasses.fields(sb)}
        assert np.array_equal(fa.pop("features"), fb.pop("features")), ctx
        assert fa == fb, ctx


def _same_candidates(a, b, ctx):
    assert len(a) == len(b), ctx
    for ca, cb in zip(a, b):
        assert (ca["split"], dict(IMPLS)[ca["impl"]], ca["t_ms"]) == \
            (cb["split"], cb["impl"], cb["t_ms"]), ctx
        assert np.array_equal(ca["features"], cb["features"]), ctx


@pytest.mark.parametrize("coeffs", ["default", "fitted"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_estimates_and_sweeps_equal_reference(pair, name, coeffs):
    ref_g, port_g, js, ts = pair(name)
    c = dict(JP.DEFAULT_COEFFS) if coeffs == "default" else dict(COEFFS)
    jp = JP.Planner(ref_g, js, coeffs=c)
    tp = TP.Planner(port_g, ts, coeffs=port_coeffs(c))
    assert np.array_equal(jp.trav_arrivals_by_type, tp.trav_arrivals_by_type)
    pairs = workload(ref_g)
    for jq, tq in pairs:
        assert jp.enumerate_plans(jq) == tp.enumerate_plans(tq)
        for split in jp.enumerate_plans(jq):
            for ji, ti in IMPLS:
                _same_estimate(jp.estimate(jq, split, ji), tp.estimate(tq, split, ti),
                               (name, split, ti))
        for impls in (("xla",), ("xla", "pallas")):
            a = jp.choose(jq, impls=impls)
            b = tp.choose(tq, impls=tuple(dict(IMPLS)[i] for i in impls))
            _same_estimate(a, b, (name, impls))
            assert dict(IMPLS)[a.impl] == b.impl
            _same_candidates(a.candidates, b.candidates, (name, impls))
    # same-shape groups, as the scheduler plans them
    groups = {}
    for jq, tq in pairs:
        groups.setdefault(jq.shape_key(), []).append((jq, tq))
    for members in groups.values():
        jqs, tqs = [m[0] for m in members], [m[1] for m in members]
        for split in jp.enumerate_plans(jqs[0]):
            for ji, ti in IMPLS:
                _same_estimate(jp.estimate_batch(jqs, split, ji),
                               tp.estimate_batch(tqs, split, ti), (name, split))
        a = jp.choose_batch(jqs, impls=JP.HOP_IMPL_CHOICES)
        b = tp.choose_batch(tqs, impls=TP.HOP_IMPL_CHOICES)
        _same_estimate(a, b, name)
        assert dict(IMPLS)[a.impl] == b.impl
        _same_candidates(a.candidates, b.candidates, name)


def test_unfitted_sweep_ties_to_the_plain_lowering(pair):
    """With default coefficients the impl sweep ties, and the tie resolves to
    the first choice — 'torch', as the reference resolves to 'xla'."""
    ref_g, port_g, js, ts = pair("medium_static_graph")
    tp = TP.Planner(port_g, ts, coeffs=dict(TP.DEFAULT_COEFFS))
    assert TP.HOP_IMPL_CHOICES == ("torch", "cuda")
    for _, tq in workload(ref_g):
        assert tp.choose(tq, impls=TP.HOP_IMPL_CHOICES).impl == "torch"
    fast = dict(TP.DEFAULT_COEFFS, theta_scatter_torch=1e-4)
    tp2 = TP.Planner(port_g, ts, coeffs=fast)
    plain = [tq for _, tq in workload(ref_g)
             if any(e.etr_op == -1 for e in tq.e_preds)]
    assert plain and all(
        tp2.choose(q, impls=TP.HOP_IMPL_CHOICES).impl == "cuda" for q in plain)


def test_coefficient_basis_and_file(tmp_path):
    assert TP.COEFF_KEYS == tuple(port_coeffs({k: 0 for k in JP.COEFF_KEYS}))
    assert set(TP.DEFAULT_COEFFS) == set(port_coeffs(JP.DEFAULT_COEFFS))
    assert np.array_equal(TP.coeff_vector(port_coeffs(COEFFS)),
                          JP.coeff_vector(COEFFS))
    assert np.array_equal(TP.coeff_vector({}), JP.coeff_vector({}))
    # the port reads and writes its own file, never the reference's
    path = os.path.normpath(TP._COEFF_PATH)
    assert path.endswith(os.path.join("src", "repro_torch", "configs",
                                      "cost_coeffs.json"))
    p = str(tmp_path / "c.json")
    TP.save_coeffs(port_coeffs(COEFFS), p)
    assert TP.load_coeffs(p) == {**TP.DEFAULT_COEFFS, **port_coeffs(COEFFS)}
    assert TP.load_coeffs(str(tmp_path / "absent.json")) == TP.DEFAULT_COEFFS


def test_fit_linear_equal_reference():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 10))
    theta = rng.normal(size=10)
    y = X @ theta + rng.normal(scale=1e-3, size=200)
    got = TP.fit_linear(X, y)
    assert np.array_equal(got, JP.fit_linear(X, y))
    np.testing.assert_allclose(got, theta, atol=1e-2)


def test_distribution_aware_planning_raises(pair):
    """A partitioning must be a Partitioning or PartitionArrays: anything
    else raises (the distribution-aware planner itself is held equal to the
    reference's below)."""
    _, port_g, _, ts = pair("small_static_graph")
    with pytest.raises(AttributeError):
        TP.Planner(port_g, ts, coeffs=dict(TP.DEFAULT_COEFFS), partitioning=object())


@pytest.mark.parametrize("w", [2, 4, 8])
@pytest.mark.parametrize("coeffs", ["default", "fitted"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_distribution_aware_estimates_equal_reference(pair, name, coeffs, w):
    """``Planner(partitioning=...)``: per-worker extents, the θ_net and
    θ_net_etr channel terms and the impl sweep equal the reference's float
    for float (t_ms, m_net, channels, features), from a Partitioning and
    from PartitionArrays alike."""
    from repro.graphdata import partitioner as JPA
    from repro_torch.graphdata import partitioner as TPA
    ref_g, port_g, js, ts = pair(name)
    c = dict(JP.DEFAULT_COEFFS) if coeffs == "default" else dict(COEFFS)
    jpart = JPA.partition_graph(ref_g, n_workers=w, parts_per_type=max(4, w // 2))
    tpart = TPA.partition_graph(port_g, n_workers=w, parts_per_type=max(4, w // 2))
    jp = JP.Planner(ref_g, js, coeffs=c, partitioning=jpart)
    tps = [TP.Planner(port_g, ts, coeffs=port_coeffs(c), partitioning=tpart),
           TP.Planner(port_g, ts, coeffs=port_coeffs(c),
                      partitioning=TPA.build_partition_arrays(port_g, tpart))]
    for tp in tps:
        assert (tp.n_workers, tp.cut_frac, tp.exchange_volume, tp.etr_exchange_volume) == \
            (jp.n_workers, jp.cut_frac, jp.exchange_volume, jp.etr_exchange_volume)
        for jq, tq in workload(ref_g):
            for split in jp.enumerate_plans(jq):
                for ji, ti in IMPLS:
                    a, b = jp.estimate(jq, split, ji), tp.estimate(tq, split, ti)
                    _same_estimate(a, b, (name, w, split, ti))
                    assert [s.m_net for s in a.steps] == [s.m_net for s in b.steps]
                    assert [s.channels for s in a.steps] == [s.channels for s in b.steps]
            a = jp.choose(jq, impls=JP.HOP_IMPL_CHOICES)
            b = tp.choose(tq, impls=TP.HOP_IMPL_CHOICES)
            _same_estimate(a, b, (name, w))
            _same_candidates(a.candidates, b.candidates, (name, w))
