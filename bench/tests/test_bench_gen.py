"""The frozen generator, query builders and traffic generator."""
import numpy as np
import pytest

from bench.gen import ldbc as G
from bench.gen import queries as QB
from bench.gen import traffic as TR
from bench.tests.bench_cells import small_graph

from repro_torch.graphdata import ldbc as PL
from repro_torch.graphdata import queries as PQ
from repro_torch.core import query as Q


def _arrays(g):
    return [g.v_type, g.v_life, g.e_src, g.e_dst, g.e_type, g.e_life] + [
        a for k in sorted(g.vprops) for a in g.vprops[k]]


@pytest.mark.parametrize("dist,dynamic", [("zipf", True), ("facebook", False)])
def test_same_seed_same_graph(dist, dynamic):
    a = small_graph(500, dist, dynamic, seed=11)
    b = small_graph(500, dist, dynamic, seed=11)
    c = small_graph(500, dist, dynamic, seed=12)
    assert all(np.array_equal(x, y) for x, y in zip(_arrays(a), _arrays(b)))
    assert not all(x.shape == y.shape and np.array_equal(x, y)
                   for x, y in zip(_arrays(a), _arrays(c)))


@pytest.mark.parametrize("dist,dynamic", [("zipf", True), ("facebook", False),
                                          ("weibull", True), ("altmann", False)])
def test_counts_match_the_ports_generator(dist, dynamic):
    """Vertex counts equal and edge counts per type within the spread the
    port's own generator shows over seeds, at 1,000 persons."""
    ours = [small_graph(1000, dist, dynamic, seed=s) for s in range(4)]
    theirs = [PL.generate_ldbc(PL.LdbcParams(n_persons=1000, degree_dist=dist,
                                             dynamic=dynamic, seed=s)) for s in range(4)]
    assert {g.n_vertices for g in ours} == {g.n_vertices for g in theirs}
    for g, h in zip(ours, theirs):
        assert np.array_equal(np.bincount(g.v_type, minlength=4),
                              np.bincount(h.v_type, minlength=4))
    for t in range(len(G.ETYPES)):
        mine = np.asarray([np.sum(g.e_type == t) for g in ours], float)
        port = np.asarray([np.sum(h.e_type == t) for h in theirs], float)
        if G.ETYPES[t] == "follows" and dist in ("zipf", "altmann"):
            # heavy tails: the port's degree normalisation swings by seed
            lo, hi = 0.3 * port.min(), 2.5 * port.max()
        else:
            spread = max(port.std(), np.sqrt(port.mean()))
            lo, hi = port.min() - 4 * spread, port.max() + 4 * spread
        assert lo <= mine.mean() <= hi, (G.ETYPES[t], mine, port)


def test_layout_and_referential_integrity():
    g = small_graph(600, "zipf", True, seed=5)
    assert np.all(np.diff(g.v_type) >= 0)
    for name, (lo, hi) in g.type_ranges.items():
        assert np.all(g.v_type[lo:hi] == G.VTYPES.index(name))
    # edge lifespans inside both endpoints', all on the 16-step grid or T
    for end in (g.e_src, g.e_dst):
        assert np.all(g.v_life[end, 0] <= g.e_life[:, 0])
        assert np.all(g.e_life[:, 1] <= g.v_life[end, 1])
    assert np.all(g.e_life[:, 0] < g.e_life[:, 1])
    step = -(-G.T_HORIZON // 16)
    t = np.concatenate([g.e_life.ravel(), g.v_life.ravel()])
    assert np.all((t % step == 0) | (t == G.T_HORIZON))
    assert g.e_src.dtype == np.int32 and g.v_life.shape == (g.n_vertices, 2)


def test_dynamic_properties_one_window_per_value():
    g = small_graph(500, "zipf", True, seed=9)
    vals, life = g.vprops[g.key_id("country")]
    for v in range(0, 500, 7):
        got = vals[v][vals[v] >= 0]
        assert len(set(got.tolist())) == len(got)            # no value twice
        spans = life[v][vals[v] >= 0]
        assert np.all(spans[:, 0] < spans[:, 1])
        assert spans[:, 0].min() == g.v_life[v, 0] and spans[:, 1].max() == G.T_HORIZON


def test_pivot():
    vals, life = G.pivot(4, np.array([2, 0, 2, 2]), np.array([7, 8, 9, 10]),
                         np.array([1, 2, 3, 4]), np.array([5, 6, 7, 8]))
    assert vals.tolist() == [[8, -1, -1], [-1, -1, -1], [7, 9, 10], [-1, -1, -1]]
    assert life[2].tolist() == [[1, 5], [3, 7], [4, 8]]
    assert life[1].tolist() == [[0, 0]] * 3


def _shape(pq, vt_name, et_name):
    """A program query's structure with type ids named."""
    return ([(vt_name(v.vtype), tuple((c.kind, c.conj, c.cmp) for c in v.clauses))
             for v in pq.v_preds],
            [(et_name(e.etype), e.direction, e.etr_op) for e in pq.e_preds],
            pq.agg_op)


#: the copy's repairs: (template, hop) -> the hop as the benchmark builds it
REPAIRED_HOPS = {("Q1", 2): ("created", Q.DIR_IN, -1),
                 ("Q3", 1): ("likes", Q.DIR_IN, 1),          # starts_before
                 ("Q5", 2): ("containerOf", Q.DIR_OUT, 3),   # starts_after
                 ("Q6", 2): ("replyOf", Q.DIR_IN, 3)}        # starts_after


@pytest.mark.parametrize("template", list(QB.TEMPLATES) + ["Q2-min", "Q2-max"])
def test_query_builders_match_the_ports(template):
    """Each frozen template lowers to the structure the port's builder gives
    (types, clause kinds, connectives, comparators, directions, ETR ops),
    but for the hops ``REPAIRED_HOPS`` names and MIN/MAX's key."""
    from bench.lib import program as P

    g = small_graph(300, "zipf", True, seed=2)
    q = QB.build(template, np.random.default_rng(0), QB.pools(g))
    mine = _shape(P.to_query(q), lambda t: G.VTYPES[t], lambda t: G.ETYPES[t])
    pg = PL.generate_ldbc(PL.LdbcParams(n_persons=300, dynamic=True, seed=2))
    b = pg.meta["builder"]
    base, _, agg = template.partition("-")
    inst = PQ.make_workload(pg, [base], 1, seed=0)[0]
    if agg:
        inst = PQ.to_minmax(inst, pg, Q.AGG_MIN if agg == "min" else Q.AGG_MAX)
    vt = {i: n for n, i in b.v_type_ids.items()}
    et = {i: n for n, i in b.e_type_ids.items()}
    theirs = _shape(inst.qry, vt.get, et.get)
    for (t, hop), repaired in REPAIRED_HOPS.items():
        if t == base:
            assert theirs[1][hop] != repaired
            theirs[1][hop] = repaired
    assert mine == theirs
    keys = {i: n for n, i in b.key_ids.items()}
    assert [[G.KEYS[c.key] if c.kind == Q.K_PROP else None for c in v.clauses]
            for v in P.to_query(q).v_preds] == \
        [[keys[c.key] if c.kind == Q.K_PROP else None for c in v.clauses]
         for v in inst.qry.v_preds]
    if agg:
        # the port's copy reads a person's length, which no person has
        assert q["agg_key"] == "birthday" and keys[inst.qry.agg_key] == "length"


def _config_graph(name, persons, seed):
    import dataclasses
    import json

    from bench.lib import spec as SP

    spec = json.loads((SP.BENCH / "configs" / f"{name}.json").read_text())
    return G.generate(dataclasses.replace(G.params_of(spec), n_persons=persons),
                      np.random.default_rng(seed))


@pytest.mark.parametrize("name,mode", [("ldbc-snb-100k-zipf-dynamic", "bucket"),
                                       ("ldbc-snb-100k-facebook-static", "static")])
def test_every_template_can_answer(name, mode):
    """On each configuration's shape every template finds paths on most
    instances, and MIN/MAX read a value the last vertex has: no template's
    answer is fixed by the schema."""
    import torch

    from bench.ref.engine import Reference, answer

    g = _config_graph(name, 300, 3)
    ref = Reference(g, 16)
    pools = QB.pools(g)
    rng = np.random.default_rng(0)
    lo, hi = 0, G.BIRTHDAY_DAYS
    for t in list(QB.TEMPLATES) + ["Q2-min", "Q2-max"]:
        if t == "Q8" and not g.params.dynamic:
            continue
        found = 0
        for _ in range(12):
            q = QB.build(t, rng, pools)
            a = answer(ref, q, mode)
            found += bool(a["total"].sum() > 0)
            if q["agg"]:
                mm = a["minmax"][torch.isfinite(a["minmax"])]
                assert mm.numel() == 0 or (mm.min() >= lo and mm.max() < hi), t
        assert found >= 2, (t, found)


def test_query_parameters_from_frequent_values():
    g = small_graph(400, "zipf", True, seed=4)
    pools = QB.pools(g)
    rng = np.random.default_rng(1)
    for _ in range(20):
        q = QB.build("Q3", rng, pools)
        c1 = q["v"][0]["clauses"][0]
        assert c1[:4] == ["prop", "and", "country", "=="] and c1[4] in pools["country"]
        lo, hi = q["v"][1]["clauses"][0][3:]
        assert hi == G.T_HORIZON and lo % 69 == 0 and lo < G.T_HORIZON // 2


def test_traffic_blocks_and_arrivals():
    g = small_graph(300, "facebook", False, seed=1)
    mix = dict(templates={"Q1": 1, "Q8": 1, "Q2-min": 2}, loop="open", rate_qps=50.0,
               max_batch=4, judge_per_template=1)
    TR.check_mix(mix)
    assert TR.templates(mix, g) == {"Q1": 1, "Q2-min": 2}      # Q8 needs dynamic
    order = TR.template_order(mix, g, 30, np.random.default_rng(0))
    for k in range(0, 27, 3):
        assert sorted(order[k:k + 3]) == ["Q1", "Q2-min", "Q2-min"]
    a = TR.arrivals(mix, 2.0, np.random.default_rng(0))
    assert len(a) == 100 and np.all(np.diff(a) >= 0) and 0 <= a[0] and a[-1] < 2.0
    with pytest.raises(ValueError):
        TR.check_mix(dict(mix, loop="ring"))
