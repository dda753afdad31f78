"""The plain reference: by hand on a tiny graph, and against the program's
answers at a small size on the CPU (every split, both lowerings)."""
import numpy as np
import pytest
import torch

from bench.gen import ldbc as G
from bench.gen import queries as QB
from bench.lib import program as P
from bench.ref.engine import Reference, answer
from bench.tests.bench_cells import small_graph

from repro_torch.core import engine as E

MODE_ID = {"static": 0, "bucket": 1, "interval": 2}


def _tiny() -> G.GraphData:
    """Persons 0-2, posts 3-4; follows 0->1 [0, 69), 1->2 [69, 1096),
    0->2 [0, 1096); likes 1->3; country of 0 changes at 138."""
    T = G.T_HORIZON
    v_type = np.array([0, 0, 0, 1, 1], np.int32)
    v_life = np.array([[0, T], [0, T], [69, T], [0, T], [138, T]], np.int32)
    fo, li = G.ETYPES.index("follows"), G.ETYPES.index("likes")
    e_src = np.array([0, 1, 0, 1], np.int32)
    e_dst = np.array([1, 2, 2, 3], np.int32)
    e_type = np.array([fo, fo, fo, li], np.int32)
    e_life = np.array([[0, 69], [69, T], [0, T], [0, T]], np.int32)
    cty = G.KEYS.index("country")
    vprops = {cty: G.pivot(5, np.array([0, 0, 1, 2]), np.array([4, 5, 4, 4]),
                           np.array([0, 138, 0, 69]), np.array([138, T, T, T]))}
    return G.GraphData(params=G.LdbcParams(n_persons=3, dynamic=True), v_type=v_type,
                       v_life=v_life, e_src=e_src, e_dst=e_dst, e_type=e_type,
                       e_life=e_life, vprops=vprops,
                       type_ranges=dict(person=(0, 3), post=(3, 5), comment=(5, 5),
                                        forum=(5, 5)))


def _two_hop(etr=None, country=None):
    first = [QB.prop("country", "==", country)] if country is not None else []
    return {"template": "t", "v": [QB._v("person", *first), QB._v("person"), QB._v("person")],
            "e": [QB._e("follows", "out"), QB._e("follows", "out", etr)],
            "agg": None, "agg_key": None}


def test_by_hand():
    ref = Reference(_tiny(), 16)
    # the one 2-hop path 0 -> 1 -> 2: edges [0, 69) then [69, 1096)
    assert float(answer(ref, _two_hop(), "static")["total"]) == 1
    assert float(answer(ref, _two_hop("fully_before"), "static")["total"]) == 1
    assert float(answer(ref, _two_hop("starts_after"), "static")["total"]) == 0
    assert float(answer(ref, _two_hop("overlaps"), "static")["total"]) == 0
    # its entities' validities never meet: no bucket, no window
    assert float(answer(ref, _two_hop(), "bucket")["total"].sum()) == 0
    assert float(answer(ref, _two_hop(), "interval")["total"]) == 0
    # one hop 0 -> 2 ([0, 1096), vertex 2 from 69): buckets 1-15, one window
    one = {"template": "t", "v": [QB._v("person"), QB._v("person")],
           "e": [QB._e("follows", "out")], "agg": None, "agg_key": None}
    b = answer(ref, one, "bucket")["total"]
    assert b.tolist() == [1.0, 2.0] + [2.0] * 14      # 0->1 in bucket 0, 1->2 and 0->2 after
    assert float(answer(ref, one, "interval")["total"]) == 3
    # country 4 holds for person 0 over [0, 138) only: 0->2 counts in bucket 1
    # alone ([69, 138)); person 1 holds it throughout
    only4 = dict(one, v=[QB._v("person", QB.prop("country", "==", 4)), QB._v("person")])
    b = answer(ref, only4, "bucket")["total"]
    assert b.tolist() == [1.0, 2.0] + [1.0] * 14
    assert float(answer(ref, only4, "interval")["total"]) == 3
    assert float(answer(ref, only4, "static")["total"]) == 3
    # OR keeps the validity of whichever clause matched
    either = dict(one, v=[QB._v("person", QB.prop("country", "==", 4),
                                QB.prop("country", "==", 5, "or")), QB._v("person")])
    assert answer(ref, either, "bucket")["total"].tolist() == [1.0, 2.0] + [2.0] * 14


def test_min_max_by_hand():
    g = _tiny()
    ln = G.KEYS.index("length")
    g.vprops[ln] = G.pivot(5, np.array([1, 2]), np.array([30, 20]),
                           np.array([0, 69]), np.array([G.T_HORIZON] * 2))
    ref = Reference(g, 16)
    one = {"template": "t", "v": [QB._v("person"), QB._v("person")],
           "e": [QB._e("follows", "out")], "agg": "min", "agg_key": "length"}
    mm = answer(ref, one, "static")["minmax"]
    assert mm.tolist() == [20.0, 20.0, float("inf"), float("inf"), float("inf")]
    mx = answer(ref, dict(one, agg="max"), "static")["minmax"]
    assert mx.tolist()[:2] == [30.0, 20.0]


@pytest.mark.parametrize("dist,dynamic", [("zipf", True), ("facebook", False)])
@pytest.mark.parametrize("mode", ["static", "bucket", "interval"])
def test_matches_the_program(dist, dynamic, mode):
    """Equal to the program's answers for every template, split and
    lowering (the CUDA lowering runs its plain versions on the CPU)."""
    g = small_graph(700, dist, dynamic, seed=21)
    graph = P.make_graph(g)
    ref = Reference(g, 16)
    pools = QB.pools(g)
    rng = np.random.default_rng(5)
    nonzero = 0
    for t in list(QB.TEMPLATES) + ["Q2-min", "Q2-max"]:
        if t == "Q8" and not dynamic:
            continue
        q = QB.build(t, rng, pools)
        m = P.served_mode(q, mode)
        want = answer(ref, q, m)
        nonzero += bool(want["total"].sum() > 0)
        pq = P.to_query(q)
        for impl in ("torch", "cuda"):
            for split in ([0] if q["agg"] else range(len(q["v"]))):
                out = E.execute_batch_out(graph, [pq, pq], split=split, mode=MODE_ID[m],
                                          n_buckets=16, impl=impl, device="cpu")
                for j in range(2):
                    assert torch.equal(out.total[j].double(), want["total"]), (t, impl, split)
                    if q["agg"]:
                        assert torch.equal(out.per_vertex[j].double(), want["per_vertex"])
                        assert torch.equal(out.minmax[j].double(), want["minmax"])
    assert nonzero >= 3
