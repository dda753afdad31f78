"""Dev smoke of the PyTorch port: engine vs oracle on a small LDBC graph, all
modes and splits.  The counterpart of ``smoke_engine.py``, with the same
queries, asserts and printed lines.

The partitioned executor rides every sweep (n_workers=4): each check asserts
oracle == dense == partitioned, for plain counts, ETR hops, the temporal
modes and the COUNT/MIN/MAX aggregates.

    PYTHONPATH=src python scripts/torch_smoke_engine.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  The last line is ``ALL SMOKE CHECKS PASSED``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import engine as E
from repro_torch.core import engine_partitioned as EP
from repro_torch.core import query as Q
from repro_torch.core.ref_engine import RefEngine
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
from repro_torch.kernels.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, the default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    g = generate_ldbc(LdbcParams(n_persons=60, seed=3, dynamic=False))
    print("graph:", g.subgraph_stats())
    b = g.meta["builder"]
    tp = b.v_type_ids
    te = b.e_type_ids
    k_tag = b.key_ids["tag"]
    k_country = b.key_ids["country"]
    k_int = b.key_ids["hasInterest"]

    tag_v = b.lookup_value(k_tag, "tag1")
    cty = b.lookup_value(k_country, "uk")
    ref = RefEngine(g)

    # Q: person(country=uk) -follows-> person -created-> post(tag=tag1)
    q1 = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(tp["person"], (Q.prop_clause(k_country, "==", cty),)),
            Q.VertexPredicate(tp["person"]),
            Q.VertexPredicate(tp["post"], (Q.prop_clause(k_tag, "in", tag_v),)),
        ),
        e_preds=(
            Q.EdgePredicate(te["follows"], Q.DIR_OUT),
            Q.EdgePredicate(te["created"], Q.DIR_OUT),
        ),
    )
    want = ref.count(q1, mode=E.MODE_STATIC)
    for split in range(3):
        got = E.count_results(g, q1, split=split, mode=E.MODE_STATIC, device=dev)
        gotp = EP.count_results(g, q1, split=split, n_workers=4, device=dev)
        print(f"q1 split={split}: got={got} part={gotp} want={want}")
        assert got == gotp == want, (got, gotp, want)

    # ETR query: person -follows-> person -follows-> person with e1 << e2
    q2 = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(tp["person"]),
            Q.VertexPredicate(tp["person"]),
            Q.VertexPredicate(tp["person"], (Q.prop_clause(k_int, "in", tag_v),)),
        ),
        e_preds=(
            Q.EdgePredicate(te["follows"], Q.DIR_OUT),
            Q.EdgePredicate(te["follows"], Q.DIR_OUT, etr_op=0),  # fully before
        ),
    )
    want = ref.count(q2, mode=E.MODE_STATIC)
    for split in range(3):
        got = E.count_results(g, q2, split=split, mode=E.MODE_STATIC, device=dev)
        gotp = EP.count_results(g, q2, split=split, n_workers=4, device=dev)
        print(f"q2(etr<<) split={split}: got={got} part={gotp} want={want}")
        assert got == gotp == want, (split, got, gotp, want)

    # ETR overlap + reverse direction hop
    q3 = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(tp["post"]),
            Q.VertexPredicate(tp["person"]),
            Q.VertexPredicate(tp["person"]),
        ),
        e_preds=(
            Q.EdgePredicate(te["created"], Q.DIR_IN),
            Q.EdgePredicate(te["follows"], Q.DIR_BOTH, etr_op=7),  # overlaps
        ),
    )
    want = ref.count(q3, mode=E.MODE_STATIC)
    for split in range(3):
        got = E.count_results(g, q3, split=split, mode=E.MODE_STATIC, device=dev)
        gotp = EP.count_results(g, q3, split=split, n_workers=4, device=dev)
        print(f"q3(etr ovl, rev) split={split}: got={got} part={gotp} want={want}")
        assert got == gotp == want, (split, got, gotp, want)

    # bucket mode (dynamic graph)
    gd = generate_ldbc(LdbcParams(n_persons=40, seed=5, dynamic=True))
    bd = gd.meta["builder"]
    refd = RefEngine(gd)
    k_c2 = bd.key_ids["country"]
    ctyd = bd.lookup_value(k_c2, "india")
    q4 = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(bd.v_type_ids["person"], (Q.prop_clause(k_c2, "==", ctyd),)),
            Q.VertexPredicate(bd.v_type_ids["person"]),
        ),
        e_preds=(Q.EdgePredicate(bd.e_type_ids["follows"], Q.DIR_OUT),),
    )
    want = refd.count(q4, mode=E.MODE_BUCKET, n_buckets=16)
    for split in range(2):
        out = E.execute(gd, q4, split=split, mode=E.MODE_BUCKET, n_buckets=16, device=dev)
        got = out.total.cpu().numpy()
        gotp = EP.execute(gd, q4, split=split, mode=E.MODE_BUCKET, n_buckets=16,
                          n_workers=4, device=dev).total.cpu().numpy()
        print(f"q4 bucket split={split}: got={got.astype(int)}")
        print(f"                want    ={want.astype(int)}")
        assert np.allclose(got, want), (split, got, want)
        assert np.array_equal(got, gotp), (split, got, gotp)

    # interval mode distinct counts
    want = refd.count(q4, mode=E.MODE_INTERVAL, n_buckets=16)
    for split in range(2):
        got = E.count_results(gd, q4, split=split, mode=E.MODE_INTERVAL, n_buckets=16,
                              device=dev)
        gotp = EP.count_results(gd, q4, split=split, mode=E.MODE_INTERVAL,
                                n_buckets=16, n_workers=4, device=dev)
        print(f"q4 interval split={split}: got={got} part={gotp} want={want}")
        assert got == gotp == want, (split, got, gotp, want)

    # aggregation: count persons followed by each person (EQ4-flavoured)
    q5 = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(tp["person"]),
            Q.VertexPredicate(tp["person"]),
        ),
        e_preds=(Q.EdgePredicate(te["follows"], Q.DIR_OUT),),
        agg_op=Q.AGG_COUNT,
    )
    want = ref.aggregate(q5, mode=E.MODE_STATIC)
    out = E.execute(g, q5, mode=E.MODE_STATIC, device=dev)
    pv = out.per_vertex.cpu().numpy()
    got = {i: float(pv[i]) for i in np.nonzero(pv)[0]}
    assert got == want, (sorted(got.items())[:5], sorted(want.items())[:5])
    pvp = EP.execute(g, q5, n_workers=4, device=dev).per_vertex.cpu().numpy()
    assert np.array_equal(pv, pvp)
    print("q5 aggregate count: OK,", len(got), "groups (dense == partitioned)")

    # MIN/MAX aggregation on the partitioned path (extremum-channel exchange)
    k_len = b.key_ids["length"]
    for op, name in ((Q.AGG_MIN, "min"), (Q.AGG_MAX, "max")):
        q6 = Q.PathQuery(
            v_preds=(
                Q.VertexPredicate(tp["person"]),
                Q.VertexPredicate(tp["post"]),
            ),
            e_preds=(Q.EdgePredicate(te["created"], Q.DIR_OUT),),
            agg_op=op, agg_key=k_len,
        )
        want = ref.aggregate(q6, mode=E.MODE_STATIC)
        out_d = E.execute(g, q6, mode=E.MODE_STATIC, device=dev)
        out_p = EP.execute(g, q6, mode=E.MODE_STATIC, n_workers=4, device=dev)
        for label, out in (("dense", out_d), ("partitioned", out_p)):
            pv = out.per_vertex.cpu().numpy()
            mm = out.minmax.cpu().numpy()
            got = {i: float(mm[i]) for i in np.nonzero(pv)[0]}
            assert got == want, (name, label,
                                 sorted(got.items())[:5],
                                 sorted(want.items())[:5])
        print(f"q6 aggregate {name}: OK, {len(want)} groups "
              "(dense == partitioned == oracle)")

    print("ALL SMOKE CHECKS PASSED")


if __name__ == "__main__":
    main()
