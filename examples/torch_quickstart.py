"""Quickstart on the PyTorch port: build a temporal property graph, run
temporal path queries.  The same graph and queries as ``quickstart.py``, and
the same printed lines.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.core import engine as E
from repro_torch.core import intervals as iv
from repro_torch.core import query as Q
from repro_torch.graphdata.loader import GraphBuilder
from repro_torch.kernels.common import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, the default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    # ---- build the paper's Figure-1-style community graph
    b = GraphBuilder()
    b.lifespan = (0, 100)
    person = b.vertex_type("person")
    post = b.vertex_type("post")
    follows = b.edge_type("follows")
    likes = b.edge_type("likes")
    k_name = b.key("name")
    k_country = b.key("country")
    k_tag = b.key("tag")

    cleo = b.add_vertex(person, (0, 100))
    alice = b.add_vertex(person, (0, 100))
    bob = b.add_vertex(person, (5, 100))
    don = b.add_vertex(person, (0, 100))
    pic = b.add_vertex(post, (20, 100))

    for vid, name in [(cleo, "Cleo"), (alice, "Alice"), (bob, "Bob"), (don, "Don")]:
        b.set_vprop(vid, k_name, name)
    # Cleo's country CHANGES over time → dynamic temporal property
    b.set_vprop(cleo, k_country, "uk", (0, 40))
    b.set_vprop(cleo, k_country, "us", (40, 100))
    b.set_vprop(alice, k_country, "india")
    b.set_vprop(bob, k_country, "uk")
    b.set_vprop(pic, k_tag, "vacation")

    b.add_edge(cleo, alice, follows, (50, 100))   # after Cleo left the UK!
    b.add_edge(alice, bob, follows, (10, 100))
    b.add_edge(bob, don, follows, (10, 30))
    b.add_edge(alice, don, follows, (45, 100))    # starts AFTER bob→don ends
    b.add_edge(bob, pic, likes, (25, 40))
    b.add_edge(don, pic, likes, (60, 100))        # Don likes it AFTER Bob

    g = b.build()
    print("graph:", g.subgraph_stats())

    uk = b.lookup_value(k_country, "uk")
    vac = b.lookup_value(k_tag, "vacation")

    # EQ1: person in 'UK' → follows → person → follows → person
    eq1 = Q.PathQuery(
        v_preds=(Q.VertexPredicate(person, (Q.prop_clause(k_country, "==", uk),)),
                 Q.VertexPredicate(person), Q.VertexPredicate(person)),
        e_preds=(Q.EdgePredicate(follows, Q.DIR_OUT),
                 Q.EdgePredicate(follows, Q.DIR_OUT)),
    )
    static = E.count_results(g, eq1, mode=E.MODE_STATIC, device=dev)
    temporal = E.count_results(g, eq1, mode=E.MODE_INTERVAL, n_buckets=20, device=dev)
    print(f"EQ1 matches: {static:.0f} structurally, {temporal:.0f} with "
          f"time-aligned semantics (Cleo path drops out)")

    # EQ2 (ETR): person liked post BEFORE another person liked it
    eq2 = Q.PathQuery(
        v_preds=(Q.VertexPredicate(person),
                 Q.VertexPredicate(post, (Q.prop_clause(k_tag, "in", vac),)),
                 Q.VertexPredicate(person)),
        e_preds=(Q.EdgePredicate(likes, Q.DIR_OUT),
                 Q.EdgePredicate(likes, Q.DIR_IN, etr_op=iv.FULLY_BEFORE)),
    )
    print(f"EQ2 (liked before): {E.count_results(g, eq2, device=dev):.0f} path(s)  "
          f"(Bob→PicPost←Don)")

    # EQ4-style temporal aggregate: who follows how many people, when?
    eq4 = Q.PathQuery(
        v_preds=(Q.VertexPredicate(person), Q.VertexPredicate(person)),
        e_preds=(Q.EdgePredicate(follows, Q.DIR_OUT),),
        agg_op=Q.AGG_COUNT,
    )
    out = E.execute(g, eq4, mode=E.MODE_BUCKET, n_buckets=20, device=dev)
    counts = out.per_vertex.cpu().numpy()
    for vid in counts.sum(1).nonzero()[0]:
        print(f"  vertex {vid}: follow-count per time bucket "
              f"{counts[vid].astype(int)}")


if __name__ == "__main__":
    main()
