"""Dev smoke of the PyTorch port: the Q1-Q8 workload through the engine (all
splits) vs the oracle, and the planner's choice; then the same workload
through the batched serving scheduler (every engine, zero per-query
fallbacks) cross-checked against the oracle's counts.  The counterpart of
``smoke_workload.py``, with the same asserts and printed lines.

    PYTHONPATH=src python scripts/torch_smoke_workload.py [--device cpu]

Runs on the card unless ``--device cpu`` is given; with no GPU and no
``--device cpu`` it raises.  The last line is ``WORKLOAD SMOKE PASSED``.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.core import engine as E
from repro_torch.core.planner import Planner
from repro_torch.core.ref_engine import RefEngine
from repro_torch.core.stats import GraphStats
from repro_torch.graphdata.ldbc import LdbcParams, generate_ldbc
from repro_torch.graphdata.queries import make_workload
from repro_torch.kernels.common import resolve_device


def smoke_scheduler(g, ref, dev):
    """Batched scheduler drain on every engine: counts must match the oracle
    (static mode), and every group dispatches as ONE batched call."""
    from repro_torch.serving import BatchScheduler

    wl = make_workload(g, n_per_template=3, seed=1)
    wl += make_workload(g, templates=("Q2", "Q3"), n_per_template=2, seed=4,
                        aggregate=True)
    want = [float(np.sum(ref.count(inst.qry, mode=E.MODE_STATIC)))
            for inst in wl if inst.qry.agg_op == -1]
    for engine in ("auto", "dense", "partitioned"):
        sched = BatchScheduler(g, engine=engine, mode=E.MODE_STATIC,
                               n_workers=2, device=dev)
        res = sched.run(wl, warm=True)
        n_groups = len(sched.last_dispatches)
        assert sum(d.n_real for d in sched.last_dispatches) == len(wl)
        plain = [r for inst, r in zip(wl, res) if inst.qry.agg_op == -1]
        for w, r in zip(want, plain):
            assert r.count == w, (engine, r.template, r.count, w)
        print(f"  scheduler[{engine}]: {len(wl)} queries in {n_groups} "
              f"batched groups — counts OK")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="'cuda' (the card, the default) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)

    for dynamic in (False, True):
        g = generate_ldbc(LdbcParams(n_persons=80, seed=7, dynamic=dynamic))
        ref = RefEngine(g)
        wl = make_workload(g, n_per_template=2, seed=1)
        stats = GraphStats(g)
        planner = Planner(g, stats)
        print(f"--- dynamic={dynamic}: {g.subgraph_stats()}, {len(wl)} queries")
        print("stats size:", stats.size_report())
        for inst in wl:
            want = ref.count(inst.qry, mode=E.MODE_STATIC)
            for split in range(inst.qry.n_vertices):
                got = E.count_results(g, inst.qry, split=split, mode=E.MODE_STATIC,
                                      device=dev)
                assert got == want, (inst.template, split, got, want)
            est = planner.choose(inst.qry)
            print(f"{inst.template}: count={want:8.0f}  plan={est.split} "
                  f"t̂={est.t_ms:.2f}ms")
        # aggregate workload, bucket mode on dynamic graph
        wla = make_workload(g, templates=("Q2", "Q4"), n_per_template=1, seed=2,
                            aggregate=True)
        for inst in wla:
            mode = E.MODE_BUCKET if dynamic else E.MODE_STATIC
            out = E.execute(g, inst.qry, mode=mode, n_buckets=16, device=dev)
            pv = out.per_vertex.cpu().numpy()
            if dynamic:
                want = ref.aggregate(inst.qry, mode=E.MODE_BUCKET, n_buckets=16)
                assert np.allclose(pv, want), (inst.template, np.abs(pv - want).max())
            else:
                want = ref.aggregate(inst.qry, mode=E.MODE_STATIC)
                got = {i: float(pv[i]) for i in np.nonzero(pv)[0]}
                assert got == want, inst.template
            print(f"{inst.template} aggregate ({'bucket' if dynamic else 'static'}): OK")
        smoke_scheduler(g, ref, dev)
    print("WORKLOAD SMOKE PASSED")


if __name__ == "__main__":
    main()
