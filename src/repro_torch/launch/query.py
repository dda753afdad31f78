"""Granite query server: the paper's Master/Worker flow.

Master receives path queries, rewrites values to dictionary ids, asks the
cost-model planner for the split point, executes on the in-memory graph, and
returns counts/aggregates — with per-query latency accounting and an
execution budget (the paper's 600 s budget, scaled).  Throughput serving
goes through the batch-scheduler runtime (``run_workload_scheduled`` /
``serving``).

    python -m repro_torch.launch.query [--device cpu] [--serve | --replay | --live]

The port of the reference package's ``launch/query.py``.  It runs on the
card unless ``--device cpu`` is given (with no GPU it raises otherwise), on
the hop kernels (``impl='cuda'``).  ``--engine partitioned`` serves through
the partitioned executor over ``--workers`` workers (with ``--serve``,
``--replay`` or ``--live``).  ``--live`` serves epoch-pinned snapshots of an
ingesting event log, journaled to ``--wal`` and recovered from it.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..core import engine as E
from ..core.planner import Planner
from ..core.ref_engine import RefEngine
from ..core.stats import GraphStats
from ..graphdata.ldbc import LdbcParams, generate_ldbc, graph_name
from ..graphdata.queries import QueryInstance, make_workload
from ..kernels.common import resolve_device


@dataclasses.dataclass
class QueryResultRecord:
    template: str
    split: int
    planned: bool
    count: float
    latency_ms: float
    ok: bool = True
    error: str = ""


class GraniteServer:
    def __init__(self, graph, use_planner: bool = True, mode: Optional[int] = None,
                 budget_s: float = 600.0, n_buckets: int = 16, device=None):
        self.device = resolve_device(device)
        self.graph = graph
        self.stats = GraphStats(graph, n_time_buckets=n_buckets)
        self.planner = Planner(graph, self.stats)
        self.use_planner = use_planner
        self.budget_s = budget_s
        self.n_buckets = n_buckets
        dynamic = bool(graph.meta.get("params", {}).get("dynamic", False))
        self.mode = mode if mode is not None else (
            E.MODE_BUCKET if dynamic else E.MODE_STATIC)
        #: the scheduler of the last ``run_workload_scheduled`` (its
        #: dispatches and caches), None before one
        self.scheduler = None

    def plan(self, inst: QueryInstance) -> int:
        if not self.use_planner:
            return 0 if inst.qry.agg_op != -1 else inst.qry.n_vertices - 1
        return self.planner.choose(inst.qry).split

    def _execute(self, inst: QueryInstance, split: int) -> np.ndarray:
        out = E.execute(self.graph, inst.qry, split=split,
                        mode=self._mode_for(inst), n_buckets=self.n_buckets,
                        device=self.device)
        return out.total.cpu().numpy()

    def warmup(self, inst: QueryInstance, split: Optional[int] = None):
        """First call (excluded from latency, as the paper excludes load time)."""
        self._execute(inst, self.plan(inst) if split is None else split)

    def _mode_for(self, inst: QueryInstance) -> int:
        if inst.qry.agg_op != -1 and self.mode == E.MODE_INTERVAL:
            return E.MODE_BUCKET
        return self.mode

    def execute(self, inst: QueryInstance, split: Optional[int] = None
                ) -> QueryResultRecord:
        s = self.plan(inst) if split is None else split
        t0 = time.perf_counter()
        try:
            total = self._execute(inst, s)
            count = float(total.sum()) if total.ndim else float(total)
            dt = (time.perf_counter() - t0) * 1e3
            ok = dt <= self.budget_s * 1e3
            return QueryResultRecord(inst.template, s, split is None, count, dt, ok)
        except Exception as e:  # pragma: no cover
            dt = (time.perf_counter() - t0) * 1e3
            return QueryResultRecord(inst.template, s, split is None, -1.0, dt,
                                     False, str(e))

    def run_workload(self, workload: List[QueryInstance], verbose=False
                     ) -> List[QueryResultRecord]:
        for inst in workload:
            self.warmup(inst)
        out = []
        for inst in workload:
            rec = self.execute(inst)
            out.append(rec)
            if verbose:
                print(f"{rec.template} split={rec.split} count={rec.count:.0f} "
                      f"{rec.latency_ms:.1f}ms")
        return out

    def run_workload_scheduled(self, workload: List[QueryInstance],
                               engine: str = "auto", warm: bool = True,
                               tracer=None, metrics=None, n_workers: int = 4):
        """Serve the workload through the batch-scheduler runtime (one
        batched call per shape group, no fallbacks).  Returns
        ``serving.ServedResult`` records in submission order; the scheduler
        stays on ``self.scheduler``.  ``tracer``/``metrics`` (``obs``)
        attach the flight recorder."""
        from ..serving import BatchScheduler
        sched = BatchScheduler(self.graph, engine=engine, mode=self.mode,
                               n_buckets=self.n_buckets,
                               use_planner=self.use_planner,
                               budget_s=self.budget_s,
                               tracer=tracer, metrics=metrics,
                               device=self.device, n_workers=n_workers)
        self.scheduler = sched
        return sched.run(workload, warm=warm)


def _serve_live(args, graph, workload, tracer, metrics, device):
    """``--live``: epoch-pinned serving over an ingesting event log.

    A fresh start decomposes the built graph into epoch 0 minus
    ``--holdout`` edges, attaches the WAL (when ``--wal`` is given), then
    ingests the held-out edges back across ``--epochs`` sealed epochs,
    draining the workload against each pinned snapshot.  If the WAL path
    already exists the server RECOVERS instead: the torn tail is truncated,
    sealed epochs replay, and serving resumes from the exact pre-crash
    pinned fingerprint (crash-recoverable ingestion).
    """
    import os
    from ..graphdata.ingest import log_from_graph
    from ..serving import BatchScheduler, EpochManager

    held: list = []
    if args.wal and os.path.exists(args.wal):
        mgr = EpochManager.recover(args.wal, metrics=metrics, tracer=tracer)
        print(f"recovered {mgr.log.n_epochs} sealed epoch(s) from "
              f"{args.wal}: pinned fp {mgr.current.fingerprint}, "
              f"{mgr.log.n_open} open event(s) pending")
    else:
        log, held = log_from_graph(graph, holdout_edges=args.holdout,
                                   seed=args.seed)
        if args.wal:
            log.attach_wal(args.wal)
            print(f"WAL -> {args.wal}")
        mgr = EpochManager(log, metrics=metrics, tracer=tracer)

    sched = BatchScheduler(graph, engine=args.engine,
                           use_planner=not args.no_planner,
                           tracer=tracer, metrics=metrics, device=device,
                           n_workers=args.workers)
    mgr.attach(sched)

    def drain(tag: str):
        recs = sched.run(workload, warm=True)
        done = sum(1 for r in recs if r.ok)
        lat = np.mean([r.latency_ms for r in recs if r.ok]) if done else 0.0
        print(f"  {tag}: fp={sched.pinned_epoch.fingerprint} "
              f"done={done}/{len(recs)} avg={lat:.2f}ms")

    drain(f"epoch {mgr.current.id}")
    if mgr.log.n_open:              # open suffix survived the crash: seal it
        ep = mgr.advance(sched)
        drain(f"epoch {ep.id} (recovered open suffix)")
    if held:
        chunks = np.array_split(np.arange(len(held)), max(args.epochs, 1))
        for ids in chunks:
            if not len(ids):
                continue
            mgr.ingest(held[int(ids[0]): int(ids[-1]) + 1])
            ep = mgr.advance(sched)
            drain(f"epoch {ep.id} (+{len(ids)} edges)")
    mgr.log.close_wal()


def main(argv: Optional[List[str]] = None) -> None:
    """Thin CLI over the serving runtime: sequential loop (default), batched
    scheduler drain (--serve), open-loop Poisson replay (--replay), or
    live epoch-pinned serving with a crash-recoverable WAL (--live)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--persons", type=int, default=1000)
    ap.add_argument("--dist", default="facebook",
                    choices=["altmann", "weibull", "facebook", "zipf"])
    ap.add_argument("--dynamic", action="store_true")
    ap.add_argument("--queries", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0,
                    help="workload + arrival-process seed (reproducible runs)")
    ap.add_argument("--no-planner", action="store_true")
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--serve", action="store_true",
                    help="drain the workload through the batch scheduler")
    ap.add_argument("--replay", action="store_true",
                    help="open-loop Poisson replay through the scheduler")
    ap.add_argument("--rate", type=float, default=50.0,
                    help="--replay arrival rate (queries/s)")
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "dense", "sliced", "partitioned"])
    ap.add_argument("--workers", type=int, default=4,
                    help="workers of --engine partitioned")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the card, the default) or 'cpu'")
    ap.add_argument("--live", action="store_true",
                    help="live-graph serving: ingest epochs from an event "
                         "log and serve each pinned snapshot")
    ap.add_argument("--wal", default=None, metavar="PATH",
                    help="--live write-ahead log; if PATH exists the server "
                         "recovers from it instead of rebuilding")
    ap.add_argument("--holdout", type=int, default=64,
                    help="--live edges held out of epoch 0 and ingested "
                         "back across --epochs live epochs")
    ap.add_argument("--epochs", type=int, default=3,
                    help="--live ingestion epochs after epoch 0")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the query flight recorder to a trace JSONL")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics registry at exit (.json = JSON "
                         "snapshot, anything else = Prometheus text format)")
    args = ap.parse_args(argv)

    params = LdbcParams(n_persons=args.persons, degree_dist=args.dist,
                        dynamic=args.dynamic)
    g = generate_ldbc(params)
    print(f"graph {graph_name(params)}: {g.subgraph_stats()}")
    server = GraniteServer(g, use_planner=not args.no_planner,
                           device=args.device)
    wl = make_workload(g, n_per_template=args.queries, seed=args.seed)

    tracer = metrics = None
    if args.trace_out:
        from ..obs import Tracer
        tracer = Tracer(sink=args.trace_out)
    if args.metrics_out:
        from ..obs import MetricsRegistry
        metrics = MetricsRegistry()

    def _finish_obs():
        if tracer is not None:
            tracer.close()
            print(f"trace: {tracer.n_completed} spans -> {args.trace_out}")
        if metrics is not None:
            metrics.write(args.metrics_out)
            print(f"metrics -> {args.metrics_out}")

    if args.live:
        _serve_live(args, g, wl, tracer, metrics, server.device)
        _finish_obs()
        return

    if args.replay:
        from ..serving import BatchScheduler, replay_workload
        sched = BatchScheduler(g, engine=args.engine,
                               use_planner=not args.no_planner,
                               tracer=tracer, metrics=metrics,
                               device=server.device, n_workers=args.workers)
        rep = replay_workload(sched, wl, rate_qps=args.rate, seed=args.seed,
                              warm=True)
        for k, v in rep.as_dict().items():
            print(f"  {k}: {v}")
        _finish_obs()
        return

    if args.serve:
        recs = server.run_workload_scheduled(wl, engine=args.engine,
                                             tracer=tracer, metrics=metrics,
                                             n_workers=args.workers)
        _finish_obs()
    else:
        recs = server.run_workload(wl, verbose=True)
    by_t = {}
    for r in recs:
        by_t.setdefault(r.template, []).append(r.latency_ms)
    print("\navg latency per template:")
    for t, ls in sorted(by_t.items()):
        print(f"  {t}: {np.mean(ls):8.2f} ms over {len(ls)} queries")
    if args.verify:
        ref = RefEngine(g)
        for inst, rec in zip(wl[: 8], recs[: 8]):
            want = ref.count(inst.qry, mode=server._mode_for(inst))
            want = float(np.sum(want))
            assert abs(want - rec.count) < 1e-6, (inst.template, want, rec.count)
        print("verification vs oracle: OK")


if __name__ == "__main__":
    main()
