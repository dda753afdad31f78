"""The adapter to the program under test, ``repro_torch``.

Everything the benchmark hands the program or reads from it passes here:
the generated graph becomes a ``core.graph.TemporalGraph`` through its public
constructor, a query dict (``bench.gen.queries``) becomes a
``core.query.PathQuery``, and the server is a ``serving.BatchScheduler``.
Nothing else of the benchmark imports the program.
"""
from __future__ import annotations

import time
from typing import Dict

from ..gen.ldbc import ETYPES, KEYS, VTYPES, GraphData

MODES = ("static", "bucket", "interval")
ETR_NAMES = ("fully_before", "starts_before", "fully_after", "starts_after",
             "overlaps")


def make_graph(g: GraphData):
    """The program's graph over the generated arrays (no tables built yet)."""
    from repro_torch.core.graph import PropColumn, TemporalGraph

    return TemporalGraph(
        g.v_type, g.v_life, g.e_src, g.e_dst, g.e_type, g.e_life,
        {k: PropColumn(vals, life) for k, (vals, life) in g.vprops.items()},
        {}, n_vertex_types=len(VTYPES), n_edge_types=len(ETYPES),
        lifespan=g.lifespan, meta={"params": {"dynamic": g.params.dynamic}})


def build_tables(graph, device) -> float:
    """Build the program's host tables and upload them (``prepare_gdev``),
    waiting for the card; returns the seconds it took."""
    import torch
    from repro_torch.core import engine as E

    t0 = time.perf_counter()
    E.prepare_gdev(graph, device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def to_query(q: dict):
    """A query dict as the program's ``PathQuery``."""
    from repro_torch.core import intervals as iv
    from repro_torch.core import query as Q

    etr = {"fully_before": iv.FULLY_BEFORE, "starts_before": iv.STARTS_BEFORE,
           "fully_after": iv.FULLY_AFTER, "starts_after": iv.STARTS_AFTER,
           "overlaps": iv.OVERLAPS}
    direction = {"out": Q.DIR_OUT, "in": Q.DIR_IN, "both": Q.DIR_BOTH}
    conj = {"and": Q.AND, "or": Q.OR}

    def clause(c):
        if c[0] == "prop":
            _, cj, key, cmp, value = c
            return Q.prop_clause(KEYS.index(key), cmp, value, conj=conj[cj])
        _, cj, cmp, lo, hi = c
        return Q.time_clause(cmp, (lo, hi), conj=conj[cj])

    v_preds = tuple(
        Q.VertexPredicate(-1 if vp["type"] is None else VTYPES.index(vp["type"]),
                          tuple(clause(c) for c in vp["clauses"]))
        for vp in q["v"])
    e_preds = tuple(
        Q.EdgePredicate(-1 if ep["type"] is None else ETYPES.index(ep["type"]),
                        direction[ep["dir"]],
                        etr_op=-1 if ep["etr"] is None else etr[ep["etr"]])
        for ep in q["e"])
    agg = {None: Q.AGG_NONE, "min": Q.AGG_MIN, "max": Q.AGG_MAX, "count": Q.AGG_COUNT}
    return Q.PathQuery(v_preds, e_preds, agg_op=agg[q["agg"]],
                       agg_key=-1 if q["agg_key"] is None else KEYS.index(q["agg_key"]))


def to_instance(q: dict):
    """A query dict as the ``QueryInstance`` the scheduler takes."""
    from repro_torch.graphdata.queries import QueryInstance

    return QueryInstance(q["template"], to_query(q), {})


def make_server(graph, server: Dict, mode: str, trace: bool, device=None):
    """The query server of a configuration's ``server`` section, in ``mode``.

    With ``trace`` the scheduler records, per dispatch, the planner's
    predicted ms (a ``TelemetryBuffer`` that never refits, so plans stay
    those of the untraced runs)."""
    from repro_torch.core import engine as E
    from repro_torch.serving import BatchScheduler, TelemetryBuffer

    if server.get("theta", "DEFAULT_COEFFS") != "DEFAULT_COEFFS":
        raise ValueError("only the program's default coefficients are defined here")
    mode_id = {"static": E.MODE_STATIC, "bucket": E.MODE_BUCKET,
               "interval": E.MODE_INTERVAL}[mode]
    return BatchScheduler(
        graph, engine=server["engine"], mode=mode_id,
        n_buckets=server["n_buckets"], use_planner=server["use_planner"],
        keep_outputs=server["keep_outputs"], impl=server["impl"],
        telemetry=TelemetryBuffer(refit=False) if trace else None,
        device=device)


def served_mode(q: dict, mode: str) -> str:
    """The mode a query's answer is in: the server answers aggregates in
    interval mode as bucket series (``BatchScheduler._mode_for``'s policy)."""
    return "bucket" if (q["agg"] is not None and mode == "interval") else mode


def hop_launches() -> Dict[str, int]:
    """The hop kernels' launch counters (``kernels.hop_scatter.LAUNCHES``)."""
    from repro_torch.kernels import hop_scatter as HK

    return dict(HK.LAUNCHES)
