"""Temporal path-query engine in torch — dense executor + plan skeleton.

The port of the reference package's ``core/engine.py``.  One superstep per
hop is a dense tensor program over the 2E traversal-edge arrays:

  vertex step : vectorised predicate eval over property columns  → match mask
  edge step   : gather source counts → edge predicate mask → per-edge counts
  delivery    : sorted segment-sum of per-edge counts by arrival vertex

Path multiplicity is carried as float32 *counts* (per-hop DP state instead of
per-path messages) in three temporal modes (static / bucket / interval; see
``superstep.py``).  ETR hops use precomputed rank tables + segment prefix
sums (exact, O(E) per hop).

Every entry point runs a batch of same-shape queries at once: state is
``[Q, N, *TS]`` and every output carries the leading query axis; ``execute``
is the batch of one.  Entry points take ``device=None``, which means the
card: with no GPU they raise unless the caller passes ``device='cpu'``.
``impl`` selects the hop lowering (``kernels.common.IMPLS``): ``'cuda'`` (the
default) runs every plain hop through the fused hop kernel and every ETR
delivery through the scatter kernel; ``'torch'`` is the plain unfused hop.

PyTorch runs eagerly, so nothing drops the per-edge count tensor
``cnt_e [Q, 2E, *TS]`` when no one reads it (the reference relies on jit
dead-code elimination).  The executors build it only where a consumer needs
it: the unfused hop, an ETR hop's delivery, the next hop's ETR prefix sums,
and the ETR-at-join contraction.

``execute()`` routes between dense and sliced (``engine_sliced.py``); the
partitioned executor (``engine_partitioned.py``) plugs its own segment runner
into ``execute_plan``.  ``batch_executable_delta`` is the live-graph entry:
the compacted base graph's hops plus the delivery of the edges appended
since (``graphdata/ingest.DeltaSpec``), equal to the merged epoch's answers.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import intervals as iv
from . import query as Q
from . import superstep as SS
from .graph import TemporalGraph
from .superstep import MODE_BUCKET, MODE_INTERVAL, MODE_STATIC  # noqa: F401
from ..kernels.common import check_impl, resolve_device, use_kernels


# =========================================================================
# segment execution (dense)
# =========================================================================
@dataclasses.dataclass
class SegmentResult:
    arrivals_e: Optional[torch.Tensor]  # per traversal-edge counts into final vertex
    arrivals_v: Optional[torch.Tensor]  # segment-sum of the above ([Q, V, *TS])
    stats: List[dict]                   # per-superstep instrumentation
    minmax_v: Optional[torch.Tensor] = None  # min/max channel at final vertex


def needs_edge_counts(fused: bool, e_preds: Sequence[Q.EdgePredicate], i: int,
                      need_final_e: bool) -> bool:
    """Does hop ``i`` have to build its per-edge counts ``cnt_e``?  Yes on
    the unfused path, on ETR hops (delivered from ``cnt_e``), before an ETR
    hop (its prefix sums read them), and at the segment's end when the
    ETR-at-join contraction reads them."""
    if not fused or e_preds[i].etr_op != -1:
        return True
    if i + 1 < len(e_preds):
        return e_preds[i + 1].etr_op != -1
    return need_final_e


def run_segment(
    gdev: dict,
    v_preds: Sequence[Q.VertexPredicate],
    e_preds: Sequence[Q.EdgePredicate],
    params,
    pbases_v: Sequence[int],
    pbases_e: Sequence[int],
    mode: int,
    n_buckets: int,
    backward: bool,
    bedges,
    with_minmax: bool = False,
    minmax_op: int = Q.AGG_MIN,
    minmax_col=None,
    impl: str = "torch",
    need_final_e: bool = True,
    delta=None,
) -> SegmentResult:
    """Run one path segment.  v_preds has one more entry than e_preds; the
    FINAL vertex predicate is NOT applied (it belongs to the join).

    ``delta`` (a ``graphdata.ingest.DeltaSpec.device(device)`` dict) adds
    the base+delta execution path: every plain hop also evaluates the edge
    predicate over the delta-edge slots and adds their (unsorted) delivery
    to the base arrivals — bit-identical to running on the merged epoch
    graph, with the base graph's arrival CSR (and so the kernels' launch
    shapes) untouched.  ETR hops read global rank tables and are
    delta-incompatible (callers gate on query shape;
    ``batch_executable_delta`` refuses them).

    With ``impl='cuda'`` every plain hop runs the FUSED gather → temporal
    mask → segment-reduce kernel (``superstep.fused_hop_deliver``; the
    extremum channel rides the same call) and ETR-hop deliveries run the
    scatter kernel.  ``need_final_e`` says whether the caller reads the final
    hop's per-edge counts (``arrivals_e``).

    Returns raw arrivals (per-edge and per-vertex) at the final vertex.
    """
    V = gdev["v_life"].shape[0]
    stats: List[dict] = []
    fused = use_kernels(impl)
    t_src = gdev["t_src_l"]
    ptr = gdev["arr_ptr"]

    # ---- init superstep (first vertex predicate)
    vm, vv = SS.eval_predicate(
        gdev["vprops"], gdev["v_type"], gdev["v_life"], v_preds[0].vtype,
        v_preds[0].clauses, params, pbases_v[0], mode, bedges,
    )
    state_v = SS.init_state(vm, vv, mode, n_buckets, bedges)
    stats.append(dict(phase="init", matched=vm.sum(dim=1)))

    mch_v = None
    if with_minmax:
        vals0, _ = minmax_col
        mch_v = SS.minmax_seed(state_v, vals0, minmax_op, mode)

    arrivals_e = None
    arrivals_v = None
    prev_raw_e = None
    for i, ep in enumerate(e_preds):
        wmask, evalidity = SS.edge_predicate_weights(
            gdev, ep, params, pbases_e[i], mode, bedges
        )
        if i > 0:
            # apply the intermediate vertex predicate (post-arrival)
            vm, vv = SS.eval_predicate(
                gdev["vprops"], gdev["v_type"], gdev["v_life"], v_preds[i].vtype,
                v_preds[i].clauses, params, pbases_v[i], mode, bedges,
            )
        need_e = needs_edge_counts(fused, e_preds, i, need_final_e)
        src_val = sv = None
        if ep.etr_op == -1:
            prev_raw_e = None  # only an ETR hop reads the previous counts
        arrivals_e = None
        if ep.etr_op != -1:
            if delta is not None:
                raise NotImplementedError(
                    "delta execution across ETR hops (global rank tables)")
            if with_minmax:
                raise NotImplementedError("min/max aggregation across ETR hops")
            # ETR hop: prefix-sum over *raw* previous arrivals, then apply the
            # intermediate vertex predicate at the source gather.
            src_cnt = SS.etr_weighted(gdev, prev_raw_e, ep.etr_op, backward,
                                      use_arr=False)
            if mode == MODE_STATIC:
                src_val = src_cnt * vm[:, t_src].to(SS.F32)
            elif mode == MODE_BUCKET:
                src_val = src_cnt * (vm[..., None] & vv)[:, t_src].to(SS.F32)
            else:
                src_val = SS.apply_validity(src_cnt, vm[:, t_src], vv[:, t_src],
                                            mode, bedges)
            del src_cnt
        else:
            sv = state_v if i == 0 else SS.apply_validity(arrivals_v, vm, vv,
                                                          mode, bedges)
            if need_e:
                src_val = sv[:, t_src]
        cnt_e = (SS.apply_edge(src_val, wmask, evalidity, mode, bedges)
                 if need_e else None)
        d_add = d_mm = None
        if delta is not None:
            # delta-segment contribution, from the SAME pre-hop source state
            # and extremum channel the base delivery reads
            d_add, d_mm = SS.delta_hop_deliver(
                delta, ep, sv, params, pbases_e[i], mode, V, bedges,
                mch=(mch_v if with_minmax else None), minmax_op=minmax_op)
        if fused and ep.etr_op == -1:
            # fused kernel hop: arrivals (and the extremum channel) come from
            # one pass over the state table, with no per-edge state
            arrivals_v, mch_new = SS.fused_hop_deliver(
                sv, gdev["t_src"], wmask, evalidity, mode, ptr, V, bedges,
                mch=(mch_v if with_minmax else None), minmax_op=minmax_op)
            if with_minmax:
                mch_v = mch_new
        else:
            arrivals_v = SS.deliver(cnt_e, ptr, V, impl=impl)
            if with_minmax:
                m_e = SS.minmax_edge(mch_v[:, t_src], cnt_e, minmax_op, mode)
                mch_v = SS.deliver_extremum(m_e, ptr, V, minmax_op, impl=impl)
        if d_add is not None:
            arrivals_v = arrivals_v + d_add
            if with_minmax:
                comb = torch.minimum if minmax_op == Q.AGG_MIN else torch.maximum
                mch_v = comb(mch_v, d_mm)
            del d_add, d_mm
        stat = dict(phase=f"hop{i}", matched_edges=wmask.sum(dim=1))
        if not fused:
            # per-edge activity would force the materialisation the fused
            # path exists to avoid; report it on the plain path only
            stat["active_edges"] = torch.sum(
                (src_val if mode == MODE_STATIC else src_val.sum(
                    dim=tuple(range(2, src_val.dim())))) > 0, dim=1)
        stats.append(stat)
        del src_val
        arrivals_e = cnt_e
        prev_raw_e = cnt_e

    return SegmentResult(arrivals_e if need_final_e else None, arrivals_v,
                         stats, mch_v)


# =========================================================================
# plan execution (split-point plans, Sec. 4.3)
# =========================================================================
@dataclasses.dataclass
class ExecOutput:
    total: torch.Tensor                 # [Q] (static/interval) or [Q, B] (bucket)
    per_vertex: Optional[torch.Tensor]  # aggregation output ([Q, V] / [Q, V, B])
    minmax: Optional[torch.Tensor]      # [Q, V]
    stats: List[dict]


def pbases(qry: Q.PathQuery):
    """Parameter-row offsets per predicate (matching query_params order)."""
    pv, pe = [], []
    off = 0
    for v in qry.v_preds:
        pv.append(off)
        off += len(v.clauses)
    for e in qry.e_preds:
        pe.append(off)
        off += len(e.clauses)
    return pv, pe


def execute_plan(gdev, qry: Q.PathQuery, split: int, mode: int, n_buckets: int,
                 params, bedges, impl: str = "torch",
                 segment_runner=None, delta=None) -> ExecOutput:
    """Plan execution for a batch of same-shape queries (``params`` int32
    [Q, n_clauses, 3]).  All query structure is Python-static.

    ``segment_runner`` (default: the dense ``run_segment``) lets another
    executor reuse the split/join skeleton, as the partitioned one does.  It
    is called as ``run_segment`` is, without ``gdev``, ``bedges`` and
    ``impl``, plus ``need_final_e``; it must return a ``SegmentResult`` in
    GLOBAL vertex/traversal-edge space.  ``impl`` and ``delta`` (the
    base+delta path, see ``run_segment``) only parameterise the default
    dense runner."""
    n = qry.n_vertices
    assert 0 <= split < n
    pv, pe = pbases(qry)
    want_agg = qry.agg_op != Q.AGG_NONE
    want_minmax = qry.agg_op in (Q.AGG_MIN, Q.AGG_MAX)
    if want_agg:
        assert split == 0, "aggregate queries group by the first vertex → split=0"
    etr_at_join = 0 < split < n - 1 and qry.e_preds[split].etr_op != -1

    def runner(*a, **kw):
        if segment_runner is not None:
            return segment_runner(*a, need_final_e=etr_at_join, **kw)
        return run_segment(gdev, *a, bedges=bedges, impl=impl,
                           need_final_e=etr_at_join, delta=delta, **kw)

    rev = qry.reversed()

    # ---- left segment: v0 .. v_split (forward)
    left = None
    if split > 0:
        left = runner(
            qry.v_preds[: split + 1], qry.e_preds[:split], params,
            pv[: split + 1], pe[:split], mode, n_buckets, backward=False,
        )

    # ---- right segment: v_{n-1} .. v_split (reversed)
    right = None
    n_right_hops = (n - 1) - split
    if n_right_hops > 0:
        # params rows were packed for the ORIGINAL query; map them:
        # rev.v_preds[i] == qry.v_preds[n-1-i]; rev.e_preds[j] == qry.e_preds[n-2-j]
        rpv_orig = [pv[n - 1 - i] for i in range(n)]
        rpe_orig = [pe[n - 2 - j] for j in range(n - 1)]
        right = runner(
            rev.v_preds[: n_right_hops + 1], rev.e_preds[:n_right_hops],
            params, rpv_orig[: n_right_hops + 1], rpe_orig[:n_right_hops],
            mode, n_buckets, backward=True,
            with_minmax=want_minmax,
            minmax_op=qry.agg_op,
            minmax_col=(gdev["vprops"].get(qry.agg_key) if want_minmax else None),
        )

    stats = (left.stats if left else []) + (right.stats if right else [])

    # ---- join at v_split
    vm, vv = SS.eval_predicate(
        gdev["vprops"], gdev["v_type"], gdev["v_life"], qry.v_preds[split].vtype,
        qry.v_preds[split].clauses, params, pv[split], mode, bedges,
    )

    def vertex_apply(av):
        return SS.apply_validity(av, vm, vv, mode, bedges)

    if n == 1:  # degenerate single-vertex query
        st = SS.init_state(vm, vv, mode, n_buckets, bedges)
        total = SS.state_total(st, mode)
        per_v = mm = None
        if want_agg:
            per_v = st if mode != MODE_INTERVAL else SS.cells_to_buckets(st)
        if want_minmax:
            vals0, _ = gdev["vprops"][qry.agg_key]
            mm = SS.minmax_seed(st, vals0, qry.agg_op, mode)
        return ExecOutput(total, per_v, mm, stats)

    if not etr_at_join:
        if left is None:
            Rv = vertex_apply(right.arrivals_v)
            total = SS.state_total(Rv, mode)
            if want_agg:
                per_v = Rv if mode != MODE_INTERVAL else SS.cells_to_buckets(Rv)
                mm = None
                if want_minmax:
                    mm = torch.where(SS.state_alive(Rv, mode), right.minmax_v,
                                     torch.full_like(right.minmax_v,
                                                     SS.minmax_neutral(qry.agg_op)))
                return ExecOutput(total, per_v, mm, stats)
            return ExecOutput(total, None, None, stats)
        if right is None:
            Lv = vertex_apply(left.arrivals_v)
            return ExecOutput(SS.state_total(Lv, mode), None, None, stats)
        # both sides present, plain product join
        return ExecOutput(product_join(vertex_apply(left.arrivals_v),
                                       right.arrivals_v, mode), None, None, stats)

    # ---- ETR-at-join: weight right final edges by left arrivals via ranks
    op = qry.e_preds[split].etr_op
    W = SS.etr_weighted(gdev, left.arrivals_e, op, backward=False, use_arr=True)
    t_dst = gdev["t_dst_l"]
    total = etr_join(W, right.arrivals_e, vm[:, t_dst],
                     None if vv is None else vv[:, t_dst], mode, bedges)
    return ExecOutput(total, None, None, stats)


def product_join(Lv, Rv, mode):
    """Σ over the split vertex of left × right arrivals (per query)."""
    if mode == MODE_STATIC:
        return torch.sum(Lv * Rv, dim=1)
    if mode == MODE_BUCKET:
        return torch.sum(Lv * Rv, dim=1)
    return torch.sum(SS.join_interval_counts(Lv, Rv), dim=1)


def etr_join(W, right_e, vm_e, vv_e, mode, bedges):
    """ETR-at-join total: rank-weighted left arrivals ``W`` against the right
    segment's final per-edge counts, with the split vertex's predicate
    (``vm_e``/``vv_e``, gathered at each edge's join vertex) applied."""
    if mode == MODE_STATIC:
        return torch.sum(W * right_e * vm_e.to(SS.F32), dim=1)
    if mode == MODE_BUCKET:
        return torch.sum(W * right_e * (vm_e[..., None] & vv_e).to(SS.F32), dim=1)
    Wc = SS.apply_validity(W, vm_e, vv_e, mode, bedges)
    return torch.sum(SS.join_interval_counts_edges(Wc, right_e), dim=1)


# =========================================================================
# public API
# =========================================================================
def prepare_gdev(graph: TemporalGraph, device) -> dict:
    """The graph's device arrays plus int64 copies of the index arrays that
    torch indexing reads (cached on the graph, per device)."""
    g = graph.device_arrays(device)
    if "t_src_l" not in g:
        g["t_src_l"] = g["t_src"].long()
        g["t_dst_l"] = g["t_dst"].long()
    return g


def bucket_edges_for(graph: TemporalGraph, n_buckets: int, device) -> torch.Tensor:
    return torch.from_numpy(
        iv.bucket_edges(graph.lifespan[0], graph.lifespan[1], n_buckets)).to(device)


def default_split(qry: Q.PathQuery) -> int:
    """Left-to-right (split = n-1) for plain queries, right-to-left (split =
    0) for aggregates."""
    return 0 if qry.agg_op != Q.AGG_NONE else qry.n_vertices - 1


def check_batch_shape(queries: Sequence[Q.PathQuery]) -> tuple:
    """Validate that a batch shares one template shape; returns the key."""
    assert queries, "empty batch"
    shape0 = queries[0].shape_key()
    for q in queries[1:]:
        if q.shape_key() != shape0:
            raise ValueError("batched queries must share a template shape")
    return shape0


def batch_executable(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    sliced: Optional[bool] = None,
    impl: str = "cuda",
    device=None,
):
    """Batched entry for one query shape.

    Returns ``run(params)`` where ``params`` is the stacked parameter tensor
    int32[Q, n_clauses, 3] of same-shape instances; ``run`` yields an
    ``ExecOutput`` whose every field carries a leading query axis.
    ``sliced=None`` picks the sliced executor when the query qualifies
    (``engine_sliced.sliceable``).
    """
    from . import engine_sliced as ES

    dev = resolve_device(device)
    check_impl(impl)
    if split is None:
        split = default_split(qry)
    use_sliced = ES.sliceable(qry) if sliced is None else sliced
    if use_sliced and not ES.sliceable(qry):
        raise ValueError("query not sliceable (wildcard vertex type)")
    gdev = prepare_gdev(graph, dev)
    bedges = bucket_edges_for(graph, n_buckets, dev)
    V = graph.n_vertices
    sb = ptrs = None
    if use_sliced:
        # the slices' CSR pointers are made once per executable, not per run
        sb = ES.SliceBounds.from_graph(graph)
        ptrs = ES.slice_ptrs(gdev, sb, ES.arrival_types(qry, split))
    embed = None
    if use_sliced and qry.agg_op != Q.AGG_NONE:
        embed = sb.v[qry.v_preds[0].vtype]

    def run(params) -> ExecOutput:
        params = torch.as_tensor(np.asarray(params, np.int32)).to(dev)
        with torch.no_grad():
            if use_sliced:
                out = ES.execute_plan_sliced(gdev, qry, split, mode, n_buckets,
                                             params, bedges, sb, impl=impl,
                                             ptrs=ptrs)
            else:
                out = execute_plan(gdev, qry, split, mode, n_buckets, params,
                                   bedges, impl=impl)
        per_vertex = out.per_vertex
        if embed is not None and per_vertex is not None:
            # sliced aggregates live on the first-vertex type slice; re-embed
            lo, hi = embed
            full = per_vertex.new_zeros((per_vertex.shape[0], V)
                                        + tuple(per_vertex.shape[2:]))
            full[:, lo:hi] = per_vertex
            per_vertex = full
        return ExecOutput(out.total, per_vertex, out.minmax, out.stats)

    return run


def batch_executable_delta(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    impl: str = "cuda",
    device=None,
):
    """Base+delta twin of ``batch_executable`` for live-graph serving.

    ``graph`` is the COMPACTED BASE; the returned ``run(params, delta)``
    additionally takes a ``graphdata.ingest.DeltaSpec.device(device)`` dict
    and answers as if the delta edges were part of the graph —
    bit-identical to ``batch_executable`` on the merged epoch graph
    (tests/test_torch_ingest.py).  The base hops run on the base graph's
    arrival CSR (the fused hop kernels with ``impl='cuda'``); each hop adds
    the delta's unsorted delivery after it.  The executable binds nothing
    of the delta, so one executable serves every epoch of a compaction
    window.

    ETR hops read whole-graph rank tables, so queries containing them are
    refused (the scheduler serves those from the merged epoch graph).
    ``device`` follows ``batch_executable``'s rule.
    """
    if any(e.etr_op != -1 for e in qry.e_preds):
        raise ValueError("ETR hops need global rank tables — not delta-"
                         "executable; serve from the merged epoch graph")
    dev = resolve_device(device)
    check_impl(impl)
    if split is None:
        split = default_split(qry)
    gdev = prepare_gdev(graph, dev)
    bedges = bucket_edges_for(graph, n_buckets, dev)

    def run(params, delta) -> ExecOutput:
        params = torch.as_tensor(np.asarray(params, np.int32)).to(dev)
        with torch.no_grad():
            out = execute_plan(gdev, qry, split, mode, n_buckets, params,
                               bedges, impl=impl, delta=delta)
        return ExecOutput(out.total, out.per_vertex, out.minmax, out.stats)

    return run


def execute_batch_out(
    graph: TemporalGraph,
    queries: Sequence[Q.PathQuery],
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    sliced: Optional[bool] = None,
    impl: str = "cuda",
    device=None,
) -> ExecOutput:
    """Batched execution of same-shape instances; full ExecOutput with a
    leading query axis on every field (aggregates included)."""
    check_batch_shape(queries)
    run = batch_executable(graph, queries[0], split, mode, n_buckets, sliced,
                           impl=impl, device=device)
    return run(np.stack([Q.query_params(q) for q in queries]))


def execute_batch(
    graph: TemporalGraph,
    queries: Sequence[Q.PathQuery],
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    sliced: Optional[bool] = None,
    impl: str = "cuda",
    device=None,
) -> np.ndarray:
    """Batched execution of query instances sharing one template shape.

    Returns totals [n_queries] (static/interval) or [n_queries, B] (bucket)
    as numpy.  For aggregates / per-vertex outputs use ``execute_batch_out``.
    """
    out = execute_batch_out(graph, queries, split, mode, n_buckets, sliced,
                            impl=impl, device=device)
    return out.total.cpu().numpy()


def execute(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    sliced: Optional[bool] = None,
    impl: str = "cuda",
    device=None,
) -> ExecOutput:
    """Execute one path query with the given plan (split point): the batch of
    one, with the query axis dropped from every field.

    split=None defaults to left-to-right (split = n-1) for plain queries and
    right-to-left (split = 0) for aggregates.  ``sliced`` selects the
    type-sliced path (engine_sliced.py); None = auto.
    """
    out = execute_batch_out(graph, [qry], split, mode, n_buckets, sliced,
                            impl=impl, device=device)

    def one(x):
        return None if x is None else x[0]

    stats = [{k: one(v) for k, v in s.items() if not isinstance(v, str)}
             for s in out.stats]
    return ExecOutput(one(out.total), one(out.per_vertex), one(out.minmax), stats)


def count_results(graph, qry, **kw) -> float:
    out = execute(graph, qry, **kw)
    t = out.total.cpu().numpy()
    return float(t.sum()) if t.ndim else float(t)
