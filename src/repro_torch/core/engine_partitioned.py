"""Partition-sharded superstep execution — the DISTRIBUTED executor, in torch.

The port of the reference package's ``core/engine_partitioned.py`` (the
paper's execution model, Sec. 4).  The graph is split by the two-level
partitioner (``graphdata.partitioner``); each worker owns the traversal
edges *arriving* at its vertices, and a superstep is

  local compute   per worker: gather boundary state for its halo sources,
                  apply the edge predicate, and DELIVER locally by a
                  segment-sum over its own arrival CSR (no cross-worker
                  writes);
  exchange        between supersteps: a point-to-point ragged all-to-all
                  (``superstep.p2p_exchange`` over the partitioner's lane
                  tables) hands each worker exactly the ghost entries its
                  halo names.

State lives OWNER-LOCAL throughout a segment: per-worker vertex state
[Q, W, Vmax, *TS] (kept flat as [Q, W·Vmax, *TS]) and per-edge counts over
the workers' REAL owned edges, worker-major ([Q, E, *TS]: the partitioner
pads each worker's edge row to the longest worker's, and the port drops the
pads from every per-edge tensor).  Global views are published once per
segment (the plan skeleton joins in global space), not per hop.

One process runs every worker as a batched axis, and the exchange as a
transpose of the two worker axes.  With a ``torch.distributed`` group
(``group=``) each rank runs W / R consecutive workers, the same exchange
moves with one ``all_to_all_single`` (gloo on the CPU, NCCL on GPUs) and the
segment-end publish is one ``all_reduce`` per view (SUM; MIN or MAX for the
extremum channel).  Both are pure data movement over identical tables, so
they agree bit for bit.

Kernels (``impl='cuda'``): every plain hop is ONE launch of the fused hop
kernel (B1 static/bucket, B2 interval) and every ETR delivery ONE launch of
the scatter kernel (B3), over all workers and all queries at once: the
workers' local arrival CSRs are flattened into one over their real edges
(``kernels.hop_scatter.WorkerCSR``), so no lane walks a pad edge.

Three exchange channels ride the same mechanism:

  plain-hop state    each hop ships the ghost vertices' count state
                     (``PartitionArrays.exchange_volume()`` entries);
  extremum           MIN/MAX aggregates ship the per-vertex extremum channel
                     alongside (same lanes, ±inf fill);
  ETR rank summaries ETR hops ship only the boundary rank summaries of cut
                     segments (``etr_exchange_volume()`` entries): segment
                     owners produce per-edge summaries from SEGMENT-LOCAL
                     prefix tables (``superstep.etr_local_summaries``).

Semantics: the same answers as ``engine.execute`` in all three temporal
modes and on the full query surface, because every elementwise primitive
comes from ``superstep.py`` unchanged and each vertex's arrival edges live on
ONE worker in canonical order.

Entry points take ``device=None`` (the card) and raise with no GPU unless the
caller passes ``device='cpu'``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import query as Q
from . import superstep as SS
from .engine import (ExecOutput, SegmentResult, bucket_edges_for,
                     check_batch_shape, default_split, execute_plan,
                     needs_edge_counts, pbases, prepare_gdev)
from .graph import TemporalGraph
from .superstep import MODE_BUCKET, MODE_INTERVAL, MODE_STATIC  # noqa: F401
from ..kernels import hop_scatter as HK
from ..kernels.common import check_impl, resolve_device, use_kernels

#: boundary-exchange channels, in reporting order (measure_supersteps and the
#: cost-model fit use these indices)
CHANNELS = ("state", "extremum", "etr")


# =========================================================================
# device tables
# =========================================================================
def worker_slice(n_workers: int, group=None) -> slice:
    """The workers this process runs: all of them, or with a
    ``torch.distributed`` group of R ranks the rank's W / R consecutive
    ones (the counterpart of the reference's ``resolve_n_devices``)."""
    if group is None:
        return slice(0, n_workers)
    import torch.distributed as dist

    R, r = dist.get_world_size(group), dist.get_rank(group)
    if n_workers % R:
        raise ValueError(f"{n_workers} workers do not divide over {R} ranks")
    wl = n_workers // R
    return slice(r * wl, (r + 1) * wl)


def _prepare_pdev(arrays, gdev: dict, device, workers: slice,
                  distributed: bool = False) -> dict:
    """torch views of the partitioner's tables for ``workers``, with the
    per-edge tables moved onto the real-edge layout (see module docstring).

    Vertex-side tables keep the padded [Wl, Vmax] rows; the flat owned-slot
    ids ``own_flat`` pad with V (the synthetic zero row)."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    sl = workers
    V = int(arrays.owner_of_vertex.shape[0])
    v_max, e_max, h_max = arrays.v_max, arrays.e_max, arrays.h_max
    own = arrays.own_ids[sl].astype(np.int64)
    Wl = own.shape[0]
    lay = HK.worker_csr(arrays.worker_arrival_ptr()[sl], e_max, device)
    real = lay.real.cpu().numpy()
    real_w = real // e_max
    eids = arrays.edge_ids[sl].reshape(-1)[real].astype(np.int64)
    src_rows = real_w * h_max + arrays.src_halo[sl].reshape(-1)[real]
    n_real_w = np.bincount(real_w, minlength=Wl)
    off = np.concatenate(([0], np.cumsum(n_real_w)[:-1]))
    n_real = int(n_real_w.sum())

    def compact(perm):  # local edge slots -> real-edge rows; pad -> n_real
        p = perm[sl].astype(np.int64)
        return np.where(p < e_max, p + off[:, None], n_real)

    own_flat = own.reshape(-1)
    own_pos = np.nonzero(own_flat < V)[0]
    t_src = gdev["t_src"].long()
    ranks = gdev["etr_dep_ranks"].long()
    src_eids = t(arrays.etr_src_eids[sl].astype(np.int64))
    ranks_pad = torch.cat([ranks, ranks.new_zeros((4, 1))], dim=1)
    ti = lambda a: t(a.astype(np.int64))
    # ETR summaries land straight at the real owned edges: receive slot
    # (w, j) of the padded [Wl, e_max] rows is real-edge row off[w] + j (a
    # pad slot is never a receive position)
    edge_row = np.zeros(Wl * e_max, np.int64)
    edge_row[real] = np.arange(n_real)
    state_tables = tuple(ti(a[sl]) for a in (
        arrays.halo_own_slot, arrays.xchg_send_slot, arrays.xchg_recv_slot))
    etr_tables = tuple(ti(a[sl]) for a in (
        arrays.etr_local_slot, arrays.etr_send_slot, arrays.etr_recv_slot))
    return dict(
        layout=lay,
        n_real=n_real,
        own_flat=t(own_flat),
        own_pos=t(own_pos),
        own_vids=t(own_flat[own_pos]),
        real_eids=t(eids),
        src_rows=t(src_rows.astype(np.int32)),
        t_src_real=t_src.index_select(0, t(eids)),
        state_tables=state_tables,
        plan_state=SS.exchange_plan(*state_tables, v_max, h_max, distributed),
        etr_perm_s=t(compact(arrays.etr_perm_local_s)),
        etr_perm_e=t(compact(arrays.etr_perm_local_e)),
        etr_src_base=t(arrays.etr_src_base[sl].astype(np.int64)),
        etr_src_len=t(arrays.etr_src_len[sl].astype(np.int64)),
        etr_ranks=ranks_pad[:, src_eids.reshape(-1)].reshape(
            (4,) + tuple(src_eids.shape)).permute(1, 0, 2).contiguous(),
        etr_tables=etr_tables,
        plan_etr=SS.exchange_plan(*etr_tables, arrays.s_max, e_max, distributed,
                                  out_pos=t(edge_row), n_out=n_real),
        v_max=v_max, e_max=e_max, h_max=h_max, n_workers_local=Wl,
    )


def _rows(x, idx, fill=None):
    """``x[:, idx]`` along the entity axis, keeping a query-shared ``x``
    (query stride 0) shared.  With ``fill`` an index equal to x.shape[1]
    reads a synthetic row of ``fill`` (the reference's zero-row sentinel)."""
    shared = x.shape[0] > 1 and x.stride(0) == 0
    base = x[:1] if shared else x
    if fill is not None:
        pad = torch.full((base.shape[0], 1) + tuple(base.shape[2:]), fill,
                         dtype=base.dtype, device=base.device)
        base = torch.cat([base, pad], dim=1)
    out = base.index_select(1, idx)
    return out.expand((x.shape[0],) + tuple(out.shape[1:])) if shared else out


def _gather_vpred_w(vm, vv, own_flat):
    """A global vertex predicate at the owned slots [Q, Wl·Vmax] (pad slots
    read the zero row: dead state)."""
    vm_w = _rows(vm, own_flat, fill=False)
    vv_w = None
    if vv is not None:
        vv_w = _rows(vv, own_flat, fill=False if vv.dtype == torch.bool else 0)
    return vm_w, vv_w


def _publish(rows, ids, pos, n_global: int, fill: float = 0.0):
    """Owner-local rows [Q, K, *TS] at positions ``pos`` → global
    [Q, n_global, *TS] at ``ids`` (unique: every entity has one owner)."""
    out = torch.full((rows.shape[0], n_global) + tuple(rows.shape[2:]), fill,
                     dtype=rows.dtype, device=rows.device)
    src = rows if pos is None else rows.index_select(1, pos)
    return out.index_copy_(1, ids, src)


# =========================================================================
# the local hop: p2p exchange → halo gather → edge apply → local delivery
# =========================================================================
def _exchange_state(state, pdev, group, fill: float = 0.0):
    """The vertex-state boundary exchange: owned state [Q, Wl·Vmax, *TS] →
    every worker's halo slice, stacked [Q, Wl·Hmax, *TS]."""
    nq, Wl, Vm = state.shape[0], pdev["n_workers_local"], pdev["v_max"]
    ts = tuple(state.shape[2:])
    halo = SS.p2p_exchange(state.reshape((nq, Wl, Vm) + ts),
                           *pdev["state_tables"], pdev["h_max"], group,
                           fill=fill, plan=pdev["plan_state"])
    return halo.reshape((nq, Wl * pdev["h_max"]) + ts)


def _local_compute(halo, m_halo, wmask, evalid, pdev, mode: int, mch_op: int,
                   impl: str, bedges, need_e: bool):
    """A superstep's local part on exchanged halos: per-edge counts (only
    when ``need_e``) and the delivery.  With ``impl='cuda'`` the delivery
    (and the extremum channel, when ``m_halo`` is given) is one fused-hop
    launch over every worker's CSR.

    Returns (cnt [Q, E, *TS] | None, arrivals [Q, Wl·Vmax, *TS], mch | None)."""
    lay = pdev["layout"]
    wm = _rows(wmask, pdev["real_eids"])
    ev = None if evalid is None else _rows(evalid, pdev["real_eids"])
    fused = use_kernels(impl)
    cnt = None
    if need_e or not fused:
        cnt = SS.apply_edge(halo.index_select(1, pdev["src_rows"].long()), wm,
                            ev, mode, bedges)
    if fused:
        arrivals, mch = SS.fused_hop_deliver(
            halo, pdev["src_rows"], wm, ev, mode, lay.ptr, lay.n_dst, bedges,
            mch=m_halo, minmax_op=mch_op)
        return cnt, arrivals, mch
    arrivals = SS.deliver(cnt, lay.ptr, lay.n_dst)
    mch = None
    if m_halo is not None:
        m_e = SS.minmax_edge(m_halo.index_select(1, pdev["src_rows"].long()),
                             cnt, mch_op, mode)
        mch = SS.deliver_extremum(m_e, lay.ptr, lay.n_dst, mch_op)
    return cnt, arrivals, mch


def _local_hop_p2p(state, wmask, evalid, pdev, mode: int, group, mch=None,
                   minmax_op: int = Q.AGG_MIN, impl: str = "torch",
                   bedges=None, need_e: bool = True):
    """One superstep on owner-local state: exchange (state, and the extremum
    channel on the same lanes), then the local compute."""
    halo = _exchange_state(state, pdev, group)
    m_halo = None
    if mch is not None:
        m_halo = _exchange_state(mch, pdev, group,
                                 fill=SS.minmax_neutral(minmax_op))
    return _local_compute(halo, m_halo, wmask, evalid, pdev, mode, minmax_op,
                          impl, bedges, need_e)


# =========================================================================
# ETR hop: per-worker rank-summary production + p2p summary exchange
# =========================================================================
#: bytes of one prefix table the ETR producer builds at a time: workers are
#: taken in groups that fit (all at once in static mode; one at a time at
#: interval width, where a worker's table is about 1.3 GB at W = 8 on the
#: 100,000-person graph)
ETR_CHUNK_BYTES = 2 << 30


def _etr_produce_w(cnt, pdev, op: int, backward: bool):
    """Every local worker's rank summaries [Q, Wl, Smax, *TS] from its owned
    prev-hop counts (real-edge rows [Q, E, *TS]) reordered by the per-worker
    (dst, stat) permutations, in groups of workers of at most
    ``ETR_CHUNK_BYTES`` a table."""
    nq, ts = cnt.shape[0], tuple(cnt.shape[2:])
    Wl, e_max = pdev["n_workers_local"], pdev["e_max"]
    width = nq * e_max * max(1, int(np.prod(ts))) * cnt.element_size()
    step = max(1, ETR_CHUNK_BYTES // max(width, 1))
    cnt_pad = torch.cat([cnt, cnt.new_zeros((nq, 1) + ts)], dim=1)
    end = SS.etr_needs_end(op, backward)
    out = None
    for w0 in range(0, Wl, step):
        sl = slice(w0, min(w0 + step, Wl))
        n = sl.stop - sl.start

        def perm(p):
            return cnt_pad.index_select(1, p[sl].reshape(-1)).reshape(
                (nq, n, e_max) + ts)

        part = SS.etr_local_summaries(
            perm(pdev["etr_perm_s"]), perm(pdev["etr_perm_e"]) if end else None,
            pdev["etr_src_base"][sl], pdev["etr_src_len"][sl],
            pdev["etr_ranks"][sl], op, backward)
        if n == Wl:
            return part
        if out is None:
            out = part.new_empty((nq, Wl) + tuple(part.shape[2:]))
        out[:, sl] = part
        del part
    return out


def _exchange_etr(out_w, pdev, group):
    """The ETR boundary exchange: producers route each summary to the edge's
    owner.  Returns the summaries at the real owned edges [Q, E, *TS]."""
    return SS.p2p_exchange(out_w, *pdev["etr_tables"], pdev["e_max"], group,
                           plan=pdev["plan_etr"])


def _etr_apply_sources(summ, vm, vv, tsrc, mode: int, bedges):
    """Intermediate vertex predicate at the owned edges' source vertices
    (replicated elementwise compute, no exchange)."""
    if mode == MODE_STATIC:
        return summ * vm[:, tsrc].to(SS.F32)
    if mode == MODE_BUCKET:
        return summ * (vm[..., None] & vv)[:, tsrc].to(SS.F32)
    return SS.apply_validity(summ, vm[:, tsrc], vv[:, tsrc], mode, bedges)


def _etr_consume(summ, vm, vv, wmask, evalid, pdev, mode: int, impl: str,
                 bedges):
    """The consumer half of an ETR hop: source predicate, edge apply and the
    local delivery (B3 over every worker's CSR with ``impl='cuda'``)."""
    lay = pdev["layout"]
    sv = _etr_apply_sources(summ, vm, vv, pdev["t_src_real"], mode, bedges)
    ev = None if evalid is None else _rows(evalid, pdev["real_eids"])
    cnt = SS.apply_edge(sv, _rows(wmask, pdev["real_eids"]), ev, mode, bedges)
    del sv
    return cnt, SS.deliver(cnt, lay.ptr, lay.n_dst, impl)


def _etr_hop_p2p(pdev, prev: list, vm, vv, wmask, evalid, op: int,
                 backward: bool, mode: int, group, impl: str, bedges):
    """One ETR superstep on owner-local state: produce → exchange → consume.
    ``prev`` holds the previous hop's counts and is emptied once the
    summaries exist (at interval width they are gigabytes)."""
    out_w = _etr_produce_w(prev.pop(), pdev, op, backward)
    summ = _exchange_etr(out_w, pdev, group)
    del out_w
    return _etr_consume(summ, vm, vv, wmask, evalid, pdev, mode, impl, bedges)


# =========================================================================
# segment runner (plugs into engine.execute_plan)
# =========================================================================
def run_segment_partitioned(
    gdev: dict,
    pdev: dict,
    group,
    impl: str,
    bedges,
    v_preds: Sequence[Q.VertexPredicate],
    e_preds: Sequence[Q.EdgePredicate],
    params,
    pbases_v: Sequence[int],
    pbases_e: Sequence[int],
    mode: int,
    n_buckets: int,
    backward: bool,
    with_minmax: bool = False,
    minmax_op: int = Q.AGG_MIN,
    minmax_col=None,
    need_final_e: bool = True,
) -> SegmentResult:
    """Partitioned twin of ``engine.run_segment`` on owner-local state.

    Per-hop state never leaves the workers except through the
    point-to-point exchange; the GLOBAL views the plan skeleton needs are
    published once at segment end (with a group: one all_reduce each).
    Per-edge counts are built only where a reader needs them
    (``engine.needs_edge_counts``): the next hop's ETR producer, or the
    segment-end ``arrivals_e`` when ``need_final_e``."""
    V = gdev["v_life"].shape[0]
    n2e = gdev["t_dst"].shape[0]
    fused = use_kernels(impl)
    own_flat = pdev["own_flat"]

    vm, vv = SS.eval_predicate(
        gdev["vprops"], gdev["v_type"], gdev["v_life"], v_preds[0].vtype,
        v_preds[0].clauses, params, pbases_v[0], mode, bedges,
    )
    vm_w, vv_w = _gather_vpred_w(vm, vv, own_flat)
    state = SS.init_state(vm_w, vv_w, mode, n_buckets, bedges)

    mch = None
    if with_minmax:
        vals0, _ = minmax_col
        vals_w = torch.cat([vals0, vals0.new_zeros((1,) + tuple(vals0.shape[1:]))])
        mch = SS.minmax_seed(state, vals_w.index_select(0, own_flat), minmax_op,
                             mode)

    cnt = None
    arrivals = None
    for i, ep in enumerate(e_preds):
        wmask, evalid = SS.edge_predicate_weights(
            gdev, ep, params, pbases_e[i], mode, bedges)
        if i > 0:
            vm, vv = SS.eval_predicate(
                gdev["vprops"], gdev["v_type"], gdev["v_life"],
                v_preds[i].vtype, v_preds[i].clauses, params, pbases_v[i],
                mode, bedges,
            )
        need_e = needs_edge_counts(fused, e_preds, i, need_final_e)
        if ep.etr_op != -1:
            if with_minmax:
                raise NotImplementedError("min/max aggregation across ETR hops")
            prev, cnt = [cnt], None
            cnt, arrivals = _etr_hop_p2p(pdev, prev, vm, vv, wmask, evalid,
                                         ep.etr_op, backward, mode, group,
                                         impl, bedges)
        else:
            if i > 0:
                vm_w, vv_w = _gather_vpred_w(vm, vv, own_flat)
                state = SS.apply_validity(arrivals, vm_w, vv_w, mode, bedges)
            cnt = None  # the previous counts have no reader past this point
            cnt, arrivals, mch = _local_hop_p2p(
                state, wmask, evalid, pdev, mode, group, mch, minmax_op, impl,
                bedges, need_e)
        del wmask, evalid

    # publish the segment's GLOBAL views; with a group each rank holds its
    # own entities and zeros (the neutral for the extremum) elsewhere, so
    # one all_reduce combines them exactly
    arrivals_e = None
    if need_final_e and cnt is not None:
        arrivals_e = _publish(cnt, pdev["real_eids"], None, n2e)
    del cnt
    arrivals_v = _publish(arrivals, pdev["own_vids"], pdev["own_pos"], V)
    mch_g = None
    if mch is not None:
        mch_g = _publish(mch, pdev["own_vids"], pdev["own_pos"], V,
                         fill=SS.minmax_neutral(minmax_op))
    if group is not None:
        import torch.distributed as dist

        for x in (arrivals_e, arrivals_v):
            if x is not None:
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        if mch_g is not None:
            dist.all_reduce(mch_g, group=group, op=(
                dist.ReduceOp.MIN if minmax_op == Q.AGG_MIN
                else dist.ReduceOp.MAX))
    return SegmentResult(arrivals_e, arrivals_v, [], mch_g)


# =========================================================================
# public API
# =========================================================================
def partition_for(graph: TemporalGraph, n_workers: int,
                  parts_per_type: Optional[int] = None):
    """(Partitioning, PartitionArrays) for a graph, cached ON the graph
    object so the cache's lifetime (and the validity of the ownership
    tables) is tied to the graph itself.  The set-up seconds of a fresh
    build are kept on the arrays as ``setup_s`` (partition, tables)."""
    from ..graphdata.partitioner import build_partition_arrays, partition_graph

    ppt = parts_per_type if parts_per_type is not None else max(4, n_workers // 2)
    cache = getattr(graph, "_partition_cache", None)
    if cache is None:
        cache = {}
        graph._partition_cache = cache
    key = (n_workers, ppt)
    hit = cache.get(key)
    if hit is None:
        t0 = time.perf_counter()
        part = partition_graph(graph, n_workers=n_workers, parts_per_type=ppt)
        t1 = time.perf_counter()
        arrays = build_partition_arrays(graph, part)
        arrays.setup_s = dict(partition=t1 - t0,
                              tables=time.perf_counter() - t1)
        hit = (part, arrays)
        cache[key] = hit
    return hit


def device_tables(graph: TemporalGraph, n_workers: int,
                  parts_per_type: Optional[int] = None, device=None,
                  group=None):
    """(PartitionArrays, device tables of this process's workers), cached on
    the graph per (workers, device, worker slice)."""
    dev = resolve_device(device)
    _, arrays = partition_for(graph, n_workers, parts_per_type)
    sl = worker_slice(n_workers, group)
    cache = graph.__dict__.setdefault("_partition_dev_cache", {})
    key = (n_workers, parts_per_type, str(dev), sl.start, sl.stop,
           group is not None)
    pdev = cache.get(key)
    if pdev is None:
        pdev = _prepare_pdev(arrays, prepare_gdev(graph, dev), dev, sl,
                             distributed=group is not None)
        cache[key] = pdev
    return arrays, pdev


def batch_executable(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    n_workers: int = 4,
    parts_per_type: Optional[int] = None,
    impl: str = "cuda",
    device=None,
    group=None,
):
    """Batched entry on the DISTRIBUTED path: the whole superstep pipeline
    (p2p halo exchange → local delivery → segment-end publish) runs with a
    query-batch leading axis, so one partitioned sweep serves the batch.

    Returns ``run(params[B, n_clauses, 3]) -> ExecOutput`` with a leading
    query axis on every field.  ``group`` (a ``torch.distributed`` process
    group) runs this rank's share of the workers; every rank returns the
    same answers."""
    check_impl(impl)
    dev = resolve_device(device)
    if split is None:
        split = default_split(qry)
    gdev = prepare_gdev(graph, dev)
    _, pdev = device_tables(graph, n_workers, parts_per_type, dev, group)
    bedges = bucket_edges_for(graph, n_buckets, dev)

    def runner(*a, **kw):
        return run_segment_partitioned(gdev, pdev, group, impl, bedges, *a, **kw)

    def run(params) -> ExecOutput:
        params = torch.as_tensor(np.asarray(params, np.int32)).to(dev)
        with torch.no_grad():
            return execute_plan(gdev, qry, split, mode, n_buckets, params,
                                bedges, impl=impl, segment_runner=runner)

    return run


def execute_batch_out(
    graph: TemporalGraph,
    queries: Sequence[Q.PathQuery],
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    n_workers: int = 4,
    parts_per_type: Optional[int] = None,
    impl: str = "cuda",
    device=None,
    group=None,
) -> ExecOutput:
    """Batched partitioned execution of same-shape instances."""
    check_batch_shape(queries)
    run = batch_executable(graph, queries[0], split, mode, n_buckets, n_workers,
                           parts_per_type, impl=impl, device=device,
                           group=group)
    return run(np.stack([Q.query_params(q) for q in queries]))


def execute(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    split: Optional[int] = None,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    n_workers: int = 4,
    parts_per_type: Optional[int] = None,
    impl: str = "cuda",
    device=None,
    group=None,
) -> ExecOutput:
    """Partition-sharded execution of one query; the same results as
    ``engine.execute`` (the batch of one, the query axis dropped)."""
    out = execute_batch_out(graph, [qry], split, mode, n_buckets, n_workers,
                            parts_per_type, impl, device, group)
    one = lambda x: None if x is None else x[0]
    return ExecOutput(one(out.total), one(out.per_vertex), one(out.minmax), [])


def count_results(graph, qry, **kw) -> float:
    out = execute(graph, qry, **kw)
    t = out.total.cpu().numpy()
    return float(t.sum()) if t.ndim else float(t)


def hop_exchange_channels(qry: Q.PathQuery, arrays) -> List[Dict[str, int]]:
    """Structural per-HOP boundary volume per channel on the p2p lanes — the
    canonical statement of what each hop exchanges (the flight recorder's
    per-hop exchange spans and the planner's channel terms apply the same
    rule).  MIN/MAX ride the extremum channel on every plain hop; ETR hops
    ship only the boundary rank summaries."""
    minmax = qry.agg_op in (Q.AGG_MIN, Q.AGG_MAX)
    rows = []
    for ep in qry.e_preds:
        if ep.etr_op != -1:
            rows.append(dict(state=0, extremum=0,
                             etr=int(arrays.etr_exchange_volume())))
        else:
            v = int(arrays.exchange_volume())
            rows.append(dict(state=v, extremum=v if minmax else 0, etr=0))
    return rows


def query_exchange_volumes(qry: Q.PathQuery, arrays) -> Dict[str, int]:
    """Whole-query boundary volume per channel: the sum of
    ``hop_exchange_channels`` over the query's hops."""
    totals = dict(state=0, extremum=0, etr=0)
    for row in hop_exchange_channels(qry, arrays):
        for ch, v in row.items():
            totals[ch] += v
    return totals


# =========================================================================
# instrumented per-worker superstep timing (cost-model fit, chip_smoke)
# =========================================================================
@dataclasses.dataclass
class SuperstepProfile:
    times_s: np.ndarray            # float64[n_hops, W] — measured local-hop time
    exchange_msgs: np.ndarray      # int64[n_hops] — boundary messages (all channels)
    exchange_channels: np.ndarray  # int64[n_hops, 3] — per CHANNELS breakdown
    total: float                   # query total (sanity cross-check)

    @property
    def makespan_s(self) -> np.ndarray:
        """Per-superstep makespan: the straggler worker's measured time."""
        return self.times_s.max(axis=1)

    @property
    def balance_eff(self) -> float:
        per_worker = self.times_s.sum(axis=0)
        return float(per_worker.mean() / max(per_worker.max(), 1e-12))

    def channel_totals(self) -> Dict[str, int]:
        """Whole-query boundary volume per exchange channel."""
        sums = self.exchange_channels.sum(axis=0)
        return {name: int(sums[i]) for i, name in enumerate(CHANNELS)}


def _timer(dev):
    """``timed(fn, repeats)`` -> (best seconds, last output): CUDA events on
    the card, ``perf_counter`` on the CPU."""
    def timed(fn, repeats):
        best, out = np.inf, None
        for _ in range(max(1, repeats)):
            if dev.type == "cuda":
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn()
                b.record()
                b.synchronize()
                dt = a.elapsed_time(b) / 1e3
            else:
                t0 = time.perf_counter()
                out = fn()
                dt = time.perf_counter() - t0
            best = min(best, dt)
        return best, out
    return timed


def measure_supersteps(
    graph: TemporalGraph,
    qry: Q.PathQuery,
    n_workers: int = 4,
    mode: int = MODE_STATIC,
    n_buckets: int = 16,
    parts_per_type: Optional[int] = None,
    repeats: int = 2,
    impl: str = "cuda",
    tracer=None,
    device=None,
) -> SuperstepProfile:
    """Measured (not modelled) per-worker superstep times.

    Plain-count queries profile the left-to-right plan (split = n−1); COUNT
    and MIN/MAX aggregates profile the reversed segment (split = 0), with
    MIN/MAX threading the extremum channel through every hop, so all three
    boundary channels are measurable.  Each worker's local compute (the
    executor's own code on that worker's tables) runs SEPARATELY and is
    timed, best of ``repeats``; the point-to-point exchange runs between
    timings, untimed, and its per-channel ragged volume is reported in
    ``exchange_channels`` (halo ghosts for state and extremum, boundary rank
    summaries for ETR).  Per-edge counts are built only for the hops whose
    next hop's ETR producer reads them, as in the executor.

    ``tracer`` records the profile as a span tree (measure_supersteps →
    superstep per hop → exchange), the flight recorder's schema.
    """
    want_minmax = qry.agg_op in (Q.AGG_MIN, Q.AGG_MAX)
    if want_minmax and any(ep.etr_op != -1 for ep in qry.e_preds):
        raise NotImplementedError("min/max aggregation across ETR hops")
    check_impl(impl)
    dev = resolve_device(device)
    backward = qry.agg_op != Q.AGG_NONE
    gdev = prepare_gdev(graph, dev)
    arrays, pdev = device_tables(graph, n_workers, parts_per_type, dev)
    W = arrays.n_workers
    # each worker's own tables, as one rank of W would hold them
    pw = [_prepare_pdev(arrays, gdev, dev, slice(w, w + 1), distributed=True)
          for w in range(W)]
    bedges = bucket_edges_for(graph, n_buckets, dev)
    params = torch.as_tensor(Q.query_params(qry)[None]).to(dev)
    pv, pe = pbases(qry)
    n = qry.n_vertices
    if backward:
        rev = qry.reversed()
        v_preds, e_preds = rev.v_preds, rev.e_preds
        pv = [pv[n - 1 - i] for i in range(n)]
        pe = [pe[n - 2 - j] for j in range(n - 1)]
    else:
        v_preds, e_preds = qry.v_preds, qry.e_preds
    n_hops = len(e_preds)
    fused = use_kernels(impl)
    timed = _timer(dev)
    op_mm = qry.agg_op

    def vpred(i):
        vp = v_preds[i]
        return SS.eval_predicate(gdev["vprops"], gdev["v_type"], gdev["v_life"],
                                 vp.vtype, vp.clauses, params, pv[i], mode,
                                 bedges)

    times = np.zeros((n_hops, W))
    channels = np.zeros((n_hops, len(CHANNELS)), np.int64)
    n_ghost = int(arrays.n_ghost.sum())
    n_etr_ghost = int(arrays.n_src_ghost.sum())
    h = arrays.h_max
    with torch.no_grad():
        vm, vv = vpred(0)
        vm_w, vv_w = _gather_vpred_w(vm, vv, pdev["own_flat"])
        state = SS.init_state(vm_w, vv_w, mode, n_buckets, bedges)
        mch = None
        if want_minmax:
            vals0, _ = gdev["vprops"][qry.agg_key]
            vals_w = torch.cat([vals0, vals0.new_zeros((1,) + tuple(vals0.shape[1:]))])
            mch = SS.minmax_seed(state, vals_w.index_select(0, pdev["own_flat"]),
                                 op_mm, mode)
        cnt_rows = None   # per-worker real-edge counts of the last hop
        arrivals = None
        for i, ep in enumerate(e_preds):
            wmask, evalid = SS.edge_predicate_weights(gdev, ep, params, pe[i],
                                                      mode, bedges)
            if i > 0:
                vm, vv = vpred(i)
            need_e = needs_edge_counts(fused, e_preds, i, False)
            new_cnt, arr_rows, mch_rows = [], [], []
            if ep.etr_op != -1:
                summ_rows = []
                for w in range(W):
                    t_prod, ow = timed(lambda: _etr_produce_w(
                        cnt_rows[w], pw[w], ep.etr_op, backward), repeats)
                    times[i, w] = t_prod
                    summ_rows.append(ow)
                summ = _exchange_etr(torch.cat(summ_rows, dim=1), pdev, None)
                del summ_rows
                channels[i, 2] = n_etr_ghost
                bounds = np.concatenate(([0], np.cumsum(
                    [p["n_real"] for p in pw])))
                for w in range(W):
                    sw = summ[:, bounds[w]:bounds[w + 1]]
                    t_best, (cw, aw) = timed(lambda: _etr_consume(
                        sw, vm, vv, wmask, evalid, pw[w], mode, impl, bedges),
                        repeats)
                    times[i, w] += t_best
                    new_cnt.append(cw)
                    arr_rows.append(aw)
                del summ
            else:
                if i > 0:
                    vm_w, vv_w = _gather_vpred_w(vm, vv, pdev["own_flat"])
                    state = SS.apply_validity(arrivals, vm_w, vv_w, mode, bedges)
                halo = _exchange_state(state, pdev, None)
                channels[i, 0] = n_ghost
                m_halo = None
                if mch is not None:
                    m_halo = _exchange_state(mch, pdev, None,
                                             fill=SS.minmax_neutral(op_mm))
                    channels[i, 1] = n_ghost
                for w in range(W):
                    hw = halo[:, w * h:(w + 1) * h]
                    mw = None if m_halo is None else m_halo[:, w * h:(w + 1) * h]
                    t_best, (cw, aw, mo) = timed(lambda: _local_compute(
                        hw, mw, wmask, evalid, pw[w], mode, op_mm, impl,
                        bedges, need_e), repeats)
                    times[i, w] = t_best
                    new_cnt.append(cw)
                    arr_rows.append(aw)
                    mch_rows.append(mo)
                del halo, m_halo
                if mch is not None:
                    mch = torch.cat(mch_rows, dim=1)
            cnt_rows = new_cnt if new_cnt[0] is not None else None
            arrivals = torch.cat(arr_rows, dim=1)
        vmf, vvf = vpred(len(v_preds) - 1)
        av = _publish(arrivals, pdev["own_vids"], pdev["own_pos"],
                      graph.n_vertices)
        total = SS.state_total(SS.apply_validity(av, vmf, vvf, mode, bedges),
                               mode).cpu().numpy()
    profile = SuperstepProfile(times, channels.sum(axis=1), channels,
                               float(total.sum()))
    if tracer is not None and getattr(tracer, "enabled", False):
        root = tracer.start("measure_supersteps", n_workers=W, n_hops=n_hops,
                            impl=impl, mode=mode, backward=backward)
        for i in range(n_hops):
            ss = tracer.start(
                "superstep", parent=root, hop=i,
                measured_ms=float(times[i].max() * 1e3),
                per_worker_ms=[float(t * 1e3) for t in times[i]],
                etr=bool(e_preds[i].etr_op != -1))
            ex = tracer.start("exchange", parent=ss, hop=i,
                              state=int(channels[i, 0]),
                              extremum=int(channels[i, 1]),
                              etr=int(channels[i, 2]))
            tracer.end(ex)
            tracer.end(ss)
        tracer.end(root, total=profile.total, balance_eff=profile.balance_eff)
    return profile
