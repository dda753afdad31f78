"""Type-sliced plan execution in torch — the port of ``core/engine_sliced.py``.

The paper's type-based partitioning (Sec. 4.4.1) lets a superstep skip every
partition whose vertex type cannot match.  In tensor form: vertices are
type-major and traversal edges are arrival-sorted, so *the traversal edges
arriving at one vertex type are one contiguous slice* and a typed hop only
has to touch that slice.  Slice bounds are host-known per graph; everything
else (predicate eval, delivery, ETR rank prefix sums) operates on the slices
unchanged.

Work per hop drops from O(2E) to O(arrivals(σ_{i+1})) and the init from O(V)
to O(|V_σ0|).

Requires: every vertex predicate carries a type (the LDBC workload does), and
the aggregate, if any, is COUNT.  ``engine.execute`` routes other queries to
the dense executor.

A hop delivers into its arrival-type slice through the slice's own CSR
pointer ``arr_ptr[vlo:vhi+1] - arr_ptr[vlo]`` (``slice_ptrs``); on the kernel
path out-of-slice sources read the fused kernel's zero row.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import query as Q
from . import superstep as SS
from .engine import ExecOutput, etr_join, needs_edge_counts, pbases, product_join
from .graph import TemporalGraph
from .superstep import MODE_BUCKET, MODE_INTERVAL, MODE_STATIC
from ..kernels.common import use_kernels


@dataclasses.dataclass(frozen=True)
class SliceBounds:
    """Host-side static slice bounds for one graph."""
    v: Tuple[Tuple[int, int], ...]   # per type: [vlo, vhi)
    e: Tuple[Tuple[int, int], ...]   # per type: arrival-edge slice [elo, ehi)

    @staticmethod
    def from_graph(g: TemporalGraph) -> "SliceBounds":
        tr = g.type_ranges
        ptr = g.traversal["arr_ptr"]
        v = tuple((int(a), int(b)) for a, b in tr)
        e = tuple((int(ptr[a]), int(ptr[b])) for a, b in tr)
        return SliceBounds(v, e)


def arrival_types(qry: Q.PathQuery, split: int) -> list:
    """The vertex types a plan's hops deliver into: the forward segment
    arrives at v_1..v_split, the reversed segment at v_{n-2}..v_split."""
    v = list(qry.v_preds)
    return [p.vtype for p in v[1: split + 1] + v[split: len(v) - 1]]


def slice_ptrs(gdev, sb: SliceBounds, vtypes) -> Dict[int, torch.Tensor]:
    """Per vertex type in ``vtypes``: the int32 CSR pointer of the edges
    arriving at that type's vertex slice, relative to its edge slice.  A new
    dict; nothing is written into ``gdev``."""
    return {vt: gdev["arr_ptr"][sb.v[vt][0]:sb.v[vt][1] + 1] - sb.e[vt][0]
            for vt in dict.fromkeys(vtypes)}


def _vertex_eval_sliced(gdev, vp, params, pbase, mode, bedges, vb):
    lo, hi = vb
    props = {k: (v[0][lo:hi], v[1][lo:hi]) for k, v in gdev["vprops"].items()}
    return SS.eval_predicate(
        props, gdev["v_type"][lo:hi], gdev["v_life"][lo:hi], vp.vtype,
        vp.clauses, params, pbase, mode, bedges,
    )


def _edge_eval_sliced(gdev, ep, params, pbase, mode, bedges, eb):
    lo, hi = eb
    eprops = {k: (v[0][lo:hi], v[1][lo:hi]) for k, v in gdev["eprops_t"].items()}
    match, validity = SS.eval_predicate(
        eprops, gdev["t_type"][lo:hi], gdev["t_life"][lo:hi], ep.etype, ep.clauses,
        params, pbase, mode, bedges,
    )
    return SS.and_rows(match, SS.direction_mask(gdev["t_isfwd"][lo:hi], ep.direction)), validity


def _etr_weighted_sliced(gdev, cnt_prev, op, backward, use_arr,
                         prev_eb, cur_eb, prev_vb):
    """ETR prefix over the previous arrival slice, gathered for the current
    slice's edges.  cnt_prev [Q, K, *TS] lives on [prev_eb); ranks are
    slice-invariant."""
    alpha, terms = SS.ETR_SPECS[(op, backward)]
    plo, phi = prev_eb
    clo, chi = cur_eb
    perm_s = gdev["etr_perm_start"][plo:phi].long() - plo
    ranks = (gdev["etr_arr_ranks"] if use_arr else gdev["etr_dep_ranks"])[:, clo:chi].long()
    ptr = gdev["arr_ptr"].long()
    segv = (gdev["t_dst_l"] if use_arr else gdev["t_src_l"])[clo:chi]

    S_s = SS.prefix_table(cnt_prev, perm_s)
    S_e = None
    if SS.etr_needs_end(op, backward):
        S_e = SS.prefix_table(cnt_prev, gdev["etr_perm_end"][plo:phi].long() - plo)
    nmax = phi - plo
    base_pos = torch.clamp(ptr[segv] - plo, 0, nmax)
    end_pos = torch.clamp(ptr[segv + 1] - plo, 0, nmax)
    # edges whose source is outside the previous type slice contribute 0
    in_range = (ptr[segv] >= plo) & (ptr[segv + 1] <= phi)
    base_s = S_s.index_select(1, base_pos)
    out = None
    if alpha:
        out = (S_s.index_select(1, end_pos) - base_s) * alpha
    for sign, term in terms:
        S = S_e if term == 3 else S_s
        base = S_e.index_select(1, base_pos) if term == 3 else base_s
        pos = torch.clamp(base_pos + ranks[term], 0, nmax)
        val = (S.index_select(1, pos) - base) * sign
        out = val if out is None else out + val
    mask = in_range.to(cnt_prev.dtype).view((1, -1) + (1,) * (cnt_prev.dim() - 2))
    return out * mask


@dataclasses.dataclass
class _SegResult:
    arrivals_e: Optional[torch.Tensor]   # on the final arrival slice
    arrivals_v: Optional[torch.Tensor]   # [Q, vhi-vlo, *TS] of final vertex type
    final_eb: Tuple[int, int]
    final_vb: Tuple[int, int]


def _run_segment_sliced(gdev, v_preds, e_preds, params, pv, pe, mode,
                        n_buckets, backward, sb: SliceBounds, bedges, ptrs,
                        impl: str = "torch", need_final_e: bool = True):
    fused = use_kernels(impl)
    vb0 = sb.v[v_preds[0].vtype]
    vm, vv = _vertex_eval_sliced(gdev, v_preds[0], params, pv[0], mode, bedges, vb0)
    state_v = SS.init_state(vm, vv, mode, n_buckets, bedges)   # on slice of type σ0

    arrivals_e = None
    arrivals_v = None
    prev_raw = None
    prev_eb = None
    cur_vb = vb0
    for i, ep in enumerate(e_preds):
        nxt_vb = sb.v[v_preds[i + 1].vtype]
        cur_eb = sb.e[v_preds[i + 1].vtype]     # edges arriving at next type
        wmask, evalid = _edge_eval_sliced(gdev, ep, params, pe[i], mode,
                                          bedges, cur_eb)
        if i > 0:
            vm, vv = _vertex_eval_sliced(gdev, v_preds[i], params, pv[i], mode,
                                         bedges, cur_vb)
        lo, hi = cur_eb
        vlo, vhi = cur_vb
        src = gdev["t_src_l"][lo:hi]
        src_local = torch.clamp(src - vlo, 0, vhi - vlo - 1)
        src_in = (src >= vlo) & (src < vhi)
        need_e = needs_edge_counts(fused, e_preds, i, need_final_e)
        src_val = sv = None
        if ep.etr_op == -1:
            prev_raw = None  # only an ETR hop reads the previous counts
        arrivals_e = None
        if ep.etr_op != -1:
            src_cnt = _etr_weighted_sliced(gdev, prev_raw, ep.etr_op, backward,
                                           False, prev_eb, cur_eb, cur_vb)
            if mode == MODE_STATIC:
                src_val = src_cnt * (vm[:, src_local] & src_in).to(SS.F32)
            elif mode == MODE_BUCKET:
                mk = (vm[..., None] & vv)
                src_val = src_cnt * (mk[:, src_local] & src_in[:, None]).to(SS.F32)
            else:
                src_val = SS.apply_validity(src_cnt, vm[:, src_local] & src_in,
                                            vv[:, src_local], mode, bedges)
            del src_cnt
        else:
            sv = state_v if i == 0 else SS.apply_validity(arrivals_v, vm, vv,
                                                          mode, bedges)
            if need_e:
                m = src_in.view((1, -1) + (1,) * (sv.dim() - 2))
                src_val = sv[:, src_local] * m.to(sv.dtype)
        cnt_e = (SS.apply_edge(src_val, wmask, evalid, mode, bedges)
                 if need_e else None)
        del src_val
        nvlo, nvhi = nxt_vb
        ptr = ptrs[v_preds[i + 1].vtype]
        if fused and ep.etr_op == -1:
            # fused kernel hop on the arrival-type slice: out-of-slice
            # sources point at the kernel's zero row instead of clip+mask
            src_slot = torch.where(src_in, src - vlo, torch.full_like(src, vhi - vlo))
            arrivals_v, _ = SS.fused_hop_deliver(
                sv, src_slot, wmask, evalid, mode, ptr, nvhi - nvlo, bedges)
        else:
            arrivals_v = SS.deliver(cnt_e, ptr, nvhi - nvlo, impl=impl)
        arrivals_e = cnt_e
        prev_raw = cnt_e
        prev_eb = cur_eb
        cur_vb = nxt_vb
    return _SegResult(arrivals_e if need_final_e else None, arrivals_v,
                      prev_eb or sb.e[v_preds[0].vtype], cur_vb)


def _zero_output(qry, mode, n_buckets, sb, want_agg, nq, device):
    """Static early-out when any hop's type slice is empty (no such
    vertices exist → zero matches, trivially)."""
    shape = (nq, n_buckets) if mode == MODE_BUCKET else (nq,)
    total = torch.zeros(shape, dtype=torch.float32, device=device)
    per_v = None
    if want_agg:
        lo, hi = sb.v[qry.v_preds[0].vtype]
        shape = (nq, hi - lo) if mode == MODE_STATIC else (nq, hi - lo, n_buckets)
        per_v = torch.zeros(shape, dtype=torch.float32, device=device)
    return ExecOutput(total, per_v, None, [])


def execute_plan_sliced(gdev, qry: Q.PathQuery, split: int, mode: int,
                        n_buckets: int, params, bedges, sb: SliceBounds,
                        impl: str = "torch", ptrs=None) -> ExecOutput:
    """Sliced twin of ``engine.execute_plan`` (counts + count-aggregates) for
    a batch of same-shape queries (``params`` int32 [Q, n_clauses, 3]).

    ``ptrs`` maps each arrival type of the plan to its slice's CSR pointer
    (``slice_ptrs``); a caller that runs the plan again passes it to make the
    pointers once.  Without it they are made here, each once a call.  The
    plan writes into none of its arguments."""
    n = qry.n_vertices
    nq = params.shape[0]
    pv, pe = pbases(qry)
    want_agg = qry.agg_op != Q.AGG_NONE
    if any(sb.v[v.vtype][1] <= sb.v[v.vtype][0] for v in qry.v_preds):
        return _zero_output(qry, mode, n_buckets, sb, want_agg, nq, params.device)
    arrivals = arrival_types(qry, split)
    if any(sb.e[vt][1] <= sb.e[vt][0] for vt in arrivals):
        return _zero_output(qry, mode, n_buckets, sb, want_agg, nq, params.device)
    if ptrs is None:
        ptrs = slice_ptrs(gdev, sb, arrivals)
    if want_agg:
        assert qry.agg_op == Q.AGG_COUNT, "sliced path: count aggregates"
        assert split == 0
    etr_at_join = 0 < split < n - 1 and qry.e_preds[split].etr_op != -1
    rev = qry.reversed()

    left = None
    if split > 0:
        left = _run_segment_sliced(gdev, qry.v_preds[: split + 1],
                                   qry.e_preds[:split], params,
                                   pv[: split + 1], pe[:split], mode,
                                   n_buckets, False, sb, bedges, ptrs, impl,
                                   need_final_e=etr_at_join)
    right = None
    m_hops = (n - 1) - split
    if m_hops > 0:
        rpv = [pv[n - 1 - i] for i in range(n)]
        rpe = [pe[n - 2 - j] for j in range(n - 1)]
        right = _run_segment_sliced(gdev, rev.v_preds[: m_hops + 1],
                                    rev.e_preds[:m_hops], params,
                                    rpv[: m_hops + 1], rpe[:m_hops], mode,
                                    n_buckets, True, sb, bedges, ptrs, impl,
                                    need_final_e=etr_at_join)

    vb = sb.v[qry.v_preds[split].vtype]
    vm, vv = _vertex_eval_sliced(gdev, qry.v_preds[split], params, pv[split],
                                 mode, bedges, vb)

    def vapply(av):
        return SS.apply_validity(av, vm, vv, mode, bedges)

    if n == 1:
        st = SS.init_state(vm, vv, mode, n_buckets, bedges)
        per_v = None
        if want_agg:
            per_v = st if mode != MODE_INTERVAL else SS.cells_to_buckets(st)
        return ExecOutput(SS.state_total(st, mode), per_v, None, [])

    if not etr_at_join:
        if left is None:
            Rv = vapply(right.arrivals_v)
            if want_agg:
                total = SS.state_total(Rv, mode)
                # interval cells flatten to per-bucket series, as dense does
                per_v = Rv if mode != MODE_INTERVAL else SS.cells_to_buckets(Rv)
                return ExecOutput(total, per_v, None, [])
            return ExecOutput(SS.state_total(Rv, mode), None, None, [])
        if right is None:
            Lv = vapply(left.arrivals_v)
            return ExecOutput(SS.state_total(Lv, mode), None, None, [])
        return ExecOutput(product_join(vapply(left.arrivals_v), right.arrivals_v,
                                       mode), None, None, [])

    # ETR at join: left/right final arrivals share the split-type edge slice
    op = qry.e_preds[split].etr_op
    eb = sb.e[qry.v_preds[split].vtype]
    W = _etr_weighted_sliced(gdev, left.arrivals_e, op, False, True, eb, eb, vb)
    lo, hi = eb
    dst_local = gdev["t_dst_l"][lo:hi] - vb[0]
    total = etr_join(W, right.arrivals_e, vm[:, dst_local],
                     None if vv is None else vv[:, dst_local], mode, bedges)
    return ExecOutput(total, None, None, [])


def sliceable(qry: Q.PathQuery) -> bool:
    return all(v.vtype >= 0 for v in qry.v_preds) and (
        qry.agg_op in (Q.AGG_NONE, Q.AGG_COUNT))
