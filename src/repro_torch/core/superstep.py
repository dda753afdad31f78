"""Shared superstep core — the hop primitives the executors build on, in torch.

The port of the reference package's ``core/superstep.py``.  Three executors use
it in this package:

  engine.py             dense executor  — whole-graph tensor supersteps
  engine_sliced.py      sliced executor — type-slice extents per hop
  engine_partitioned.py partitioned executor — per-worker shards with a
                        point-to-point boundary exchange

  predicate evaluation   eval_predicate()        — type ∧ folded clauses over
                                                   property columns, returning
                                                   (match, validity) per mode
  edge masking           direction_mask(),
                         edge_predicate_weights() — edge predicate ∧ direction
  state algebra          init_state(), apply_validity(), apply_edge(),
                         state_total(), state_alive(), cells_to_buckets()
  ETR rank application   etr_weighted()          — rank tables + segment prefix
                                                   sums (exact, O(E) per hop)
  delivery               deliver()               — sorted segment-sum of
                                                   per-edge counts by arrival
                         fused_hop_deliver()     — the fused kernel hop
                                                   (gather → temporal mask →
                                                   segment-reduce, never
                                                   materialising [Q, E, *TS])
  extremum channel       minmax_seed(), minmax_edge(), deliver_extremum()
  boundary exchange      exchange_plan(),
                         p2p_exchange()          — ragged all-to-all over the
                                                   partitioner's lane tables
  ETR summaries          etr_local_summaries()   — per-edge rank summaries
                                                   from segment-local prefixes
  joins                  join_interval_counts(), join_interval_counts_edges()

Temporal modes:

  MODE_STATIC    scalar counts per entity
  MODE_BUCKET    counts per time bucket          state [..., B]
  MODE_INTERVAL  counts per running-intersection interval cell
                 (start-bucket, end-bucket)      state [..., B, B+1]

Layout contract: every tensor that depends on the query parameters carries a
leading QUERY axis Q (the reference adds it by ``jax.vmap``; a hand-written
kernel cannot be vmapped, so the axis is explicit here and a grid axis of
every kernel).  Then comes the entity axis (vertices or traversal edges),
then the temporal-state axes.  Query-independent results are ``expand``-ed
views with query stride 0, so they cost no memory.  ``params`` is the
stacked int32 [Q, n_clauses, 3] parameter tensor.  Bucket edges ``bedges``
(int32 [B+1]) are passed explicitly to every function that reads them.

``impl`` is ``'torch'`` (the plain unfused hop, the reference's ``'xla'``)
or ``'cuda'`` (the kernels of ``kernels/hop_scatter``, the reference's
``'pallas'``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from . import intervals as iv
from . import query as Q
from ..kernels import hop_scatter as HK
from ..kernels.common import check_impl, use_kernels

MODE_STATIC = 0
MODE_BUCKET = 1
MODE_INTERVAL = 2

# ETR term kinds (rank-array rows in graph.EtrTables):
#   0: #(acc.start <  cur.start)     1: #(acc.start <= cur.start)
#   2: #(acc.start <  cur.end)       3: #(acc.end   <= cur.start)
# spec: (alpha, ((sign, term), ...)) st. result = alpha * n_acc + Σ sign * P[term]
ETR_SPECS = {
    (iv.FULLY_BEFORE, False): (0.0, ((1.0, 3),)),
    (iv.STARTS_BEFORE, False): (0.0, ((1.0, 0),)),
    (iv.FULLY_AFTER, False): (1.0, ((-1.0, 2),)),
    (iv.STARTS_AFTER, False): (1.0, ((-1.0, 1),)),
    (iv.OVERLAPS, False): (0.0, ((1.0, 2), (-1.0, 3))),
    (iv.FULLY_BEFORE, True): (1.0, ((-1.0, 2),)),
    (iv.STARTS_BEFORE, True): (1.0, ((-1.0, 1),)),
    (iv.FULLY_AFTER, True): (0.0, ((1.0, 3),)),
    (iv.STARTS_AFTER, True): (0.0, ((1.0, 0),)),
    (iv.OVERLAPS, True): (0.0, ((1.0, 2), (-1.0, 3))),
}

F32 = torch.float32


def _per_query(x: torch.Tensor, nq: int) -> torch.Tensor:
    """Give a query-independent [N, ...] result the leading query axis as a
    view with query stride 0 (no copy)."""
    return x[None].expand((nq,) + tuple(x.shape))


def and_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a & b`` for a [Q, N] mask and a query-independent [N] mask that
    keeps a query-independent ``a`` a stride-0 view (so the fused kernels
    read one shared weight row for every query)."""
    if a.shape[0] > 1 and a.stride(0) == 0:
        return _per_query(a[0] & b, a.shape[0])
    return a & b


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot with ``jax.nn.one_hot`` semantics: an index outside
    [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device, dtype=idx.dtype)).to(F32)


# =========================================================================
# clause evaluation
# =========================================================================
def _eval_prop_clause(col, value, cmp: int, mode: int, bedges, ent_life):
    """Evaluate one property clause over an entity set for every query.

    ``value`` is int32 [Q].  Returns (match bool[Q, N], validity) where
    validity is a bucket mask [Q, N, B] (MODE_BUCKET), an interval
    int32[Q, N, 2] (MODE_INTERVAL), or None.
    """
    vals, life = col  # [N,S], [N,S,2]
    nq = value.shape[0]
    slot_eq = vals[None] == value[:, None, None]          # [Q, N, S]
    has_any = torch.any(vals >= 0, dim=1)                  # [N]
    if cmp == Q.P_NEQ:
        match = has_any[None] & ~torch.any(slot_eq, dim=2)
        if mode == MODE_BUCKET:
            return match, _per_query(iv.interval_to_bucket_mask(ent_life, bedges), nq)
        if mode == MODE_INTERVAL:
            return match, _per_query(ent_life, nq)
        return match, None
    # EQ / CONTAINS: any slot equal
    match = torch.any(slot_eq, dim=2)
    if mode == MODE_BUCKET:
        slot_masks = iv.interval_to_bucket_mask(life, bedges)  # [N,S,B]
        valid = torch.any(slot_masks[None] & slot_eq[..., None], dim=2)
        return match, valid
    if mode == MODE_INTERVAL:
        # first matching slot (jnp.argmax over bool): a strictly decreasing
        # score makes the maximum unique, so no tie rule is relied on
        S = vals.shape[1]
        score = slot_eq.to(torch.int32) * torch.arange(
            S, 0, -1, device=vals.device, dtype=torch.int32)
        idx = score.argmax(dim=2)                          # [Q, N]
        lq = life[None].expand(nq, -1, -1, -1)
        sel = torch.gather(lq, 2, idx[:, :, None, None].expand(-1, -1, 1, 2))[:, :, 0]
        valid = torch.where(match[..., None], sel, torch.zeros_like(sel))
        return match, valid
    return match, None


def _eval_time_clause(ent_life, cmp_id: int, interval, mode: int, bedges):
    """``interval`` is int32 [Q, 2]."""
    nq = interval.shape[0]
    match = iv.compare(cmp_id, ent_life[None], interval[:, None, :])
    if mode == MODE_BUCKET:
        return match, _per_query(iv.interval_to_bucket_mask(ent_life, bedges), nq)
    if mode == MODE_INTERVAL:
        return match, _per_query(ent_life, nq)
    return match, None


def _fold_clauses(parts, mode):
    """AND/OR left-fold of (conj, match, validity) triples."""
    acc_m, acc_v = None, None
    for conj, m, v in parts:
        if acc_m is None:
            acc_m, acc_v = m, v
            continue
        if conj == Q.AND:
            acc_m = acc_m & m
            if mode == MODE_BUCKET:
                acc_v = acc_v & v
            elif mode == MODE_INTERVAL:
                acc_v = iv.intersect(acc_v, v)
        else:  # OR
            new_m = acc_m | m
            if mode == MODE_BUCKET:
                acc_v = (acc_v & acc_m[..., None]) | (v & m[..., None])
            elif mode == MODE_INTERVAL:
                # span approximation for OR in interval mode (documented)
                acc_v = torch.where(
                    (acc_m & ~m)[..., None], acc_v,
                    torch.where((m & ~acc_m)[..., None], v, iv.span(acc_v, v)),
                )
            acc_m = new_m
    return acc_m, acc_v


def eval_predicate(
    props: Dict[int, tuple],
    ent_type,
    ent_life,
    req_type: int,
    clauses: Sequence[Q.Clause],
    params,
    pbase: int,
    mode: int,
    bedges,
):
    """Full predicate = type check ∧ folded clauses; returns (match
    bool[Q, N], validity [Q, N, B] | int32[Q, N, 2] | None).

    ``params`` carries the data values: row i of ``params[q]`` = (value,
    t_lo, t_hi) for the i-th clause of the whole query; ``pbase`` is this
    predicate's first row.
    """
    nq = params.shape[0]
    n = ent_life.shape[0]
    match = torch.ones((n,), dtype=torch.bool, device=ent_life.device)
    if req_type >= 0:
        match = ent_type == req_type
    match = match & (ent_life[:, 0] < ent_life[:, 1])
    if mode == MODE_BUCKET:
        validity = iv.interval_to_bucket_mask(ent_life, bedges)
    elif mode == MODE_INTERVAL:
        validity = ent_life
    else:
        validity = None
    parts = []
    for i, c in enumerate(clauses):
        row = params[:, pbase + i]                         # [Q, 3]
        if c.kind == Q.K_PROP:
            m, v = _eval_prop_clause(props[c.key], row[:, 0], c.cmp, mode, bedges,
                                     ent_life)
        else:
            m, v = _eval_time_clause(ent_life, c.cmp, row[:, 1:3], mode, bedges)
        parts.append((c.conj, m, v))
    if parts:
        cm, cv = _fold_clauses(parts, mode)
        match = match & cm
        if mode == MODE_BUCKET:
            validity = validity & cv
        elif mode == MODE_INTERVAL:
            validity = iv.intersect(validity, cv)
        return match, validity
    return _per_query(match, nq), (None if validity is None else
                                   _per_query(validity, nq))


# =========================================================================
# edge masking
# =========================================================================
def direction_mask(t_isfwd, direction: int):
    """bool mask selecting traversal edges compatible with a hop direction."""
    if direction == Q.DIR_OUT:
        return t_isfwd == 1
    if direction == Q.DIR_IN:
        return t_isfwd == 0
    return torch.ones_like(t_isfwd, dtype=torch.bool)


def edge_predicate_weights(gdev, ep: Q.EdgePredicate, params, pbase, mode, bedges):
    """(weight mask bool[Q, 2E], bucket/interval validity) for one hop."""
    match, validity = eval_predicate(
        gdev["eprops_t"], gdev["t_type"], gdev["t_life"], ep.etype, ep.clauses,
        params, pbase, mode, bedges,
    )
    return and_rows(match, direction_mask(gdev["t_isfwd"], ep.direction)), validity


# =========================================================================
# mode-generic state ops
# =========================================================================
def init_state(match, validity, mode: int, n_buckets: int, bedges):
    """Seed DP state [Q, N, *TS] from a vertex predicate result."""
    if mode == MODE_STATIC:
        return match.to(F32)
    if mode == MODE_BUCKET:
        return (match[..., None] & validity).to(F32)
    # INTERVAL: one-hot cell at (start_bucket, end_bucket); cells [B, B+1]
    B = n_buckets
    sb, eb = interval_to_cells(validity, B, bedges)
    cell = _one_hot(sb, B)[..., :, None] * _one_hot(eb, B + 1)[..., None, :]
    return cell * match[..., None, None].to(F32)


def interval_to_cells(ivl, B: int, bedges):
    """Map int32[..., 2] intervals to int32 (start_bucket, end_bucket) ids."""
    s = ivl[..., 0].contiguous()
    e = ivl[..., 1].contiguous()
    sb = torch.clamp(torch.searchsorted(bedges, s, right=True, out_int32=True) - 1, 0, B - 1)
    eb = torch.clamp(torch.searchsorted(bedges, e, right=False, out_int32=True), 0, B)
    eb = torch.where(s >= e, sb, eb)  # empty → zero-width cell (filtered later)
    return sb, eb


def apply_validity(state, match, validity, mode: int, bedges):
    """Multiply state [Q, N, *TS] by a predicate's (match, validity)."""
    if mode == MODE_STATIC:
        return state * match.to(F32)
    if mode == MODE_BUCKET:
        return state * (match[..., None] & validity).to(F32)
    # INTERVAL: clamp running-intersection cells by the validity interval
    B = state.shape[-2]
    sb, eb = interval_to_cells(validity, B, bedges)
    out = _clamp_end(_clamp_start(state, sb), eb)
    out.mul_(match[..., None, None].to(F32))
    return out.mul_(_valid_cells(B, state.device))


def apply_edge(src_val, wmask, evalidity, mode: int, bedges):
    """Apply a hop's edge weights to gathered source values (per-edge)."""
    if mode == MODE_STATIC:
        return src_val * wmask.to(F32)
    if mode == MODE_BUCKET:
        return src_val * (wmask[..., None] & evalidity).to(F32)
    return apply_validity(src_val, wmask, evalidity, mode, bedges)


def _clamp_start(state, ps):
    """cells[q, n, s, e] move to (max(s, ps[q, n]), e): the rows s <= ps sum
    onto row ps.  (A masked sum where the reference gathers from a cumsum:
    the same integers, with one full-size temporary fewer.)"""
    s_ids = torch.arange(state.shape[-2], device=state.device)
    below = (s_ids <= ps[..., None]).to(state.dtype)
    acc = (state * below[..., :, None]).sum(dim=-2)               # [.., B+1]
    out = state * (s_ids > ps[..., None]).to(state.dtype)[..., :, None]
    return out.addcmul_(_one_hot(ps, state.shape[-2])[..., :, None], acc[..., None, :])


def _clamp_end(state, pe):
    """cells[q, n, s, e] move to (s, min(e, pe[q, n])): the columns e >= pe
    sum onto column pe."""
    e_ids = torch.arange(state.shape[-1], device=state.device)
    above = (e_ids >= pe[..., None]).to(state.dtype)
    acc = (state * above[..., None, :]).sum(dim=-1)               # [.., B]
    out = state * (e_ids < pe[..., None]).to(state.dtype)[..., None, :]
    return out.addcmul_(_one_hot(pe, state.shape[-1])[..., None, :], acc[..., :, None])


def _valid_cells(B: int, device) -> torch.Tensor:
    s_ids = torch.arange(B, device=device)[:, None]
    e_ids = torch.arange(B + 1, device=device)[None, :]
    return (s_ids < e_ids).to(F32)


def _mask_valid_cells(state):
    return state * _valid_cells(state.shape[-2], state.device)


def state_total(state, mode):
    """Per-query totals: [Q] (static/interval) or [Q, B] (bucket)."""
    if mode == MODE_STATIC:
        return torch.sum(state, dim=1)
    if mode == MODE_BUCKET:
        return torch.sum(state, dim=1)  # per-bucket totals
    return torch.sum(_mask_valid_cells(state), dim=(1, 2, 3))


def state_alive(state, mode):
    """bool[Q, N]: entities whose count state is non-zero anywhere (static
    scalar, any bucket, or any interval cell) — the liveness gate of the
    extremum channel."""
    if mode == MODE_STATIC:
        return state > 0
    return state.sum(dim=tuple(range(2, state.dim()))) > 0


def cells_to_buckets(state):
    """[Q, N, B, B+1] running-interval cells → [Q, N, B] per-bucket series."""
    B = state.shape[-2]
    s_ids = torch.arange(B, device=state.device)[:, None]
    e_ids = torch.arange(B + 1, device=state.device)[None, :]
    out = []
    for b in range(B):
        m = ((s_ids <= b) & (e_ids > b)).to(state.dtype)
        out.append(torch.sum(state * m, dim=(-2, -1)))
    return torch.stack(out, dim=-1)


# =========================================================================
# point-to-point boundary exchange (the partitioned executor's collective)
# =========================================================================
def exchange_plan(local_src, send_slot, recv_slot, n_rows: int, n_slots: int,
                  distributed: bool = False, out_pos=None,
                  n_out: Optional[int] = None) -> dict:
    """The index arithmetic of one exchange channel, computed once per table
    set (``p2p_exchange``'s arguments; ``n_rows`` = K, the owner-local rows
    a worker sends from).  Only real entries are listed: a pad is never
    read or written.

    In one process (``distributed`` false) every lane's send and receive
    ends are composed, so the whole exchange is one gather from the owners'
    rows and one placement: the k-th row worker s sends to d
    (``send_slot[s, d, k]``) lands at ``recv_slot[d, s, k]``, which is the
    transpose of the two worker axes.  Distributed, the send side fills the
    padded [Wl, W, C] payload and the receive side places from the
    [Wl_dst, W_src, C] one an all-to-all delivered.

    ``out_pos`` (int [Wl·n_slots]) sends receive position d·n_slots + n to
    row ``out_pos[...]`` of a flat output of ``n_out`` rows instead (the
    partitioned executor places ETR summaries straight at its real owned
    edges)."""
    Wl, W, C = send_slot.shape
    dev = send_slot.device
    K, N = n_rows, n_slots
    d, n = torch.nonzero(local_src < K, as_tuple=True)
    plan = dict(local_dst=d * N + n, local_src=d * K + local_src[d, n].long())
    dd, ss, kk = torch.nonzero(recv_slot < N, as_tuple=True)
    recv_dst = dd * N + recv_slot[dd, ss, kk].long()
    if not distributed:
        src = ss * K + send_slot[ss, dd, kk].long()
        plan.update(dst=torch.cat([plan.pop("local_dst"), recv_dst]),
                    src=torch.cat([plan.pop("local_src"), src]))
    else:
        i, j, k = torch.nonzero(send_slot < K, as_tuple=True)
        plan.update(send_pos=(i * W + j) * C + k,
                    send_src=i * K + send_slot[i, j, k].long(),
                    recv_dst=recv_dst, recv_pos=(dd * W + ss) * C + kk)
    if out_pos is None:
        n_out = Wl * N
    else:
        out_pos = out_pos.to(dev).long()
        for key in ("dst", "local_dst", "recv_dst"):
            if key in plan:
                plan[key] = out_pos[plan[key]]
    plan.update(n_out=n_out, out_pos=out_pos is not None, W=W, C=C)
    return plan


def p2p_exchange(rows_w, local_src, send_slot, recv_slot, n_slots: int,
                 group=None, fill: float = 0.0, plan=None):
    """Ragged all-to-all over the worker axis — the boundary exchange.

    Every receive-buffer entry (a halo vertex's state, or an owned edge's
    ETR rank summary) lives with exactly ONE owner.  The partitioner's
    routing tables split them into a local copy (entries the receiver owns
    itself) and one ragged lane per worker pair carrying just the ghost
    entries — so only ghost entries move, with no global [V]/[2E] buffer and
    no reduction (ownership is exclusive: the exchange is a copy).

      rows_w     [Q, Wl, K, *TS]  owner-local source rows of this process's
                                  workers (Wl = W in the simulation)
      local_src  int [Wl, N]      own-row slot per self-owned receive entry,
                                  pad = K (the entry keeps ``fill``)
      send_slot  int [Wl, W, C]   own-row slot of the k-th row local worker i
                                  sends to GLOBAL worker d, pad = K
      recv_slot  int [Wl, W, C]   receive-buffer position where the k-th row
                                  from GLOBAL worker s lands, pad = N
      n_slots    N                receive-buffer extent

    Returns [Q, Wl, N, *TS] (or [Q, n_out, *TS] under a ``plan`` made with
    ``out_pos``); entries nobody sends hold ``fill``.  With ``group`` unset
    every worker is in this process and the exchange is one gather and one
    placement over the composed lanes (``exchange_plan``).  With a
    ``torch.distributed`` group of R ranks, each holding W / R consecutive
    workers, the padded payload [Wl, W, C, *TS] moves with one
    ``all_to_all_single``.  Both are pure data movement over identical
    tables, so they agree bit for bit.  Placement is ``index_copy_`` on
    unique positions (each entry has one owner), so it is deterministic.
    ``plan`` is ``exchange_plan`` of the same tables, precomputed.
    """
    nq, Wl, K = rows_w.shape[:3]
    ts = tuple(rows_w.shape[3:])
    if plan is None:
        plan = exchange_plan(local_src, send_slot, recv_slot, K, n_slots,
                             distributed=group is not None)
    rows = rows_w.reshape((nq, Wl * K) + ts)
    out = torch.full((nq, plan["n_out"]) + ts, fill, dtype=rows_w.dtype,
                     device=rows_w.device)
    if group is None:
        out.index_copy_(1, plan["dst"], rows.index_select(1, plan["src"]))
    else:
        import torch.distributed as dist

        W, C = plan["W"], plan["C"]
        R = dist.get_world_size(group)
        out.index_copy_(1, plan["local_dst"], rows.index_select(1, plan["local_src"]))
        payload = torch.full((nq, Wl * W * C) + ts, fill, dtype=rows_w.dtype,
                             device=rows_w.device)
        payload.index_copy_(1, plan["send_pos"], rows.index_select(1, plan["send_src"]))
        # [Q, Wl_src, R, Wl_dst, C] -> [R_dst, Q, Wl_src, Wl_dst, C]
        q = payload.reshape((nq, Wl, R, Wl, C) + ts).movedim(2, 0).contiguous()
        del payload
        got = torch.empty_like(q)
        dist.all_to_all_single(got, q, group=group)
        del q
        # [R_src, Q, Wl_src, Wl_dst, C] -> [Q, Wl_dst, W_src, C]
        recv = got.permute((1, 3, 0, 2, 4) + tuple(range(5, 5 + len(ts))))
        recv = recv.reshape((nq, Wl * W * C) + ts)
        del got
        out.index_copy_(1, plan["recv_dst"], recv.index_select(1, plan["recv_pos"]))
    if plan["out_pos"]:
        return out
    return out.reshape((nq, Wl, n_slots) + ts)


# =========================================================================
# delivery
# =========================================================================
def deliver(cnt_e, ptr, num_segments: int, impl: str = "torch"):
    """Sorted segment-sum of per-edge counts [Q, E, *TS] by arrival vertex —
    the message delivery of one superstep.  ``ptr`` (int [num_segments + 1])
    is the arrival CSR pointer of the edges.

    ``'torch'`` is the segment-sum scatter over the edges' arrival ids;
    ``'cuda'`` runs the scatter kernel over ``ptr`` — identical sums while
    counts are exact integers in float32, the engine's invariant."""
    if not use_kernels(check_impl(impl)):
        seg_ids = HK.segment_ids(ptr, cnt_e.shape[1])
        out = cnt_e.new_zeros((cnt_e.shape[0], num_segments) + tuple(cnt_e.shape[2:]))
        return out.index_add_(1, seg_ids, cnt_e)
    return HK.scatter_cols(cnt_e.contiguous(), ptr)


def _shared_over_queries(*xs) -> bool:
    """True when every tensor given is one row broadcast over the query axis."""
    return all(x is None or x.shape[0] == 1 or x.stride(0) == 0 for x in xs)


def fused_hop_deliver(
    state,                       # [Q, N, *TS] source-state table
    src_slot,                    # int32[E] — source row per edge; N = zero row
    wmask,                       # bool[Q, E] edge-predicate ∧ direction match
    evalid,                      # temporal validity: None / bool[Q, E, B] /
                                 # int32[Q, E, 2] interval (per mode)
    mode: int,
    ptr,                         # int32[num_segments + 1] arrival CSR pointer
    num_segments: int,
    bedges,
    mch=None,                    # optional extremum channel table [Q, N]
    minmax_op: int = Q.AGG_MIN,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One fused traversal hop: gather → temporal mask → segment-reduce.

    The kernel twin of the three-step plain hop (``state[:, src]`` gather,
    ``apply_edge``, ``deliver``) that never materialises the per-edge
    ``[Q, E, *TS]`` state.  When ``mch`` is given, the MIN/MAX extremum
    channel is gathered, liveness-gated by the contributions and min/max
    reduced alongside (the ``minmax_edge`` + ``deliver_extremum`` pair).

    Edge weights that do not depend on the query are computed once and
    broadcast over the query axis (the kernels read them with query stride 0).

    Returns (arrivals [Q, num_segments, *TS], mch_out [Q, num_segments] | None).
    """
    nq = state.shape[0]
    shared = _shared_over_queries(wmask, evalid)
    if shared:  # compute the weights on one row, broadcast to every query
        wmask = wmask[:1]
        evalid = None if evalid is None else evalid[:1]
    op_is_min = minmax_op == Q.AGG_MIN
    neutral = float("inf") if op_is_min else float("-inf")
    src_slot = src_slot.to(torch.int32).contiguous()
    state = state.contiguous()
    if mch is not None:
        mch = mch.to(F32).contiguous()
    if mode == MODE_INTERVAL:
        B = state.shape[-2]
        sb, eb = interval_to_cells(evalid, B, bedges)
        w = wmask.to(F32)
        if shared:
            w, sb, eb = (x.expand(nq, -1) for x in (w, sb, eb))
        arrivals, mch_out = HK.fused_hop_interval(
            state, src_slot, w, sb, eb, ptr, mch=mch, neutral=neutral,
            op_is_min=op_is_min)
    else:
        N = state.shape[1]
        ts = tuple(state.shape[2:])
        C = 1 if mode == MODE_STATIC else state.shape[2]
        if mode == MODE_STATIC:
            w = wmask.to(F32)[..., None]
        else:
            w = (wmask[..., None] & evalid).to(F32)
        if shared:
            w = w.expand(nq, -1, -1)
        out, mch_out = HK.fused_hop_cols(
            state.reshape(nq, N, C), src_slot, w, ptr, mch=mch, neutral=neutral,
            op_is_min=op_is_min)
        arrivals = out.reshape((nq, num_segments) + ts)
    return arrivals, mch_out


# =========================================================================
# extremum (MIN/MAX aggregate) channel
# =========================================================================
def minmax_neutral(op: int) -> float:
    """The aggregation-neutral element of the extremum channel."""
    return float("inf") if op == Q.AGG_MIN else float("-inf")


def minmax_seed(state, col_vals, op: int, mode: int):
    """Seed the per-entity extremum channel [Q, N] from the aggregate's
    property column: the first-slot value where the count state is alive,
    neutral elsewhere."""
    base = col_vals[:, 0].to(F32)
    neutral = torch.full_like(base, minmax_neutral(op))
    return torch.where(state_alive(state, mode), base, neutral)


def minmax_edge(mch_src, cnt_e, op: int, mode: int):
    """Per-edge extremum message: the source channel where the edge carries
    any live count, neutral elsewhere (so dead/pad edges cannot win)."""
    return torch.where(state_alive(cnt_e, mode), mch_src,
                       torch.full_like(mch_src, minmax_neutral(op)))


def deliver_extremum(m_e, ptr, num_segments: int, op: int, impl: str = "torch"):
    """Extremum twin of ``deliver``: sorted segment min/max of the per-edge
    channel [Q, E] by arrival vertex; empty segments hold the neutral."""
    neutral = minmax_neutral(op)
    if not use_kernels(check_impl(impl)):
        seg_ids = HK.segment_ids(ptr, m_e.shape[1])
        out = torch.full((m_e.shape[0], num_segments), neutral, dtype=F32,
                         device=m_e.device)
        return out.scatter_reduce_(1, seg_ids.expand(m_e.shape[0], -1), m_e,
                                   "amin" if op == Q.AGG_MIN else "amax",
                                   include_self=True)
    # m_e is already liveness-gated by minmax_edge, so every edge is "alive"
    m_e = m_e.contiguous()
    return HK.scatter_extremum(m_e, torch.ones_like(m_e), ptr, neutral,
                               op == Q.AGG_MIN)


# =========================================================================
# ETR prefix machinery
# =========================================================================
def prefix_table(cnt, perm):
    """Exclusive prefix sums [Q, K+1, *TS] of ``cnt[:, perm]`` along edges.

    The scan runs over the innermost axis of a [Q, C, K] copy: PyTorch's
    CUDA scan along an outer axis gives one thread per (query, column) and
    walks all K edges serially, which made the bucket and interval ETR hops
    take seconds on an H100 (PERF.md)."""
    nq, K = cnt.shape[0], perm.shape[0]
    ts = tuple(cnt.shape[2:])
    cols = cnt.index_select(1, perm).reshape(nq, K, -1).transpose(1, 2).contiguous()
    S = cnt.new_empty((nq, cols.shape[1], K + 1))
    S[:, :, 0] = 0
    S[:, :, 1:] = torch.cumsum(cols, dim=2)
    del cols
    return S.transpose(1, 2).contiguous().reshape((nq, K + 1) + ts)


def etr_weighted(gdev, cnt_e_prev, op: int, backward: bool, use_arr: bool):
    """Per current traversal edge: Σ over accumulated arrivals at its vertex
    of cnt × [ETR condition], via rank tables (exact).  [Q, 2E, *TS]."""
    alpha, terms = ETR_SPECS[(op, backward)]
    ranks = gdev["etr_arr_ranks"] if use_arr else gdev["etr_dep_ranks"]
    ptr = gdev["arr_ptr"].long()
    segv = (gdev["t_dst"] if use_arr else gdev["t_src"]).long()

    S_s = prefix_table(cnt_e_prev, gdev["etr_perm_start"].long())
    S_e = (prefix_table(cnt_e_prev, gdev["etr_perm_end"].long())
           if etr_needs_end(op, backward) else None)
    base_pos = ptr[segv]
    base_s = S_s.index_select(1, base_pos)
    out = None
    if alpha:
        out = (S_s.index_select(1, ptr[segv + 1]) - base_s) * alpha
    for sign, term in terms:
        S = S_e if term == 3 else S_s
        base = S_e.index_select(1, base_pos) if term == 3 else base_s
        val = (S.index_select(1, base_pos + ranks[term].long()) - base) * sign
        out = val if out is None else out + val
    return out


def etr_needs_end(op: int, backward: bool) -> bool:
    """Does this ETR spec read the (dst, life-end)-ordered prefix table?"""
    _, terms = ETR_SPECS[(op, backward)]
    return any(t == 3 for _, t in terms)


def etr_local_summaries(cnt_perm_s, cnt_perm_e, base, seg_len, ranks,
                        op: int, backward: bool):
    """Per-edge ETR rank summaries from SEGMENT-LOCAL prefix tables.

    The contraction of ``etr_weighted`` only ever takes prefix DIFFERENCES
    inside one arrival segment, so a worker owning whole segments can compute
    it from prefix sums over just its own prev-hop counts: this is that
    local step, and its outputs are exactly the per-edge values the
    partitioned executor exchanges (boundary rank summaries) on ETR hops.

      cnt_perm_s  [Q, Wl, K, *TS] owned prev-hop counts in (dst, life-start)
                                  order, per worker
      cnt_perm_e  [Q, Wl, K, *TS] same in (dst, life-end) order; None when
                                  ``not etr_needs_end(op, backward)``
      base        int [Wl, S]     local prefix index of each produced edge's
                                  source-segment base (0 <= base <= K)
      seg_len     int [Wl, S]     that segment's length (base + len <= K)
      ranks       int [Wl, 4, S]  the global rank tables at the produced
                                  edges (within-segment offsets)

    Returns [Q, Wl, S, *TS]; pad rows (base = len = ranks = 0) give 0.  The
    prefix scans run over the innermost axis of a [Q, Wl, C, K] copy (the
    reason is ``prefix_table``'s)."""
    alpha, terms = ETR_SPECS[(op, backward)]
    nq, Wl, K = cnt_perm_s.shape[:3]
    ts = tuple(cnt_perm_s.shape[3:])
    S = base.shape[1]

    def table(c):
        cols = c.reshape(nq, Wl, K, -1).transpose(2, 3).contiguous()
        P = cols.new_empty(cols.shape[:3] + (K + 1,))
        P[..., 0] = 0
        P[..., 1:] = torch.cumsum(cols, dim=3)
        return P                                    # [Q, Wl, C, K + 1]

    S_s = table(cnt_perm_s)
    del cnt_perm_s
    S_e = table(cnt_perm_e) if cnt_perm_e is not None else None
    del cnt_perm_e
    Cn = S_s.shape[2]

    def at(P, idx):
        return P.gather(3, idx.long()[None, :, None, :].expand(nq, Wl, Cn, S))

    base_s = at(S_s, base)
    out = None
    if alpha:
        out = (at(S_s, base + seg_len) - base_s) * alpha
    for sign, term in terms:
        P = S_e if term == 3 else S_s
        b0 = at(S_e, base) if term == 3 else base_s
        val = (at(P, base + ranks[:, term]) - b0) * sign
        out = val if out is None else out + val
    return out.transpose(2, 3).contiguous().reshape((nq, Wl, S) + ts)


# =========================================================================
# joins
# =========================================================================
def join_interval_counts(L, R):
    """Distinct-path count from left/right running-intersection cell states.

    D = Σ_{cells} L·R·[intervals overlap] per entity, via the complement
    (total − disjoint) with cumsum contractions — O(B²) per entity.
    L, R: [Q, N, B, B+1] → [Q, N].
    """
    totL = L.sum(dim=(2, 3))
    totR = R.sum(dim=(2, 3))
    Le = L.sum(dim=2)       # [Q, N, B+1] marginal over start
    Ls = L.sum(dim=3)       # [Q, N, B]   marginal over end
    Re = R.sum(dim=2)
    Rs = R.sum(dim=3)
    B = Rs.shape[-1]
    # pairs with L.end <= R.start  (cells: e1 <= s2)
    d1 = (Rs * torch.cumsum(Le, dim=2)[..., :B]).sum(dim=-1)
    # pairs with R.end <= L.start
    d2 = (Ls * torch.cumsum(Re, dim=2)[..., :B]).sum(dim=-1)
    return totL * totR - d1 - d2


# identical contraction at traversal-edge granularity (ETR-at-join)
join_interval_counts_edges = join_interval_counts
