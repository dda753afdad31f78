"""Two-level graph partitioning (paper Sec. 4.4.1).

Level 1: group vertices by *type* (the loader already makes ids type-major).
Level 2: split each typed group into ``p`` topological sub-partitions.  The
paper uses METIS on the same-type subgraph with edge-lifespan weights; METIS
is unavailable offline, so we use a greedy BFS block-growing partitioner with
the same objective (balanced sizes, low weighted edge-cut) and report the cut
quality so the approximation is measurable.

Placement: sub-partitions are assigned round-robin over workers, so each
worker holds ~t·p/w sub-partitions with ~p/w per type — the paper's load
balancing argument for typed supersteps.

Execution arrays: ``build_partition_arrays`` lowers a ``Partitioning`` into
the padded per-worker tensors the partitioned executor
(``core.engine_partitioned``) runs on — each worker owns the traversal edges
*arriving* at its vertices (so delivery is a purely local segment-sum) plus a
halo table of the source vertices it must receive boundary state for each
superstep (the exchange).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List

import numpy as np

from ..core.graph import TemporalGraph


@dataclasses.dataclass
class Partitioning:
    part_of: np.ndarray        # int32[V] — global sub-partition id
    worker_of_part: np.ndarray # int32[n_parts]
    n_parts: int
    n_workers: int
    stats: Dict

    def worker_of(self, vid: int) -> int:
        return int(self.worker_of_part[self.part_of[vid]])


def _greedy_bfs_blocks(n: int, adj_ptr, adj_idx, weights, p: int) -> np.ndarray:
    """Split [0, n) into p balanced blocks by BFS growth; returns block ids."""
    target = max(1, -(-n // p))
    block = np.full(n, -1, np.int32)
    order = np.argsort(-np.diff(adj_ptr))  # seed from high degree
    cur = 0
    filled = 0
    q: deque = deque()
    for seed in order:
        if block[seed] != -1:
            continue
        q.append(seed)
        while q:
            v = q.popleft()
            if block[v] != -1:
                continue
            block[v] = cur
            filled += 1
            if filled >= target:
                cur = min(cur + 1, p - 1)
                filled = 0
                q.clear()
                break
            for e in range(adj_ptr[v], adj_ptr[v + 1]):
                u = adj_idx[e]
                if block[u] == -1:
                    q.append(u)
    block[block == -1] = cur
    return block


def partition_graph(
    graph: TemporalGraph,
    n_workers: int = 8,
    parts_per_type: int = 4,
    hash_baseline: bool = False,
) -> Partitioning:
    V = graph.n_vertices
    part_of = np.zeros(V, np.int32)
    if hash_baseline:
        # Giraph's default: hash partitioning by vertex id.
        n_parts = n_workers * parts_per_type
        part_of = (np.arange(V, dtype=np.int64) * 2654435761 % n_parts).astype(np.int32)
        worker = (np.arange(n_parts) % n_workers).astype(np.int32)
        cut = _edge_cut(graph, part_of)
        return Partitioning(part_of, worker, n_parts, n_workers,
                            dict(kind="hash", edge_cut=cut))

    # same-type subgraph adjacency with lifespan-length edge weights
    next_part = 0
    for t in range(graph.n_vertex_types):
        lo, hi = graph.type_ranges[t]
        n = hi - lo
        if n == 0:
            continue
        sel = (
            (graph.e_src >= lo) & (graph.e_src < hi)
            & (graph.e_dst >= lo) & (graph.e_dst < hi)
        )
        src = graph.e_src[sel] - lo
        dst = graph.e_dst[sel] - lo
        w = (graph.e_life[sel, 1] - graph.e_life[sel, 0]).astype(np.float64)
        # symmetric CSR
        s2 = np.concatenate([src, dst])
        d2 = np.concatenate([dst, src])
        order = np.argsort(s2, kind="stable")
        adj_idx = d2[order].astype(np.int64)
        adj_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(s2, minlength=n), out=adj_ptr[1:])
        blocks = _greedy_bfs_blocks(n, adj_ptr, adj_idx,
                                    np.concatenate([w, w])[order], parts_per_type)
        part_of[lo:hi] = blocks + next_part
        next_part += parts_per_type

    n_parts = next_part if next_part else 1
    worker = (np.arange(n_parts) % n_workers).astype(np.int32)
    cut = _edge_cut(graph, part_of)
    sizes = np.bincount(part_of, minlength=n_parts)
    return Partitioning(
        part_of, worker, n_parts, n_workers,
        dict(kind="type+topo", edge_cut=cut,
             size_imbalance=float(sizes.max() / max(sizes.mean(), 1)),
             parts_per_type=parts_per_type),
    )


def extend_partitioning(base: Partitioning, graph: TemporalGraph,
                        remap: np.ndarray):
    """Carry a partitioning forward over an ingestion epoch (the partitioner
    delta table of graphdata/ingest.py).

    ``remap[i]`` is base vertex i's gid in ``graph``; carried vertices keep
    their sub-partition, and each NEW vertex joins a same-type part by
    majority vote over its already-assigned neighbours (ties → lowest part
    id; isolated vertices → the least-loaded part of the type).  Worker
    placement is untouched, so the epoch's partition tables stay aligned
    with the base's and only the delta is re-placed — O(new + incident
    edges) instead of the full BFS growth.  Any assignment yields
    bit-identical results on the partitioned executor (ownership only
    routes delivery); the vote just keeps the edge cut from degrading.

    Returns None when a new vertex's type has no existing part (a type
    introduced mid-stream) — the caller falls back to a fresh
    ``partition_graph``."""
    V = graph.n_vertices
    part_of = np.full(V, -1, np.int32)
    part_of[remap] = base.part_of
    n_parts = base.n_parts
    assigned = part_of >= 0
    part_type = np.full(n_parts, -1, np.int32)
    part_type[part_of[assigned]] = graph.v_type[assigned]
    sizes = np.bincount(part_of[assigned], minlength=n_parts).astype(np.int64)
    new = np.nonzero(~assigned)[0]
    cands = {t: np.nonzero(part_type == t)[0]
             for t in range(graph.n_vertex_types)}
    # adjacency restricted to edges touching an unassigned vertex
    nbrs: Dict[int, list] = {}
    touch = ~assigned[graph.e_src] | ~assigned[graph.e_dst]
    for s, d in zip(graph.e_src[touch], graph.e_dst[touch]):
        nbrs.setdefault(int(s), []).append(int(d))
        nbrs.setdefault(int(d), []).append(int(s))
    for v in new:
        c = cands[int(graph.v_type[v])]
        if len(c) == 0:
            return None
        cset = set(int(x) for x in c)
        votes: Dict[int, int] = {}
        for u in nbrs.get(int(v), ()):
            pu = int(part_of[u])
            if pu >= 0 and pu in cset:
                votes[pu] = votes.get(pu, 0) + 1
        if votes:
            best = min(votes, key=lambda pk: (-votes[pk], pk))
        else:
            best = int(c[np.argmin(sizes[c])])
        part_of[v] = best
        sizes[best] += 1
    stats = dict(base.stats)
    stats.update(kind=str(stats.get("kind", "?")) + "+extend",
                 edge_cut=_edge_cut(graph, part_of),
                 extended=int(len(new)))
    return Partitioning(part_of, base.worker_of_part, n_parts,
                        base.n_workers, stats)


def _edge_cut(graph: TemporalGraph, part_of: np.ndarray) -> float:
    if graph.n_edges == 0:
        return 0.0
    crossing = part_of[graph.e_src] != part_of[graph.e_dst]
    w = (graph.e_life[:, 1] - graph.e_life[:, 0]).astype(np.float64)
    return float((w * crossing).sum() / max(w.sum(), 1e-9))


@dataclasses.dataclass
class PartitionArrays:
    """Padded per-worker execution tables for the partitioned executor.

    Shapes: W = n_workers, Vmax/Emax/Hmax/Smax = padded per-worker extents.
    Padding sentinels: vertex ids pad with V, traversal-edge ids with 2E —
    both index a synthetic zero row on device — ``dst_local`` pads with Vmax
    (a trash delivery segment that is sliced off) and ``src_halo`` pads with
    Hmax (a synthetic zero slot appended to each worker's halo slice, so pad
    edges can never alias a real halo vertex).

    Ownership invariants (asserted by ``build_partition_arrays``):
      * every vertex appears in exactly one worker's ``own_ids`` row;
      * every traversal edge appears in exactly one worker's ``edge_ids`` row
        (the worker owning its arrival vertex), preserving canonical
        arrival-sorted order so per-worker segment-sum delivery reproduces
        the dense engine's summation order bit-for-bit.

    ETR exchange tables: an ETR hop needs, per current edge e, prefix sums
    over the arrival segment of its *source* vertex.  Those segment edges are
    owned by worker(t_src[e]) — the tables below let that owner compute the
    per-edge rank summary from purely local prefix tables (its owned prev-hop
    counts reordered by the global (dst, lifespan-stat) permutations restrict
    to per-worker permutations because every arrival segment lives whole on
    one worker).  Only summaries for edges consumed by ANOTHER worker
    (``n_src_ghost``) cross partitions — O(cut edges), not O(frontier).

    Point-to-point routing tables: the executor's exchange is a ragged
    all-to-all (``superstep.p2p_exchange``) — each worker pair (s, d) has a
    lane carrying exactly the entries d needs that s owns, so only ghost
    entries move (no global [V]/[2E] scatter+psum buffer).  Two channels
    share one table layout:

      vertex-state channel (plain-hop state; the MIN/MAX extremum channel
      rides the same tables with a ±inf fill):
        halo_own_slot[d, h]     local own-slot of halo entry h when d owns it
                                itself (local copy, no traffic), pad = Vmax
        xchg_send_slot[s, d, k] own-slot of the k-th state row s sends to d,
                                pad = Vmax; diagonal lanes are empty
        xchg_recv_slot[d, s, k] halo slot where that row lands at d, pad = Hmax

      ETR rank-summary channel:
        etr_local_slot[d, j]    producer-row slot of owned edge j's summary
                                when d produced it itself, pad = Smax
        etr_send_slot[s, d, k]  producer-row slot of the k-th summary s sends
                                to d, pad = Smax
        etr_recv_slot[d, s, k]  owned-edge slot where it lands at d, pad = Emax

    Lanes are padded to the max per-pair ghost count (``c_max`` /
    ``etr_c_max``); the REAL traffic — what ``exchange_volume()`` /
    ``etr_exchange_volume()`` report and θ_net is fitted on — is the ragged
    content: Σ n_ghost and Σ n_src_ghost entries per superstep.
    """

    n_workers: int
    own_ids: np.ndarray    # int32[W, Vmax] — owned global vertex ids, pad = V
    edge_ids: np.ndarray   # int32[W, Emax] — owned traversal-edge ids, pad = 2E
    dst_local: np.ndarray  # int32[W, Emax] — arrival slot in own_ids, pad = Vmax
    halo_ids: np.ndarray   # int32[W, Hmax] — source vertices needed, pad = V
    src_halo: np.ndarray   # int32[W, Emax] — per-edge slot into halo_ids, pad = Hmax
    owner_of_vertex: np.ndarray  # int32[V]
    n_own: np.ndarray      # int64[W] — real owned-vertex count
    n_edges: np.ndarray    # int64[W] — real owned-edge count
    n_halo: np.ndarray     # int64[W] — halo table size
    n_ghost: np.ndarray    # int64[W] — halo entries owned by ANOTHER worker
    # ---- ETR rank-summary exchange tables
    etr_perm_local_s: np.ndarray  # int32[W, Emax] — local slot of the j-th owned
    #                               edge in global (dst, life-start) order, pad = Emax
    etr_perm_local_e: np.ndarray  # int32[W, Emax] — same for (dst, life-end) order
    etr_src_eids: np.ndarray      # int32[W, Smax] — edges whose SOURCE vertex this
    #                               worker owns (it produces their summaries), pad = 2E
    etr_src_base: np.ndarray      # int32[W, Smax] — local prefix index of the source
    #                               segment's base in this worker's perm order, pad = 0
    etr_src_len: np.ndarray       # int32[W, Smax] — source arrival-segment length, pad = 0
    n_src: np.ndarray             # int64[W] — summaries produced per worker
    n_src_ghost: np.ndarray       # int64[W] — summaries consumed by ANOTHER worker
    # ---- point-to-point routing tables (see class docstring)
    halo_own_slot: np.ndarray     # int32[W, Hmax] — pad = Vmax
    xchg_send_slot: np.ndarray    # int32[W, W, Cmax] — pad = Vmax
    xchg_recv_slot: np.ndarray    # int32[W, W, Cmax] — pad = Hmax
    etr_local_slot: np.ndarray    # int32[W, Emax] — pad = Smax
    etr_send_slot: np.ndarray     # int32[W, W, Cetr] — pad = Smax
    etr_recv_slot: np.ndarray     # int32[W, W, Cetr] — pad = Emax
    stats: Dict

    @property
    def v_max(self) -> int:
        return int(self.own_ids.shape[1])

    @property
    def e_max(self) -> int:
        return int(self.edge_ids.shape[1])

    @property
    def h_max(self) -> int:
        return int(self.halo_ids.shape[1])

    @property
    def s_max(self) -> int:
        return int(self.etr_src_eids.shape[1])

    def exchange_volume(self) -> int:
        """Boundary messages per plain superstep: ghost-state entries received."""
        return int(self.n_ghost.sum())

    def worker_arrival_ptr(self) -> np.ndarray:
        """Each worker's local arrival CSR over ``dst_local``: int32
        [W, Vmax + 2], so that worker w's edges arriving at local slot v are
        ``ptr[w, v]:ptr[w, v + 1]`` of its row of ``edge_ids``.

        A worker's owned edges are already sorted by local arrival slot
        (canonical order restricted to the shard) with the pads on the trash
        segment ``v_max``, so the pointer is a searchsorted of that row; the
        trash segment is ``ptr[w, v_max]:ptr[w, v_max + 1]`` =
        ``n_edges[w]:e_max``.  Cached on the arrays object."""
        ptr = getattr(self, "_arrival_ptr", None)
        if ptr is None:
            W = self.n_workers
            ptr = np.empty((W, self.v_max + 2), np.int32)
            slots = np.arange(self.v_max + 2)
            for w in range(W):
                ptr[w] = np.searchsorted(self.dst_local[w], slots, side="left")
            self._arrival_ptr = ptr
        return ptr

    def etr_exchange_volume(self) -> int:
        """Boundary messages per ETR superstep: rank summaries whose producer
        (source-segment owner) differs from their consumer (edge owner)."""
        return int(self.n_src_ghost.sum())


def build_partition_arrays(
    graph: TemporalGraph, part: Partitioning
) -> PartitionArrays:
    """Lower a vertex partitioning into padded per-worker superstep tables."""
    V = graph.n_vertices
    W = part.n_workers
    tr = graph.traversal
    t_src = tr["t_src"].astype(np.int64)
    t_dst = tr["t_dst"].astype(np.int64)
    n2e = t_src.shape[0]

    owner = part.worker_of_part[part.part_of].astype(np.int32)  # int32[V]
    local_of = np.zeros(V, np.int64)

    owned: List[np.ndarray] = []
    edges: List[np.ndarray] = []
    halos: List[np.ndarray] = []
    src_halos: List[np.ndarray] = []
    dst_locals: List[np.ndarray] = []
    n_ghost = np.zeros(W, np.int64)
    edge_owner = owner[t_dst]
    for w in range(W):
        own = np.where(owner == w)[0].astype(np.int64)  # ascending
        local_of[own] = np.arange(own.shape[0])
        eidx = np.where(edge_owner == w)[0].astype(np.int64)  # canonical order
        halo = np.unique(t_src[eidx])
        owned.append(own)
        edges.append(eidx)
        halos.append(halo)
        src_halos.append(np.searchsorted(halo, t_src[eidx]))
        dst_locals.append(local_of[t_dst[eidx]])
        n_ghost[w] = int((owner[halo] != w).sum())

    n_own = np.asarray([o.shape[0] for o in owned], np.int64)
    n_edges = np.asarray([e.shape[0] for e in edges], np.int64)
    n_halo = np.asarray([h.shape[0] for h in halos], np.int64)
    assert int(n_own.sum()) == V, "every vertex must be owned exactly once"
    assert int(n_edges.sum()) == n2e, "every traversal edge owned exactly once"

    v_max = max(1, int(n_own.max()))
    e_max = max(1, int(n_edges.max()))
    h_max = max(1, int(n_halo.max()))

    def _pad(rows, width, fill):
        out = np.full((W, width), fill, np.int32)
        for w, r in enumerate(rows):
            out[w, : r.shape[0]] = r
        return out

    # ---- ETR rank-summary exchange tables.
    # Arrival segments are whole per worker (edge ownership is by t_dst), so
    # the global (dst, stat) permutations split into per-worker permutations
    # over each worker's owned edges; within-segment order — and hence every
    # within-segment prefix difference the rank machinery takes — is
    # preserved exactly.  ``base_local[v]`` counts this worker's perm entries
    # before v's segment (identical for the start- and end-stat orders, which
    # only differ *inside* segments).
    etr = graph.etr_tables
    perm_s = etr.perm_start.astype(np.int64)
    perm_e = etr.perm_end.astype(np.int64)
    ptr = graph.traversal["arr_ptr"].astype(np.int64)
    seg_len_v = np.diff(ptr)
    src_owner = owner[t_src]
    base_local = np.zeros(V, np.int64)
    perm_locals_s: List[np.ndarray] = []
    perm_locals_e: List[np.ndarray] = []
    src_eids: List[np.ndarray] = []
    src_bases: List[np.ndarray] = []
    src_lens: List[np.ndarray] = []
    n_src = np.zeros(W, np.int64)
    n_src_ghost = np.zeros(W, np.int64)
    eo_perm_s = edge_owner[perm_s]
    eo_perm_e = edge_owner[perm_e]
    for w in range(W):
        own = owned[w]
        lens = seg_len_v[own]
        base_local[own] = np.concatenate(([0], np.cumsum(lens)[:-1]))
        eidx = edges[w]
        perm_locals_s.append(np.searchsorted(eidx, perm_s[eo_perm_s == w]))
        perm_locals_e.append(np.searchsorted(eidx, perm_e[eo_perm_e == w]))
        produced = np.where(src_owner == w)[0].astype(np.int64)  # ascending
        src_eids.append(produced)
        src_bases.append(base_local[t_src[produced]])
        src_lens.append(seg_len_v[t_src[produced]])
        n_src[w] = produced.shape[0]
        n_src_ghost[w] = int((edge_owner[produced] != w).sum())
    assert int(n_src.sum()) == n2e, "every edge's summary produced exactly once"
    s_max = max(1, int(n_src.max()))

    # ---- point-to-point routing tables: one ragged lane per worker pair.
    # Vertex-state channel: d's halo entries owned by s travel on lane (s, d)
    # in d's halo order; entries d owns itself are a local copy
    # (halo_own_slot).  Every halo entry is either local or on exactly one
    # lane, so a padded all-to-all over the lanes moves only ghost entries.
    halo_own_slot = np.full((W, h_max), v_max, np.int32)
    send_lists: Dict[tuple, tuple] = {}
    for d in range(W):
        halo = halos[d]
        hpos = np.arange(halo.shape[0], dtype=np.int64)
        halo_owner = owner[halo]
        self_sel = halo_owner == d
        halo_own_slot[d, hpos[self_sel]] = local_of[halo[self_sel]]
        for s in np.unique(halo_owner[~self_sel]):
            sel = halo_owner == s
            send_lists[(int(s), d)] = (local_of[halo[sel]], hpos[sel])
    c_max = max(1, max((v[0].shape[0] for v in send_lists.values()), default=0))
    xchg_send_slot = np.full((W, W, c_max), v_max, np.int32)
    xchg_recv_slot = np.full((W, W, c_max), h_max, np.int32)
    for (s, d), (slots, hpos) in send_lists.items():
        xchg_send_slot[s, d, : slots.shape[0]] = slots
        xchg_recv_slot[d, s, : hpos.shape[0]] = hpos
    lane_ghost = np.asarray(
        [sum(v[0].shape[0] for (s, d), v in send_lists.items() if d == w)
         for w in range(W)], np.int64)
    assert np.array_equal(lane_ghost, n_ghost), "p2p lanes must cover ghosts"

    # ETR rank-summary channel: producer s's k-th produced summary goes to
    # the owner of its edge; self-consumed summaries are a local copy.
    etr_local_slot = np.full((W, e_max), s_max, np.int32)
    etr_lists: Dict[tuple, tuple] = {}
    for s in range(W):
        produced = src_eids[s]
        consumer = edge_owner[produced]
        self_sel = consumer == s
        # local copy: position of the self-consumed summaries in s's own
        # edge row (edges are ascending, produced eids too → searchsorted)
        etr_local_slot[s, np.searchsorted(edges[s], produced[self_sel])] = \
            np.nonzero(self_sel)[0]
        for d in np.unique(consumer[~self_sel]):
            sel = consumer == d
            etr_lists[(s, int(d))] = (
                np.nonzero(sel)[0],
                np.searchsorted(edges[int(d)], produced[sel]),
            )
    etr_c_max = max(1, max((v[0].shape[0] for v in etr_lists.values()),
                           default=0))
    etr_send_slot = np.full((W, W, etr_c_max), s_max, np.int32)
    etr_recv_slot = np.full((W, W, etr_c_max), e_max, np.int32)
    for (s, d), (slots, epos) in etr_lists.items():
        etr_send_slot[s, d, : slots.shape[0]] = slots
        etr_recv_slot[d, s, : epos.shape[0]] = epos
    lane_etr = np.asarray(
        [sum(v[0].shape[0] for (s, d), v in etr_lists.items() if s == w)
         for w in range(W)], np.int64)
    assert np.array_equal(lane_etr, n_src_ghost), "ETR lanes must cover ghosts"

    arrays = PartitionArrays(
        n_workers=W,
        own_ids=_pad(owned, v_max, V),
        edge_ids=_pad(edges, e_max, n2e),
        dst_local=_pad(dst_locals, e_max, v_max),
        halo_ids=_pad(halos, h_max, V),
        src_halo=_pad(src_halos, e_max, h_max),
        owner_of_vertex=owner,
        n_own=n_own,
        n_edges=n_edges,
        n_halo=n_halo,
        n_ghost=n_ghost,
        etr_perm_local_s=_pad(perm_locals_s, e_max, e_max),
        etr_perm_local_e=_pad(perm_locals_e, e_max, e_max),
        etr_src_eids=_pad(src_eids, s_max, n2e),
        etr_src_base=_pad(src_bases, s_max, 0),
        etr_src_len=_pad(src_lens, s_max, 0),
        n_src=n_src,
        n_src_ghost=n_src_ghost,
        halo_own_slot=halo_own_slot,
        xchg_send_slot=xchg_send_slot,
        xchg_recv_slot=xchg_recv_slot,
        etr_local_slot=etr_local_slot,
        etr_send_slot=etr_send_slot,
        etr_recv_slot=etr_recv_slot,
        stats=dict(
            **part.stats,
            n_workers=W,
            edge_imbalance=float(n_edges.max() / max(n_edges.mean(), 1e-9)),
            ghost_frac=float(n_ghost.sum() / max(n_halo.sum(), 1)),
            exchange_volume=int(n_ghost.sum()),
            etr_exchange_volume=int(n_src_ghost.sum()),
            p2p_lane_width=int(c_max),
            p2p_etr_lane_width=int(etr_c_max),
        ),
    )
    return arrays


def reassign_on_failure(p: Partitioning, failed_worker: int) -> Partitioning:
    """Rebalance a failed worker's sub-partitions over survivors (fault path)."""
    survivors = [w for w in range(p.n_workers) if w != failed_worker]
    new_worker = p.worker_of_part.copy()
    j = 0
    for i in range(p.n_parts):
        if new_worker[i] == failed_worker:
            new_worker[i] = survivors[j % len(survivors)]
            j += 1
    return Partitioning(p.part_of, new_worker, p.n_parts, p.n_workers,
                        {**p.stats, "reassigned_from": failed_worker})
