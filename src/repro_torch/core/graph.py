"""Temporal property graph container (host-side, numpy) + torch device views.

Layout decisions (see DESIGN.md Sec. 2/5):

* Structure-of-arrays, fully dictionary-encoded: vertex/edge types, property
  keys and property values are int ids.  The string dictionaries live in the
  loader (`graphdata/loader.py`); the engine never sees a string.
* Vertices are **type-major**: the loader permutes vertex ids so each type is
  a contiguous id range (``type_ranges``).  This is the tensor analogue of the
  paper's type-based partitioning — a type predicate becomes a range check and
  an init superstep touches only that slice.
* Edges are materialised once as **traversal arrays** of size 2E: entry
  ``i < E`` is edge ``i`` traversed forward (src→dst), entry ``E + i`` is the
  same edge traversed backward.  Directed/undirected hops become weight masks
  over the same arrays, so ETR rank tables and segment offsets are built once.
* Traversal arrays are sorted by arrival vertex (``t_dst``); ``arr_ptr`` gives
  the CSR-style segment offsets.  Per-superstep message delivery is then a
  sorted segment-sum, which the hop kernels (``kernels/hop_scatter``) walk
  destination by destination.
* **ETR rank tables**: for the edge-temporal-relationship operator we need,
  per candidate edge e', the weighted count of accumulated edges at a vertex
  whose lifespan stat (start/end) compares against a threshold taken from e'.
  Because the graph is static at query time, the *rank* of each threshold in
  the sorted per-vertex stat lists is precomputed; at query time an ETR hop is
  two cumsums + gathers (exact, O(E)).

Properties: per-key dense pivot ``vals int32[N, S]`` / ``life int32[N, S, 2]``
with ``S`` = max concurrent versions or multi-values; missing = -1 and empty
lifespan.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Dict, Optional, Tuple

import numpy as np

NO_VALUE = -1


@dataclasses.dataclass(frozen=True)
class PropColumn:
    """Dense pivot of one property key over vertices or edges."""

    vals: np.ndarray   # int32[N, S]
    life: np.ndarray   # int32[N, S, 2]

    @property
    def n_slots(self) -> int:
        return self.vals.shape[1]


@dataclasses.dataclass(frozen=True)
class EtrTables:
    """Precomputed rank tables for ETR prefix-sum evaluation.

    All arrays are over the 2E traversal-edge space in canonical
    (arrival-sorted) order.
    """

    perm_start: np.ndarray  # int32[2E] — traversal ids sorted by (t_dst, life_start)
    perm_end: np.ndarray    # int32[2E] — sorted by (t_dst, life_end)
    # rank arrays, one row per term kind (see engine.ETR_TERMS):
    #   0: #(acc.start <  cur.start)   over perm_start
    #   1: #(acc.start <= cur.start)   over perm_start
    #   2: #(acc.start <  cur.end)     over perm_start
    #   3: #(acc.end   <= cur.start)   over perm_end
    dep_ranks: np.ndarray   # int32[4, 2E] — thresholds from edges *departing* v (hop step)
    arr_ranks: np.ndarray   # int32[4, 2E] — thresholds from edges *arriving* at v (join)


class TemporalGraph:
    """Immutable temporal property graph (host container)."""

    def __init__(
        self,
        v_type: np.ndarray,
        v_life: np.ndarray,
        e_src: np.ndarray,
        e_dst: np.ndarray,
        e_type: np.ndarray,
        e_life: np.ndarray,
        vprops: Dict[int, PropColumn],
        eprops: Dict[int, PropColumn],
        n_vertex_types: int,
        n_edge_types: int,
        lifespan: Tuple[int, int],
        meta: Optional[dict] = None,
    ):
        self.v_type = np.asarray(v_type, np.int32)
        self.v_life = np.asarray(v_life, np.int32)
        self.e_src = np.asarray(e_src, np.int32)
        self.e_dst = np.asarray(e_dst, np.int32)
        self.e_type = np.asarray(e_type, np.int32)
        self.e_life = np.asarray(e_life, np.int32)
        self.vprops = vprops
        self.eprops = eprops
        self.n_vertex_types = int(n_vertex_types)
        self.n_edge_types = int(n_edge_types)
        self.lifespan = (int(lifespan[0]), int(lifespan[1]))
        self.meta = meta or {}
        self._validate()
        self._device_cache: Optional[Dict[str, dict]] = None

    # ------------------------------------------------------------------ basic
    @property
    def n_vertices(self) -> int:
        return int(self.v_type.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.e_src.shape[0])

    def _validate(self) -> None:
        V, E = self.n_vertices, self.n_edges
        assert self.v_life.shape == (V, 2)
        assert self.e_dst.shape == (E,) and self.e_type.shape == (E,)
        assert self.e_life.shape == (E, 2)
        if E:
            assert self.e_src.min() >= 0 and self.e_src.max() < V
            assert self.e_dst.min() >= 0 and self.e_dst.max() < V
        # referential integrity: edge lifespan within both endpoint lifespans
        # (constraint from Sec. 3.2; generator guarantees it, we spot check).
        if E:
            k = min(E, 1024)
            idx = np.linspace(0, E - 1, k).astype(np.int64)
            s_ok = self.v_life[self.e_src[idx], 0] <= self.e_life[idx, 0]
            e_ok = self.v_life[self.e_src[idx], 1] >= self.e_life[idx, 1]
            if not (s_ok & e_ok).all():
                raise ValueError("edge lifespans violate referential integrity (src)")

    # ------------------------------------------------------- type structure
    @cached_property
    def type_ranges(self) -> np.ndarray:
        """int32[n_vertex_types, 2] — [start, end) vertex-id range per type.

        Requires type-major ordering (loader guarantees); falls back to
        full-range for any type that is not contiguous.
        """
        tr = np.zeros((self.n_vertex_types, 2), np.int32)
        sorted_ok = bool(np.all(np.diff(self.v_type) >= 0))
        for t in range(self.n_vertex_types):
            if sorted_ok:
                lo = int(np.searchsorted(self.v_type, t, side="left"))
                hi = int(np.searchsorted(self.v_type, t, side="right"))
            else:  # pragma: no cover — loaders always sort
                lo, hi = 0, self.n_vertices
            tr[t] = (lo, hi)
        return tr

    @cached_property
    def type_counts(self) -> np.ndarray:
        return np.bincount(self.v_type, minlength=self.n_vertex_types).astype(np.int64)

    @cached_property
    def edge_type_counts(self) -> np.ndarray:
        return np.bincount(self.e_type, minlength=self.n_edge_types).astype(np.int64)

    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.bincount(self.e_src, minlength=self.n_vertices).astype(np.int32)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.e_dst, minlength=self.n_vertices).astype(np.int32)

    # ------------------------------------------------------ traversal arrays
    @cached_property
    def traversal(self) -> dict:
        """2E traversal-edge arrays in canonical arrival-sorted order."""
        E = self.n_edges
        t_src = np.concatenate([self.e_src, self.e_dst])
        t_dst = np.concatenate([self.e_dst, self.e_src])
        t_life = np.concatenate([self.e_life, self.e_life], axis=0)
        t_type = np.concatenate([self.e_type, self.e_type])
        t_isfwd = np.concatenate(
            [np.ones(E, np.int32), np.zeros(E, np.int32)]
        )
        t_eid = np.concatenate([np.arange(E, dtype=np.int32)] * 2)
        order = np.lexsort((t_src, t_dst)).astype(np.int32)
        arr_ptr = np.zeros(self.n_vertices + 1, np.int64)
        np.cumsum(
            np.bincount(t_dst, minlength=self.n_vertices), out=arr_ptr[1:]
        )
        return dict(
            t_src=t_src[order].astype(np.int32),
            t_dst=t_dst[order].astype(np.int32),
            t_life=t_life[order].astype(np.int32),
            t_type=t_type[order].astype(np.int32),
            t_isfwd=t_isfwd[order].astype(np.int32),
            t_eid=t_eid[order].astype(np.int32),
            arr_ptr=arr_ptr.astype(np.int32),
        )

    @cached_property
    def etr_tables(self) -> EtrTables:
        tr = self.traversal
        n2e = tr["t_dst"].shape[0]
        t_dst = tr["t_dst"]
        t_src = tr["t_src"]
        starts = tr["t_life"][:, 0].astype(np.int64)
        ends = tr["t_life"][:, 1].astype(np.int64)
        ptr = tr["arr_ptr"].astype(np.int64)

        # Sort (within each arrival segment) by stat.  Canonical order is
        # already grouped by t_dst, so a stable lexsort on (t_dst, stat) works.
        perm_start = np.lexsort((starts, t_dst)).astype(np.int32)
        perm_end = np.lexsort((ends, t_dst)).astype(np.int32)
        sorted_starts = starts[perm_start]
        sorted_ends = ends[perm_end]

        def seg_searchsorted(sorted_vals, seg_of_query, thresh, side) -> np.ndarray:
            """rank of thresh within its vertex's segment of sorted_vals."""
            lo = ptr[seg_of_query]
            hi = ptr[seg_of_query + 1]
            out = np.zeros(thresh.shape[0], np.int32)
            # Vectorised trick: offset values per segment so a single global
            # searchsorted works.  Stats fit int32; segments indexed by vertex.
            # Simpler and still O(2E log E): loop-free via np.searchsorted on
            # concatenated arrays using np.searchsorted's sorter is not
            # segment-aware, so do it with a per-element binary search through
            # np.searchsorted on the global array bounded to segments:
            # implemented via the "offset encoding": val' = vertex * SPAN + val.
            span = int(max(sorted_vals.max(initial=0), thresh.max(initial=0)) + 2)
            seg_of_sorted = np.repeat(
                np.arange(len(ptr) - 1, dtype=np.int64), np.diff(ptr)
            )
            enc_sorted = seg_of_sorted * span + sorted_vals
            enc_q = seg_of_query.astype(np.int64) * span + thresh
            pos = np.searchsorted(enc_sorted, enc_q, side=side)
            out = (pos - lo).astype(np.int32)
            np.clip(out, 0, (hi - lo).astype(np.int64), out=out)
            return out

        def build_ranks(seg_of_query: np.ndarray) -> np.ndarray:
            q_start = starts
            q_end = ends
            r0 = seg_searchsorted(sorted_starts, seg_of_query, q_start, "left")
            r1 = seg_searchsorted(sorted_starts, seg_of_query, q_start, "right")
            r2 = seg_searchsorted(sorted_starts, seg_of_query, q_end, "left")
            r3 = seg_searchsorted(sorted_ends, seg_of_query, q_start, "right")
            return np.stack([r0, r1, r2, r3]).astype(np.int32)

        dep_ranks = build_ranks(t_src.astype(np.int64))
        arr_ranks = build_ranks(t_dst.astype(np.int64))
        assert dep_ranks.shape == (4, n2e)
        return EtrTables(perm_start, perm_end, dep_ranks, arr_ranks)

    # --------------------------------------------------------------- device
    def device_arrays(self, device, include_etr: bool = True) -> dict:
        """torch views of everything the engines need, cached per device.

        Index arrays stay int32 (the kernels' operand type); the engines cast
        to int64 only where torch indexing demands it."""
        import torch

        device = torch.device(device)
        cache = self._device_cache
        if cache is None:
            cache = self._device_cache = {}
        key = str(device)
        if key in cache:
            return cache[key]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        tr = self.traversal
        g = dict(
            v_type=t(self.v_type),
            v_life=t(self.v_life),
            t_src=t(tr["t_src"]),
            t_dst=t(tr["t_dst"]),
            t_life=t(tr["t_life"]),
            t_type=t(tr["t_type"]),
            t_isfwd=t(tr["t_isfwd"]),
            arr_ptr=t(tr["arr_ptr"]),
            type_ranges=t(self.type_ranges),
        )
        if include_etr:
            et = self.etr_tables
            g.update(
                etr_perm_start=t(et.perm_start),
                etr_perm_end=t(et.perm_end),
                etr_dep_ranks=t(et.dep_ranks),
                etr_arr_ranks=t(et.arr_ranks),
            )
        g["vprops"] = {k: (t(c.vals), t(c.life)) for k, c in self.vprops.items()}
        # edge property columns gathered into traversal space (2E)
        t_eid = tr["t_eid"]
        g["eprops_t"] = {
            k: (t(c.vals[t_eid]), t(c.life[t_eid])) for k, c in self.eprops.items()
        }
        cache[key] = g
        return g

    # ------------------------------------------------------------- utilities
    def subgraph_stats(self) -> dict:
        return dict(
            n_vertices=self.n_vertices,
            n_edges=self.n_edges,
            n_vertex_types=self.n_vertex_types,
            n_edge_types=self.n_edge_types,
            lifespan=self.lifespan,
            n_vprop_keys=len(self.vprops),
            n_eprop_keys=len(self.eprops),
        )


def make_prop_column(
    n_entities: int,
    entity_ids: np.ndarray,
    values: np.ndarray,
    lifespans: np.ndarray,
) -> PropColumn:
    """Pivot a flat (entity, value, lifespan) table into a dense PropColumn."""
    entity_ids = np.asarray(entity_ids, np.int64)
    values = np.asarray(values, np.int32)
    lifespans = np.asarray(lifespans, np.int32).reshape(-1, 2)
    counts = np.bincount(entity_ids, minlength=n_entities)
    S = max(1, int(counts.max(initial=1)))
    vals = np.full((n_entities, S), NO_VALUE, np.int32)
    life = np.zeros((n_entities, S, 2), np.int32)
    order = np.argsort(entity_ids, kind="stable")
    slot = np.zeros(n_entities, np.int64)
    eo = entity_ids[order]
    # slot index within each entity via cumcount
    slot_of = np.arange(len(eo)) - np.concatenate(([0], np.cumsum(np.bincount(eo, minlength=n_entities))))[eo]
    vals[eo, slot_of] = values[order]
    life[eo, slot_of] = lifespans[order]
    del slot
    return PropColumn(vals=vals, life=life)
