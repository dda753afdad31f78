"""Temporal graph statistics for the cost model (Sec. 5.1 of the paper).

Per property key we maintain a 2-D histogram over (value × time-bucket) of
entity counts, coarsened into variance-bounded *tiles* (the paper uses the DP
hierarchical tiling of Muthukrishnan et al. [52]; we use the equivalent
top-down recursive split, which has the same invariant — per-tile frequency
variance ≤ threshold — at lower build cost), stored in an *interval tree*
keyed by tile time-range.  High-cardinality keys are frequency-clustered and
queries are rewritten to cluster ids (paper Sec. 5.1).

The port's copy of the reference package's ``core/stats.py`` (numpy only):
the same tables from the same graph, array for array — the ETR selectivity
samples draw from ``np.random`` in the reference's order.

Beyond the paper (documented in DESIGN.md):
  * type-aware degree table ``D[vtype, etype, dir]`` — the paper keeps a
    single (δ_in, δ_out) per histogram entry; conditioning on the edge type
    sharpens the active-edge estimate for typed hops.
  * ETR selectivity: per edge-type-pair empirical probability that a random
    incident edge pair satisfies each ETR comparator (sampled at build time).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import intervals as iv
from . import query as Q
from .graph import TemporalGraph


# ---------------------------------------------------------------- tiles/tree
@dataclasses.dataclass
class Tile:
    v_lo: int
    v_hi: int
    t_lo: int
    t_hi: int
    freq: float          # average per-(value,bucket) frequency inside the tile
    d_in: float
    d_out: float


class IntervalTree:
    """Static augmented interval tree over tile time-ranges."""

    def __init__(self, tiles: List[Tile]):
        self.tiles = sorted(tiles, key=lambda t: (t.t_lo, t.t_hi))
        self.starts = np.asarray([t.t_lo for t in self.tiles], np.int64)
        self.maxend = np.zeros(len(self.tiles), np.int64)
        # balanced recursion replaced by a sorted array + running max-end —
        # lookup prunes with searchsorted (equivalent pruning power for the
        # partition-of-grid tiles we store).
        run = -(2 ** 62)
        for i, t in enumerate(self.tiles):
            run = max(run, t.t_hi)
            self.maxend[i] = run

    def query(self, t_lo: int, t_hi: int) -> List[Tile]:
        if not self.tiles:
            return []
        hi = int(np.searchsorted(self.starts, t_hi, side="left"))
        out = []
        for i in range(hi - 1, -1, -1):
            if self.maxend[i] <= t_lo:
                break
            t = self.tiles[i]
            if t.t_hi > t_lo:
                out.append(t)
        return out


def _tile_grid(grid: np.ndarray, din: np.ndarray, dout: np.ndarray,
               var_threshold: float) -> List[Tile]:
    """Top-down variance-bounded tiling of a (values × buckets) count grid."""
    tiles: List[Tile] = []

    def rec(v0, v1, t0, t1):
        sub = grid[v0:v1, t0:t1]
        if sub.size == 0:
            return
        if sub.size == 1 or float(sub.var()) <= var_threshold:
            cnt = float(sub.mean())
            w = sub.sum()
            if w > 0:
                di = float((din[v0:v1, t0:t1] * sub).sum() / w)
                do = float((dout[v0:v1, t0:t1] * sub).sum() / w)
            else:
                di = do = 0.0
            tiles.append(Tile(v0, v1, t0, t1, cnt, di, do))
            return
        if (v1 - v0) >= (t1 - t0) and (v1 - v0) > 1:
            mid = (v0 + v1) // 2
            rec(v0, mid, t0, t1)
            rec(mid, v1, t0, t1)
        else:
            mid = (t0 + t1) // 2
            rec(v0, v1, t0, mid)
            rec(v0, v1, mid, t1)

    rec(0, grid.shape[0], 0, grid.shape[1])
    return tiles


# ------------------------------------------------------------------ per key
@dataclasses.dataclass
class KeyStats:
    tree: IntervalTree
    cluster_of: Dict[int, int]       # value id → cluster row
    cluster_size: np.ndarray         # values per cluster row
    n_rows: int


@dataclasses.dataclass
class HEntry:
    f: float
    d_in: float
    d_out: float


class GraphStats:
    """All statistics the planner needs.  Built once per graph (host side)."""

    def __init__(
        self,
        graph: TemporalGraph,
        n_time_buckets: int = 16,
        max_value_clusters: int = 64,
        var_threshold: float = 4.0,
        etr_samples: int = 2048,
        seed: int = 0,
    ):
        self.g = graph
        self.B = n_time_buckets
        self.bedges = iv.bucket_edges(graph.lifespan[0], graph.lifespan[1], n_time_buckets)
        self.var_threshold = var_threshold
        self.max_clusters = max_value_clusters
        self.vkey_stats: Dict[int, KeyStats] = {}
        self.ekey_stats: Dict[int, KeyStats] = {}
        self.type_life_hist = np.zeros((graph.n_vertex_types, self.B))
        self.etype_life_hist = np.zeros((graph.n_edge_types, self.B))
        self.degree_table = np.zeros((graph.n_vertex_types, graph.n_edge_types, 2))
        self.etr_select: Dict[int, float] = {}
        self._build(etr_samples, seed)

    # ------------------------------------------------------------- builders
    def _bucket_overlap_counts(self, life: np.ndarray) -> np.ndarray:
        """bool[N, B]: does interval life[n] overlap bucket b."""
        lo = self.bedges[:-1][None, :]
        hi = self.bedges[1:][None, :]
        return (life[:, 0:1] < hi) & (lo < life[:, 1:2])

    def _build_key(self, col, degrees_in, degrees_out) -> KeyStats:
        vals = col.vals.reshape(-1)
        life = col.life.reshape(-1, 2)
        n_ent = col.vals.shape[0]
        ent = np.repeat(np.arange(n_ent), col.vals.shape[1])
        keep = vals >= 0
        vals, life, ent = vals[keep], life[keep], ent[keep]
        if vals.size == 0:
            return KeyStats(IntervalTree([]), {}, np.zeros(0), 0)
        uniq, inv, cnts = np.unique(vals, return_inverse=True, return_counts=True)
        # frequency clustering for high-cardinality keys
        if len(uniq) > self.max_clusters:
            order = np.argsort(-cnts, kind="stable")
            rows_of_sorted = (
                np.arange(len(uniq)) * self.max_clusters // len(uniq)
            )
            row_of_uniq = np.empty(len(uniq), np.int64)
            row_of_uniq[order] = rows_of_sorted
        else:
            row_of_uniq = np.arange(len(uniq))
        n_rows = int(row_of_uniq.max()) + 1
        cluster_of = {int(u): int(r) for u, r in zip(uniq, row_of_uniq)}
        cluster_size = np.bincount(row_of_uniq, minlength=n_rows).astype(np.float64)
        rows = row_of_uniq[inv]

        ovl = self._bucket_overlap_counts(life)  # [n, B]
        grid = np.zeros((n_rows, self.B))
        din = np.zeros((n_rows, self.B))
        dout = np.zeros((n_rows, self.B))
        for b in range(self.B):
            sel = ovl[:, b]
            np.add.at(grid, (rows[sel], b), 1.0)
            if degrees_in is not None:
                np.add.at(din, (rows[sel], b), degrees_in[ent[sel]])
                np.add.at(dout, (rows[sel], b), degrees_out[ent[sel]])
        with np.errstate(invalid="ignore", divide="ignore"):
            din = np.where(grid > 0, din / np.maximum(grid, 1), 0.0)
            dout = np.where(grid > 0, dout / np.maximum(grid, 1), 0.0)
        # per-row normalisation: grid holds counts per cluster row; divide by
        # cluster size to estimate per-VALUE frequency (paper's cluster map).
        grid = grid / np.maximum(cluster_size[:, None], 1.0)
        tiles = _tile_grid(grid, din, dout, self.var_threshold)
        return KeyStats(IntervalTree(tiles), cluster_of, cluster_size, n_rows)

    def _build(self, etr_samples: int, seed: int):
        g = self.g
        din = g.in_degree.astype(np.float64)
        dout = g.out_degree.astype(np.float64)
        for k, col in g.vprops.items():
            self.vkey_stats[k] = self._build_key(col, din, dout)
        for k, col in g.eprops.items():
            self.ekey_stats[k] = self._build_key(col, None, None)
        # lifespan histograms per type
        ovl_v = self._bucket_overlap_counts(g.v_life)
        for t in range(g.n_vertex_types):
            sel = g.v_type == t
            self.type_life_hist[t] = ovl_v[sel].sum(axis=0)
        ovl_e = self._bucket_overlap_counts(g.e_life)
        for t in range(g.n_edge_types):
            sel = g.e_type == t
            self.etype_life_hist[t] = ovl_e[sel].sum(axis=0)
        # type-aware degree table D[vt, et, dir]: avg #incident et-edges per
        # vt-vertex; dir 0 = outgoing, 1 = incoming.
        for et in range(g.n_edge_types):
            sel = g.e_type == et
            src_t = g.v_type[g.e_src[sel]]
            dst_t = g.v_type[g.e_dst[sel]]
            cnt_s = np.bincount(src_t, minlength=g.n_vertex_types)
            cnt_d = np.bincount(dst_t, minlength=g.n_vertex_types)
            denom = np.maximum(g.type_counts, 1)
            self.degree_table[:, et, 0] = cnt_s / denom
            self.degree_table[:, et, 1] = cnt_d / denom
        # ETR selectivity per comparator (sampled incident edge pairs)
        rng = np.random.default_rng(seed)
        if g.n_edges >= 2:
            e1 = rng.integers(0, g.n_edges, size=etr_samples)
            e2 = rng.integers(0, g.n_edges, size=etr_samples)
            a = g.e_life[e1].astype(np.int64)
            b = g.e_life[e2].astype(np.int64)
            sel = {
                iv.FULLY_BEFORE: np.mean(a[:, 1] <= b[:, 0]),
                iv.STARTS_BEFORE: np.mean(a[:, 0] < b[:, 0]),
                iv.FULLY_AFTER: np.mean(a[:, 0] >= b[:, 1]),
                iv.STARTS_AFTER: np.mean(a[:, 0] > b[:, 0]),
                iv.OVERLAPS: np.mean((a[:, 0] < b[:, 1]) & (b[:, 0] < a[:, 1])),
            }
            self.etr_select = {k: float(v) for k, v in sel.items()}

    # ------------------------------------------------------------- lookups
    def _bucket_range(self, interval: Optional[Tuple[int, int]]) -> Tuple[int, int]:
        if interval is None:
            return 0, self.B
        lo = int(np.searchsorted(self.bedges, interval[0], side="right")) - 1
        hi = int(np.searchsorted(self.bedges, interval[1], side="left"))
        return max(lo, 0), min(max(hi, lo + 1), self.B)

    def h_lookup(self, key: int, value: int, interval=None, is_edge=False) -> HEntry:
        """The paper's H_κ(val, τ) → (f, δ_in, δ_out)."""
        ks = (self.ekey_stats if is_edge else self.vkey_stats).get(key)
        if ks is None or ks.n_rows == 0:
            return HEntry(0.0, 0.0, 0.0)
        row = ks.cluster_of.get(int(value))
        if row is None:
            return HEntry(0.0, 0.0, 0.0)
        b_lo, b_hi = self._bucket_range(interval)
        tiles = ks.tree.query(b_lo, b_hi)
        f = di = do = w = 0.0
        for t in tiles:
            if t.v_lo <= row < t.v_hi:
                ow = min(t.t_hi, b_hi) - max(t.t_lo, b_lo)
                f += t.freq * ow
                di += t.d_in * ow
                do += t.d_out * ow
                w += ow
        if w == 0:
            return HEntry(0.0, 0.0, 0.0)
        return HEntry(f / w, di / w, do / w)   # time-weighted average

    def type_count(self, vtype: int) -> float:
        if vtype < 0:
            return float(self.g.n_vertices)
        return float(self.g.type_counts[vtype])

    def etype_count(self, etype: int) -> float:
        if etype < 0:
            return float(self.g.n_edges)
        return float(self.g.edge_type_counts[etype])

    def lifespan_frac(self, vtype: int, interval, is_edge=False) -> float:
        """Fraction of type-σ entities whose lifespan overlaps interval."""
        b_lo, b_hi = self._bucket_range(interval)
        hist = self.etype_life_hist if is_edge else self.type_life_hist
        if is_edge:
            tot = self.etype_count(vtype)
            row = hist[vtype] if vtype >= 0 else hist.sum(axis=0)
        else:
            tot = self.type_count(vtype)
            row = hist[vtype] if vtype >= 0 else hist.sum(axis=0)
        if tot == 0:
            return 0.0
        return float(row[b_lo:b_hi].max(initial=0.0)) / tot

    def degree(self, vtype: int, etype: int, direction: int) -> float:
        """avg # of traversable etype-edges per vtype-vertex for a hop dir."""
        if vtype < 0:
            d = self.degree_table.mean(axis=0)
        else:
            d = self.degree_table[vtype]
        if etype < 0:
            d = d.sum(axis=0)
        else:
            d = d[etype]
        if direction == Q.DIR_OUT:
            return float(d[0])
        if direction == Q.DIR_IN:
            return float(d[1])
        return float(d[0] + d[1])

    def size_report(self) -> dict:
        n_tiles = sum(len(s.tree.tiles) for s in self.vkey_stats.values())
        n_tiles += sum(len(s.tree.tiles) for s in self.ekey_stats.values())
        raw_cells = sum(s.n_rows * self.B for s in self.vkey_stats.values())
        raw_cells += sum(s.n_rows * self.B for s in self.ekey_stats.values())
        return dict(n_tiles=n_tiles, raw_cells=raw_cells,
                    bytes_tiled=n_tiles * 7 * 8, bytes_raw=raw_cells * 3 * 8)
