"""Plain reference for temporal path queries, in PyTorch.

It answers the query dicts of ``bench.gen.queries`` over a ``GraphData`` with
the semantics the port's ``core/ref_engine.py`` states, from the generated
arrays alone (it imports nothing of the program and reads nothing the program
derived):

* a vertex or edge matches its predicate by type and clauses (AND/OR folded
  left to right), and carries a *validity*: its lifespan, narrowed by the
  lifespans of the property values an ``==`` / ``in`` clause matched;
* a path matches when every entity on it matches and every ETR clause holds
  between the lifespans of adjacent edges;
* static mode counts matching paths; bucket mode counts, per time bucket, the
  paths whose every entity is valid in that bucket; interval mode counts one
  result per path and maximal contiguous window of the intersection of its
  entities' validities;
* MIN/MAX aggregates group by the first vertex and take the extremum of the
  last vertex's first ``agg_key`` value over its paths (in bucket mode, the
  paths valid in at least one bucket).

How it computes (nothing of this is the program's method): time is cut into
the elementary segments between every lifespan endpoint of the data and
every bucket edge, and every validity becomes a mask over those segments.
Each mode then reduces to plain path counting over *channels*, one 0/1 mask
per entity and channel: one channel (static), one per bucket (bucket), or
one per segment plus one per pair of adjacent segments (interval: a path's
maximal windows are its covered segments minus its covered adjacent pairs).
Paths are counted by dynamic programming from the last vertex back to the
first, per edge where the next hop carries an ETR clause; an ETR sum is read
from per-vertex histograms of the next edges' start or end times and their
prefix sums.  Counts are float64, exact to 2**53, unless ``dtype`` says
otherwise (the control computes in bfloat16).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..gen.ldbc import GraphData

STATIC, BUCKET, INTERVAL = "static", "bucket", "interval"


def bucket_edges(t_min: int, t_max: int, n_buckets: int) -> np.ndarray:
    """Bucket boundaries: ``n_buckets`` buckets of width ceil(span / n)."""
    width = max(1, -(-(t_max - t_min) // n_buckets))
    return np.asarray([t_min + i * width for i in range(n_buckets + 1)], np.int64)


def _allen(cmp: str, a_s, a_e, b_s, b_e):
    """``a cmp b`` on lifespans, false where either interval is empty."""
    rel = {
        "<<": lambda: a_e <= b_s,
        "<": lambda: a_s < b_s,
        ">>": lambda: a_s >= b_e,
        ">": lambda: a_s > b_s,
        "during": lambda: (a_s > b_s) & (a_e < b_e),
        "==": lambda: (a_s == b_s) & (a_e == b_e),
        "in": lambda: (a_s >= b_s) & (a_e <= b_e),
        "overlaps": lambda: (a_s < b_e) & (b_s < a_e),
    }[cmp]()
    return rel & (a_s < a_e) & (b_s < b_e)


class Reference:
    """A graph held on ``device`` for answering many queries."""

    def __init__(self, g: GraphData, n_buckets: int, device="cpu",
                 dtype: torch.dtype = torch.float64):
        self.g = g
        self.dev = torch.device(device)
        self.dtype = dtype
        self.n_buckets = n_buckets
        t = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=self.dev)  # noqa: E731
        self.v_life = t(g.v_life)
        self.e_src, self.e_dst, self.e_life = t(g.e_src), t(g.e_dst), t(g.e_life)
        self.e_type = t(g.e_type)
        self.bedges = bucket_edges(g.lifespan[0], g.lifespan[1], n_buckets)
        pts = [g.v_life.ravel(), g.e_life.ravel(), self.bedges]
        for vals, life in g.vprops.values():
            pts.append(life[vals >= 0].ravel())
        self.tvals = t(np.unique(np.concatenate(pts)))      # segment bounds
        lo, hi = self.tvals[:-1], self.tvals[1:]
        self.seg_lo, self.seg_hi = lo, hi
        # the bucket of every segment (bucket edges are segment bounds)
        self.seg_bucket = torch.searchsorted(t(self.bedges), lo, right=True) - 1
        self.vprops = {k: (t(v), t(l)) for k, (v, l) in g.vprops.items()}
        self._edges_of: Dict[int, torch.Tensor] = {}

    # ----------------------------------------------------------- validity
    def cover(self, life: torch.Tensor) -> torch.Tensor:
        """bool [N, K]: segments a lifespan [N, 2] covers (none if empty)."""
        s, e = life[:, 0:1], life[:, 1:2]
        return (s < self.seg_hi) & (self.seg_lo < e) & (s < e)

    def channels(self, match: torch.Tensor, cov: torch.Tensor, mode: str):
        """0/1 [N, C] channel masks of entities with ``match`` and ``cov``."""
        if mode == STATIC:
            ch = match[:, None]
        elif mode == BUCKET:
            ch = torch.zeros((cov.shape[0], self.n_buckets), dtype=torch.bool,
                             device=self.dev)
            for b in range(self.n_buckets):
                ch[:, b] = cov[:, self.seg_bucket == b].any(dim=1)
            ch &= match[:, None]
        elif mode == INTERVAL:
            ch = torch.cat([cov, cov[:, :-1] & cov[:, 1:]], dim=1) & match[:, None]
        else:
            raise ValueError(f"unknown mode {mode!r}")
        return ch.to(self.dtype)

    def vertex_channels(self, vp: dict, mode: str) -> torch.Tensor:
        """[V, C] channels of a vertex predicate (zero outside its type)."""
        g = self.g
        lo, hi = g.type_ranges[vp["type"]] if vp["type"] is not None else (0, g.n_vertices)
        life = self.v_life[lo:hi]
        match = life[:, 0] < life[:, 1]
        base = self.cover(life)
        acc_m = acc_v = None
        for c in vp["clauses"]:
            if c[0] == "time":
                _, conj, cmp, ts, te = c
                m = _allen(cmp, life[:, 0], life[:, 1], ts, te)
                v = base
            else:
                _, conj, key, cmp, value = c
                vals, plife = self.vprops[g.key_id(key)]
                vals, plife = vals[lo:hi], plife[lo:hi]
                present = vals >= 0
                if cmp == "!=":
                    m = present.any(1) & ~(present & (vals == value)).any(1)
                    v = base
                elif cmp in ("==", "in"):
                    hit = present & (vals == value)
                    m = hit.any(1)
                    v = torch.zeros_like(base)
                    for s in range(vals.shape[1]):
                        v |= hit[:, s:s + 1] & self.cover(plife[:, s])
                else:
                    raise ValueError(f"unknown property comparator {cmp!r}")
            if acc_m is None:
                acc_m, acc_v = m, v
            elif conj == "and":
                acc_m, acc_v = acc_m & m, acc_v & v
            elif conj == "or":
                acc_v = torch.where((acc_m & ~m)[:, None], acc_v,
                                    torch.where((m & ~acc_m)[:, None], v, acc_v | v))
                acc_m = acc_m | m
            else:
                raise ValueError(f"unknown connective {conj!r}")
        if acc_m is not None:
            match, base = match & acc_m, base & acc_v
        ch = self.channels(match, base, mode)
        out = torch.zeros((g.n_vertices, ch.shape[1]), dtype=self.dtype, device=self.dev)
        out[lo:hi] = ch
        return out

    def hop_edges(self, ep: dict):
        """(a, b, life) of a hop: ``a`` on the query's earlier vertex, ``b``
        on the later one, every matching edge in each direction it may be
        walked."""
        if ep.get("clauses"):
            raise NotImplementedError("edge property clauses")
        if ep["type"] is None:
            ids = torch.arange(self.g.n_edges, device=self.dev)
        else:
            t = self.g.etype_id(ep["type"])
            ids = self._edges_of.get(t)
            if ids is None:
                ids = self._edges_of[t] = torch.nonzero(self.e_type == t).flatten()
        src, dst, life = self.e_src[ids], self.e_dst[ids], self.e_life[ids]
        if ep["dir"] == "out":
            return src, dst, life
        if ep["dir"] == "in":
            return dst, src, life
        if ep["dir"] == "both":
            return torch.cat([src, dst]), torch.cat([dst, src]), torch.cat([life, life])
        raise ValueError(f"unknown direction {ep['dir']!r}")

    # ------------------------------------------------------------- ETR sums
    def _etr_reduce(self, op: str, vals: torch.Tensor, a_next, life_next,
                    b, life, kind: str) -> torch.Tensor:
        """For every edge (``b``, ``life``) of a hop: the sum (``kind``
        'sum') or extremum ('min' / 'max') of ``vals`` [E', C] over the next
        hop's edges leaving its ``b`` whose lifespans stand in ``op`` to its
        own.  Histograms per vertex by the next edges' start or end time."""
        if op == "overlaps":
            if kind != "sum":
                raise NotImplementedError("MIN/MAX over an overlaps ETR hop")
            # e.s < e'.e and e'.s < e.e  ==  #(e'.s < e.e) - #(e'.e <= e.s),
            # since e'.e <= e.s < e.e already puts e'.s before e.e
            return (self._etr_reduce("_start_lt_end", vals, a_next, life_next, b, life, kind)
                    - self._etr_reduce("_end_le_start", vals, a_next, life_next, b, life, kind))
        # (key of the next edge, threshold from this edge, the keys wanted)
        key_col, thr_col, want = {
            "fully_before": (0, 1, "ge"),      # e.e <= e'.s
            "starts_before": (0, 0, "gt"),     # e.s <  e'.s
            "fully_after": (1, 0, "le"),       # e.s >= e'.e
            "starts_after": (0, 0, "lt"),      # e.s >  e'.s
            "_start_lt_end": (0, 1, "lt"),     # e'.s < e.e
            "_end_le_start": (1, 0, "le"),     # e'.e <= e.s
        }[op]
        R = self.tvals.shape[0]
        C = vals.shape[1]
        uniq, u_of = torch.unique(a_next, return_inverse=True)
        slot = torch.full((self.g.n_vertices,), -1, dtype=torch.long, device=self.dev)
        slot[uniq] = torch.arange(uniq.shape[0], device=self.dev)
        r = torch.searchsorted(self.tvals, life_next[:, key_col].contiguous())
        cell = u_of * R + r
        nu = uniq.shape[0]
        if kind == "sum":
            H = torch.zeros((nu * R, C), dtype=vals.dtype, device=self.dev)
            H.index_add_(0, cell, vals)
            H = H.reshape(nu, R, C)
            # Ex[u, j] = sum of rows of u with key rank < j, j = 0 .. R
            Ex = torch.zeros((nu, R + 1, C), dtype=vals.dtype, device=self.dev)
            Ex[:, 1:] = torch.cumsum(H, dim=1)
        else:
            neutral = float("inf") if kind == "min" else float("-inf")
            H = torch.full((nu * R, C), neutral, dtype=vals.dtype, device=self.dev)
            H.scatter_reduce_(0, cell[:, None].expand(-1, C), vals,
                              "amin" if kind == "min" else "amax")
            H = H.reshape(nu, R, C)
        x = life[:, thr_col].contiguous()
        j_left = torch.searchsorted(self.tvals, x)                # keys <  x
        j_right = torch.searchsorted(self.tvals, x, right=True)   # keys <= x
        u = slot[b]
        has = u >= 0
        us = u.clamp(min=0)
        if kind == "sum":
            tot = Ex[:, R][us]
            got = {"lt": lambda: Ex[us, j_left], "le": lambda: Ex[us, j_right],
                   "gt": lambda: tot - Ex[us, j_right],
                   "ge": lambda: tot - Ex[us, j_left]}[want]()
            return torch.where(has[:, None], got, torch.zeros_like(got))
        # extremum over a prefix (lt/le) or a suffix (gt/ge) of key ranks
        red = torch.cummin if kind == "min" else torch.cummax
        if want in ("lt", "le"):
            P = torch.cat([torch.full((nu, 1, C), neutral, dtype=vals.dtype,
                                      device=self.dev), red(H, dim=1).values], dim=1)
            got = P[us, j_left if want == "lt" else j_right]
        else:
            Hs = red(H.flip(1), dim=1).values.flip(1)             # over ranks >= j
            P = torch.cat([Hs, torch.full((nu, 1, C), neutral, dtype=vals.dtype,
                                          device=self.dev)], dim=1)
            got = P[us, j_right if want == "gt" else j_left]
        return torch.where(has[:, None], got, torch.full_like(got, neutral))

    # ------------------------------------------------------------ the query
    def run(self, q: dict, mode: str) -> dict:
        """The answers to ``q`` in ``mode``: ``total`` (a number, or one per
        bucket), and for aggregates ``per_vertex`` (paths from each first
        vertex, per bucket in bucket mode) and ``minmax`` ([V] extremum,
        +-inf where a first vertex has no path)."""
        vs, es = q["v"], q["e"]
        n = len(vs)
        chan_v = [self.vertex_channels(vp, mode) for vp in vs]
        hops = [self.hop_edges(ep) for ep in es]
        agg = q.get("agg")
        want_mm = agg in ("min", "max")
        if want_mm and mode == INTERVAL:
            raise ValueError("MIN/MAX aggregates are answered in static or bucket mode")
        if want_mm:
            kind = agg
            neutral = float("inf") if agg == "min" else float("-inf")
            vals, _ = self.vprops[self.g.key_id(q["agg_key"])]
            val = vals[:, 0].to(self.dtype)
            M = torch.where(chan_v[n - 1] > 0, val[:, None], neutral)
        state = chan_v[n - 1]
        S_next = ME_next = None
        for i in reversed(range(n - 1)):
            a, b, life = hops[i]
            ch_e = self.channels(life[:, 0] < life[:, 1], self.cover(life), mode)
            etr = es[i + 1]["etr"] if i + 1 < n - 1 else None
            if etr is not None:
                a_n, _, life_n = hops[i + 1]
                X = self._etr_reduce(etr, S_next, a_n, life_n, b, life, "sum")
                X = X * chan_v[i + 1][b]
            else:
                X = state[b]
            S = ch_e * X
            state = torch.zeros_like(state).index_add_(0, a, S) * chan_v[i]
            if want_mm:
                if etr is not None:
                    Y = self._etr_reduce(etr, ME_next, a_n, life_n, b, life, kind)
                    Y = torch.where(chan_v[i + 1][b] > 0, Y, neutral)
                else:
                    Y = M[b]
                ME = torch.where(ch_e > 0, Y, neutral)
                M = torch.full_like(M, neutral).scatter_reduce_(
                    0, a[:, None].expand(-1, ME.shape[1]), ME,
                    "amin" if agg == "min" else "amax")
                M = torch.where(chan_v[i] > 0, M, neutral)
                ME_next = ME
            S_next = S
        out = {}
        col = state.sum(dim=0)
        if mode == STATIC:
            out["total"] = col[0]
        elif mode == BUCKET:
            out["total"] = col
        else:
            K = self.seg_lo.shape[0]
            out["total"] = col[:K].sum() - col[K:].sum()
        if agg is not None:
            out["per_vertex"] = state[:, 0] if mode == STATIC else state
        if want_mm:
            red = M.amin(dim=1) if agg == "min" else M.amax(dim=1)
            out["minmax"] = red
        return out


def answer(ref: Reference, q: dict, mode: str) -> Dict[str, torch.Tensor]:
    """``Reference.run`` under ``torch.no_grad``."""
    with torch.no_grad():
        return ref.run(q, mode)

