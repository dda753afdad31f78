"""Exact reference oracle for temporal path queries (pure Python/numpy).

Enumerates matching paths explicitly with true interval-list semantics.  Used
by the test-suite to validate the vectorised engine (engine.py) and by the
benchmarks as the "ground truth" result verifier.  Only suitable for small
graphs (explicit DFS).

Semantics mirrored (see engine.py docstring):
  * static mode   — boolean predicate matching, scalar path counts.
  * bucket mode   — per-bucket counts: a path counts at bucket b iff every
    entity on it is valid at b (validity = lifespan ∧ value-specific property
    validity for EQ/CONTAINS clauses).
  * interval mode — distinct temporal paths: one result per (path, maximal
    contiguous window of the running validity intersection).
ETR clauses compare adjacent edge lifespans; temporal aggregation groups by
the first vertex (and bucket, in temporal modes).
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import intervals as iv
from . import query as Q
from .graph import TemporalGraph

Interval = Tuple[int, int]
IList = List[Interval]  # disjoint, sorted


# ------------------------------------------------------------ interval lists
def _norm(ivs: IList) -> IList:
    ivs = sorted((s, e) for s, e in ivs if s < e)
    out: IList = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _ilist_intersect(a: IList, b: IList) -> IList:
    out = []
    for s1, e1 in a:
        for s2, e2 in b:
            s, e = max(s1, s2), min(e1, e2)
            if s < e:
                out.append((s, e))
    return _norm(out)


def _ilist_union(a: IList, b: IList) -> IList:
    return _norm(list(a) + list(b))


def _cmp_interval(op: int, a: Interval, b: Interval) -> bool:
    if a[0] >= a[1] or b[0] >= b[1]:
        return False
    if op == iv.FULLY_BEFORE:
        return a[1] <= b[0]
    if op == iv.STARTS_BEFORE:
        return a[0] < b[0]
    if op == iv.FULLY_AFTER:
        return a[0] >= b[1]
    if op == iv.STARTS_AFTER:
        return a[0] > b[0]
    if op == iv.DURING:
        return a[0] > b[0] and a[1] < b[1]
    if op == iv.EQUALS:
        return a == b
    if op == iv.DURING_EQ:
        return a[0] >= b[0] and a[1] <= b[1]
    if op == iv.OVERLAPS:
        return a[0] < b[1] and b[0] < a[1]
    raise ValueError(op)


# ------------------------------------------------------------- clause eval
class _Entity:
    """A vertex or edge with its properties, for oracle-side predicate eval."""

    __slots__ = ("etype", "life", "props")

    def __init__(self, etype: int, life: Interval, props: Dict[int, List[Tuple[int, Interval]]]):
        self.etype = etype
        self.life = life
        self.props = props  # key -> [(value, validity)]


def _eval_clause(ent: _Entity, c: Q.Clause) -> Tuple[bool, IList]:
    base = [ent.life]
    if c.kind == Q.K_TIME:
        return _cmp_interval(c.cmp, ent.life, tuple(c.interval)), base
    vals = ent.props.get(c.key, [])
    if c.cmp == Q.P_NEQ:
        has = len(vals) > 0
        m = has and all(v != c.value for v, _ in vals)
        return m, base
    matched = [(v, ivl) for v, ivl in vals if v == c.value]
    valid = _norm([ivl for _, ivl in matched])
    return len(matched) > 0, (valid if valid else [])


def _eval_predicate(ent: _Entity, req_type: int, clauses: Sequence[Q.Clause]):
    """Returns (match, validity ilist)."""
    if ent.life[0] >= ent.life[1]:
        return False, []
    if req_type >= 0 and ent.etype != req_type:
        return False, []
    validity: IList = [ent.life]
    if not clauses:
        return True, validity
    acc_m: Optional[bool] = None
    acc_v: IList = []
    for c in clauses:
        m, v = _eval_clause(ent, c)
        if acc_m is None:
            acc_m, acc_v = m, v
        elif c.conj == Q.AND:
            acc_m = acc_m and m
            acc_v = _ilist_intersect(acc_v, v)
        else:
            if acc_m and not m:
                pass
            elif m and not acc_m:
                acc_v = v
            else:
                acc_v = _ilist_union(acc_v, v)
            acc_m = acc_m or m
    return bool(acc_m), _ilist_intersect(validity, acc_v)


# --------------------------------------------------------------- the oracle
class RefEngine:
    def __init__(self, graph: TemporalGraph, max_expansions: int = 5_000_000):
        self.g = graph
        self.max_expansions = max_expansions
        self._adj_out: Dict[int, List[int]] = defaultdict(list)
        self._adj_in: Dict[int, List[int]] = defaultdict(list)
        for e in range(graph.n_edges):
            self._adj_out[int(graph.e_src[e])].append(e)
            self._adj_in[int(graph.e_dst[e])].append(e)
        self._vcache: Dict[int, _Entity] = {}
        self._ecache: Dict[int, _Entity] = {}

    # ---- entity views
    def vertex(self, vid: int) -> _Entity:
        ent = self._vcache.get(vid)
        if ent is None:
            props = {}
            for k, col in self.g.vprops.items():
                lst = []
                for s in range(col.n_slots):
                    v = int(col.vals[vid, s])
                    if v >= 0:
                        lst.append((v, (int(col.life[vid, s, 0]), int(col.life[vid, s, 1]))))
                if lst:
                    props[k] = lst
            ent = _Entity(int(self.g.v_type[vid]),
                          (int(self.g.v_life[vid, 0]), int(self.g.v_life[vid, 1])), props)
            self._vcache[vid] = ent
        return ent

    def edge(self, eid: int) -> _Entity:
        ent = self._ecache.get(eid)
        if ent is None:
            props = {}
            for k, col in self.g.eprops.items():
                lst = []
                for s in range(col.n_slots):
                    v = int(col.vals[eid, s])
                    if v >= 0:
                        lst.append((v, (int(col.life[eid, s, 0]), int(col.life[eid, s, 1]))))
                if lst:
                    props[k] = lst
            ent = _Entity(int(self.g.e_type[eid]),
                          (int(self.g.e_life[eid, 0]), int(self.g.e_life[eid, 1])), props)
            self._ecache[eid] = ent
        return ent

    def _neighbors(self, vid: int, direction: int):
        """Yield (edge_id, neighbor_vid) honoring hop direction."""
        if direction in (Q.DIR_OUT, Q.DIR_BOTH):
            for e in self._adj_out[vid]:
                yield e, int(self.g.e_dst[e])
        if direction in (Q.DIR_IN, Q.DIR_BOTH):
            for e in self._adj_in[vid]:
                yield e, int(self.g.e_src[e])

    # ---- enumeration
    def enumerate_paths(self, qry: Q.PathQuery):
        """Yield (path_vertices, path_edges, validity_ilist) for every match.

        validity is the running intersection of entity validities (interval
        mode semantics); static-mode callers ignore it.
        """
        n = qry.n_vertices
        expansions = 0
        for v0 in range(self.g.n_vertices):
            m, val = _eval_predicate(self.vertex(v0), qry.v_preds[0].vtype, qry.v_preds[0].clauses)
            if not m:
                continue
            stack = [([v0], [], val)]
            while stack:
                vs, es, run_val = stack.pop()
                hop = len(es)
                if hop == n - 1:
                    yield vs, es, run_val
                    continue
                ep = qry.e_preds[hop]
                vp_next = qry.v_preds[hop + 1]
                for eid, nxt in self._neighbors(vs[-1], ep.direction):
                    expansions += 1
                    if expansions > self.max_expansions:
                        raise RuntimeError("oracle expansion budget exceeded")
                    em, ev = _eval_predicate(self.edge(eid), ep.etype, ep.clauses)
                    if not em:
                        continue
                    if ep.etr_op != -1:
                        left = self.edge(es[-1]).life
                        right = self.edge(eid).life
                        if not _cmp_interval(ep.etr_op, left, right):
                            continue
                    vm, vv = _eval_predicate(self.vertex(nxt), vp_next.vtype, vp_next.clauses)
                    if not vm:
                        continue
                    nv = _ilist_intersect(_ilist_intersect(run_val, ev), vv)
                    stack.append((vs + [nxt], es + [eid], nv))

    # ---- counting, per mode
    def count(self, qry: Q.PathQuery, mode: int = 0, n_buckets: int = 16):
        from .engine import MODE_BUCKET, MODE_INTERVAL, MODE_STATIC

        if mode == MODE_STATIC:
            return float(sum(1 for _ in self.enumerate_paths(qry)))
        edges = iv.bucket_edges(self.g.lifespan[0], self.g.lifespan[1], n_buckets)
        if mode == MODE_BUCKET:
            out = np.zeros(n_buckets)
            for _, _, val in self.enumerate_paths(qry):
                for b in range(n_buckets):
                    blo, bhi = int(edges[b]), int(edges[b + 1])
                    if any(s < bhi and blo < e for s, e in val):
                        out[b] += 1
            return out
        if mode == MODE_INTERVAL:
            total = 0
            for _, _, val in self.enumerate_paths(qry):
                total += len(val)  # one result per maximal window
            return float(total)
        raise ValueError(mode)

    def aggregate(self, qry: Q.PathQuery, mode: int = 0, n_buckets: int = 16):
        """Temporal aggregation: group by first vertex (× bucket in temporal
        modes); returns dict v0 -> value (static) or array [V, B] (bucket)."""
        from .engine import MODE_BUCKET, MODE_STATIC

        assert qry.agg_op != Q.AGG_NONE
        if mode == MODE_STATIC:
            groups: Dict[int, List[float]] = defaultdict(list)
            for vs, _, _ in self.enumerate_paths(qry):
                last = vs[-1]
                if qry.agg_op == Q.AGG_COUNT:
                    groups[vs[0]].append(1.0)
                else:
                    col = self.g.vprops[qry.agg_key]
                    groups[vs[0]].append(float(col.vals[last, 0]))
            out = {}
            for v0, lst in groups.items():
                if qry.agg_op == Q.AGG_COUNT:
                    out[v0] = float(len(lst))
                elif qry.agg_op == Q.AGG_MIN:
                    out[v0] = min(lst)
                else:
                    out[v0] = max(lst)
            return out
        assert mode == MODE_BUCKET and qry.agg_op == Q.AGG_COUNT
        edges = iv.bucket_edges(self.g.lifespan[0], self.g.lifespan[1], n_buckets)
        out = np.zeros((self.g.n_vertices, n_buckets))
        for vs, _, val in self.enumerate_paths(qry):
            for b in range(n_buckets):
                blo, bhi = int(edges[b]), int(edges[b + 1])
                if any(s < bhi and blo < e for s, e in val):
                    out[vs[0], b] += 1
        return out
