"""Temporal path query model (Sec. 3.3 of the paper).

An n-hop linear chain query = n vertex predicates + (n-1) edge predicates.
Predicates are property clauses / time clauses combined with AND/OR, plus the
novel edge-temporal-relationship (ETR) clause and an optional temporal
aggregation operator.

The query *structure* (clause kinds, keys, comparators, hop count,
directions, ETR ops) decides which tensor program runs, and the query
*parameters* are data (property values and interval constants), so the 100
instances of an LDBC template stack into one batch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from . import intervals as iv

# ----------------------------------------------------------------- constants
# clause kinds
K_PROP = 1
K_TIME = 2

# property comparators
P_EQ = 0
P_NEQ = 1
P_CONTAINS = 2  # '∋' membership over multi-valued keys

PROP_CMP_NAMES = {"==": P_EQ, "!=": P_NEQ, "in": P_CONTAINS}

# Boolean connectives
AND = 0
OR = 1

# edge directions
DIR_OUT = 0   # →
DIR_IN = 1    # ←
DIR_BOTH = 2  # ↔

# ETR ops (edge-lifespan vs edge-lifespan) — exact fast path subset
ETR_OPS = (
    iv.FULLY_BEFORE,
    iv.STARTS_BEFORE,
    iv.FULLY_AFTER,
    iv.STARTS_AFTER,
    iv.OVERLAPS,
)

# aggregation
AGG_NONE = -1
AGG_COUNT = 0
AGG_MIN = 1
AGG_MAX = 2
AGG_NAMES = {"count": AGG_COUNT, "min": AGG_MIN, "max": AGG_MAX}


# ----------------------------------------------------------------- AST types
@dataclasses.dataclass(frozen=True)
class Clause:
    kind: int                       # K_PROP | K_TIME
    conj: int = AND                 # connective to the running accumulator
    key: int = -1                   # property key id       (K_PROP)
    cmp: int = P_EQ                 # P_* or interval cmp id (K_TIME)
    value: int = -1                 # dict-encoded value     (K_PROP, data)
    interval: Tuple[int, int] = (0, 0)  # constant interval  (K_TIME, data)

    def shape_key(self):
        return (self.kind, self.conj, self.key, self.cmp)


def prop_clause(key: int, cmp: str, value: int, conj: int = AND) -> Clause:
    return Clause(kind=K_PROP, conj=conj, key=key, cmp=PROP_CMP_NAMES[cmp], value=value)


def time_clause(cmp: str, interval: Tuple[int, int], conj: int = AND) -> Clause:
    return Clause(
        kind=K_TIME, conj=conj, cmp=iv.TIME_CMP_NAMES[cmp], interval=tuple(interval)
    )


@dataclasses.dataclass(frozen=True)
class VertexPredicate:
    vtype: int = -1                       # -1 = wildcard
    clauses: Tuple[Clause, ...] = ()

    def shape_key(self):
        return (self.vtype, tuple(c.shape_key() for c in self.clauses))


@dataclasses.dataclass(frozen=True)
class EdgePredicate:
    etype: int = -1
    direction: int = DIR_OUT
    clauses: Tuple[Clause, ...] = ()
    etr_op: int = -1                      # -1 = no ETR clause on this hop

    def shape_key(self):
        return (
            self.etype,
            self.direction,
            tuple(c.shape_key() for c in self.clauses),
            self.etr_op,
        )


@dataclasses.dataclass(frozen=True)
class PathQuery:
    v_preds: Tuple[VertexPredicate, ...]
    e_preds: Tuple[EdgePredicate, ...]
    agg_op: int = AGG_NONE
    agg_key: int = -1                     # property at last vertex (min/max)

    def __post_init__(self):
        assert len(self.v_preds) == len(self.e_preds) + 1, "n vertex preds, n-1 edge preds"
        if self.e_preds and self.e_preds[0].etr_op != -1:
            raise ValueError("ETR needs a left edge; first hop cannot carry one")
        for e in self.e_preds:
            if e.etr_op != -1 and e.etr_op not in ETR_OPS:
                raise ValueError(f"unsupported ETR op {e.etr_op} (exact set: {ETR_OPS})")

    @property
    def n_hops(self) -> int:
        return len(self.e_preds)

    @property
    def n_vertices(self) -> int:
        return len(self.v_preds)

    def shape_key(self):
        """Hashable structure — the engine's batching key."""
        return (
            tuple(v.shape_key() for v in self.v_preds),
            tuple(e.shape_key() for e in self.e_preds),
            self.agg_op,
            self.agg_key,
        )

    # ------------------------------------------------------------- plan data
    def reversed(self) -> "PathQuery":
        """The same query traversed right-to-left (directions flipped).

        ETR note: an ETR clause on ``e_preds[i]`` constrains the *pair*
        ``(e_{i-1}, e_i)``.  Under reversal, the pair ``(e_k, e_{k+1})`` is
        checked while processing ``e_k`` (whose predecessor in execution
        order is ``e_{k+1}``), so ETR ops shift by one position.  The engine
        evaluates shifted ops with the *backward* comparator specs.
        """
        flip = {DIR_OUT: DIR_IN, DIR_IN: DIR_OUT, DIR_BOTH: DIR_BOTH}
        m = len(self.e_preds)
        v = tuple(reversed(self.v_preds))
        e = []
        for j, pred in enumerate(reversed(self.e_preds)):
            etr = -1 if j == 0 else self.e_preds[m - j].etr_op
            e.append(
                dataclasses.replace(pred, direction=flip[pred.direction], etr_op=etr)
            )
        return PathQuery(v, tuple(e), self.agg_op, self.agg_key)


# --------------------------------------------------------------- parameters
def query_params(q: PathQuery) -> np.ndarray:
    """Pack the data-dependent parameters into one int32[n_clauses, 3] array.

    Row layout: [value, t_lo, t_hi].  Order: vertex preds then edge preds,
    clauses in declaration order.  Matches `iter_clauses`.
    """
    rows = []
    for c in iter_clauses(q):
        rows.append((c.value, c.interval[0], c.interval[1]))
    if not rows:
        rows = [(0, 0, 0)]
    return np.asarray(rows, np.int32)


def iter_clauses(q: PathQuery):
    for v in q.v_preds:
        yield from v.clauses
    for e in q.e_preds:
        yield from e.clauses


# ------------------------------------------------------------- pretty print
_DIR_STR = {DIR_OUT: "→", DIR_IN: "←", DIR_BOTH: "↔"}


def format_query(q: PathQuery) -> str:
    parts = []
    for i, v in enumerate(q.v_preds):
        parts.append(f"V{i}(type={v.vtype},{len(v.clauses)}c)")
        if i < q.n_hops:
            e = q.e_preds[i]
            etr = f",ETR{e.etr_op}" if e.etr_op != -1 else ""
            parts.append(f"-E{i}(type={e.etype}{etr}){_DIR_STR[e.direction]}")
    if q.agg_op != AGG_NONE:
        parts.append(f" ⊕agg{q.agg_op}[{q.agg_key}]")
    return "".join(parts)
