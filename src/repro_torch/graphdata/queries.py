"""LDBC-derived temporal path query workload (paper Table 5, Q1–Q8).

Each template mirrors the corresponding paper query's shape: hop count,
number of property/time predicates, ETR presence, and (for Q8) dependence on
a dynamic property.  Parameters (underlined values in the paper) are sampled
per instance from the graph's value dictionaries, frequency-weighted so most
instances have non-empty result sets (the paper's workload generator does the
same).  The aggregate workload wraps templates with the count operator.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..core import intervals as iv
from ..core import query as Q
from .ldbc import T_HORIZON

TEMPLATES = ("Q1", "Q2", "Q3", "Q4", "Q5", "Q6", "Q7", "Q8")
DYNAMIC_ONLY = ("Q8",)


@dataclasses.dataclass
class QueryInstance:
    template: str
    qry: Q.PathQuery
    params: dict


class _Schema:
    """Resolved ids for the generated LDBC schema."""

    def __init__(self, graph):
        b = graph.meta["builder"]
        self.b = b
        self.vt = b.v_type_ids
        self.et = b.e_type_ids
        self.k = b.key_ids

    def val(self, key_name: str, value) -> int:
        return self.b.lookup_value(self.k[key_name], value)


def _freq_values(graph, key_name: str, top_frac: float = 0.6) -> List[int]:
    """Value ids for a key, restricted to the most frequent ones."""
    b = graph.meta["builder"]
    k = b.key_ids[key_name]
    col = graph.vprops.get(k)
    if col is None:
        return []
    vals = col.vals.reshape(-1)
    vals = vals[vals >= 0]
    uniq, cnts = np.unique(vals, return_counts=True)
    order = np.argsort(-cnts)
    keep = max(1, int(len(uniq) * top_frac))
    return [int(v) for v in uniq[order[:keep]]]


def _interval(rng, align=16):
    step = -(-T_HORIZON // align)
    lo = int(rng.integers(0, T_HORIZON // 2) // step * step)
    return (lo, T_HORIZON)


# ------------------------------------------------------------ the templates
def _q1(s: _Schema, rng, pools) -> QueryInstance:
    tagx = int(rng.choice(pools["tag"]))
    tagy = int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    ivl = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["post"], (Q.prop_clause(s.k["tag"], "in", tagx),)),
            Q.VertexPredicate(s.vt["forum"], (Q.time_clause("overlaps", ivl),)),
            Q.VertexPredicate(s.vt["post"], (Q.prop_clause(s.k["tag"], "in", tagy),)),
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["country"], "==", cty),)),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["containerOf"], Q.DIR_IN),
            Q.EdgePredicate(s.et["containerOf"], Q.DIR_OUT, etr_op=iv.STARTS_BEFORE),
            Q.EdgePredicate(s.et["hasMember"], Q.DIR_IN),
        ),
    )
    return QueryInstance("Q1", qry, dict(tagx=tagx, tagy=tagy, country=cty, ivl=ivl))


def _q2(s: _Schema, rng, pools) -> QueryInstance:
    tag = int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    g = s.val("gender", "f")
    ivl = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(
                s.vt["person"],
                (Q.prop_clause(s.k["country"], "==", cty),
                 Q.prop_clause(s.k["gender"], "==", g, conj=Q.OR)),
            ),
            Q.VertexPredicate(
                s.vt["post"],
                (Q.prop_clause(s.k["tag"], "in", tag),
                 Q.time_clause(">", ivl, conj=Q.AND)),
            ),
            Q.VertexPredicate(
                s.vt["person"], (Q.prop_clause(s.k["hasInterest"], "in", tag),)
            ),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["created"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["likes"], Q.DIR_IN),
        ),
    )
    return QueryInstance("Q2", qry, dict(tag=tag, country=cty, ivl=ivl))


def _q3(s: _Schema, rng, pools) -> QueryInstance:
    c1 = int(rng.choice(pools["country"]))
    c2 = int(rng.choice(pools["country"]))
    ivl = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["country"], "==", c1),)),
            Q.VertexPredicate(s.vt["post"], (Q.time_clause("overlaps", ivl),)),
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["country"], "==", c2),)),
            Q.VertexPredicate(s.vt["person"]),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["likes"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["likes"], Q.DIR_IN, etr_op=iv.FULLY_BEFORE),
            Q.EdgePredicate(s.et["follows"], Q.DIR_OUT),
        ),
    )
    return QueryInstance("Q3", qry, dict(c1=c1, c2=c2, ivl=ivl))


def _q4(s: _Schema, rng, pools) -> QueryInstance:
    c1 = int(rng.choice(pools["country"]))
    ivl1 = _interval(rng)
    ivl2 = _interval(rng)
    person = s.vt["person"]
    fo = s.et["follows"]
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(person, (Q.prop_clause(s.k["country"], "==", c1),)),
            Q.VertexPredicate(person, (Q.time_clause("overlaps", ivl1),)),
            Q.VertexPredicate(person),
            Q.VertexPredicate(person, (Q.time_clause("overlaps", ivl2),)),
            Q.VertexPredicate(person),
        ),
        e_preds=(
            Q.EdgePredicate(fo, Q.DIR_OUT),
            Q.EdgePredicate(fo, Q.DIR_OUT, etr_op=iv.STARTS_BEFORE),
            Q.EdgePredicate(fo, Q.DIR_OUT, etr_op=iv.STARTS_BEFORE),
            Q.EdgePredicate(fo, Q.DIR_OUT),
        ),
    )
    return QueryInstance("Q4", qry, dict(c1=c1, ivl1=ivl1, ivl2=ivl2))


def _q5(s: _Schema, rng, pools) -> QueryInstance:
    tagx = int(rng.choice(pools["tag"]))
    tagy = int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    g = s.val("gender", "m")
    ivl = _interval(rng)
    ivl2 = _interval(rng)
    ivl3 = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["country"], "==", cty),)),
            Q.VertexPredicate(s.vt["post"],
                              (Q.prop_clause(s.k["tag"], "in", tagx),
                               Q.time_clause("overlaps", ivl, conj=Q.AND))),
            Q.VertexPredicate(s.vt["forum"], (Q.time_clause("overlaps", ivl2),)),
            Q.VertexPredicate(s.vt["post"],
                              (Q.prop_clause(s.k["tag"], "in", tagy),
                               Q.time_clause(">", ivl3, conj=Q.AND))),
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["gender"], "==", g),)),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["created"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["containerOf"], Q.DIR_IN),
            Q.EdgePredicate(s.et["containerOf"], Q.DIR_OUT, etr_op=iv.FULLY_AFTER),
            Q.EdgePredicate(s.et["created"], Q.DIR_IN),
        ),
    )
    return QueryInstance("Q5", qry, dict(tagx=tagx, tagy=tagy, country=cty))


def _q6(s: _Schema, rng, pools) -> QueryInstance:
    g = s.val("gender", "f")
    tag = int(rng.choice(pools["tag"]))
    ivl = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["gender"], "==", g),)),
            Q.VertexPredicate(s.vt["comment"]),
            Q.VertexPredicate(s.vt["post"],
                              (Q.prop_clause(s.k["tag"], "in", tag),
                               Q.time_clause("overlaps", ivl, conj=Q.AND))),
            Q.VertexPredicate(s.vt["comment"]),
            Q.VertexPredicate(s.vt["person"]),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["created"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["replyOf"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["replyOf"], Q.DIR_IN, etr_op=iv.FULLY_AFTER),
            Q.EdgePredicate(s.et["created"], Q.DIR_IN),
        ),
    )
    return QueryInstance("Q6", qry, dict(gender=g, tag=tag))


def _q7(s: _Schema, rng, pools) -> QueryInstance:
    c1 = int(rng.choice(pools["country"]))
    c2 = int(rng.choice(pools["country"]))
    lang = s.val("language", "en")
    ivl = _interval(rng)
    ivl2 = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["post"],
                              (Q.prop_clause(s.k["language"], "==", lang),
                               Q.time_clause("overlaps", ivl, conj=Q.AND))),
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["country"], "==", c1),)),
            Q.VertexPredicate(s.vt["person"],
                              (Q.prop_clause(s.k["country"], "==", c2),
                               Q.time_clause("overlaps", ivl2, conj=Q.AND))),
            Q.VertexPredicate(s.vt["post"]),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["created"], Q.DIR_IN),
            Q.EdgePredicate(s.et["follows"], Q.DIR_OUT, etr_op=iv.STARTS_AFTER),
            Q.EdgePredicate(s.et["created"], Q.DIR_OUT, etr_op=iv.STARTS_BEFORE),
        ),
    )
    return QueryInstance("Q7", qry, dict(c1=c1, c2=c2))


def _q8(s: _Schema, rng, pools) -> QueryInstance:
    w1 = int(rng.choice(pools["worksAt"]))
    w2 = int(rng.choice(pools["worksAt"]))
    ivl = _interval(rng)
    qry = Q.PathQuery(
        v_preds=(
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["worksAt"], "==", w1),)),
            Q.VertexPredicate(s.vt["person"], (Q.time_clause("overlaps", ivl),)),
            Q.VertexPredicate(s.vt["person"], (Q.prop_clause(s.k["worksAt"], "==", w2),)),
        ),
        e_preds=(
            Q.EdgePredicate(s.et["follows"], Q.DIR_OUT),
            Q.EdgePredicate(s.et["follows"], Q.DIR_IN, etr_op=iv.OVERLAPS),
        ),
    )
    return QueryInstance("Q8", qry, dict(w1=w1, w2=w2))


_BUILDERS: Dict[str, Callable] = {
    "Q1": _q1, "Q2": _q2, "Q3": _q3, "Q4": _q4,
    "Q5": _q5, "Q6": _q6, "Q7": _q7, "Q8": _q8,
}


def to_minmax(inst: QueryInstance, graph, op: int = Q.AGG_MIN) -> QueryInstance:
    """MIN/MAX variant of a plain instance, aggregating the post ``length``
    property (the same construction as the reference package's)."""
    b = graph.meta["builder"]
    tag = "min" if op == Q.AGG_MIN else "max"
    return dataclasses.replace(
        inst, template=f"{inst.template}-{tag}",
        qry=dataclasses.replace(inst.qry, agg_op=op,
                                agg_key=b.key_ids["length"]))


def make_workload(
    graph,
    templates: Sequence[str] = TEMPLATES,
    n_per_template: int = 100,
    seed: int = 0,
    aggregate: bool = False,
    rng: Optional[np.random.Generator] = None,
) -> List[QueryInstance]:
    """Generate the benchmark workload for a graph.

    Instance parameters are drawn from ``rng`` when given, else from a fresh
    ``default_rng(seed)`` — the same (graph, templates, n_per_template, seed)
    always yields the identical workload."""
    s = _Schema(graph)
    if rng is None:
        rng = np.random.default_rng(seed)
    dynamic = bool(graph.meta.get("params", {}).get("dynamic", False))
    pools = {
        "tag": _freq_values(graph, "tag") or [0],
        "country": _freq_values(graph, "country") or [0],
        "worksAt": _freq_values(graph, "worksAt") or [0],
    }
    out: List[QueryInstance] = []
    for name in templates:
        if name in DYNAMIC_ONLY and not dynamic:
            continue
        fn = _BUILDERS[name]
        for _ in range(n_per_template):
            inst = fn(s, rng, pools)
            if aggregate:
                inst = QueryInstance(
                    inst.template,
                    dataclasses.replace(inst.qry, agg_op=Q.AGG_COUNT),
                    inst.params,
                )
            out.append(inst)
    return out
