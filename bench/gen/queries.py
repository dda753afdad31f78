"""LDBC-derived temporal path queries Q1-Q8 (Granite, Table 5), as plain data.

A frozen copy of the port's ``graphdata/queries`` builders and ``to_minmax``,
repaired where the copy could never match on this schema.  Each template
keeps the paper query's shape: hop count, property and time predicates, ETR
clauses and, for Q8, a dynamic property.  Parameters are drawn per instance
from the graph's most frequent values, so most instances match.  The repairs:

* Q1's last hop walks ``created`` into the second post (its author), not
  ``hasMember``, which joins forums to persons and never reaches a post;
* Q3, Q5 and Q6 order their ETR pair by start (``starts_before`` /
  ``starts_after``): likes, containerOf and replyOf edges never end, so the
  copy's ``fully_before`` / ``fully_after`` held on no path;
* MIN/MAX take the last vertex's own ordered key (a person's ``birthday``,
  a message's ``length``): a person has no ``length``.

A query is a plain dict that both sides read: the harness lowers it to the
program's query objects and the reference interprets it itself::

    {"template": "Q2",
     "v": [{"type": "person", "clauses": [clause, ...]}, ...],   # n vertices
     "e": [{"type": "created", "dir": "out", "etr": None}, ...],  # n - 1 hops
     "agg": None | "min" | "max", "agg_key": None | "length" | "birthday"}

A clause is ``["prop", conj, key, cmp, value]`` (cmp ``==``, ``!=`` or
``in``) or ``["time", conj, cmp, lo, hi]`` (cmp an Allen comparator name:
``<<``, ``<``, ``>>``, ``>``, ``overlaps``, ...); ``conj`` is ``and`` or
``or`` and joins the clause to those before it.  ``etr`` names the relation
between the previous hop's edge lifespan and this hop's: ``fully_before``,
``starts_before``, ``fully_after``, ``starts_after`` or ``overlaps``.
"""
from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np

from .ldbc import T_HORIZON, VALUE_IDS, GraphData

TEMPLATES = ("Q1", "Q2", "Q3", "Q4", "Q5", "Q6", "Q7", "Q8")
DYNAMIC_ONLY = ("Q8",)


def _v(vtype: str, *clauses) -> dict:
    return {"type": vtype, "clauses": [list(c) for c in clauses]}


def _e(etype: str, direction: str, etr=None) -> dict:
    return {"type": etype, "dir": direction, "etr": etr}


def prop(key: str, cmp: str, value: int, conj: str = "and") -> list:
    return ["prop", conj, key, cmp, int(value)]


def time(cmp: str, ivl, conj: str = "and") -> list:
    return ["time", conj, cmp, int(ivl[0]), int(ivl[1])]


def freq_values(g: GraphData, key: str, top_frac: float = 0.6) -> List[int]:
    """Value ids of a vertex key, the most frequent ``top_frac`` of them."""
    vals = g.vprops[g.key_id(key)][0].reshape(-1)
    vals = vals[vals >= 0]
    if vals.size == 0:
        return [0]
    uniq, cnts = np.unique(vals, return_counts=True)
    order = np.argsort(-cnts, kind="stable")
    keep = max(1, int(len(uniq) * top_frac))
    return [int(v) for v in uniq[order[:keep]]]


def _interval(rng, align: int = 16):
    step = -(-T_HORIZON // align)
    lo = int(rng.integers(0, T_HORIZON // 2) // step * step)
    return (lo, T_HORIZON)


def _q1(rng, pools):
    tagx, tagy = int(rng.choice(pools["tag"])), int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    ivl = _interval(rng)
    return ([_v("post", prop("tag", "in", tagx)),
             _v("forum", time("overlaps", ivl)),
             _v("post", prop("tag", "in", tagy)),
             _v("person", prop("country", "==", cty))],
            [_e("containerOf", "in"),
             _e("containerOf", "out", "starts_before"),
             _e("created", "in")])


def _q2(rng, pools):
    tag = int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    ivl = _interval(rng)
    return ([_v("person", prop("country", "==", cty),
                prop("gender", "==", VALUE_IDS["gender"]["f"], "or")),
             _v("post", prop("tag", "in", tag), time(">", ivl)),
             _v("person", prop("hasInterest", "in", tag))],
            [_e("created", "out"), _e("likes", "in")])


def _q3(rng, pools):
    c1, c2 = int(rng.choice(pools["country"])), int(rng.choice(pools["country"]))
    ivl = _interval(rng)
    return ([_v("person", prop("country", "==", c1)),
             _v("post", time("overlaps", ivl)),
             _v("person", prop("country", "==", c2)),
             _v("person")],
            [_e("likes", "out"), _e("likes", "in", "starts_before"),
             _e("follows", "out")])


def _q4(rng, pools):
    c1 = int(rng.choice(pools["country"]))
    ivl1, ivl2 = _interval(rng), _interval(rng)
    return ([_v("person", prop("country", "==", c1)),
             _v("person", time("overlaps", ivl1)),
             _v("person"),
             _v("person", time("overlaps", ivl2)),
             _v("person")],
            [_e("follows", "out"), _e("follows", "out", "starts_before"),
             _e("follows", "out", "starts_before"), _e("follows", "out")])


def _q5(rng, pools):
    tagx, tagy = int(rng.choice(pools["tag"])), int(rng.choice(pools["tag"]))
    cty = int(rng.choice(pools["country"]))
    ivl, ivl2, ivl3 = _interval(rng), _interval(rng), _interval(rng)
    return ([_v("person", prop("country", "==", cty)),
             _v("post", prop("tag", "in", tagx), time("overlaps", ivl)),
             _v("forum", time("overlaps", ivl2)),
             _v("post", prop("tag", "in", tagy), time(">", ivl3)),
             _v("person", prop("gender", "==", VALUE_IDS["gender"]["m"]))],
            [_e("created", "out"), _e("containerOf", "in"),
             _e("containerOf", "out", "starts_after"), _e("created", "in")])


def _q6(rng, pools):
    tag = int(rng.choice(pools["tag"]))
    ivl = _interval(rng)
    return ([_v("person", prop("gender", "==", VALUE_IDS["gender"]["f"])),
             _v("comment"),
             _v("post", prop("tag", "in", tag), time("overlaps", ivl)),
             _v("comment"),
             _v("person")],
            [_e("created", "out"), _e("replyOf", "out"),
             _e("replyOf", "in", "starts_after"), _e("created", "in")])


def _q7(rng, pools):
    c1, c2 = int(rng.choice(pools["country"])), int(rng.choice(pools["country"]))
    ivl, ivl2 = _interval(rng), _interval(rng)
    return ([_v("post", prop("language", "==", VALUE_IDS["language"]["en"]),
                time("overlaps", ivl)),
             _v("person", prop("country", "==", c1)),
             _v("person", prop("country", "==", c2), time("overlaps", ivl2)),
             _v("post")],
            [_e("created", "in"), _e("follows", "out", "starts_after"),
             _e("created", "out", "starts_before")])


def _q8(rng, pools):
    w1, w2 = int(rng.choice(pools["worksAt"])), int(rng.choice(pools["worksAt"]))
    ivl = _interval(rng)
    return ([_v("person", prop("worksAt", "==", w1)),
             _v("person", time("overlaps", ivl)),
             _v("person", prop("worksAt", "==", w2))],
            [_e("follows", "out"), _e("follows", "in", "overlaps")])


BUILDERS = {"Q1": _q1, "Q2": _q2, "Q3": _q3, "Q4": _q4,
            "Q5": _q5, "Q6": _q6, "Q7": _q7, "Q8": _q8}


def pools(g: GraphData) -> Dict[str, List[int]]:
    return {k: freq_values(g, k) for k in ("tag", "country", "worksAt")}


def build(template: str, rng, pool: Dict[str, List[int]]) -> dict:
    """One instance of ``template``: a base template (``Q1`` .. ``Q8``) or
    its MIN/MAX variant (``Q2-min``, ``Q2-max``), parameters from ``rng``."""
    base, _, agg = template.partition("-")
    v, e = BUILDERS[base](rng, pool)
    q = {"template": base, "v": v, "e": e, "agg": None, "agg_key": None}
    return to_minmax(q, agg) if agg else q


#: the ordered key a vertex type has, which MIN/MAX reads at the last vertex
AGG_KEYS = {"person": "birthday", "post": "length", "comment": "length"}


def to_minmax(q: dict, op: str = "min") -> dict:
    """The MIN/MAX variant of a plain instance: the extremum of the last
    vertex's ordered key (``AGG_KEYS``) over the paths from each first
    vertex."""
    if op not in ("min", "max"):
        raise ValueError(f"aggregate must be min or max, got {op!r}")
    out = copy.deepcopy(q)
    out.update(template=f"{q['template']}-{op}", agg=op,
               agg_key=AGG_KEYS[q["v"][-1]["type"]])
    return out
