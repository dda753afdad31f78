"""Carry the reference package's data into the port without importing it.

Both functions read plain attributes and dictionaries (duck typing), so a
test can hand the port exactly the graph and queries the reference package
runs on:

  graph_from_arrays(g)   a ``TemporalGraph`` from any object with the
                         reference graph's field names
  query_from_dict(d)     a ``PathQuery`` from ``dataclasses.asdict`` of a
                         reference query
"""
from __future__ import annotations

from typing import Mapping

import numpy as np

from .core import query as Q
from .core.graph import PropColumn, TemporalGraph
from .graphdata.loader import GraphBuilder


def _column(c) -> PropColumn:
    if hasattr(c, "vals"):
        return PropColumn(np.asarray(c.vals, np.int32), np.asarray(c.life, np.int32))
    vals, life = c
    return PropColumn(np.asarray(vals, np.int32), np.asarray(life, np.int32))


def builder_from_meta(meta: Mapping) -> GraphBuilder:
    """A ``GraphBuilder`` holding the dictionaries a graph's ``meta`` records
    (what ``make_workload`` reads through ``meta['builder']``)."""
    b = GraphBuilder()
    b.v_type_ids = dict(meta.get("v_type_ids", {}))
    b.e_type_ids = dict(meta.get("e_type_ids", {}))
    b.key_ids = dict(meta.get("key_ids", {}))
    b.key_ordered = {int(k): bool(v) for k, v in meta.get("key_ordered", {}).items()}
    b.value_dicts = {int(k): dict(d) for k, d in meta.get("value_dicts", {}).items()}
    return b


def graph_from_arrays(g) -> TemporalGraph:
    """The port's ``TemporalGraph`` from an object with the reference graph's
    fields (``v_type``, ``v_life``, ``e_src``, ``e_dst``, ``e_type``,
    ``e_life``, ``vprops``/``eprops`` as ``{key: column}`` where a column has
    ``vals``/``life`` or is a ``(vals, life)`` pair, ``n_vertex_types``,
    ``n_edge_types``, ``lifespan``; ``meta`` is optional)."""
    src_meta = getattr(g, "meta", None) or {}
    meta = {k: v for k, v in src_meta.items()
            if k in ("v_type_ids", "e_type_ids", "key_ids", "key_ordered",
                     "value_dicts", "params")}
    out = TemporalGraph(
        np.asarray(g.v_type), np.asarray(g.v_life), np.asarray(g.e_src),
        np.asarray(g.e_dst), np.asarray(g.e_type), np.asarray(g.e_life),
        {int(k): _column(c) for k, c in g.vprops.items()},
        {int(k): _column(c) for k, c in g.eprops.items()},
        g.n_vertex_types, g.n_edge_types, tuple(g.lifespan), meta=meta,
    )
    if "key_ids" in meta:
        out.meta["builder"] = builder_from_meta(meta)
    return out


def _clause(d: Mapping) -> Q.Clause:
    return Q.Clause(kind=int(d["kind"]), conj=int(d["conj"]), key=int(d["key"]),
                    cmp=int(d["cmp"]), value=int(d["value"]),
                    interval=tuple(int(x) for x in d["interval"]))


def query_from_dict(d: Mapping) -> Q.PathQuery:
    """The port's ``PathQuery`` from ``dataclasses.asdict(reference_query)``."""
    v = tuple(Q.VertexPredicate(int(p["vtype"]), tuple(_clause(c) for c in p["clauses"]))
              for p in d["v_preds"])
    e = tuple(Q.EdgePredicate(int(p["etype"]), int(p["direction"]),
                              tuple(_clause(c) for c in p["clauses"]), int(p["etr_op"]))
              for p in d["e_preds"])
    return Q.PathQuery(v, e, int(d["agg_op"]), int(d["agg_key"]))
