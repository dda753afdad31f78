"""Carry the reference package's data into the port without importing it.

Every function reads plain attributes, dictionaries and numpy arrays (duck
typing), so a test can hand the port exactly the graph, queries and model
parameters the reference package runs on:

  graph_from_arrays(g)   a ``TemporalGraph`` from any object with the
                         reference graph's field names
  query_from_dict(d)     a ``PathQuery`` from ``dataclasses.asdict`` of a
                         reference query
  transformer_params_from_arrays(cfg, tree)
  dlrm_params_from_arrays(cfg, tree)
                         the port's model parameters from the reference's
                         parameter tree as numpy arrays (same layout, so no
                         transpose; cast to ``cfg.dtype``)
  gnn_params_from_arrays(arch, tree)
                         the same for a GNN of ``models/gnn.py`` (float32)
  optimizer_state_from_arrays(tree)
                         the port's AdamW state (``training/optimizer.py``)
                         from the reference's ``init_state`` /
                         ``apply_updates`` state as numpy arrays: float32
                         moments, an int32 step
  optimizer_state_to_arrays(state)
                         its inverse, numpy arrays in the reference's tree
"""
from __future__ import annotations

from typing import Mapping, Optional, Union

import numpy as np
import torch

from .core import query as Q
from .core.graph import PropColumn, TemporalGraph
from .graphdata.loader import GraphBuilder
from .kernels.common import resolve_device
from .training.tree import tree_map


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


def _tensor(a, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    # via float32: numpy has no bfloat16 that torch reads, and bf16 -> f32 -> bf16 is exact
    return torch.from_numpy(np.array(a, np.float32)).to(device=dev, dtype=dtype)


def transformer_params_from_arrays(cfg, tree: Mapping,
                                   device: Optional[Union[str, torch.device]] = None):
    """The port's transformer parameters (``models/transformer.py``) from the
    reference's ``init_params`` tree (``embed``, ``ln_f``, ``layers``,
    optional ``head``) as numpy arrays."""
    dev = resolve_device(device)
    out = dict(embed=_tensor(tree["embed"], cfg.dtype, dev),
               ln_f=_tensor(tree["ln_f"], cfg.dtype, dev),
               layers={k: _tensor(v, cfg.dtype, dev) for k, v in tree["layers"].items()})
    if "head" in tree:
        out["head"] = _tensor(tree["head"], cfg.dtype, dev)
    return out


def dlrm_params_from_arrays(cfg, tree: Mapping,
                            device: Optional[Union[str, torch.device]] = None):
    """The port's DLRM parameters (``models/dlrm.py``) from the reference's
    ``init_params`` tree (``tables``, ``bot``, ``top``) as numpy arrays."""
    dev = resolve_device(device)
    mlp = lambda layers: [dict(w=_tensor(ly["w"], cfg.dtype, dev), b=_tensor(ly["b"], cfg.dtype, dev))
                          for ly in layers]
    return dict(tables=[_tensor(t, cfg.dtype, dev) for t in tree["tables"]],
                bot=mlp(tree["bot"]), top=mlp(tree["top"]))


_GNN_KEYS = {
    "pna": {"encoder", "layers", "decoder"},
    "egnn": {"encoder", "layers", "decoder"},
    "meshgraphnet": {"node_enc", "edge_enc", "layers", "decoder"},
    "schnet": {"encoder", "interactions", "decoder"},
}


def gnn_params_from_arrays(arch: str, tree: Mapping,
                           device: Optional[Union[str, torch.device]] = None):
    """The port's parameters of GNN ``arch`` (``models/gnn.py``) from the
    reference's ``INIT[arch]`` tree as numpy arrays: nested dicts and lists
    of arrays (``{w, b}`` layers, MeshGraphNet's ``ln_e``/``ln_n``), the
    same structure with float32 tensors."""
    if arch not in _GNN_KEYS:
        raise ValueError(f"unknown GNN {arch!r}")
    if set(tree) != _GNN_KEYS[arch]:
        raise ValueError(f"{arch}: parameter tree has {sorted(tree)}, "
                         f"want {sorted(_GNN_KEYS[arch])}")
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, Mapping):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return _tensor(t, torch.float32, dev)

    return conv(tree)


def optimizer_state_from_arrays(tree: Mapping,
                                device: Optional[Union[str, torch.device]] = None):
    """The port's AdamW state from the reference's ``dict(mu, nu, step)``
    as numpy arrays: ``mu`` and ``nu`` trees of float32 tensors (the
    parameters' structure), ``step`` an int32 0-dim tensor."""
    if set(tree) != {"mu", "nu", "step"}:
        raise ValueError(f"optimizer state has {sorted(tree)}, want ['mu', 'nu', 'step']")
    dev = resolve_device(device)
    moments = lambda t: tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dev), t)
    return dict(mu=moments(tree["mu"]), nu=moments(tree["nu"]),
                step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32, device=dev))


def optimizer_state_to_arrays(state: Mapping) -> dict:
    """``optimizer_state_from_arrays``'s inverse: numpy arrays (float32
    moments, an int32 0-dim step) in the reference's tree."""
    host = lambda t: tree_map(lambda x: x.detach().cpu().numpy(), t)
    return dict(mu=host(state["mu"]), nu=host(state["nu"]),
                step=np.asarray(int(state["step"]), np.int32))
