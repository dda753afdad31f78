"""Shapes shared by the GNN configurations (the port's copy of the
reference's ``configs/common.py::GNN_SHAPES``) and ``ArchMeta``, the part of
the reference's ``ArchSpec`` the port has so far: an architecture's id,
family and ``meta`` (its parameter count and the ``OptCfg`` it trains
with).  ``ArchSpec``'s shape cells wait for the dry-run slice.

The reference pads node and edge counts to a multiple of 512 (``pad512``)
for its 512-way sharded dry runs; the port runs on one card, so it keeps the
counts as they are.
"""
import dataclasses
from typing import Any, Dict


@dataclasses.dataclass(frozen=True)
class ArchMeta:
    arch_id: str
    family: str
    meta: Dict[str, Any]


GNN_SHAPES = dict(
    full_graph_sm=dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="train"),
    minibatch_lg=dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                      fanout=(15, 10), d_feat=602, kind="train_sampled"),
    ogb_products=dict(n_nodes=2449029, n_edges=61859140, d_feat=100, kind="train"),
    molecule=dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, kind="train"),
)
