"""MeshGraphNet [arXiv:2010.03409]. 15 layers, d_hidden 128, sum agg, 2-layer MLPs.

``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses
from functools import partial

from ..models.gnn import MGNCfg
from . import common
from .common import GNN_SHAPES

CONFIG = MGNCfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="meshgraphnet", family="gnn-mpnn",
        shapes={name: partial(common.gnn_cell, "meshgraphnet", CONFIG, name)
                for name in GNN_SHAPES}, skip={},
        smoke=lambda device=None: common.gnn_smoke("meshgraphnet", CONFIG, device=device),
        meta={},
    )
