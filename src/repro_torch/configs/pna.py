"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

4 layers, d_hidden 75, aggregators mean/max/min/std, scalers id/amp/atten.
``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses
from functools import partial

from ..models.gnn import PNACfg
from . import common
from .common import GNN_SHAPES

CONFIG = PNACfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="pna", family="gnn-spmm",
        shapes={name: partial(common.gnn_cell, "pna", CONFIG, name)
                for name in GNN_SHAPES}, skip={},
        smoke=lambda device=None: common.gnn_smoke("pna", CONFIG, device=device),
        meta={},
    )
