"""EGNN — E(n)-equivariant GNN [arXiv:2102.09844]. 4 layers, d_hidden 64.

``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses
from functools import partial

from ..models.gnn import EGNNCfg
from . import common
from .common import GNN_SHAPES

CONFIG = EGNNCfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="egnn", family="gnn-equivariant",
        shapes={name: partial(common.gnn_cell, "egnn", CONFIG, name)
                for name in GNN_SHAPES}, skip={},
        smoke=lambda device=None: common.gnn_smoke("egnn", CONFIG, device=device),
        meta={},
    )
