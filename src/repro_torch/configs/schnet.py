"""SchNet [arXiv:1706.08566]. 3 interactions, d_hidden 64, 300 RBF, cutoff 10.

``SMOKE`` keeps every width and cuts the depth to 2 interactions.
"""
import dataclasses
from functools import partial

from ..models.gnn import SchNetCfg
from . import common
from .common import GNN_SHAPES

CONFIG = SchNetCfg()
SMOKE = dataclasses.replace(CONFIG, n_interactions=2)
SHAPES = GNN_SHAPES


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="schnet", family="gnn-molecular",
        shapes={name: partial(common.gnn_cell, "schnet", CONFIG, name)
                for name in GNN_SHAPES}, skip={},
        smoke=lambda device=None: common.gnn_smoke("schnet", CONFIG, device=device),
        meta={},
    )
