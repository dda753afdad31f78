"""EGNN — E(n)-equivariant GNN [arXiv:2102.09844]. 4 layers, d_hidden 64.

``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses

from ..models.gnn import EGNNCfg
from .common import GNN_SHAPES

CONFIG = EGNNCfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES
