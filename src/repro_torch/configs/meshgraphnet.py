"""MeshGraphNet [arXiv:2010.03409]. 15 layers, d_hidden 128, sum agg, 2-layer MLPs.

``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses

from ..models.gnn import MGNCfg
from .common import GNN_SHAPES

CONFIG = MGNCfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES
