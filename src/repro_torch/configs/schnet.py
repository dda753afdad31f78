"""SchNet [arXiv:1706.08566]. 3 interactions, d_hidden 64, 300 RBF, cutoff 10.

``SMOKE`` keeps every width and cuts the depth to 2 interactions.
"""
import dataclasses

from ..models.gnn import SchNetCfg
from .common import GNN_SHAPES

CONFIG = SchNetCfg()
SMOKE = dataclasses.replace(CONFIG, n_interactions=2)
SHAPES = GNN_SHAPES
