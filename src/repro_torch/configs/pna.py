"""PNA — Principal Neighbourhood Aggregation [arXiv:2004.05718].

4 layers, d_hidden 75, aggregators mean/max/min/std, scalers id/amp/atten.
``SMOKE`` keeps every width and cuts the depth to 2 layers.
"""
import dataclasses

from ..models.gnn import PNACfg
from .common import GNN_SHAPES

CONFIG = PNACfg()
SMOKE = dataclasses.replace(CONFIG, n_layers=2)
SHAPES = GNN_SHAPES
