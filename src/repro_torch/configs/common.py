"""Shared machinery of the port's architecture configurations: ``ArchSpec``,
the shapes of the LM and GNN families, and the reduced-config smoke kits.

The port's counterpart of the reference's ``configs/common.py``.  An
``ArchSpec`` has the reference's fields: an architecture's id, family,
shape names, skipped shapes with their reasons, a smoke check and ``meta``
(parameter counts, the ``OptCfg`` it trains with).  The reference's shape
cells lower a step on the production mesh for its dry run; the port's come
with its dry-run slice (``ROADMAP.md`` §A.2), so each ``shapes[name]`` of
the port raises ``NotImplementedError`` until then.

A smoke check runs a reduced config end to end on ``device`` (None: the
card) and returns the reference's keys: ``ok``, and ``loss`` (and the LMs'
``logits_shape``) where the reference has them.  Its seeds are
``torch.Generator``s, so its numbers are the port's own, not the
reference's.

``pad512`` is the reference's padding of node and edge counts for its
512-way sharded dry runs; the port runs on one card and keeps the counts as
they are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models import gnn as gnn_mod
from ..models import transformer as tr

Device = Optional[Union[str, torch.device]]

#: where the shape cells come from
DRYRUN_SLICE = ("the dry-run slice of ROADMAP.md §A.2 (shape cells with param_specs and "
                "cache_specs, launch/mesh.py, roofline/analysis.py, launch/dryrun.py)")


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str
    shapes: Dict[str, Callable]       # shape name → its cell (the dry-run slice)
    skip: Dict[str, str]              # shape name → reason
    smoke: Callable[..., dict]        # reduced config end to end: smoke(device=None)
    meta: Dict[str, Any]


def pending_cells(arch_id: str, names: Iterable[str]) -> Dict[str, Callable]:
    """{shape name: a callable that raises ``NotImplementedError``}: the
    shape cells of ``arch_id`` that wait for the dry-run slice."""
    def pending(name: str) -> Callable:
        def cell(*args, **kwargs):
            raise NotImplementedError(f"{arch_id} shape {name!r}: shape cells come with "
                                      f"{DRYRUN_SLICE}")
        return cell

    return {name: pending(name) for name in names}


# ===================================================================== LM
LM_SHAPES = dict(
    train_4k=dict(seq=4096, batch=256, kind="train"),
    prefill_32k=dict(seq=32768, batch=32, kind="prefill"),
    decode_32k=dict(seq=32768, batch=128, kind="decode"),
    long_500k=dict(seq=524288, batch=1, kind="decode"),
)


def lm_smoke(cfg_small: tr.TransformerCfg, device: Device = None) -> dict:
    """The reference's LM smoke: parameters from seed 0, tokens [2, 16] from
    seed 1; ``forward``, ``loss_fn`` and one ``decode_step`` from an empty
    cache of 32 rows, all finite.  The config says whether the MLP is a
    mixture of experts."""
    dev = resolve_device(device)
    with torch.no_grad():
        p = tr.init_params(cfg_small, torch.Generator().manual_seed(0), device=dev)
        toks = torch.randint(0, cfg_small.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1)).to(dev)
        logits = tr.forward(cfg_small, p, toks)
        loss = tr.loss_fn(cfg_small, p, {"tokens": toks, "labels": toks})
        cache = tr.init_cache(cfg_small, 2, 32, device=dev)
        lg, cache = tr.decode_step(cfg_small, p, cache, toks[:, 0], 1)
    ok = bool(torch.isfinite(logits).all() and torch.isfinite(loss) and torch.isfinite(lg).all())
    return dict(ok=ok, loss=float(loss), logits_shape=tuple(logits.shape))


# ===================================================================== GNN
def pad512(n: int) -> int:
    """The reference's dry-run padding to a multiple of 512 devices."""
    return -(-n // 512) * 512


GNN_SHAPES = dict(
    full_graph_sm=dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="train"),
    minibatch_lg=dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                      fanout=(15, 10), d_feat=602, kind="train_sampled"),
    ogb_products=dict(n_nodes=2449029, n_edges=61859140, d_feat=100, kind="train"),
    molecule=dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, kind="train"),
)


def gnn_smoke(arch: str, cfg, device: Device = None) -> dict:
    """The reference's GNN smoke: a random graph of 40 nodes, 120 edges, 8
    features and 4 graphs (numpy seed 0), parameters from seed 0, the loss
    finite."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    N, E, F = 40, 120, 8
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)
    with torch.no_grad():
        g = gnn_mod.GraphBatch(
            node_feat=t(rng.normal(size=(N, F)), torch.float32),
            edge_src=t(rng.integers(0, N, E), torch.int32),
            edge_dst=t(rng.integers(0, N, E), torch.int32),
            coords=t(rng.normal(size=(N, 3)), torch.float32),
            graph_of=t(rng.integers(0, 4, N), torch.int32), n_graphs=4,
            targets=t(rng.normal(size=(N, 1)), torch.float32),
        )
        params = gnn_mod.INIT[arch](cfg, torch.Generator().manual_seed(0), F, device=dev)
        loss = gnn_mod.gnn_loss(arch, cfg, params, g)
    return dict(ok=bool(torch.isfinite(loss)), loss=float(loss))
