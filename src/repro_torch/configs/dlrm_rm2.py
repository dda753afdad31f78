"""DLRM RM2 [arXiv:1906.00091] — 13 dense + 26 sparse features, embed 64,
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.

Shapes: train 65536 / serve_p99 512 / serve_bulk 262144 / retrieval 1×1M.
``SMOKE`` keeps every width and cuts each table to 512 rows.  The train
cell's gradient runs the plain lookup (``impl='torch'``); the serve and
retrieval cells take the kernel (B8), as the port serves.
"""
import dataclasses
from functools import partial

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models import dlrm as dm
from ..training.optimizer import OptCfg, init_state
from . import common
from .common import P

CONFIG = dm.DLRMCfg()
SMOKE = dataclasses.replace(CONFIG, vocab_sizes=[512] * 26)

SHAPES = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve"),
    serve_bulk=dict(batch=262144, kind="serve"),
    retrieval_cand=dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
)


def _cell(shape_name: str, mesh) -> common.ShapeCell:
    info = SHAPES[shape_name]
    dp = common.data_axes_of(mesh)
    pspecs = dm.param_specs(CONFIG, mesh)
    params = dm.init_shapes(CONFIG)
    B = info["batch"]
    dense = common.sds((B, CONFIG.n_dense), torch.float32)
    sparse = common.sds((B, CONFIG.n_sparse, CONFIG.multi_hot), torch.int32)

    if info["kind"] == "train":
        cfg = dataclasses.replace(CONFIG, impl="torch")
        opt_cfg = OptCfg(lr=1e-3, weight_decay=0.0)
        opt_state = init_state(params)
        opt_specs = dict(mu=pspecs, nu=pspecs, step=P())

        def step(params, opt_state, batch):
            new_p, new_s, loss, m = common._train_update(
                lambda p, b: dm.loss_fn(cfg, p, b), opt_cfg, params, opt_state, batch)
            return new_p, new_s, dict(loss=loss, **m)

        batch = dict(dense=dense, sparse=sparse, label=common.sds((B,), torch.float32))
        bspec = dict(dense=P(dp, None), sparse=P(dp, None, None), label=P(dp))
        out_specs = (pspecs, opt_specs, dict(loss=P(), lr=P(), grad_norm=P()))
        return common.ShapeCell(step, (params, opt_state, batch), (pspecs, opt_specs, bspec),
                                out_specs, "train")

    if info["kind"] == "serve":
        def serve(params, dense, sparse):
            return dm.serve_score(CONFIG, params, dense, sparse)

        return common.ShapeCell(serve, (params, dense, sparse),
                                (pspecs, P(dp, None), P(dp, None, None)),
                                P(dp) if B > 1 else P(), "serve")

    # retrieval: 1 query vs 1M candidate embeddings (padded to 512 multiple)
    N = common.pad512(info["n_candidates"])
    all_ax = tuple(mesh.axis_names)

    def retrieve(params, dense, sparse, cand):
        return dm.retrieval_score(CONFIG, params, dense, sparse, cand, top_k=128)

    return common.ShapeCell(retrieve,
                            (params, dense, sparse,
                             common.sds((N, CONFIG.embed_dim), torch.float32)),
                            (pspecs, P(None, None), P(None, None, None), P(all_ax, None)),
                            (P(), P()), "serve", note="retrieval top-k")


def _smoke(device=None) -> dict:
    """The reference's DLRM smoke: SMOKE's parameters from seed 0, a batch
    of 16 (dense features, one index a table, labels; numpy seed 0), the
    loss finite."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    B = 16
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)
    batch = dict(dense=t(rng.normal(size=(B, 13)), torch.float32),
                 sparse=t(rng.integers(0, 512, (B, 26, 1)), torch.int32),
                 label=t(rng.integers(0, 2, B), torch.float32))
    with torch.no_grad():
        p = dm.init_params(SMOKE, torch.Generator().manual_seed(0), device=dev)
        loss = dm.loss_fn(SMOKE, p, batch)
    return dict(ok=bool(torch.isfinite(loss)), loss=float(loss))


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="dlrm-rm2", family="recsys", shapes={name: partial(_cell, name) for name in SHAPES},
        skip={}, smoke=_smoke, meta=dict(params=CONFIG.param_count()),
    )
