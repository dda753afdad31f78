"""DLRM RM2 [arXiv:1906.00091] — 13 dense + 26 sparse features, embed 64,
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.

Shapes: train 65536 / serve_p99 512 / serve_bulk 262144 / retrieval 1×1M.
``SMOKE`` keeps every width and cuts each table to 512 rows.
"""
import dataclasses

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..models import dlrm as dm
from . import common

CONFIG = dm.DLRMCfg()
SMOKE = dataclasses.replace(CONFIG, vocab_sizes=[512] * 26)

SHAPES = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve"),
    serve_bulk=dict(batch=262144, kind="serve"),
    retrieval_cand=dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
)


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
        arch_id="dlrm-rm2", family="recsys", shapes=common.pending_cells("dlrm-rm2", SHAPES),
        skip={}, smoke=_smoke, meta=dict(params=CONFIG.param_count()),
    )
