"""DLRM RM2 [arXiv:1906.00091] — 13 dense + 26 sparse features, embed 64,
bot MLP 13-512-256-64, top MLP 512-512-256-1, dot interaction.

Shapes: train 65536 / serve_p99 512 / serve_bulk 262144 / retrieval 1×1M.
``SMOKE`` keeps every width and cuts each table to 512 rows.
"""
import dataclasses

from ..models import dlrm as dm

CONFIG = dm.DLRMCfg()
SMOKE = dataclasses.replace(CONFIG, vocab_sizes=[512] * 26)

SHAPES = dict(
    train_batch=dict(batch=65536, kind="train"),
    serve_p99=dict(batch=512, kind="serve"),
    serve_bulk=dict(batch=262144, kind="serve"),
    retrieval_cand=dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
)
