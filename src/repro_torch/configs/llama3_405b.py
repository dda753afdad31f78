"""Llama-3 405B — dense GQA transformer [arXiv:2407.21783].

126L, d_model 16384, 128 heads (GQA kv=8), d_ff 53248, vocab 128256.
``CONFIG`` is configuration only: 405 B parameters do not fit one card.
``SMOKE`` is the reference's reduced variant (2 layers, width 64, GQA 8:2,
float32).
"""
import dataclasses

import torch

from ..models import transformer as tr
from ..training.optimizer import OptCfg
from . import common

CONFIG = tr.TransformerCfg(
    name="llama3-405b",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, d_head=128,
    d_ff=53248, vocab=128256, rope_theta=500000.0, dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=160, vocab=512, dtype=torch.float32,
)


def get_arch() -> common.ArchMeta:
    return common.ArchMeta(
        arch_id="llama3-405b", family="lm-dense",
        meta=dict(params=CONFIG.param_count(), opt=OptCfg(schedule="cosine")),
    )
