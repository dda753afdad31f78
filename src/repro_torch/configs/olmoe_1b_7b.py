"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060; hf].

16L, d_model 2048, 16 heads (kv=16, i.e. MHA), d_head 128, per-expert d_ff
1024, vocab 50304, tied embeddings: 6,816,073,728 parameters, 1,178,929,152
active a token.  ``SMOKE`` is the reference's reduced variant (2 layers,
width 64, 8 experts top-2, float32).
"""
import dataclasses
from functools import partial

import torch

from ..models import transformer as tr
from . import common

CONFIG = tr.TransformerCfg(
    name="olmoe-1b-7b",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_head=128,
    d_ff=1024, vocab=50304, rope_theta=10000.0, dtype=torch.bfloat16,
    moe=tr.MoECfg(n_experts=64, top_k=8, d_ff=1024),
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_head=16,
    d_ff=64, vocab=512, dtype=torch.float32,
    moe=tr.MoECfg(n_experts=8, top_k=2, d_ff=64),
)


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="olmoe-1b-7b", family="lm-moe",
        shapes={name: partial(common.lm_cell, CONFIG, name)
                for name in ("train_4k", "prefill_32k", "decode_32k")},
        skip={"long_500k": "pure full attention (assignment rule)"},
        smoke=lambda device=None: common.lm_smoke(SMOKE, device=device),
        meta=dict(params=CONFIG.param_count(), active_params=CONFIG.active_param_count()),
    )
