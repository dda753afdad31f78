"""Mixtral-8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].

56L, d_model 6144, 48 heads (GQA kv=8), d_head 128, per-expert d_ff 16384,
vocab 32768, window 4096 (long_500k runs: rolling-window attention is
sub-quadratic).  ``CONFIG`` is configuration only: its
140,428,744,704 parameters (281 GB in bf16) do not fit one card.  ``SMOKE`` is the
reference's reduced variant (2 layers, width 64, GQA 8:2, 4 experts top-2,
window 8, float32).
"""
import dataclasses
from functools import partial

import torch

from ..models import transformer as tr
from . import common

CONFIG = tr.TransformerCfg(
    name="mixtral-8x22b",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_head=128,
    d_ff=16384, vocab=32768, rope_theta=1_000_000.0, dtype=torch.bfloat16,
    moe=tr.MoECfg(n_experts=8, top_k=2, d_ff=16384),
    sliding_window=4096,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_head=8,
    d_ff=96, vocab=512, dtype=torch.float32,
    moe=tr.MoECfg(n_experts=4, top_k=2, d_ff=96), sliding_window=8,
)


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="mixtral-8x22b", family="lm-moe-swa",
        shapes={name: partial(common.lm_cell, CONFIG, name)
                for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k")},
        skip={},
        # SMOKE's d_head 8 has no attention kernel (they take 16 to 256):
        # the smoke's attention is the plain version, on either device
        smoke=lambda device=None: common.lm_smoke(dataclasses.replace(SMOKE, impl="torch"),
                                                  device=device),
        meta=dict(params=CONFIG.param_count(), active_params=CONFIG.active_param_count()),
    )
