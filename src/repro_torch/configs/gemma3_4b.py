"""Gemma-3 4B — 5:1 local:global attention, 262k vocab [hf:google/gemma-3].

34L, d_model 2560, 8 heads (kv=4), d_head 256, d_ff 10240.  Sliding window
1024 on local layers; every 6th layer is global.  long_500k runs (local
layers are sub-quadratic; decode against the long cache).  ``SMOKE`` is the
reference's reduced variant (6 layers, width 64, float32, window 8).
"""
import dataclasses
from functools import partial

import torch

from ..models import transformer as tr
from . import common

CONFIG = tr.TransformerCfg(
    name="gemma3-4b",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab=262144, rope_theta=1_000_000.0, dtype=torch.bfloat16,
    sliding_window=1024, global_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=512, dtype=torch.float32, sliding_window=8, global_every=3,
)


def get_arch() -> common.ArchSpec:
    return common.ArchSpec(
        arch_id="gemma3-4b", family="lm-dense-swa",
        shapes={name: partial(common.lm_cell, CONFIG, name)
                for name in ("train_4k", "prefill_32k", "decode_32k", "long_500k")},
        skip={}, smoke=lambda device=None: common.lm_smoke(SMOKE, device=device),
        meta=dict(params=CONFIG.param_count()),
    )
