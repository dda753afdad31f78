"""MiniCPM-2B — llama-like dense with the WSD schedule [arXiv:2404.06395; hf].

40L, d_model 2304, 36 heads (kv=36, i.e. MHA), d_ff 5760, vocab 122753,
tied embeddings: 2,724,880,896 parameters.  ``SMOKE`` is the reference's
reduced variant (2 layers, width 72, float32).
"""
import dataclasses
from functools import partial

import torch

from ..models import transformer as tr
from ..training.optimizer import OptCfg
from . import common

CONFIG = tr.TransformerCfg(
    name="minicpm-2b",
    n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, d_head=64,
    d_ff=5760, vocab=122753, rope_theta=10000.0, dtype=torch.bfloat16,
)

SMOKE = dataclasses.replace(
    CONFIG, n_layers=2, d_model=72, n_heads=6, n_kv_heads=6, d_head=12,
    d_ff=180, vocab=512, dtype=torch.float32,
)


def get_arch() -> common.ArchSpec:
    shapes = {"train_4k": partial(common.lm_cell, CONFIG, "train_4k",
                                  opt_cfg=OptCfg(schedule="wsd", total_steps=10_000))}
    shapes.update({name: partial(common.lm_cell, CONFIG, name)
                   for name in ("prefill_32k", "decode_32k")})
    return common.ArchSpec(
        arch_id="minicpm-2b", family="lm-dense",
        shapes=shapes,
        skip={"long_500k": "pure full attention (assignment rule)"},
        # SMOKE's d_head 12 has no attention kernel (they take 16 to 256):
        # the smoke's attention is the plain version, on either device
        smoke=lambda device=None: common.lm_smoke(dataclasses.replace(SMOKE, impl="torch"),
                                                  device=device),
        meta=dict(params=CONFIG.param_count(),
                  opt=OptCfg(schedule="wsd", total_steps=10_000)),
    )
