"""End-to-end training driver: synthetic data → train step (loss, gradient,
AdamW) → periodic async checkpoints → resume.

The counterpart of the reference's ``launch/train.py``; it prints the
reference's lines.  ``--arch`` selects an LM config (``minicpm-2b``,
``llama3-405b``); its ``SMOKE`` variant unless ``--full``.  Runs on the card
unless ``--device cpu``; with no GPU and no ``--device cpu`` it raises.

    python -m repro_torch.launch.train --arch minicpm-2b [--full] --steps N \\
        --batch B --seq S --microbatches M --ckpt-dir D [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import time
from pathlib import Path
from typing import Optional, Union

import numpy as np
import torch

from ..kernels.common import resolve_device

DEFAULT_CKPT = str(Path(__file__).resolve().parents[3] / "build" / "train_ckpt")


def synthetic_lm_batches(vocab: int, batch: int, seq: int, n: int, seed=0,
                         device: Optional[Union[str, torch.device]] = None) -> list:
    """Deterministic synthetic LM data stream (zipf-ish token dist): the
    reference's draws from ``np.random.default_rng(seed)``, token for token,
    as int32 tensors on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = (rng.zipf(1.3, size=(batch, seq + 1)) % vocab).astype(np.int32)
        out.append(dict(tokens=torch.from_numpy(toks[:, :-1].copy()).to(dev),
                        labels=torch.from_numpy(toks[:, 1:].copy()).to(dev)))
    return out


def train(arch_id: str = "minicpm-2b", steps: int = 50, smoke: bool = True,
          ckpt_dir: str = DEFAULT_CKPT, batch: int = 4, seq: int = 64,
          microbatches: int = 1, resume: bool = True, seed: int = 0,
          device: Optional[Union[str, torch.device]] = None) -> list:
    from ..models import transformer as tr
    from ..training import checkpoint as ckpt
    from ..training.optimizer import OptCfg, init_state
    from ..training.train_loop import make_train_step

    dev = resolve_device(device)
    mod = importlib.import_module(f"repro_torch.configs.{arch_id.replace('-', '_')}")
    cfg = mod.SMOKE if smoke else mod.CONFIG
    opt_cfg = mod.get_arch().meta.get("opt", OptCfg())
    opt_cfg = dataclasses.replace(opt_cfg, total_steps=steps, warmup_steps=max(1, steps // 10))

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = tr.init_params(cfg, gen, device=dev)
    opt_state = init_state(params)
    # in place (the reference's donated buffers; it donates nothing here
    # because its async save reads the arrays later, where the port's
    # save_async copies them to the host before it returns)
    step_fn = make_train_step(lambda p, b: tr.loss_fn(cfg, p, b), opt_cfg,
                              microbatches=microbatches, donate=True)
    start = 0
    if resume and ckpt.latest_step(ckpt_dir) is not None:
        (params, opt_state), start = ckpt.restore((params, opt_state), ckpt_dir, device=dev)
        print(f"resumed from step {start}")
    batches = synthetic_lm_batches(cfg.vocab, batch, seq, steps, device=dev)
    losses = []
    t0 = time.time()
    for i in range(start, steps):
        params, opt_state, m = step_fn(params, opt_state, batches[i])
        losses.append(float(m["loss"]))
        if (i + 1) % 10 == 0:
            ckpt.save_async((params, opt_state), i + 1, ckpt_dir)
            print(f"step {i+1}: loss={losses[-1]:.4f} lr={float(m['lr']):.2e} "
                  f"({(time.time()-t0)/(i+1-start)*1e3:.0f} ms/step)")
    ckpt.wait_pending()
    ckpt.save((params, opt_state), steps, ckpt_dir)
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="minicpm-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true", help="full (non-smoke) config")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train(args.arch, steps=args.steps, smoke=not args.full,
          ckpt_dir=args.ckpt_dir, batch=args.batch, seq=args.seq,
          microbatches=args.microbatches, device=args.device)


if __name__ == "__main__":
    main()
