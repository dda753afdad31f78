"""AdamW with warmup-stable-decay (WSD, MiniCPM) and cosine schedules.

The counterpart of the reference's ``training/optimizer.py``, op for op: the
moments are float32 whatever the parameters' dtype, the update is computed
in float32 and rounded back to each parameter's dtype, the step counter is
an int32 tensor, and every expression keeps the reference's order of
operations, so that on the same inputs the two agree to float32 rounding
(``pow`` and ``cos`` may differ by an ulp).  Not ``torch.optim.AdamW``: it
applies the weight decay before the moment step and folds the bias
correction into the step size, which rounds differently.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from . import tree as T


@dataclasses.dataclass(frozen=True)
class OptCfg:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0
    schedule: str = "cosine"       # 'const' | 'cosine' | 'wsd'
    warmup_steps: int = 100
    total_steps: int = 10_000
    wsd_decay_frac: float = 0.1    # MiniCPM: final 10% exponential-ish decay
    min_lr_frac: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: OptCfg, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a float32
    0-dim tensor on the step's device."""
    s = step.float() if torch.is_tensor(step) else torch.tensor(float(step))
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    if cfg.schedule == "const":
        post = 1.0
    elif cfg.schedule == "cosine":
        t = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        post = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        decay_start = cfg.total_steps * (1.0 - cfg.wsd_decay_frac)
        t = torch.clamp((s - decay_start) / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
        # stable plateau, then fast decay to min_lr (MiniCPM Sec. 4)
        post = torch.where(s < decay_start, _f32(1.0, s), cfg.min_lr_frac ** t)
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * post


def init_state(params) -> Dict:
    """Zero float32 moments shaped like ``params`` and an int32 step 0."""
    ps = T.leaves(params)
    dev = ps[0].device if ps else torch.device("cpu")
    zeros = lambda: T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), params)
    return dict(mu=zeros(), nu=zeros(), step=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in T.leaves(tree)))


def apply_updates(cfg: OptCfg, params, grads, state, inplace: bool = False
                  ) -> Tuple[Any, Dict, Dict]:
    """One AdamW step: (new params, new state, dict(lr, grad_norm)).  With
    ``inplace`` the parameters and moments are overwritten and returned (the
    reference's donated buffers); the arithmetic is the same."""
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm is not None:
        scale = torch.clamp_max(_f32(cfg.clip_norm, gnorm) / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1 - b1 ** step.float()
    bc2 = 1 - b2 ** step.float()

    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(state["mu"]),
                          T.leaves(state["nu"])):
        # the clip's product is float32 (a bf16 gradient times a float32 scale)
        gf = g.float() * scale if scale is not None else g.to(torch.float32, copy=True)
        if not inplace:
            m, v = m.clone(), v.clone()
        m.mul_(b1).add_(gf * (1 - b1))                       # b1 m + (1 - b1) g
        v.mul_(b2).add_(gf.square_().mul_(1 - b2))           # b2 v + (1 - b2) g^2
        del gf
        u = m / bc1
        u.div_((v / bc2).sqrt_().add_(cfg.eps))              # (m/bc1) / (sqrt(v/bc2) + eps)
        pf = p.float()
        u.add_(pf * cfg.weight_decay).mul_(lr)               # lr (u + wd p)
        u = torch.sub(pf, u, out=u)                          # p - lr u
        if inplace:
            p.copy_(u)
            new_p.append(p)
        else:
            new_p.append(u.to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return (T.unflatten(params, new_p),
            dict(mu=T.unflatten(state["mu"], new_m), nu=T.unflatten(state["nu"], new_v),
                 step=step),
            dict(lr=lr, grad_norm=gnorm))
