"""Shared layers: RMS and layer norm, rotary embedding, dense init, the
MLP stack and the token cross-entropy.

The counterparts of the reference's ``models/layers.py`` (no sharding
helpers: the port runs on one card).  Weights keep the reference's
``[in, out]`` layout (``x @ w + b``), so parameters carried across by
``interop.py`` need no transpose.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.common import resolve_device


# -------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Mean square in float32, the normalised value rounded back to
    ``x.dtype`` before the scale, as the reference does."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * w


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Mean and (biased) variance in float32, the normalised value rounded
    back to ``x.dtype`` before the affine, as the reference does."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


# -------------------------------------------------------------------- rotary
def rope_freqs(d_head: int, theta: float = 10000.0) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2) / d_head))


@functools.lru_cache(maxsize=None)
def _freqs(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory on every call would make
    # the host wait for the card at every layer
    return torch.as_tensor(rope_freqs(d_head, theta), dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [..., S, D]; positions [..., S] (absolute).  Interleaved pairs
    (x[0::2], x[1::2]) rotate by position × frequency, in float32."""
    d = x.shape[-1]
    freqs = _freqs(d, float(theta), x.device)
    ang = positions[..., None].float() * freqs                  # [..., S, D/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., 0::2].float(), x[..., 1::2].float()
    out = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------- init
def dense_init(generator: torch.Generator, shape: Sequence[int], fan_in: int,
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None) -> torch.Tensor:
    """Normal(0, 1) · fan_in^-1/2 drawn in float32 on the generator's device,
    then cast to ``dtype`` on ``device``."""
    t = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (t * fan_in ** -0.5).to(device=resolve_device(device), dtype=dtype)


def mlp_params(generator: torch.Generator, sizes: Sequence[int],
               dtype: torch.dtype = torch.float32,
               device: Optional[Union[str, torch.device]] = None) -> List[Dict]:
    dev = resolve_device(device)
    return [dict(w=dense_init(generator, (sizes[i], sizes[i + 1]), sizes[i], dtype, dev),
                 b=torch.zeros(sizes[i + 1], dtype=dtype, device=dev))
            for i in range(len(sizes) - 1)]


def mlp_apply(params: List[Dict], x: torch.Tensor,
              act: Callable[[torch.Tensor], torch.Tensor] = F.relu,
              final_act: bool = False) -> torch.Tensor:
    for i, lyr in enumerate(params):
        x = x @ lyr["w"] + lyr["b"]
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Token-mean cross-entropy of ``logits`` [..., V] against integer
    ``labels`` [...], in float32 through logsumexp, as the reference."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
