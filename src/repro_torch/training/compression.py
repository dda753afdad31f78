"""Gradient compression for the data-parallel exchange.

The counterpart of the reference's ``training/compression.py``.  Two
schemes, both with error feedback (the residual is carried to the next step,
so the compression is unbiased over time):

* int8 quantisation — per-tensor scale, 4× volume reduction on f32 grads.
* top-k sparsification — keep the k largest-|g| entries per tensor.

``compressed_psum`` is the exchange: compress, sum the decoded shards over a
``torch.distributed`` group with ``all_reduce``, divide by the group's size.
With no group set up the world is this process and the sum is the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist

from . import tree as T


@dataclasses.dataclass(frozen=True)
class CompressionCfg:
    kind: str = "int8"       # 'none' | 'int8' | 'topk'
    topk_frac: float = 0.01


def world(group=None) -> Tuple[int, int]:
    """(size, rank) of ``group``; (1, 0) when no process group is set up."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _psum(x: torch.Tensor, group) -> torch.Tensor:
    if world(group)[0] > 1:
        x = x.clone()
        dist.all_reduce(x, group=group)
    return x


def init_error_state(params):
    return T.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                      params)


def _quant_int8(g: torch.Tensor):
    scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequant_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _scatter(vals: torch.Tensor, idx: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.numel(), dtype=torch.float32, device=like.device).index_put_(
        (idx,), vals).reshape(like.shape)


def _one(cfg: CompressionCfg, g: torch.Tensor, e: torch.Tensor):
    gf = g.float() + e
    if cfg.kind == "int8":
        q, s = _quant_int8(gf)
        return (q, s), gf - _dequant_int8(q, s)
    if cfg.kind == "topk":
        flat = gf.reshape(-1)
        k = max(1, int(flat.shape[0] * cfg.topk_frac))
        idx = torch.topk(torch.abs(flat), k).indices
        vals = flat[idx]
        approx = _scatter(vals, idx, gf)
        return (vals, idx, gf.shape[0] if gf.dim() else 1), gf - approx
    raise ValueError(cfg.kind)


def compress(cfg: CompressionCfg, grads, err):
    """(payload tree to exchange, new residual): the payload has a tuple
    where ``grads`` has a leaf — int8 ``(q, scale)``, top-k ``(values,
    indices, leading size)``."""
    if cfg.kind == "none":
        return grads, err
    outs = [_one(cfg, g, e) for g, e in zip(T.leaves(grads), T.leaves(err))]
    return (T.unflatten(grads, [o[0] for o in outs]),
            T.unflatten(grads, [o[1] for o in outs]))


def _decode(cfg: CompressionCfg, p, ref: torch.Tensor) -> torch.Tensor:
    if cfg.kind == "int8":
        return _dequant_int8(*p)
    vals, idx, _ = p
    return _scatter(vals, idx, ref)


def decompress(cfg: CompressionCfg, payload, like):
    if cfg.kind == "none":
        return payload
    return T.unflatten(like, [_decode(cfg, p, r) for p, r in
                              zip(T.leaves_like(payload, like), T.leaves(like))])


def compressed_psum(cfg: CompressionCfg, grads, err, group=None):
    """compress → sum the decoded shards over ``group`` → divide by its size;
    returns (mean gradient tree, new residual).  The int8 path sums the
    dequantised shards (the sum of q·s), the top-k path the scattered dense
    tensors (indices differ by rank)."""
    n, _ = world(group)
    if cfg.kind == "none":
        return T.tree_map(lambda g: _psum(g, group) / n, grads), err
    payload, new_err = compress(cfg, grads, err)
    summed = [_psum(_decode(cfg, p, r), group) / n
              for p, r in zip(T.leaves_like(payload, grads), T.leaves(grads))]
    return T.unflatten(grads, summed), new_err
