"""Dense LM transformer (the gemma3 family): GQA + RoPE + SwiGLU, with
sliding-window and local:global attention patterns, and its serve path.

The counterpart of the reference's ``models/transformer.py`` for dense
models on one card.  Parameters keep the reference's layout: per-layer
weights stacked on a leading ``[L, ...]`` axis, ``x @ w`` with ``w`` as
``[in, out]``.  Layers run in a Python loop, so every layer's attention
window is a Python int and every attention call of ``forward``, ``prefill``
and ``decode_step`` goes through ``kernels.flash_attention`` (the
reference's unscanned forward takes the same kernel; its scanned prefill
and its decode compute the same function with masked einsums).

Not ported here (ROADMAP A11): mixture-of-experts layers, the int8 KV
cache, training (loss, remat, sharding).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.common import check_impl, resolve_device
from ..kernels.flash_attention import ops as FA
from .layers import apply_rope, cross_entropy_loss, dense_init, rms_norm

FULL_WINDOW = 1 << 30

Params = Dict
Cache = Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TransformerCfg:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    rope_theta: float = 500000.0
    norm_eps: float = 1e-6
    moe: Optional[object] = None           # not ported: ROADMAP A11
    sliding_window: Optional[int] = None   # local window size
    global_every: int = 0                  # 0: uniform; k: every k-th layer full
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    kv_cache_quant: bool = False           # not ported: ROADMAP A11
    impl: str = "cuda"                     # 'cuda' (the kernel) | 'torch' (plain)
    remat: bool = True                     # training: recompute each layer in backward
    remat_inner: bool = False              # training: recompute each attention chunk
    gqa_native: bool = False               # training: grouped-einsum GQA, no repeated KV

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError("mixture-of-experts layers are not ported yet (ROADMAP A11)")
        if self.kv_cache_quant:
            raise NotImplementedError("the int8 KV cache is not ported yet (ROADMAP A11)")
        check_impl(self.impl)
        if self.n_heads % self.n_kv_heads:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    def layer_windows(self) -> np.ndarray:
        w = np.full(self.n_layers, FULL_WINDOW, np.int32)
        if self.sliding_window is not None:
            w[:] = self.sliding_window
            if self.global_every > 0:
                w[self.global_every - 1:: self.global_every] = FULL_WINDOW
        return w

    def param_count(self) -> int:
        D, F_, V, L = self.d_model, self.d_ff, self.vocab, self.n_layers
        attn = D * self.n_heads * self.d_head * 2 + D * self.n_kv_heads * self.d_head * 2
        return V * D * (1 if self.tie_embeddings else 2) + L * (attn + 3 * D * F_ + 2 * D) + D


# ------------------------------------------------------------------- params
def init_params(cfg: TransformerCfg, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Normal weights scaled by fan_in^-1/2 (the reference's ``ninit``), drawn
    from ``generator`` one layer at a time (float32 scratch of one layer),
    stored in ``cfg.dtype`` on ``device``; norm weights are 1."""
    dev = resolve_device(device)
    D, L, dt = cfg.d_model, cfg.n_layers, cfg.dtype
    Hq, Hkv, Dh, F_ = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff

    def stacked(shape, fan_in):
        out = torch.empty((L,) + shape, dtype=dt, device=dev)
        for i in range(L):
            out[i] = dense_init(generator, shape, fan_in, dt, dev)
        return out

    layers = dict(
        ln1=torch.ones((L, D), dtype=dt, device=dev),
        ln2=torch.ones((L, D), dtype=dt, device=dev),
        wq=stacked((D, Hq * Dh), D),
        wk=stacked((D, Hkv * Dh), D),
        wv=stacked((D, Hkv * Dh), D),
        wo=stacked((Hq * Dh, D), Hq * Dh),
        wg=stacked((D, F_), D),
        wu=stacked((D, F_), D),
        wd=stacked((F_, D), F_),
    )
    params = dict(embed=dense_init(generator, (cfg.vocab, D), D, dt, dev),
                  ln_f=torch.ones(D, dtype=dt, device=dev), layers=layers)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (D, cfg.vocab), D, dt, dev)
    return params


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _head(params: Params) -> torch.Tensor:
    head = params.get("head")
    return params["embed"].t() if head is None else head


# ------------------------------------------------------------------ compute
def _qkv(cfg: TransformerCfg, lp, x, positions):
    """Pre-norm projections with RoPE on q and k: q [B, Hq, S, Dh], k and v
    [B, Hkv, S, Dh] (v a view of the [B, S, Hkv·Dh] projection)."""
    B, S, _ = x.shape
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = (h @ lp["wq"]).view(B, S, Hq, Dh).transpose(1, 2)
    k = (h @ lp["wk"]).view(B, S, Hkv, Dh).transpose(1, 2)
    v = (h @ lp["wv"]).view(B, S, Hkv, Dh).transpose(1, 2)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _window(w) -> Optional[int]:
    return None if int(w) >= FULL_WINDOW else int(w)


def _attn_out(cfg: TransformerCfg, lp, x, o):
    B, S, _ = x.shape
    o = o.to(x.dtype).transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.d_head)
    return x + o @ lp["wo"]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """x · 1 / (1 + e^-x) op by op in x's dtype, as the reference's
    ``jax.nn.silu`` lowers (``F.silu`` rounds once, and in bf16 that moves
    the logits by up to 2 % of their largest value after six layers)."""
    return x * (1 / (1 + torch.exp(-x)))


def _mlp(cfg: TransformerCfg, lp, x):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    g = _silu(h @ lp["wg"]) * (h @ lp["wu"])
    return x + g @ lp["wd"]


def _embed(cfg: TransformerCfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.dtype)


def forward(cfg: TransformerCfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] in ``cfg.dtype``."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        o = FA.flash_attention(q, k, v, causal=True, window=_window(w), impl=cfg.impl)
        x = _mlp(cfg, lp, _attn_out(cfg, lp, x, o))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ _head(params).to(cfg.dtype)


# ----------------------------------------------------------------- training
def _chunked_attention(q, k, v, window: int, Dh: int, chunk: int = 512,
                       native: bool = False, remat_chunks: bool = False) -> torch.Tensor:
    """Causal + sliding-window GQA attention in float32, chunked over query
    blocks so the score transient is [B, H, chunk, S]: the reference's
    ``_chunked_attention``.  q [B, Hq, S, Dh]; k, v [B, Hkv, S, Dh] →
    float32 [B, Hq, S, Dh].  ``native`` consumes the KV heads with grouped
    products (no group× repeat); ``remat_chunks`` recomputes each chunk in
    the backward pass."""
    B, Hq, S, _ = q.shape
    Hkv = k.shape[1]
    group = Hq // Hkv
    if native:
        kf, vf = k.float()[:, :, None], v.float()[:, :, None]          # [B, Hkv, 1, S, D]
    else:
        kf = k.repeat_interleave(group, dim=1).float()
        vf = v.repeat_interleave(group, dim=1).float()
    chunk = min(chunk, S)
    n_chunks = -(-S // chunk)
    pad = n_chunks * chunk - S
    if pad:
        q = F.pad(q, (0, 0, 0, pad))
    kpos = torch.arange(S, device=q.device)

    def one(i: int, qb):
        qpos = i * chunk + torch.arange(chunk, device=q.device)
        mask = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] > qpos[:, None] - window)
        s = qb.float() @ kf.transpose(-1, -2)
        s = torch.where(mask, s * (Dh ** -0.5), -1e30)
        return torch.softmax(s, dim=-1) @ vf

    outs = []
    for i in range(n_chunks):
        qb = q[:, :, i * chunk:(i + 1) * chunk]
        if native:
            qb = qb.reshape(B, Hkv, group, chunk, qb.shape[-1])
        o = (checkpoint(one, i, qb, use_reentrant=False, preserve_rng_state=False)
             if remat_chunks else one(i, qb))
        outs.append(o.reshape(B, Hq, chunk, -1))
    return torch.cat(outs, dim=2)[:, :, :S]


def _train_layer(cfg: TransformerCfg, lp, x, positions, window: int):
    q, k, v = _qkv(cfg, lp, x, positions)
    o = _chunked_attention(q, k, v, window, cfg.d_head, native=cfg.gqa_native,
                           remat_chunks=cfg.remat_inner)
    return _mlp(cfg, lp, _attn_out(cfg, lp, x, o))


def train_forward(cfg: TransformerCfg, params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] in ``cfg.dtype`` through the
    training path (the reference's scanned forward): chunked attention,
    each layer recomputed in backward when ``cfg.remat``."""
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=x.device).expand(B, S)
    # one unbind of each stacked weight: its backward stacks the layers'
    # gradients once (indexing each layer would add a full-size zero tensor
    # a layer)
    layers = {k: v.unbind(0) for k, v in params["layers"].items()}
    for i, w in enumerate(cfg.layer_windows()):
        lp = {k: v[i] for k, v in layers.items()}
        if cfg.remat:
            x = checkpoint(_train_layer, cfg, lp, x, positions, int(w),
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _train_layer(cfg, lp, x, positions, int(w))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ _head(params).to(cfg.dtype)


def loss_fn(cfg: TransformerCfg, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Token-mean cross-entropy of ``train_forward`` on ``batch['tokens']``
    against ``batch['labels']`` (float32 scalar)."""
    return cross_entropy_loss(train_forward(cfg, params, batch["tokens"]), batch["labels"])


# -------------------------------------------------------------------- serve
def init_cache(cfg: TransformerCfg, batch: int, max_len: int,
               device: Optional[Union[str, torch.device]] = None) -> Cache:
    """Zeroed (k, v) caches, each [L, B, Hkv, max_len, Dh] in ``cfg.dtype``."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


def prefill(cfg: TransformerCfg, params: Params, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt tokens [B, S]; return (float32 logits of the last
    position [B, V], the cache with the prompt's rotated keys and values in
    rows 0..S-1 and zeros up to ``max_len``)."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    x = _embed(cfg, params, tokens)
    ck, cv = init_cache(cfg, B, max_len, device=x.device)
    positions = torch.arange(S, device=x.device).expand(B, S)
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        ck[i, :, :, :S] = k
        cv[i, :, :, :S] = v
        o = FA.flash_attention(q, k, v, causal=True, window=_window(w), impl=cfg.impl)
        x = _mlp(cfg, lp, _attn_out(cfg, lp, x, o))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, -1] @ _head(params).to(cfg.dtype)).float()
    return logits, (ck, cv)


def decode_step(cfg: TransformerCfg, params: Params, cache: Cache,
                tokens: torch.Tensor, cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens [B]; ``cache_len`` = tokens so far, this one
    included (it sits at position ``cache_len - 1``).  Returns (float32
    logits [B, V], cache).  The cache is updated in place (row
    ``cache_len - 1`` of every layer) and returned, where the reference
    returns a new one: that saves a copy of the whole cache per token."""
    ck, cv = cache
    if not 1 <= cache_len <= ck.shape[3]:
        raise ValueError(f"cache_len {cache_len} outside 1..{ck.shape[3]}")
    B = tokens.shape[0]
    pos = cache_len - 1
    x = _embed(cfg, params, tokens)[:, None, :]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        ck[i, :, :, pos] = k[:, :, 0]
        cv[i, :, :, pos] = v[:, :, 0]
        o = FA.decode_attention(q, ck[i], cv[i], cache_len, window=_window(w), impl=cfg.impl)
        x = _mlp(cfg, lp, _attn_out(cfg, lp, x, o))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params).to(cfg.dtype)).float()
    return logits, cache
