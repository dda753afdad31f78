"""LM transformer family (gemma3 / minicpm / llama3 / olmoe / mixtral): GQA +
RoPE + SwiGLU, optional mixture-of-experts MLP, sliding-window and
local:global attention patterns, its serve path and its training path.

The counterpart of the reference's ``models/transformer.py`` on one card.
Parameters keep the reference's layout: per-layer weights stacked on a
leading ``[L, ...]`` axis, ``x @ w`` with ``w`` as ``[in, out]``.  Layers
run in a Python loop, so every layer's attention window is a Python int and
every attention call of ``forward``, ``prefill`` and ``decode_step`` goes
through ``kernels.flash_attention`` (the reference's unscanned forward takes
the same kernel; its scanned prefill and its decode compute the same
function with masked einsums).

The MoE MLP is the reference's sort-based dispatch: groups are batch rows,
each with capacity ``C = max(1, int(cf * K * S / E))``; tokens past an
expert's capacity are dropped, never rerouted.  Its expert products are
batched matrix products, as the reference's are (no kernel).

The int8 KV cache (``kv_cache_quant``) is the reference's: per (token,
head) symmetric int8 rows with bfloat16 scales, written by ``decode_step``
and read by the attention kernel's int8 decode route; ``prefill`` returns
the float cache, as the reference's does.

``init_shapes`` gives the parameter tree as tensors on the ``meta`` device
(shapes and dtypes, nothing drawn) and ``param_specs`` / ``cache_specs``
their partition specs on a mesh (``launch/mesh.py``): the reference's rules
for its dry run.  The port itself runs on one card; it shards nothing.
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
from ..launch.mesh import P, data_axes_of
from .layers import apply_rope, cross_entropy_loss, dense_init, rms_norm

FULL_WINDOW = 1 << 30

Params = Dict
#: (k, v) in ``cfg.dtype``, or with ``kv_cache_quant`` (k8, v8, k_scale, v_scale)
Cache = Tuple[torch.Tensor, ...]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25

    def __post_init__(self):
        if not 1 <= self.top_k <= self.n_experts:
            raise ValueError(f"top_k {self.top_k} outside 1..n_experts {self.n_experts}")

    def capacity(self, group_tokens: int) -> int:
        """Slots per expert in a group of ``group_tokens`` tokens, from the
        shape alone (Python float arithmetic, as the reference)."""
        return max(1, int(self.capacity_factor * self.top_k * group_tokens / self.n_experts))


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
    moe: Optional[MoECfg] = None
    sliding_window: Optional[int] = None   # local window size
    global_every: int = 0                  # 0: uniform; k: every k-th layer full
    tie_embeddings: bool = True
    dtype: torch.dtype = torch.bfloat16
    kv_cache_quant: bool = False           # int8 KV cache w/ per-token-head scales
    impl: str = "cuda"                     # 'cuda' (the kernel) | 'torch' (plain)
    remat: bool = True                     # training: recompute each layer in backward
    remat_inner: bool = False              # training: recompute attention chunks, MoE layers
    gqa_native: bool = False               # training: grouped-einsum GQA, no repeated KV

    def __post_init__(self):
        if self.moe is not None and not isinstance(self.moe, MoECfg):
            raise TypeError(f"moe must be a MoECfg, not {type(self.moe).__name__}")
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

    def _attn_params(self) -> int:
        return self.d_model * (self.n_heads + self.n_kv_heads) * self.d_head * 2

    def param_count(self) -> int:
        D, V, L = self.d_model, self.vocab, self.n_layers
        if self.moe:
            mlp = self.moe.n_experts * 3 * D * self.moe.d_ff + D * self.moe.n_experts
        else:
            mlp = 3 * D * self.d_ff
        layer = self._attn_params() + mlp + 2 * D
        return V * D * (1 if self.tie_embeddings else 2) + L * layer + D

    def active_param_count(self) -> int:
        """Parameters a token uses: top_k experts of each MoE layer (the
        reference's count, one embedding table whether tied or not)."""
        if not self.moe:
            return self.param_count()
        D, L = self.d_model, self.n_layers
        mlp = self.moe.top_k * 3 * D * self.moe.d_ff + D * self.moe.n_experts
        return self.vocab * D + L * (self._attn_params() + mlp + 2 * D) + D


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
    )
    if cfg.moe:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        layers.update(router=stacked((D, E), D), wg=stacked((E, D, Fe), D),
                      wu=stacked((E, D, Fe), D), wd=stacked((E, Fe, D), Fe))
    else:
        layers.update(wg=stacked((D, F_), D), wu=stacked((D, F_), D),
                      wd=stacked((F_, D), F_))
    params = dict(embed=dense_init(generator, (cfg.vocab, D), D, dt, dev),
                  ln_f=torch.ones(D, dtype=dt, device=dev), layers=layers)
    if not cfg.tie_embeddings:
        params["head"] = dense_init(generator, (D, cfg.vocab), D, dt, dev)
    return params


def _param_shapes(cfg: TransformerCfg) -> Dict:
    """The shape of every leaf of ``init_params``'s tree."""
    D, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    layers = dict(ln1=(L, D), ln2=(L, D), wq=(L, D, Hq * Dh), wk=(L, D, Hkv * Dh),
                  wv=(L, D, Hkv * Dh), wo=(L, Hq * Dh, D))
    if cfg.moe:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        layers.update(router=(L, D, E), wg=(L, E, D, Fe), wu=(L, E, D, Fe),
                      wd=(L, E, Fe, D))
    else:
        layers.update(wg=(L, D, cfg.d_ff), wu=(L, D, cfg.d_ff), wd=(L, cfg.d_ff, D))
    shapes = dict(embed=(V, D), ln_f=(D,), layers=layers)
    if not cfg.tie_embeddings:
        shapes["head"] = (D, V)
    return shapes


def init_shapes(cfg: TransformerCfg) -> Params:
    """``init_params``'s tree as ``meta`` tensors in ``cfg.dtype``: the shapes
    and dtypes, with nothing drawn or stored."""
    def leaf(x):
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return torch.empty(x, dtype=cfg.dtype, device="meta")

    return leaf(_param_shapes(cfg))


def _divides(mesh, n: int, axis):
    """``axis`` (a name or a tuple of names) where its mesh size divides
    ``n``, else None (replicated)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    return axis if n % int(np.prod([mesh.shape[a] for a in names])) == 0 else None


def param_specs(cfg: TransformerCfg, mesh=None) -> Dict:
    """Partition specs mirroring ``init_params``: FSDP over the mesh's data
    axes × tensor parallelism over ``model`` (a dimension is split only where
    the axes' size divides it); MoE weights expert-parallel over ``model``
    where it divides the experts, else tensor-parallel inside each expert.
    ``mesh=None``: every leaf replicated."""
    if mesh is None:
        def rep(x):
            return {k: rep(v) for k, v in x.items()} if isinstance(x, dict) else P()
        return rep(_param_shapes(cfg))
    dp, tp = data_axes_of(mesh), "model"
    div = lambda n, axis: _divides(mesh, n, axis)
    Hq, Hkv, Dh, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    layers = dict(
        ln1=P(None, None),
        ln2=P(None, None),
        wq=P(None, div(D, dp), div(Hq * Dh, tp)),
        wk=P(None, div(D, dp), div(Hkv * Dh, tp)),
        wv=P(None, div(D, dp), div(Hkv * Dh, tp)),
        wo=P(None, div(Hq * Dh, tp), div(D, dp)),
    )
    if cfg.moe:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        e_ax = div(E, tp)
        if e_ax is not None:   # expert parallelism over the model axis
            layers.update(router=P(None, None, None),
                          wg=P(None, e_ax, div(D, dp), None),
                          wu=P(None, e_ax, div(D, dp), None),
                          wd=P(None, e_ax, None, div(D, dp)))
        else:                  # tensor-parallel inside each expert
            layers.update(router=P(None, None, None),
                          wg=P(None, None, div(D, dp), div(Fe, tp)),
                          wu=P(None, None, div(D, dp), div(Fe, tp)),
                          wd=P(None, None, div(Fe, tp), div(D, dp)))
    else:
        F_ = cfg.d_ff
        layers.update(wg=P(None, div(D, dp), div(F_, tp)),
                      wu=P(None, div(D, dp), div(F_, tp)),
                      wd=P(None, div(F_, tp), div(D, dp)))
    specs = dict(embed=P(div(cfg.vocab, tp), None), ln_f=P(None), layers=layers)
    if not cfg.tie_embeddings:
        specs["head"] = P(None, div(cfg.vocab, tp))
    return specs


def cache_specs(cfg: TransformerCfg, mesh=None) -> P:
    """The partition spec of a [L, B, Hkv, Smax, Dh] cache: batch over the
    data axes, kv heads over ``model`` where it divides them, else d_head
    (scores and outputs then recombine with a small all-reduce).
    ``mesh=None``: replicated."""
    if mesh is None:
        return P()
    dp = data_axes_of(mesh)
    if cfg.n_kv_heads % max(mesh.shape["model"], 1) == 0:
        return P(None, dp, "model", None, None)
    return P(None, dp, None, None, "model")   # shard d_head instead


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
    if cfg.moe is None:
        g = _silu(h @ lp["wg"]) * (h @ lp["wu"])
        return x + g @ lp["wd"]
    if cfg.remat_inner and torch.is_grad_enabled():   # recomputed in backward
        return x + checkpoint(_moe_groups, cfg, lp, h, use_reentrant=False,
                              preserve_rng_state=False)
    return x + _moe_groups(cfg, lp, h)


def top_k(gates: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, largest first, and their indices;
    of equal values the lower index first (``jax.lax.top_k``'s order, which
    ``torch.topk`` does not promise): a stable descending sort."""
    w, i = torch.sort(gates, dim=-1, descending=True, stable=True)
    return w[..., :k], i[..., :k]


def _moe_groups(cfg: TransformerCfg, lp, h: torch.Tensor) -> torch.Tensor:
    """The MoE MLP of the normed input ``h`` [G, S, D], each of the G batch
    rows one group: the reference's ``group_moe`` mapped over the groups.
    Returns [G, S, D] in ``h.dtype``.

    Routing: the float32 softmax of ``h @ router``, its top K normalised by
    max(sum, 1e-9).  The (token, choice) pairs sorted stably by expert give
    each its rank within its expert; rank >= C drops it (weight 0).  The
    expert buffer [E, C, D] holds, at (e, c), the token of rank c at
    expert e, or zeros: the reference's scatter of the kept tokens, written
    as a gather.  Each token's output is the float32 sum of its kept
    choices' expert outputs times their weights, cast to ``h.dtype``."""
    m = cfg.moe
    G, S, D = h.shape
    E, K = m.n_experts, m.top_k
    C = m.capacity(S)
    dev = h.device
    gates = torch.softmax((h @ lp["router"]).float(), dim=-1)          # [G, S, E]
    topw, topi = top_k(gates, K)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e = topi.reshape(G, S * K)                                    # pair p = t * K + k
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(1, order)                                       # experts, sorted
    first = torch.searchsorted(se, se, side="left")
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(S * K, device=dev) - first)             # rank of pair p
    keep = rank < C
    # dispatch: slot (e, c) takes sorted pair start[e] + c where c < count[e]
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    start = torch.searchsorted(se, experts, side="left")
    count = torch.searchsorted(se, experts, side="right") - start
    c = torch.arange(C, device=dev)
    src = (start[..., None] + c).clamp_max(S * K - 1)                  # [G, E, C]
    tok = order.gather(1, src.view(G, E * C)) // K
    xe = h.gather(1, tok[..., None].expand(G, E * C, D))
    xe = xe * (c < count[..., None]).view(G, E * C, 1).to(h.dtype)     # empty slots: 0
    xe = xe.view(G, E, C, D).transpose(0, 1).reshape(E, G * C, D)
    oe = (_silu(xe @ lp["wg"]) * (xe @ lp["wu"])) @ lp["wd"]           # [E, G*C, D]
    oe = oe.view(E, G, C, D).transpose(0, 1).reshape(G, E * C, D)
    # combine: token t sums its K choices' rows (dropped: weight 0)
    slot = (flat_e * C + rank).clamp_max(E * C - 1)
    rows = oe.gather(1, slot[..., None].expand(G, S * K, D)).float()
    w = (topw.reshape(G, S * K) * keep).view(G * S, 1, K)
    return torch.bmm(w, rows.view(G * S, K, D)).view(G, S, D).to(h.dtype)


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
    """Zeroed (k, v) caches, each [L, B, Hkv, max_len, Dh] in ``cfg.dtype``;
    with ``cfg.kv_cache_quant`` (k8, v8, k_scale, v_scale): int8 caches of
    that shape and bfloat16 scales [L, B, Hkv, max_len]."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
    if cfg.kv_cache_quant:
        return (torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape, dtype=torch.int8, device=dev),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev),
                torch.zeros(shape[:-1], dtype=torch.bfloat16, device=dev))
    return (torch.zeros(shape, dtype=cfg.dtype, device=dev),
            torch.zeros(shape, dtype=cfg.dtype, device=dev))


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 of x [..., Dh], the reference's: scale
    = max(max|x| / 127, 1e-8) in float32, q = clip(round(x / scale), -127,
    127); returns (q int8, scale as bfloat16 [...]).  Both divisions are
    true divisions by a tensor (CUDA's division by a Python number is a
    multiply by its reciprocal, an ulp off at times, and one ulp of scale
    flips a round at .5)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1)
    scale = (scale / scale.new_full((), 127.0)).clamp_min(1e-8)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def prefill(cfg: TransformerCfg, params: Params, tokens: torch.Tensor,
            max_len: int) -> Tuple[torch.Tensor, Cache]:
    """Run the prompt tokens [B, S]; return (float32 logits of the last
    position [B, V], the cache with the prompt's rotated keys and values in
    rows 0..S-1 and zeros up to ``max_len``).  The cache is (k, v) in
    ``cfg.dtype`` whatever ``kv_cache_quant`` says, as the reference's."""
    B, S = tokens.shape
    if S > max_len:
        raise ValueError(f"prompt of {S} tokens exceeds max_len {max_len}")
    x = _embed(cfg, params, tokens)
    ck, cv = init_cache(dataclasses.replace(cfg, kv_cache_quant=False), B, max_len,
                        device=x.device)
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


def quantize_cache(cache: Cache, rows: int) -> Cache:
    """The int8 cache (k8, v8, k_scale, v_scale) of a float (k, v) cache,
    such as ``prefill`` returns: its rows 0..rows-1 quantized layer by layer
    by ``_quantize_kv``.  Scales are per (token, head), so these are the
    rows ``decode_step`` with ``kv_cache_quant`` writes for those keys; the
    rows from ``rows`` on stay 0 for it to fill."""
    ck, cv = cache
    L, B, Hkv, max_len, Dh = ck.shape
    if not 0 <= rows <= max_len:
        raise ValueError(f"rows {rows} outside 0..{max_len}")
    out = (torch.zeros(ck.shape, dtype=torch.int8, device=ck.device),
           torch.zeros(ck.shape, dtype=torch.int8, device=ck.device),
           torch.zeros(ck.shape[:-1], dtype=torch.bfloat16, device=ck.device),
           torch.zeros(ck.shape[:-1], dtype=torch.bfloat16, device=ck.device))
    for i in range(L):
        for src, q8, s8 in ((ck, out[0], out[2]), (cv, out[1], out[3])):
            q8[i, :, :, :rows], s8[i, :, :, :rows] = _quantize_kv(src[i, :, :, :rows])
    return out


def decode_step(cfg: TransformerCfg, params: Params, cache: Cache,
                tokens: torch.Tensor, cache_len: int) -> Tuple[torch.Tensor, Cache]:
    """One decode step.  tokens [B]; ``cache_len`` = tokens so far, this one
    included (it sits at position ``cache_len - 1``).  Returns (float32
    logits [B, V], cache).  The cache is updated in place (row
    ``cache_len - 1`` of every layer) and returned, where the reference
    returns a new one: that saves a copy of the whole cache per token.

    With ``cfg.kv_cache_quant`` the cache is (k8, v8, k_scale, v_scale): the
    new rows are quantized (``_quantize_kv``) and written with their scales
    before the attention, so the token attends to its own quantized row, as
    in the reference."""
    ck, cv = cache[:2]
    if len(cache) != (4 if cfg.kv_cache_quant else 2):
        raise ValueError(f"a {'quantized' if cfg.kv_cache_quant else 'float'} cache is a "
                         f"{4 if cfg.kv_cache_quant else 2}-tuple, got {len(cache)}")
    if not 1 <= cache_len <= ck.shape[3]:
        raise ValueError(f"cache_len {cache_len} outside 1..{ck.shape[3]}")
    B = tokens.shape[0]
    pos = cache_len - 1
    x = _embed(cfg, params, tokens)[:, None, :]
    positions = torch.full((B, 1), pos, dtype=torch.long, device=x.device)
    if cfg.kv_cache_quant:   # row pos of every layer of k8, v8, k_scale, v_scale
        new_rows = [t[:, :, :, pos] for t in cache]
    for i, w in enumerate(cfg.layer_windows()):
        lp = _layer(params, i)
        q, k, v = _qkv(cfg, lp, x, positions)
        scales = None
        if cfg.kv_cache_quant:
            # k and v quantized in one pass: the scales are per row, so this
            # equals two calls
            q8, s8 = _quantize_kv(torch.stack((k[:, :, 0], v[:, :, 0])))
            for row, new in zip(new_rows, (*q8.unbind(0), *s8.unbind(0))):
                row[i].copy_(new)
            scales = (cache[2][i], cache[3][i])
        else:
            ck[i, :, :, pos] = k[:, :, 0]
            cv[i, :, :, pos] = v[:, :, 0]
        o = FA.decode_attention(q, ck[i], cv[i], cache_len, window=_window(w),
                                scales=scales, impl=cfg.impl)
        x = _mlp(cfg, lp, _attn_out(cfg, lp, x, o))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = (x[:, 0] @ _head(params).to(cfg.dtype)).float()
    return logits, cache
