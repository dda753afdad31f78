"""DLRM (RM2 variant): huge sparse embedding tables → dot interaction → MLPs.

The counterpart of the reference's ``models/dlrm.py`` on one card (no
sharding).  The reference looks up each sparse feature's table on its own;
here one ``kernels.embedding_bags`` call (one launch) looks up all of them,
straight into the interaction's input.  ``retrieval_score`` scores one query
against N candidate embeddings as one matrix-vector product and a top-k.
``loss_fn`` is the training loss; its gradient runs the plain version
(``impl='torch'``), as the reference's runs ``'xla'``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..kernels.common import check_impl, resolve_device
from ..kernels.embedding_bag import ops as EB
from .layers import mlp_apply, mlp_params

Params = Dict


@dataclasses.dataclass(frozen=True)
class DLRMCfg:
    name: str = "dlrm-rm2"
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 64
    bot_mlp: Sequence[int] = (13, 512, 256, 64)
    top_mlp: Sequence[int] = (512, 512, 256, 1)
    vocab_sizes: Optional[Sequence[int]] = None   # default 1M rows each
    multi_hot: int = 1                            # lookups per field
    dtype: torch.dtype = torch.float32
    impl: str = "cuda"                            # 'cuda' (the kernel) | 'torch' (plain)

    def __post_init__(self):
        check_impl(self.impl)

    def vocabs(self) -> List[int]:
        if self.vocab_sizes is not None:
            return list(self.vocab_sizes)
        return [1_000_000] * self.n_sparse

    def interaction_dim(self) -> int:
        f = self.n_sparse + 1
        return self.embed_dim + f * (f - 1) // 2

    def param_count(self) -> int:
        n = sum(self.vocabs()) * self.embed_dim
        sizes = list(self.bot_mlp)
        for i in range(len(sizes) - 1):
            n += sizes[i] * sizes[i + 1] + sizes[i + 1]
        tops = [self.interaction_dim()] + list(self.top_mlp)[1:]
        for i in range(len(tops) - 1):
            n += tops[i] * tops[i + 1] + tops[i + 1]
        return n


def init_params(cfg: DLRMCfg, generator: torch.Generator,
                device: Optional[Union[str, torch.device]] = None) -> Params:
    """Tables Normal(0, 1) · V^-1/4, MLP weights fan-in scaled, biases 0;
    drawn from ``generator`` on its device, stored on ``device``."""
    dev = resolve_device(device)
    tables = []
    for v in cfg.vocabs():
        t = torch.randn((v, cfg.embed_dim), generator=generator, device=generator.device)
        tables.append((t * v ** -0.25).to(device=dev, dtype=cfg.dtype))
    top_sizes = [cfg.interaction_dim()] + list(cfg.top_mlp)[1:]
    return dict(tables=tables,
                bot=mlp_params(generator, list(cfg.bot_mlp), device=dev),
                top=mlp_params(generator, top_sizes, device=dev))


def _bags(cfg: DLRMCfg, params: Params, sparse_idx: torch.Tensor,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every feature's bag sums, [B, n_sparse, d] (into ``out`` where given)."""
    return EB.embedding_bags(params["tables"], sparse_idx.to(torch.int32).contiguous(), "sum",
                             out=out, impl=cfg.impl)


def forward(cfg: DLRMCfg, params: Params, dense: torch.Tensor,
            sparse_idx: torch.Tensor) -> torch.Tensor:
    """dense [B, n_dense] float; sparse_idx [B, n_sparse, multi_hot] int →
    float32 logits [B]."""
    bot = mlp_apply(params["bot"], dense.to(cfg.dtype), final_act=True)     # [B, d]
    feats = bot.new_empty((bot.shape[0], cfg.n_sparse + 1, bot.shape[1]))  # [B, F+1, d]
    feats[:, 0] = bot
    _bags(cfg, params, sparse_idx, out=feats[:, 1:])
    inter = torch.bmm(feats, feats.transpose(1, 2))                        # pairwise dots
    fdim = feats.shape[1]
    iu, ju = torch.triu_indices(fdim, fdim, offset=1, device=feats.device)
    z = torch.cat([bot, inter[:, iu, ju]], dim=-1)
    return mlp_apply(params["top"], z)[:, 0].float()


def loss_fn(cfg: DLRMCfg, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean binary cross-entropy of the logits against ``batch['label']``,
    in the reference's stable form max(x, 0) − x·y + log1p(e^−|x|).  Its
    gradient needs ``impl='torch'``: the kernel has no backward."""
    logits = forward(cfg, params, batch["dense"], batch["sparse"])
    y = batch["label"].float()
    return torch.mean(torch.clamp_min(logits, 0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def serve_score(cfg: DLRMCfg, params: Params, dense: torch.Tensor,
                sparse_idx: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(forward(cfg, params, dense, sparse_idx))


def forward_user_tower(cfg: DLRMCfg, params: Params, dense: torch.Tensor,
                       sparse_idx: torch.Tensor) -> torch.Tensor:
    bot = mlp_apply(params["bot"], dense.to(cfg.dtype), final_act=True)
    return (bot + _bags(cfg, params, sparse_idx).sum(dim=1)).float()


def retrieval_score(cfg: DLRMCfg, params: Params, dense_q: torch.Tensor,
                    sparse_q: torch.Tensor, cand_emb: torch.Tensor,
                    top_k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score 1 query against N candidate embeddings [N, d]: (top-k scores,
    their candidate ids)."""
    q = forward_user_tower(cfg, params, dense_q, sparse_q)                 # [1, d]
    scores = cand_emb.float() @ q[0]                                       # [N]
    return torch.topk(scores, top_k)
