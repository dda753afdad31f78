"""GNN model zoo: PNA, EGNN, MeshGraphNet, SchNet.

The counterpart of the reference's ``models/gnn.py`` on one card.  All four
are message-passing networks: gather-by-src → edge compute →
segment-reduce-by-dst.  ``GraphBatch`` keeps its edges sorted by
destination and carries their CSR row pointer, so every sum and mean
aggregation (and PNA's degree) is one launch of the sorted segment-sum
kernel (``kernels.bucket_scatter``, B5).  Max and min stay plain
``scatter_reduce``, as the reference computes them outside any Pallas
kernel.

Graphs are structure-of-arrays ``GraphBatch``; batched small graphs
(molecule shape) are flattened into one disjoint graph with a node→graph map.
Each config carries ``impl``: ``'cuda'`` (the kernel) or ``'torch'`` (the
plain segment-sum).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import bucket_scatter as BS
from ..kernels.common import check_impl, resolve_device
from .layers import layer_norm, mlp_apply, mlp_params

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class GraphBatch:
    """A graph's arrays.  Edges given in any order are put in destination
    order by one stable permutation of ``edge_src``, ``edge_dst`` and
    ``edge_feat``; ``layout`` is their CSR row pointer."""
    node_feat: torch.Tensor                      # [N, F]
    edge_src: torch.Tensor                       # [E]
    edge_dst: torch.Tensor                       # [E]
    coords: Optional[torch.Tensor] = None        # [N, 3] (EGNN / SchNet / MGN)
    edge_feat: Optional[torch.Tensor] = None     # [E, Fe]
    graph_of: Optional[torch.Tensor] = None      # [N] graph id (batched-small)
    n_graphs: int = 1
    targets: Optional[torch.Tensor] = None
    layout: BS.ScatterLayout = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        dst = self.edge_dst
        if dst.numel() > 1 and not bool((dst[1:] >= dst[:-1]).all()):
            order = torch.argsort(dst, stable=True)
            self.edge_src, self.edge_dst = self.edge_src[order], dst[order]
            if self.edge_feat is not None:
                self.edge_feat = self.edge_feat[order]
        self.layout = BS.build_layout(self.edge_dst, self.node_feat.shape[0])


def _agg(values: torch.Tensor, g: GraphBatch, op: str, impl: str) -> torch.Tensor:
    """Per-destination reduction of per-edge ``values`` [E, C] → [N, C];
    empty segments give 0."""
    n = g.node_feat.shape[0]
    if op in ("sum", "mean"):
        s = BS.bucket_scatter(values.contiguous(), g.edge_dst, n, g.layout, impl)
        if op == "sum":
            return s
        c = BS.bucket_scatter(values.new_ones((values.shape[0], 1)), g.edge_dst, n,
                              g.layout, impl)
        return s / c.clamp_min(1.0)
    if op in ("max", "min"):
        idx = g.edge_dst.long()[:, None].expand_as(values)
        out = values.new_zeros((n,) + tuple(values.shape[1:])).scatter_reduce(
            0, idx, values, "amax" if op == "max" else "amin", include_self=False)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(op)


# ====================================================================== PNA
@dataclasses.dataclass(frozen=True)
class PNACfg:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    aggregators: Sequence[str] = ("mean", "max", "min", "std")
    scalers: Sequence[str] = ("identity", "amplification", "attenuation")
    out_dim: int = 1
    impl: str = "cuda"

    def __post_init__(self):
        check_impl(self.impl)


def pna_init(cfg: PNACfg, generator: torch.Generator, in_dim: int,
             device: Device = None) -> Dict:
    dev = resolve_device(device)
    d = cfg.d_hidden
    n_in = len(cfg.aggregators) * len(cfg.scalers) * d + d
    return dict(
        encoder=mlp_params(generator, [in_dim, d], device=dev),
        layers=[dict(pre=mlp_params(generator, [2 * d, d], device=dev),
                     post=mlp_params(generator, [n_in, d, d], device=dev))
                for _ in range(cfg.n_layers)],
        decoder=mlp_params(generator, [d, d, cfg.out_dim], device=dev),
    )


def pna_apply(cfg: PNACfg, params, g: GraphBatch) -> torch.Tensor:
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = mlp_apply(params["encoder"], g.node_feat, final_act=True)
    ones = torch.ones((src.shape[0], 1), dtype=torch.float32, device=src.device)
    deg = _agg(ones, g, "sum", cfg.impl)
    log_deg = torch.log1p(deg)
    mean_log_deg = log_deg.mean().clamp_min(1e-6)
    for lp in params["layers"]:
        msg = mlp_apply(lp["pre"], torch.cat([h[src], h[dst]], dim=-1), final_act=True)
        aggs = []
        mean = _agg(msg, g, "mean", cfg.impl)
        for a in cfg.aggregators:
            if a == "std":
                sq = _agg(msg * msg, g, "mean", cfg.impl)
                aggs.append(torch.sqrt(torch.clamp_min(sq - mean * mean, 1e-8)))
            elif a == "mean":
                aggs.append(mean)
            else:
                aggs.append(_agg(msg, g, a, cfg.impl))
        scaled = []
        for s in cfg.scalers:
            for a in aggs:
                if s == "identity":
                    scaled.append(a)
                elif s == "amplification":
                    scaled.append(a * (log_deg / mean_log_deg))
                else:  # attenuation (degree-0 nodes get factor 1)
                    att = torch.where(deg > 0, mean_log_deg / log_deg.clamp_min(1e-6), 1.0)
                    scaled.append(a * att)
        h = h + mlp_apply(lp["post"], torch.cat(scaled + [h], dim=-1), final_act=True)
    return mlp_apply(params["decoder"], h)


# ===================================================================== EGNN
@dataclasses.dataclass(frozen=True)
class EGNNCfg:
    name: str = "egnn"
    n_layers: int = 4
    d_hidden: int = 64
    out_dim: int = 1
    impl: str = "cuda"

    def __post_init__(self):
        check_impl(self.impl)


def egnn_init(cfg: EGNNCfg, generator: torch.Generator, in_dim: int,
              device: Device = None) -> Dict:
    dev = resolve_device(device)
    d = cfg.d_hidden
    return dict(
        encoder=mlp_params(generator, [in_dim, d], device=dev),
        layers=[dict(phi_e=mlp_params(generator, [2 * d + 1, d, d], device=dev),
                     phi_x=mlp_params(generator, [d, d, 1], device=dev),
                     phi_h=mlp_params(generator, [2 * d, d, d], device=dev))
                for _ in range(cfg.n_layers)],
        decoder=mlp_params(generator, [d, d, cfg.out_dim], device=dev),
    )


def egnn_apply(cfg: EGNNCfg, params, g: GraphBatch):
    """E(n)-equivariant layers: scalar messages from invariant distances,
    coordinate updates along relative vectors.  Returns (out, coords)."""
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = mlp_apply(params["encoder"], g.node_feat, final_act=True)
    x = g.coords
    for lp in params["layers"]:
        rel = x[src] - x[dst]
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        m = mlp_apply(lp["phi_e"], torch.cat([h[src], h[dst], d2], dim=-1), final_act=True)
        coef = torch.tanh(mlp_apply(lp["phi_x"], m))          # bounded for stability
        x = x + _agg(rel * coef, g, "mean", cfg.impl)
        magg = _agg(m, g, "sum", cfg.impl)
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, magg], dim=-1), final_act=True)
    return mlp_apply(params["decoder"], h), x


# ============================================================ MeshGraphNet
@dataclasses.dataclass(frozen=True)
class MGNCfg:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    out_dim: int = 3
    impl: str = "cuda"

    def __post_init__(self):
        check_impl(self.impl)


def mgn_init(cfg: MGNCfg, generator: torch.Generator, in_dim: int, edge_in: int = 4,
             device: Device = None) -> Dict:
    dev = resolve_device(device)
    d = cfg.d_hidden
    hidden = [d] * cfg.mlp_layers
    ln = lambda: dict(w=torch.ones(d, device=dev), b=torch.zeros(d, device=dev))
    return dict(
        node_enc=mlp_params(generator, [in_dim] + hidden, device=dev),
        edge_enc=mlp_params(generator, [edge_in] + hidden, device=dev),
        layers=[dict(edge_mlp=mlp_params(generator, [3 * d] + hidden, device=dev),
                     node_mlp=mlp_params(generator, [2 * d] + hidden, device=dev),
                     ln_e=ln(), ln_n=ln())
                for _ in range(cfg.n_layers)],
        decoder=mlp_params(generator, hidden + [cfg.out_dim], device=dev),
    )


def mgn_apply(cfg: MGNCfg, params, g: GraphBatch) -> torch.Tensor:
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = mlp_apply(params["node_enc"], g.node_feat, final_act=True)
    if g.edge_feat is not None:
        e = mlp_apply(params["edge_enc"], g.edge_feat, final_act=True)
    else:
        rel = g.coords[src] - g.coords[dst]
        ef = torch.cat([rel, torch.linalg.norm(rel, dim=-1, keepdim=True)], dim=-1)
        e = mlp_apply(params["edge_enc"], ef, final_act=True)
    for lp in params["layers"]:
        e_new = mlp_apply(lp["edge_mlp"], torch.cat([e, h[src], h[dst]], dim=-1),
                          final_act=True)
        e = e + layer_norm(e_new, lp["ln_e"]["w"], lp["ln_e"]["b"])
        agg = _agg(e, g, "sum", cfg.impl)
        h_new = mlp_apply(lp["node_mlp"], torch.cat([h, agg], dim=-1), final_act=True)
        h = h + layer_norm(h_new, lp["ln_n"]["w"], lp["ln_n"]["b"])
    return mlp_apply(params["decoder"], h)


# ==================================================================== SchNet
@dataclasses.dataclass(frozen=True)
class SchNetCfg:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    out_dim: int = 1
    impl: str = "cuda"

    def __post_init__(self):
        check_impl(self.impl)


def schnet_init(cfg: SchNetCfg, generator: torch.Generator, in_dim: int,
                device: Device = None) -> Dict:
    dev = resolve_device(device)
    d = cfg.d_hidden
    return dict(
        encoder=mlp_params(generator, [in_dim, d], device=dev),
        interactions=[dict(filter_net=mlp_params(generator, [cfg.n_rbf, d, d], device=dev),
                           in_proj=mlp_params(generator, [d, d], device=dev),
                           out_proj=mlp_params(generator, [d, d, d], device=dev))
                      for _ in range(cfg.n_interactions)],
        decoder=mlp_params(generator, [d, d, cfg.out_dim], device=dev),
    )


def _rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    centers = torch.as_tensor(np.linspace(0.0, cutoff, n_rbf), dtype=torch.float32,
                              device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def _cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    c = 0.5 * (torch.cos(math.pi * dist / cutoff) + 1.0)
    return torch.where(dist < cutoff, c, 0.0)


def schnet_apply(cfg: SchNetCfg, params, g: GraphBatch) -> torch.Tensor:
    """Continuous-filter convolutions: W(r_ij) ⊙ h_j summed over neighbours.
    The filter's softplus is ``F.softplus`` (threshold 20: above it x
    itself, where ``jax.nn.softplus`` adds log1p(e^-x) < 2.1e-9)."""
    src, dst = g.edge_src.long(), g.edge_dst.long()
    h = mlp_apply(params["encoder"], g.node_feat)
    dist = torch.linalg.norm(g.coords[src] - g.coords[dst] + 1e-9, dim=-1)
    rbf = _rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    cut = _cosine_cutoff(dist, cfg.cutoff)[:, None]
    for lp in params["interactions"]:
        W = mlp_apply(lp["filter_net"], rbf, act=F.softplus, final_act=True) * cut
        hj = mlp_apply(lp["in_proj"], h)[src]
        msg = _agg(hj * W, g, "sum", cfg.impl)
        h = h + mlp_apply(lp["out_proj"], msg, act=F.softplus)
    out = mlp_apply(params["decoder"], h)
    if g.graph_of is not None:
        return out.new_zeros((g.n_graphs,) + tuple(out.shape[1:])).index_add_(
            0, g.graph_of.long(), out)
    return out


# ------------------------------------------------------------- loss wrappers
def gnn_loss(arch: str, cfg, params, g: GraphBatch) -> torch.Tensor:
    """The training loss's value (mean squared error against the targets);
    its gradient is not ported yet."""
    if arch == "pna":
        pred = pna_apply(cfg, params, g)
    elif arch == "egnn":
        pred, _ = egnn_apply(cfg, params, g)
    elif arch == "meshgraphnet":
        pred = mgn_apply(cfg, params, g)
    elif arch == "schnet":
        pred = schnet_apply(cfg, params, g)
    else:
        raise ValueError(arch)
    tgt = g.targets
    if tgt is None or tgt.shape[0] != pred.shape[0]:
        tgt = torch.zeros_like(pred)   # graph-level heads w/ node targets: MSE to 0
    elif tgt.shape != pred.shape:
        tgt = tgt.reshape(tgt.shape[0], -1)[:, : pred.shape[-1]].broadcast_to(pred.shape)
    return torch.mean((pred.float() - tgt.float()) ** 2)


INIT = {"pna": pna_init, "egnn": egnn_init, "meshgraphnet": mgn_init,
        "schnet": schnet_init}
