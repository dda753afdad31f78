"""Shared machinery of the port's architecture configurations: ``ArchSpec``,
the dry run's shape cells, the shapes of the LM and GNN families, and the
reduced-config smoke kits.

The port's counterpart of the reference's ``configs/common.py``.  An
``ArchSpec`` has the reference's fields: an architecture's id, family,
shape cells, skipped shapes with their reasons, a smoke check and ``meta``
(parameter counts, the ``OptCfg`` it trains with).  ``shapes[name](mesh)``
builds a ``ShapeCell``: the step function, its arguments as tensors on the
``meta`` device (shapes and dtypes, never allocated; the reference's
``ShapeDtypeStruct``s), and the partition specs (``P``) of its inputs and
outputs on ``mesh`` (``launch/mesh.py``).  ``launch/dryrun.py`` traces the
cells; ``roofline/analysis.py`` counts them.

A smoke check runs a reduced config end to end on ``device`` (None: the
card) and returns the reference's keys: ``ok``, and ``loss`` (and the LMs'
``logits_shape``) where the reference has them.  Its seeds are
``torch.Generator``s, so its numbers are the port's own, not the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels.common import resolve_device
from ..launch.mesh import P, data_axes_of, shard_shape  # noqa: F401  (re-exported)
from ..models import gnn as gnn_mod
from ..models import transformer as tr
from ..training import tree as T
from ..training.optimizer import OptCfg, apply_updates, init_state
from ..training.train_loop import value_and_grad

Device = Optional[Union[str, torch.device]]


@dataclasses.dataclass
class ShapeCell:
    """One (arch × shape) dry-run cell."""
    fn: Callable                      # the step function, called as fn(*args)
    args: Tuple                       # trees of meta tensors
    in_shardings: Tuple               # trees of P, one per argument
    out_shardings: Any                # a tree of P shaped like fn's output
    kind: str                         # 'train' | 'prefill' | 'decode' | 'serve' | 'query'
    note: str = ""
    analytic_flops: Optional[float] = None   # global, where the count needs a check


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str
    shapes: Dict[str, Callable]       # shape name → (mesh) → ShapeCell
    skip: Dict[str, str]              # shape name → reason
    smoke: Callable[..., dict]        # reduced config end to end: smoke(device=None)
    meta: Dict[str, Any]


def sds(shape, dtype: torch.dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype``: an argument's shape
    and dtype, with no storage."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def spec_leaves(tree) -> list:
    """Every ``P`` of a spec tree, in the order ``training.tree.leaves``
    visits the matching tensor tree (a dict's keys sorted)."""
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in spec_leaves(tree[k])]
    return [s for v in tree for s in spec_leaves(v)]


def replicated(tree):
    """``P()`` for every tensor of ``tree``."""
    return T.tree_map(lambda _: P(), tree)


def _train_update(loss_fn: Callable, opt_cfg: OptCfg, params, opt_state, batch):
    """(new params, new state, loss, metrics): ``loss_fn``'s value and
    gradient and one AdamW step, not in place (the dry run's step)."""
    loss, grads = value_and_grad(loss_fn, params, batch)
    new_p, new_s, metrics = apply_updates(opt_cfg, params, grads, opt_state)
    return new_p, new_s, loss, metrics


# ===================================================================== LM
LM_SHAPES = dict(
    train_4k=dict(seq=4096, batch=256, kind="train"),
    prefill_32k=dict(seq=32768, batch=32, kind="prefill"),
    decode_32k=dict(seq=32768, batch=128, kind="decode"),
    long_500k=dict(seq=524288, batch=1, kind="decode"),
)


def lm_cell(cfg: tr.TransformerCfg, shape_name: str, mesh,
            opt_cfg: Optional[OptCfg] = None) -> ShapeCell:
    """The LM cell of ``shape_name`` (``LM_SHAPES``): the AdamW train step
    (``loss_fn``, remat as ``cfg`` says), ``prefill`` with a cache of the
    prompt's length, or one ``decode_step`` against a full cache of
    ``seq`` rows (int8 with its bfloat16 scales where
    ``cfg.kv_cache_quant``).  Parameters come from ``init_shapes``: nothing
    is drawn.  Decode's ``cache_len`` argument is a 0-dim int32; on
    ``meta`` it has no value, and the step reads the whole cache
    (``cache_len = seq``)."""
    info = LM_SHAPES[shape_name]
    dp = data_axes_of(mesh)
    B, S = info["batch"], info["seq"]
    pspecs = tr.param_specs(cfg, mesh)
    params = tr.init_shapes(cfg)

    if info["kind"] == "train":
        opt_cfg = opt_cfg or OptCfg()
        opt_state = init_state(params)
        opt_specs = dict(mu=pspecs, nu=pspecs, step=P())
        batch = dict(tokens=sds((B, S), torch.int32), labels=sds((B, S), torch.int32))
        bspec = dict(tokens=P(dp, None), labels=P(dp, None))

        def train_step(params, opt_state, batch):
            new_p, new_s, loss, metrics = _train_update(
                lambda p, b: tr.loss_fn(cfg, p, b), opt_cfg, params, opt_state, batch)
            return new_p, new_s, dict(loss=loss, **metrics)

        out_specs = (pspecs, opt_specs, dict(loss=P(), lr=P(), grad_norm=P()))
        return ShapeCell(train_step, (params, opt_state, batch),
                         (pspecs, opt_specs, bspec), out_specs, "train")

    if info["kind"] == "prefill":
        cspec = tr.cache_specs(cfg, mesh)

        def prefill_step(params, tokens):
            return tr.prefill(cfg, params, tokens, max_len=S)

        vocab_ax = "model" if cfg.vocab % mesh.shape["model"] == 0 else None
        return ShapeCell(prefill_step, (params, sds((B, S), torch.int32)),
                         (pspecs, P(dp, None)), (P(dp, vocab_ax), (cspec, cspec)), "prefill")

    # decode: one new token against a seq-length cache
    cshape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.d_head)
    cspec = tr.cache_specs(cfg, mesh) if B > 1 else _cache_spec_b1(cfg, mesh)
    if cfg.kv_cache_quant:
        sspec = P(*cspec[:-1])                      # scales drop the Dh dim
        cache = (sds(cshape, torch.int8), sds(cshape, torch.int8),
                 sds(cshape[:-1], torch.bfloat16), sds(cshape[:-1], torch.bfloat16))
        cache_specs = (cspec, cspec, sspec, sspec)
    else:
        cache = (sds(cshape, cfg.dtype), sds(cshape, cfg.dtype))
        cache_specs = (cspec, cspec)

    def decode(params, cache, tokens, cache_len):
        n = S if cache_len.is_meta else int(cache_len)
        return tr.decode_step(cfg, params, cache, tokens, n)

    out_specs = (P(dp, None) if B > 1 else P(None, None), cache_specs)
    return ShapeCell(decode, (params, cache, sds((B,), torch.int32), sds((), torch.int32)),
                     (pspecs, cache_specs, P(dp) if B > 1 else P(), P()),
                     out_specs, "decode", note=f"cache_len={S}")


def _cache_spec_b1(cfg: tr.TransformerCfg, mesh) -> P:
    """Batch-1 long-context decode: the cache's sequence axis over the data
    axes (flash-decode style length parallelism), kv heads over ``model``
    where it divides them, else d_head."""
    if cfg.n_kv_heads % mesh.shape["model"] == 0:
        return P(None, None, "model", data_axes_of(mesh), None)
    return P(None, None, None, data_axes_of(mesh), "model")


def lm_smoke(cfg_small: tr.TransformerCfg, device: Device = None) -> dict:
    """The reference's LM smoke: parameters from seed 0, tokens [2, 16] from
    seed 1; ``forward``, ``loss_fn`` and one ``decode_step`` from an empty
    cache of 32 rows, all finite.  The config says whether the MLP is a
    mixture of experts."""
    dev = resolve_device(device)
    with torch.no_grad():
        p = tr.init_params(cfg_small, torch.Generator().manual_seed(0), device=dev)
        toks = torch.randint(0, cfg_small.vocab, (2, 16),
                             generator=torch.Generator().manual_seed(1)).to(dev)
        logits = tr.forward(cfg_small, p, toks)
        loss = tr.loss_fn(cfg_small, p, {"tokens": toks, "labels": toks})
        cache = tr.init_cache(cfg_small, 2, 32, device=dev)
        lg, cache = tr.decode_step(cfg_small, p, cache, toks[:, 0], 1)
    ok = bool(torch.isfinite(logits).all() and torch.isfinite(loss) and torch.isfinite(lg).all())
    return dict(ok=ok, loss=float(loss), logits_shape=tuple(logits.shape))


# ===================================================================== GNN
def pad512(n: int) -> int:
    """Sharded dry-run dims are padded to the 512-device multiple, in the
    port's cells as in the reference's; padding nodes and edges are masked
    (degree 0 / self-loop), so semantics are exact."""
    return -(-n // 512) * 512


GNN_SHAPES = dict(
    full_graph_sm=dict(n_nodes=2708, n_edges=10556, d_feat=1433, kind="train"),
    minibatch_lg=dict(n_nodes=232965, n_edges=114615892, batch_nodes=1024,
                      fanout=(15, 10), d_feat=602, kind="train_sampled"),
    ogb_products=dict(n_nodes=2449029, n_edges=61859140, d_feat=100, kind="train"),
    molecule=dict(n_nodes=30, n_edges=64, batch=128, d_feat=16, kind="train"),
)


def _sampler_generator(key: torch.Tensor) -> torch.Generator:
    """The sampler's generator from a [2] uint32 key: seeded from the key's
    words on its device; on ``meta`` (no words to read) a CPU generator,
    whose draws on meta tensors have shapes and no values."""
    if key.is_meta:
        return torch.Generator()
    hi, lo = (int(w) for w in key.cpu().tolist())
    return torch.Generator(device=key.device).manual_seed((hi << 32) | lo)


def gnn_cell(arch: str, cfg, shape_name: str, mesh) -> ShapeCell:
    """The GNN train step of ``shape_name`` (``GNN_SHAPES``): sampler and
    train step fused (``minibatch_lg``), or full batch (a flattened batch of
    128 graphs for ``molecule``).  Node and edge counts padded by
    ``pad512``; parameters replicated, graph arrays split over every mesh
    axis.  The gradient runs the plain segment sum (``impl='torch'``), as
    the reference's runs XLA's."""
    info = GNN_SHAPES[shape_name]
    all_ax = tuple(mesh.axis_names)
    opt_cfg = OptCfg(lr=1e-3)
    cfg = dataclasses.replace(cfg, impl="torch")
    init = lambda F: gnn_mod.INIT[arch](cfg, torch.Generator().manual_seed(0), F,
                                        device="meta")

    if info["kind"] == "train_sampled":
        N, E = pad512(info["n_nodes"]), pad512(info["n_edges"])
        seeds = info["batch_nodes"]
        f1, f2 = info["fanout"]
        params = init(info["d_feat"])
        opt_state = init_state(params)
        p_specs, o_specs = replicated(params), replicated(opt_state)
        csr = dict(indptr=sds((N + 1,), torch.int32), indices=sds((E,), torch.int32))

        def step(params, opt_state, feats, csr, seed_ids, key):
            from ..graphdata.sampler import CSR, sample_union_graph
            gids, src_l, dst_l = sample_union_graph(
                CSR(csr["indptr"], csr["indices"]), seed_ids, (f1, f2),
                _sampler_generator(key))
            gathered = feats[gids.long()]
            g = gnn_mod.GraphBatch(node_feat=gathered, edge_src=src_l, edge_dst=dst_l,
                                   coords=gathered[:, :3], targets=None)
            new_p, new_s, loss, _ = _train_update(
                lambda p, _b: gnn_mod.gnn_loss(arch, cfg, p, g), opt_cfg, params, opt_state,
                None)
            return new_p, new_s, loss

        in_specs = (p_specs, o_specs, P(all_ax, None),
                    dict(indptr=P(None), indices=P(all_ax)), P(), P())
        return ShapeCell(step, (params, opt_state, sds((N, info["d_feat"]), torch.float32),
                                csr, sds((seeds,), torch.int32), sds((2,), torch.uint32)),
                         in_specs, (p_specs, o_specs, P()), "train",
                         note="sampler+train fused")

    # full-batch (or flattened molecule batch)
    if shape_name == "molecule":
        N = pad512(info["n_nodes"] * info["batch"])
        E = pad512(info["n_edges"] * info["batch"])
        n_graphs = info["batch"]
    else:
        N, E = pad512(info["n_nodes"]), pad512(info["n_edges"])
        n_graphs = 1
    F = info["d_feat"]
    params = init(F)
    opt_state = init_state(params)
    p_specs, o_specs = replicated(params), replicated(opt_state)
    graph = dict(node_feat=sds((N, F), torch.float32), edge_src=sds((E,), torch.int32),
                 edge_dst=sds((E,), torch.int32), coords=sds((N, 3), torch.float32),
                 graph_of=sds((N,), torch.int32), targets=sds((N, 1), torch.float32))
    g_specs = dict(node_feat=P(all_ax, None), edge_src=P(all_ax), edge_dst=P(all_ax),
                   coords=P(all_ax, None), graph_of=P(all_ax), targets=P(all_ax, None))

    def step(params, opt_state, gb):
        g = gnn_mod.GraphBatch(node_feat=gb["node_feat"], edge_src=gb["edge_src"],
                               edge_dst=gb["edge_dst"], coords=gb["coords"],
                               graph_of=gb["graph_of"], n_graphs=n_graphs,
                               targets=gb["targets"])
        new_p, new_s, loss, _ = _train_update(
            lambda p, _b: gnn_mod.gnn_loss(arch, cfg, p, g), opt_cfg, params, opt_state, None)
        return new_p, new_s, loss

    return ShapeCell(step, (params, opt_state, graph), (p_specs, o_specs, g_specs),
                     (p_specs, o_specs, P()), "train")


def gnn_smoke(arch: str, cfg, device: Device = None) -> dict:
    """The reference's GNN smoke: a random graph of 40 nodes, 120 edges, 8
    features and 4 graphs (numpy seed 0), parameters from seed 0, the loss
    finite."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    N, E, F = 40, 120, 8
    t = lambda a, dt: torch.from_numpy(np.asarray(a)).to(device=dev, dtype=dt)
    with torch.no_grad():
        g = gnn_mod.GraphBatch(
            node_feat=t(rng.normal(size=(N, F)), torch.float32),
            edge_src=t(rng.integers(0, N, E), torch.int32),
            edge_dst=t(rng.integers(0, N, E), torch.int32),
            coords=t(rng.normal(size=(N, 3)), torch.float32),
            graph_of=t(rng.integers(0, 4, N), torch.int32), n_graphs=4,
            targets=t(rng.normal(size=(N, 1)), torch.float32),
        )
        params = gnn_mod.INIT[arch](cfg, torch.Generator().manual_seed(0), F, device=dev)
        loss = gnn_mod.gnn_loss(arch, cfg, params, g)
    return dict(ok=bool(torch.isfinite(loss)), loss=float(loss))
