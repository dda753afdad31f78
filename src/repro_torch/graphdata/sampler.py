"""Neighbour sampler for sampled GNN inference and training (the
``minibatch_lg`` shape).

The counterpart of the reference's ``graphdata/sampler.py``: GraphSAGE-style
fixed-fanout uniform neighbour sampling over a CSR adjacency, on the
adjacency's device.  Layer l expands the current frontier by ``fanout[l]``
sampled neighbours (with replacement; a node of degree 0 loops to itself).
Draws come from a ``torch.Generator`` on that device, so they are not the
reference's threefry draws; the shapes, the local ids and the rule are the
same.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ..kernels.common import resolve_device


@dataclasses.dataclass(frozen=True)
class CSR:
    indptr: torch.Tensor   # int32 [N+1]
    indices: torch.Tensor  # int32 [E]

    @staticmethod
    def from_edge_index(src, dst, n_nodes: int,
                        device: Optional[Union[str, torch.device]] = None) -> "CSR":
        """Out-neighbour lists of the edges ``src[i] → dst[i]`` (numpy arrays
        or tensors), built on ``device``; a node's neighbours keep the edges'
        order."""
        dev = resolve_device(device)
        src, dst = torch.as_tensor(src, device=dev), torch.as_tensor(dst, device=dev)
        order = torch.argsort(src, stable=True)
        indices = dst[order].to(torch.int32)
        del order
        indptr = torch.zeros(n_nodes + 1, dtype=torch.int64, device=dev)
        torch.cumsum(torch.bincount(src, minlength=n_nodes), 0, out=indptr[1:])
        return CSR(indptr.to(torch.int32), indices)


@dataclasses.dataclass
class SampledBlock:
    """One message-passing layer block: edges point sampled-neighbour → target."""
    src: torch.Tensor      # int32 [n_edges] — global node ids (sampled neighbours)
    dst: torch.Tensor      # int32 [n_edges] — global node ids (targets)


@dataclasses.dataclass
class SampledSubgraph:
    layers: List[SampledBlock]       # outermost layer first
    nodes: torch.Tensor              # all node ids touched (frontier order)
    seeds: torch.Tensor


def sample_neighbors(csr: CSR, frontier: torch.Tensor, fanout: int,
                     generator: torch.Generator) -> torch.Tensor:
    """Uniform with-replacement sampling: returns int32 [len(frontier), fanout]."""
    f = frontier.long()
    start = csr.indptr[f].long()
    deg = csr.indptr[f + 1].long() - start
    u = torch.rand((f.shape[0], fanout), generator=generator, device=f.device)
    r = (u * deg.clamp_min(1)[:, None]).long()
    r = torch.minimum(r, (deg - 1).clamp_min(0)[:, None])
    has = (deg > 0)[:, None]
    pos = torch.where(has, start[:, None] + r, 0)    # degree 0 reads nothing
    nbr = csr.indices[pos]
    # zero-degree → self loop
    return torch.where(has, nbr, frontier[:, None].to(nbr.dtype)).to(torch.int32)


def sample_subgraph(csr: CSR, seeds: torch.Tensor, fanouts: Sequence[int],
                    generator: torch.Generator) -> SampledSubgraph:
    """k-hop fanout sampling; frontier grows seeds → seeds·f1 → seeds·f1·f2."""
    layers: List[SampledBlock] = []
    frontier = seeds
    all_nodes = [seeds]
    for f in fanouts:
        nbr = sample_neighbors(csr, frontier, f, generator)       # [n, f]
        src = nbr.reshape(-1)
        dst = torch.repeat_interleave(frontier, f)
        layers.append(SampledBlock(src, dst.to(torch.int32)))
        frontier = src
        all_nodes.append(src)
    # layer[0] aggregates the outermost sampled neighbours, as the models
    # consume them
    return SampledSubgraph(layers[::-1], torch.cat(all_nodes), seeds)


def sample_union_graph(csr: CSR, seeds: torch.Tensor, fanouts: Sequence[int],
                       generator: torch.Generator
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fanout sampling returning a *local* union graph.

    Sampled slots get positional local ids (no dedup — fixed-fanout standard):
    seeds → [0, S); layer-l samples appended contiguously.  The local
    destinations ``offset_prev + repeat(arange(n), f)`` therefore come out
    sorted ascending, and the returned global ids gather node features.

    Returns (global_ids [n_total], src_local [E_sub], dst_local [E_sub]),
    all int32.
    """
    dev = seeds.device
    frontier = seeds
    globals_, srcs, dsts = [seeds.to(torch.int32)], [], []
    offset_prev, offset_next = 0, seeds.shape[0]
    for f in fanouts:
        nbr = sample_neighbors(csr, frontier, f, generator)       # [n, f]
        n = frontier.shape[0]
        srcs.append(offset_next + torch.arange(n * f, dtype=torch.int32, device=dev))
        dsts.append(offset_prev + torch.arange(n, dtype=torch.int32, device=dev)
                    .repeat_interleave(f))
        globals_.append(nbr.reshape(-1))
        frontier = nbr.reshape(-1)
        offset_prev, offset_next = offset_next, offset_next + n * f
    return torch.cat(globals_), torch.cat(srcs), torch.cat(dsts)


def block_shapes(n_seeds: int, fanouts: Sequence[int]) -> List[Tuple[int, int]]:
    """Static (n_edges, n_targets) per layer, outermost-first."""
    sizes = [n_seeds]
    for f in fanouts:
        sizes.append(sizes[-1] * f)
    shapes = [(sizes[l] * f, sizes[l]) for l, f in enumerate(fanouts)]
    return shapes[::-1]
