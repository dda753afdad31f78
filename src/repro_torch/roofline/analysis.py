"""Roofline terms of the dry run's cells, counted from the program itself,
at the H100's peaks.

Three terms per (arch × shape × mesh), in seconds, per chip (NVIDIA H100
SXM data sheet):

  compute    = Σ_dtype FLOPs_dtype / peak_dtype    bf16/fp16 989e12 (tensor
               cores, dense); float32 67e12 (outside the tensor cores: TF32
               is off in the port)
  memory     = bytes / 3.35e12                     HBM3
  collective = collective_bytes / 450e9            NVLink, one direction

The reference reads FLOPs and bytes from XLA's cost analysis of its compiled
SPMD program, and collective bytes from the partitioned HLO.  The port has
no compiler in between.  ``count_program`` runs a cell's step on its
``meta`` arguments under a ``TorchDispatchMode`` and counts every aten op:

  FLOPs    the matmul-class ops (mm, addmm, bmm, baddbmm, convolutions and
           the attention ops; ``torch.utils.flop_counter``'s formulas), by
           the dtype of their first input.  Elementwise work is not counted
           as FLOPs: it is the bytes it moves.
  bytes    each op's inputs read once and its outputs written once: what
           eager PyTorch moves, op by op.  Views and allocations move
           nothing; a gather reads the rows it gathers, not its whole
           source; an in-place scatter reads its source and index and reads
           and writes as many rows of its destination; ``copy_``, ``fill_``
           and ``zero_`` write their destination without reading it.  An
           input counts its storage span (an expanded input counts once).
           A copy from host memory (a table cached on first use) is not
           the card's traffic and is not counted.
  kernels  a call of a hand-written kernel's wrapper that launches its
           kernel on the card (``impl='cuda'``) counts the kernel's own
           work, not its plain version's.  On ``meta`` every wrapper runs
           its plain version (``kernels.common.launches_kernel`` needs a
           CUDA input), and B7's plain version builds float32 scores
           [B, Hkv, g, Sq, Sk] that the kernel never moves.  So B7 counts
           ``attention_work`` / ``attention_int8_work``, B8
           ``embedding_bags_work``: the formulas of ``chip_smoke.py``'s
           kernel table.  The hop and segment-sum kernels (B1-B5) count
           their tensor operands read once and their outputs written once,
           and no FLOPs.  The plain version still runs, uncounted, for its
           output's shape.

The count is of the global program at the cell's global shapes; the
per-chip figures divide it by the chip count (an even split: work the
sharded program repeats on every chip, such as a replicated parameter's
update, is understated by that factor).  The layers are a Python loop, so
the trace sees each one: ``scan_scale`` is 1.

``collective_bytes`` is a model, not a reading (see its docstring).
``collective_bytes_from_hlo``, the reference's parser of XLA's partitioned
HLO, is not ported: the port has no HLO, and nothing in it partitions a
program.  The port's collective figures are its own and are not held equal
to the reference's.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels.flash_attention.ref import visible_rows
from ..launch.mesh import data_axes_of, shard_shape

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (data sheet)
F32_FLOP_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM bf16/fp16 tensor cores, dense
NVLINK_BYTES_PER_S = 450e9     # H100 SXM NVLink 4, one direction
FLOP_RATE = {"bf16": BF16_FLOP_PER_S, "f32": F32_FLOP_PER_S}
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
COUNT_SOURCE = ("torch_dispatch on meta: aten ops (matmul-class FLOPs by dtype; inputs "
                "read once, outputs written once), kernel regions by their work formulas")


def dtype_class(dtype: torch.dtype) -> str:
    """'bf16' for the tensor cores' 16-bit types, else 'f32'."""
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "f32"


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> tuple:
    """(ms, 'bytes' or 'operations'): the larger of ``nbytes`` over HBM and
    ``flops`` over ``flop_rate``."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / flop_rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


# =========================================================================
# the kernels' work formulas (chip_smoke.py's kernel table reads these)
# =========================================================================
def attention_work(q, k, kw) -> tuple:
    """(bytes that must move, visible query-key pairs) of one attention call
    (B7): q and the output once, and the K/V rows some query row sees.  Its
    operations are 4 D a pair, at the rate of q's dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    pos = np.arange(Sq, dtype=np.int64) + kw.get("q_offset", 0)
    hi = np.minimum(pos + 1, Sk) if kw.get("causal", True) else np.full(Sq, Sk)
    w = kw.get("window")
    lo = np.maximum(pos - w + 1, 0) if w is not None else np.zeros(Sq, np.int64)
    pairs = int(np.maximum(hi - lo, 0).sum()) * B * Hq
    rows = int(max(hi.max() - lo.min(), 0))
    nbytes = q.element_size() * (2 * B * Hq * Sq * D + 2 * B * Hkv * rows * D)
    return nbytes, pairs


def attention_int8_work(q, k8, kw) -> tuple:
    """(bytes, operations) of one decode call over an int8 cache (B7's int8
    route): q and the output in q's dtype, the visible int8 K/V rows and
    their bfloat16 scales; 4 D operations a visible query-key pair and one
    dequantizing multiply an element read, all at the float32 rate."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k8.shape[1], k8.shape[2]
    lo, hi = visible_rows(Sq, Sk, kw.get("causal", True), kw.get("window"),
                          kw.get("q_offset", 0))
    rows = hi - lo
    nbytes = 2 * q.numel() * q.element_size() + 2 * B * Hkv * rows * (D + 2)
    flops = 4.0 * D * B * Hq * Sq * rows + 2.0 * B * Hkv * rows * D
    return nbytes, flops


def embedding_bags_work(n_bags: int, lookups: int, D: int, unique_rows) -> tuple:
    """(bytes, operations) of B8 over F float32 tables, one entry of
    ``unique_rows`` a table (the distinct rows its indices read): per table
    the indices [n_bags, lookups] (int32), each distinct row once and the
    bags [n_bags, D] written; one add an element looked up."""
    nbytes = sum(4.0 * (n_bags * lookups + u * D + n_bags * D) for u in unique_rows)
    return nbytes, float(n_bags * len(unique_rows) * lookups * D)


# =========================================================================
# counting
# =========================================================================
aten = torch.ops.aten
_FREE = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
         aten.new_empty_strided, aten.detach, aten.lift_fresh, aten._unsafe_view,
         aten.alias, aten.resize_, aten.set_}
_GATHER = {aten.index, aten.embedding, aten.gather, aten.index_select}
_SCATTER_INPLACE = {aten.index_add_, aten.scatter_add_, aten.scatter_, aten.scatter_reduce_,
                    aten.index_put_, aten._index_put_impl_, aten.index_copy_}
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
_COPIES = {aten._to_copy, aten.copy_, aten.lift_fresh, aten.lift_fresh_copy}


def _tensors(tree) -> list:
    """The tensors of nested lists, tuples and dicts, in order."""
    out, stack = [], [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            stack.extend(reversed(x))
        elif isinstance(x, dict):
            stack.extend(reversed(list(x.values())))
    return out


def _span(t: torch.Tensor) -> float:
    """Bytes of ``t``'s storage span: its elements, an expanded (stride 0)
    axis once."""
    if t.numel() == 0:
        return 0.0
    span = 1 + sum((n - 1) * abs(s) for n, s in zip(t.shape, t.stride()) if n > 1)
    return float(min(span, t.numel()) * t.element_size())


_ALIASES: Dict[Any, bool] = {}


def _aliases(func) -> bool:
    """True for an op whose outputs are views of its inputs (view, expand,
    split, unbind, ...): it moves nothing."""
    got = _ALIASES.get(func)
    if got is None:
        got = _ALIASES[func] = func.is_view or any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
    return got


def _unique(ts: list) -> list:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


@dataclasses.dataclass
class Counts:
    """A program's work, globally: matmul-class FLOPs by dtype class, bytes,
    the aten ops seen, and per kernel region its calls, bytes and FLOPs
    (included in the totals)."""
    flops: Dict[str, float]
    bytes: float
    ops: int
    kernels: Dict[str, dict]
    seconds: float = 0.0

    def compute_s(self) -> float:
        """Seconds of the FLOPs at their dtypes' peaks."""
        return sum(f / FLOP_RATE[d] for d, f in self.flops.items())

    def memory_s(self) -> float:
        """Seconds of the bytes over HBM."""
        return self.bytes / HBM_BYTES_PER_S


def _meta_cumsum(x: torch.Tensor, dim: int, dtype: Optional[torch.dtype] = None):
    """``cumsum``'s output on ``meta``.  Its meta kernel is the reference
    decomposition, which builds an [..., n, n] mask: past 2^63 bytes (an ETR
    hop's prefix over 436 M edges in 16 buckets) it cannot even size it."""
    if dtype is None:
        dtype = x.dtype if x.is_floating_point() or x.is_complex() else torch.int64
    return torch.empty(x.shape, dtype=dtype, device="meta")


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = {"bf16": 0.0, "f32": 0.0}
        self.bytes = 0.0
        self.ops = 0
        self.kernels: Dict[str, dict] = {}
        self.paused = 0

    def region(self, name: str, nbytes: float, flops: Dict[str, float]) -> None:
        k = self.kernels.setdefault(name, dict(calls=0, bytes=0.0, flops=0.0))
        k["calls"] += 1
        k["bytes"] += float(nbytes)
        k["flops"] += float(sum(flops.values()))
        self.bytes += float(nbytes)
        for d, f in flops.items():
            self.flops[d] += float(f)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket is aten.cumsum and args[0].is_meta:
            out = _meta_cumsum(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        if self.paused:
            return out
        packet = func.overloadpacket
        if packet in _COPIES and any(t.device.type == "cpu" for t in _tensors((args, kwargs))):
            return out              # a copy from host memory: not the card's traffic
        self.ops += 1
        if packet in _FREE or _aliases(func):
            return out
        ins = _unique(_tensors((args, kwargs)))
        outs = [t for t in _unique(_tensors(out)) if all(t is not i for i in ins)]
        if packet in _GATHER:
            # the index, and the gathered rows (as many as the output holds)
            # read and written
            nbytes = sum(map(_span, ins[1:])) + 2 * sum(map(_span, _tensors(out)))
        elif packet in _SCATTER_INPLACE:
            # index and values read; as many rows of the destination read
            # and written as the values hold (the values come last)
            dst, src = ins[0], ins[1:]
            moved = _span(src[-1]) if src else _span(dst)
            nbytes = sum(map(_span, src)) + 2 * min(_span(dst), moved)
        elif packet in _WRITE_ONLY:
            nbytes = sum(map(_span, ins[1:])) + _span(ins[0])
        else:
            nbytes = sum(map(_span, ins)) + sum(map(_span, outs))
        self.bytes += nbytes
        fl = flop_registry.get(packet)
        if fl is not None and ins:
            self.flops[dtype_class(ins[0].dtype)] += float(fl(*args, **kwargs, out_val=out))
        return out


_ACTIVE: list = []


def _b7(a: dict, out) -> tuple:
    q, k = a["q"], a["k"]
    kw = dict(causal=a["causal"], window=a["window"], q_offset=a["q_offset"])
    if a["scales"] is not None:
        nbytes, flops = attention_int8_work(q, k, kw)
        return nbytes, {"f32": flops}
    nbytes, pairs = attention_work(q, k, kw)
    return nbytes, {dtype_class(q.dtype): 4.0 * q.shape[-1] * pairs}


def _b8_tables(a: dict, out) -> tuple:
    """Distinct rows unknown on meta: each lookup a distinct row, at most a
    table's rows."""
    n_bags, _, L = a["indices"].shape
    tables = a["tables"]
    nbytes, flops = embedding_bags_work(n_bags, L, tables[0].shape[-1],
                                        [min(n_bags * L, t.shape[0]) for t in tables])
    return nbytes, {"f32": flops}


def _b8_table(a: dict, out) -> tuple:
    n_bags, L = a["indices"].shape
    V, D = a["table"].shape
    nbytes, flops = embedding_bags_work(n_bags, L, D, [min(n_bags * L, V)])
    return nbytes, {"f32": flops}


def _operands(a: dict, out) -> tuple:
    """Every tensor operand read once, every output written once."""
    ins = _unique(_tensors(list(a.values())))
    outs = [t for t in _unique(_tensors(out)) if all(t is not i for i in ins)]
    return sum(map(_span, ins)) + sum(map(_span, outs)), {}


def _regions() -> list:
    """(module, attribute, region name, work) of every kernel wrapper the
    models and engines call, as they call it (a module attribute)."""
    from ..kernels import bucket_scatter as BS
    from ..kernels import hop_scatter as HK
    from ..kernels.embedding_bag import ops as EB
    from ..kernels.flash_attention import ops as FA

    return ([(FA, "flash_attention", "flash_attention", _b7),
             (EB, "embedding_bags", "embedding_bag", _b8_tables),
             (EB, "embedding_bag", "embedding_bag", _b8_table),
             (BS, "bucket_scatter", "bucket_scatter", _operands)]
            + [(HK, n, n, _operands) for n in ("fused_hop_cols", "fused_hop_interval",
                                               "scatter_cols", "scatter_extremum")])


def _counted(orig: Callable, name: str, work: Callable) -> Callable:
    sig = inspect.signature(orig)

    def wrapper(*args, **kwargs):
        mode = _ACTIVE[-1] if _ACTIVE else None
        if mode is None or mode.paused:
            return orig(*args, **kwargs)
        bound_args = sig.bind(*args, **kwargs)
        bound_args.apply_defaults()
        a = dict(bound_args.arguments)
        if a.get("impl", "cuda") != "cuda":       # the plain version runs on the card too
            return orig(*args, **kwargs)
        mode.paused += 1
        try:
            out = orig(*args, **kwargs)
        finally:
            mode.paused -= 1
        nbytes, flops = work(a, out)
        mode.region(name, nbytes, flops)
        return out

    return wrapper


def count_program(fn: Callable, args, kwargs: Optional[dict] = None,
                  return_output: bool = False):
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors: nothing is computed
    or stored) and count its work; see the module docstring.  Returns the
    ``Counts``, and ``fn``'s output too where ``return_output``."""
    patched = [(mod, attr, getattr(mod, attr)) for mod, attr, _, _ in _regions()]
    for (mod, attr, orig), (_, _, name, work) in zip(patched, _regions()):
        setattr(mod, attr, _counted(orig, name, work))
    counter = _Counter()
    t0 = time.perf_counter()
    try:
        _ACTIVE.append(counter)
        with counter:
            out = fn(*args, **(kwargs or {}))
    finally:
        _ACTIVE.pop()
        for mod, attr, orig in patched:
            setattr(mod, attr, orig)
    counts = Counts(dict(counter.flops), counter.bytes, counter.ops, counter.kernels,
                    time.perf_counter() - t0)
    return (counts, out) if return_output else counts


# =========================================================================
# sharding: blocks and the collective model
# =========================================================================
def _axes_size(mesh, axes) -> int:
    return int(math.prod(mesh.shape[a] for a in axes))


def _spec_axes(spec) -> list:
    """Every mesh axis a spec splits some dimension over."""
    return [a for i in range(len(spec)) for a in spec.axes(i)]


def block_bytes(t: torch.Tensor, spec, mesh) -> float:
    """Bytes of the block of ``t`` one device holds under ``spec``
    (``launch.mesh.shard_shape``)."""
    return float(math.prod(shard_shape(t.shape, spec, mesh)) * t.element_size())


def paired(tree, specs) -> list:
    """(tensor, spec) for every tensor of ``tree`` and the spec at its place
    in ``specs`` (a spec is a leaf, though it is a tuple)."""
    if isinstance(tree, torch.Tensor):
        return [(tree, specs)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in paired(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [p for i, v in enumerate(tree) for p in paired(v, specs[i])]
    return []


def memory_per_device(cell, mesh, output=None) -> dict:
    """The reference's memory keys, per device: the sharded blocks of the
    arguments and of ``output`` (the step's output, where traced).  No
    buffer assignment on ``meta``: ``temp_bytes`` and ``code_bytes`` are
    None."""
    arg = sum(block_bytes(t, s, mesh) for a, s in zip(cell.args, cell.in_shardings)
              for t, s in paired(a, s))
    out = (None if output is None else
           sum(block_bytes(t, s, mesh) for t, s in paired(output, cell.out_shardings)))
    return dict(argument_bytes=int(arg), output_bytes=None if out is None else int(out),
                temp_bytes=None, code_bytes=None)


def collective_bytes(cell, mesh) -> Dict[str, float]:
    """Modelled per-chip collective bytes of one step, by kind, from the
    cell's partition specs (the reference's convention: an all-reduce moves
    2x its size, an all-gather its output, a reduce-scatter its input
    block):

      parameters  a leaf split over a data axis (FSDP) is all-gathered to
                  its block over the other axes before use: once a step,
                  and again in the backward pass of a train step, whose
                  gradient is then reduce-scattered (the same block's
                  bytes).  In a train step, a leaf not split over the data
                  axes has its gradient block all-reduced over the chips
                  that hold it (the data-parallel reduction of replicated
                  GNN, DLRM and LM parameters).
      activations an LM whose ``wo`` (and dense or in-expert ``wd``) is split
                  over ``model`` all-reduces the output of each, [tokens of
                  a data shard, d_model] in the weights' dtype, once a layer
                  forward and once backward (train).

    Not modelled: the MoE experts' token exchange under expert parallelism,
    the recombination of a cache split over d_head, remat's recomputed
    forward, DLRM's exchange of looked-up rows across table shards, and the
    query engine's frontier exchange (a ``query`` cell models nothing)."""
    out = dict.fromkeys(COLLECTIVES, 0.0)
    if cell.kind == "query":
        return out
    train = cell.kind == "train"
    data_axes = data_axes_of(mesh)
    params = paired(cell.args[0], cell.in_shardings[0])
    for t, spec in params:
        axes = _spec_axes(spec)
        split = _axes_size(mesh, axes)
        dsplit = _axes_size(mesh, [a for a in axes if a in data_axes])
        blk = block_bytes(t, spec, mesh)
        if dsplit > 1:
            out["all-gather"] += (2 if train else 1) * blk * dsplit
            if train:
                out["reduce-scatter"] += blk * dsplit
        elif train and mesh.size // split > 1:
            out["all-reduce"] += 2.0 * blk
    p = cell.args[0]
    layers = p.get("layers") if isinstance(p, dict) else None
    if isinstance(layers, dict) and "wo" in layers:        # an LM
        pspec = cell.in_shardings[0]["layers"]
        if cell.kind == "train":
            tok, tspec = cell.args[-1]["tokens"], cell.in_shardings[-1]["tokens"]
        else:                                            # prefill: tokens; decode: tokens
            i = 1 if cell.kind == "prefill" else 2
            tok, tspec = cell.args[i], cell.in_shardings[i]
        tokens = tok.numel() / _axes_size(mesh, tspec.axes(0))
        wo = layers["wo"]
        L, D = wo.shape[0], wo.shape[-1]
        act = tokens * D * wo.element_size()
        wd_split = pspec["wd"].axes(1) if wo.dim() == layers["wd"].dim() \
            else pspec["wd"].axes(2)                     # dense [L, F, D]; MoE [L, E, Fe, D]
        n_ar = ("model" in pspec["wo"].axes(1)) + ("model" in wd_split)
        out["all-reduce"] += 2.0 * act * n_ar * L * (2 if train else 1)
    return out


# =========================================================================
# the report
# =========================================================================
@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float               # per chip: the counted FLOPs / chips
    hlo_bytes: float               # per chip: the counted bytes / chips
    collective_bytes: float
    coll_by_kind: Dict[str, float]
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    model_flops: Optional[float] = None
    useful_flops_frac: Optional[float] = None
    memory_per_device: Optional[dict] = None
    scan_scale: float = 1.0
    count_source: str = COUNT_SOURCE
    flops_by_dtype: Optional[Dict[str, float]] = None    # per chip
    kernel_regions: Optional[Dict[str, dict]] = None     # global

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def analyze_counts(counts: Counts, cell, mesh, arch: str, shape: str, mesh_name: str,
                   model_flops: Optional[float] = None, output=None) -> RooflineReport:
    """The report of one cell on one mesh from its program's ``counts``.
    Where the cell has ``analytic_flops`` and the counted FLOPs are over 50
    times it, the analytic count is trusted (the reference's rule)."""
    chips = mesh.size
    by_dtype = {d: f / chips for d, f in counts.flops.items()}
    flops = sum(by_dtype.values())
    analytic = getattr(cell, "analytic_flops", None)
    if analytic is not None and flops > 50.0 * analytic / chips:
        by_dtype = {"f32": analytic / chips, "bf16": 0.0}
        flops = analytic / chips
    byts = counts.bytes / chips
    coll = collective_bytes(cell, mesh)
    coll_total = float(sum(coll.values()))
    t_c = sum(f / FLOP_RATE[d] for d, f in by_dtype.items())
    t_m = byts / HBM_BYTES_PER_S
    t_x = coll_total / NVLINK_BYTES_PER_S
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, hlo_flops=flops,
        hlo_bytes=byts, collective_bytes=coll_total, coll_by_kind=coll, t_compute=t_c,
        t_memory=t_m, t_collective=t_x, bottleneck=max(terms, key=terms.get),
        model_flops=model_flops,
        useful_flops_frac=(model_flops / (flops * chips) if model_flops and flops else None),
        memory_per_device=memory_per_device(cell, mesh, output), scan_scale=1.0,
        flops_by_dtype=by_dtype, kernel_regions=counts.kernels)


def roofline_terms(report: RooflineReport) -> dict:
    return dict(compute=report.t_compute, memory=report.t_memory,
                collective=report.t_collective, bottleneck=report.bottleneck)


def save_report(report: RooflineReport, path: str):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report.to_json(), f, indent=2)
