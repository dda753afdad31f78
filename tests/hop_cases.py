"""Skewed arrival CSRs and hop operands shared by the hop-kernel tests.

``tests/test_torch_hop_design.py`` holds the port's plain hop versions equal
to the JAX package's Pallas kernels on these shapes (CPU, interpret mode);
``tests/test_torch_kernels.py`` holds the CUDA kernels equal to the plain
versions on the same shapes (on the card).  Numpy only, made from a seed.

Every CSR has runs of destinations of degree 0 and 1 (the first and last
destinations included), degrees at each lane-group size of the narrow-row
kernels and one either side of it (1, 2, 4, 8, 16, 32), a zipf tail, and one
destination of degree 238 (the largest arrival degree of the main path's
100,000-person graph).  Operands hold small non-negative integers, so every
sum is exact in float32 in any order; some edges are dead (weight 0, or the
zero row N as their source) so the extremum channel sees both kinds.
"""
from __future__ import annotations

import numpy as np

HUB = 238
GROUPS = (1, 2, 4, 8, 16, 32)


def skewed_ptr(rng: np.random.Generator, V: int, hub: int = HUB) -> np.ndarray:
    """int32 [V + 1] arrival CSR pointer over the degree pattern above."""
    if V < 64:
        raise ValueError("the degree pattern needs at least 64 destinations")
    deg = np.minimum(rng.zipf(1.8, size=V) - 1, 40)
    deg[:4] = 0                                   # degree-0 run, first included
    deg[4:10] = 1                                 # degree-1 run
    for i, g in enumerate(GROUPS):                # each lane-group size +-1
        deg[12 + 3 * i: 15 + 3 * i] = (g - 1, g, g + 1)
    deg[40] = hub
    deg[-4:] = 0                                  # degree-0 run, last included
    ptr = np.zeros(V + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    return ptr.astype(np.int32)


def cols_case(seed: int, Q: int, N: int, V: int, C: int, shared_w: bool) -> dict:
    """B1 operands: state [Q, N, C], src [E] (N = zero row), w [1 or Q, E, C],
    ptr [V + 1], extremum channel mch [Q, N]."""
    rng = np.random.default_rng(seed)
    ptr = skewed_ptr(rng, V)
    E = int(ptr[-1])
    return dict(
        state=rng.integers(0, 4, size=(Q, N, C)).astype(np.float32),
        src=rng.integers(0, N + 1, size=E).astype(np.int32),
        w=(rng.random((1 if shared_w else Q, E, C)) < 0.6).astype(np.float32),
        ptr=ptr,
        mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))


def interval_case(seed: int, Q: int, N: int, V: int, B: int, shared_w: bool) -> dict:
    """B2 operands: state [Q, N, B, B + 1] (cells with start < end), src [E],
    w / sb / eb [1 or Q, E], ptr [V + 1], mch [Q, N]."""
    rng = np.random.default_rng(seed)
    ptr = skewed_ptr(rng, V)
    E = int(ptr[-1])
    wq = 1 if shared_w else Q
    cells = rng.integers(0, 3, size=(Q, N, B, B + 1)).astype(np.float32)
    cells *= np.triu(np.ones((B, B + 1), np.float32), 1)
    return dict(
        state=cells,
        src=rng.integers(0, N + 1, size=E).astype(np.int32),
        w=(rng.random((wq, E)) < 0.7).astype(np.float32),
        sb=rng.integers(0, B, size=(wq, E)).astype(np.int32),
        eb=rng.integers(0, B + 1, size=(wq, E)).astype(np.int32),
        ptr=ptr,
        mch=rng.integers(1, 500, size=(Q, N)).astype(np.float32))


def worker_shards(ptr: np.ndarray, W: int, seed: int) -> dict:
    """Cut a global CSR into W padded shards, as the partitioner lays out a
    worker's owned edges: worker 1 owns the hub, worker W-1 two short runs
    (so it is mostly pads).  Per worker: its destinations' runs in canonical
    order, padded to the longest shard with pads on the trash segment
    ``v_max``; ``eid`` the global edge of each slot (-1 for a pad) and
    ``ptr_w`` the per-worker arrival pointers [W, v_max + 2]."""
    V = ptr.shape[0] - 1
    rng = np.random.default_rng(seed)
    deg = np.diff(ptr)
    owner = rng.integers(0, W, size=V)
    owner[owner == W - 1] = 0
    owner[[5, 13]] = W - 1                 # worker W-1: two short runs, mostly pads
    owner[deg == deg.max()] = 1            # the hub
    dests = [np.nonzero(owner == w)[0] for w in range(W)]
    eruns = [np.concatenate([np.arange(ptr[v], ptr[v + 1]) for v in d] or [[]]).astype(np.int64)
             for d in dests]
    v_max = max(len(d) for d in dests)
    e_max = max(len(e) for e in eruns)
    dst_local = np.full((W, e_max), v_max, np.int32)
    eid = np.full((W, e_max), -1, np.int64)
    for w in range(W):
        loc = np.repeat(np.arange(len(dests[w])), deg[dests[w]])
        dst_local[w, :len(loc)] = loc
        eid[w, :len(loc)] = eruns[w]
    ptr_w = np.stack([np.searchsorted(dst_local[w], np.arange(v_max + 2))
                      for w in range(W)]).astype(np.int32)
    return dict(v_max=v_max, e_max=e_max, dst_local=dst_local, eid=eid, ptr_w=ptr_w,
                real=np.nonzero(eid.reshape(-1) >= 0)[0])


def edge_rows(sh, per_edge, fill):
    """Per-edge values [..., E] -> padded [W, e_max, ...] (pads = fill)."""
    x = np.moveaxis(np.asarray(per_edge), -1, 0)
    out = np.full(sh["eid"].shape + x.shape[1:], fill, x.dtype)
    real = sh["eid"] >= 0
    out[real] = x[sh["eid"][real]]
    return out


def src_rows(sh, rng, R: int):
    """Per-worker source rows into a table of R rows (R = the zero row), and
    their flat form over the W tables stacked (W * R = the zero row)."""
    W = sh["eid"].shape[0]
    s = rng.integers(0, R + 1, size=(W, sh["e_max"])).astype(np.int32)
    s[sh["eid"] < 0] = R
    flat = np.where(s < R, np.arange(W)[:, None] * R + s, W * R).reshape(-1)
    return s, flat[sh["real"]].astype(np.int32)


def at_real(sh, x_w):
    """Padded [W, e_max, ...] -> real-edge rows [E_real, ...]."""
    return x_w.reshape((-1,) + x_w.shape[2:])[sh["real"]]
