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
