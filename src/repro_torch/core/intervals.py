"""Interval algebra over half-open integer intervals ``[t_s, t_e)``, in torch.

Time is a linearly ordered discrete domain (int32 time-units).  An interval is
represented as the last axis of a tensor: ``iv[..., 0] = t_s``,
``iv[..., 1] = t_e``.  An interval is *empty* iff ``t_s >= t_e``.

The eight Allen-style comparators from the paper (Sec. 3.1):

====  ===========================  =========================================
id    paper symbol                 semantics for ``a CMP b``
====  ===========================  =========================================
0     ``<<`` (fully before)        ``a.e <= b.s``
1     ``<`` (starts before)        ``a.s < b.s``
2     ``>>`` (fully after)         ``a.s >= b.e``
3     ``>`` (starts after)         ``a.s > b.s``
4     ``during``                   ``a.s > b.s and a.e < b.e``
5     ``equals``                   ``a.s == b.s and a.e == b.e``
6     ``during_eq``                ``a.s >= b.s and a.e <= b.e``
7     ``overlaps``                 ``a.s < b.e and b.s < a.e``
====  ===========================  =========================================

This module owns the comparator constants for the whole port (``query.py``
and ``ref_engine.py`` read them from here).  All tensor functions broadcast;
``bucket_edges`` is a host helper and returns numpy.
"""
from __future__ import annotations

import numpy as np
import torch

# Comparator ids (keep in sync with the table above and query.py).
FULLY_BEFORE = 0
STARTS_BEFORE = 1
FULLY_AFTER = 2
STARTS_AFTER = 3
DURING = 4
EQUALS = 5
DURING_EQ = 6
OVERLAPS = 7

TIME_CMP_NAMES = {
    "<<": FULLY_BEFORE,
    "<": STARTS_BEFORE,
    ">>": FULLY_AFTER,
    ">": STARTS_AFTER,
    "during": DURING,
    "==": EQUALS,
    "in": DURING_EQ,
    "overlaps": OVERLAPS,
}


def is_empty(iv):
    return iv[..., 0] >= iv[..., 1]


def intersect(a, b):
    """Elementwise interval intersection (may be empty)."""
    s = torch.maximum(a[..., 0], b[..., 0])
    e = torch.minimum(a[..., 1], b[..., 1])
    return torch.stack([s, e], dim=-1)


def span(a, b):
    """Smallest interval covering both."""
    s = torch.minimum(a[..., 0], b[..., 0])
    e = torch.maximum(a[..., 1], b[..., 1])
    return torch.stack([s, e], dim=-1)


def overlaps(a, b):
    nonempty = (a[..., 0] < a[..., 1]) & (b[..., 0] < b[..., 1])
    return (a[..., 0] < b[..., 1]) & (b[..., 0] < a[..., 1]) & nonempty


def _relation(op: int, a_s, a_e, b_s, b_e):
    if op == FULLY_BEFORE:
        return a_e <= b_s
    if op == STARTS_BEFORE:
        return a_s < b_s
    if op == FULLY_AFTER:
        return a_s >= b_e
    if op == STARTS_AFTER:
        return a_s > b_s
    if op == DURING:
        return (a_s > b_s) & (a_e < b_e)
    if op == EQUALS:
        return (a_s == b_s) & (a_e == b_e)
    if op == DURING_EQ:
        return (a_s >= b_s) & (a_e <= b_e)
    if op == OVERLAPS:
        return (a_s < b_e) & (b_s < a_e)
    raise ValueError(f"unknown interval comparator {op}")


def compare(op: int, a, b):
    """Vectorised Allen comparison ``a op b``.

    ``op`` is a Python int: query structure decides the comparator, so only
    the one relation that is asked for is computed.
    """
    a_s, a_e = a[..., 0], a[..., 1]
    b_s, b_e = b[..., 0], b[..., 1]
    nonempty = (a_s < a_e) & (b_s < b_e)
    return _relation(int(op), a_s, a_e, b_s, b_e) & nonempty


# ---------------------------------------------------------------------------
# Bucketised time axis (the dense stand-in for ICM's TimeWarp alignment).
# ---------------------------------------------------------------------------


def bucket_edges(t_min: int, t_max: int, n_buckets: int) -> np.ndarray:
    """Host helper: integer bucket boundaries covering [t_min, t_max)."""
    width = max(1, -(-(t_max - t_min) // n_buckets))  # ceil div
    return np.asarray([t_min + i * width for i in range(n_buckets + 1)], dtype=np.int32)


def interval_to_bucket_mask(iv, edges):
    """``bool[..., B]`` mask of buckets the interval overlaps.

    ``edges`` is ``int32[B+1]`` of bucket boundaries.  Bucket b spans
    ``[edges[b], edges[b+1])``.
    """
    lo = edges[:-1]
    hi = edges[1:]
    s = iv[..., 0:1]
    e = iv[..., 1:2]
    return (s < hi) & (lo < e)


def bucket_id(t, edges):
    """Bucket index of time-point ``t`` (clamped)."""
    b = torch.searchsorted(edges, t.contiguous(), right=True, out_int32=True) - 1
    return torch.clamp(b, 0, edges.shape[0] - 2)
