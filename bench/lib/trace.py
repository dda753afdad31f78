"""Reduce a ``torch.profiler`` session to the numbers the metrics read.

Device busy time is the union of the intervals of every device event (kernels,
copies, sets), clipped to the traced slice; the rest of the slice is idle.
Each idle gap is named by what the host was doing at its middle: the
benchmark's own span there (``bench.flush``, ``bench.submit``,
``bench.wait``) and the innermost other host operation that covers it.
"""
from __future__ import annotations

import collections
from typing import Dict, List, Tuple

import numpy as np


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge [N, 2] intervals into disjoint sorted ones."""
    if iv.shape[0] == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    starts, ends = iv[:, 0], np.maximum.accumulate(iv[:, 1])
    new = np.ones(iv.shape[0], bool)
    new[1:] = starts[1:] > ends[:-1]
    grp = np.cumsum(new) - 1
    out = np.zeros((grp[-1] + 1, 2))
    out[:, 0] = starts[new]
    np.maximum.at(out[:, 1], grp, ends)
    return out


def reduce(prof, span_s: float, top: int = 10) -> Dict:
    """``busy_s``, ``window_s`` and per-kernel device seconds of a finished
    profiler, and the longest idle gaps by host activity."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        if tr.end <= tr.start:
            continue
        if ev.device_type == DeviceType.CUDA:
            # the benchmark's own spans are mirrored onto the device's timeline
            if getattr(ev, "is_user_annotation", False) or ev.name.startswith("bench."):
                continue
            dev.append((tr.start, tr.end, ev.name))
        elif ev.device_type == DeviceType.CPU:
            host.append((tr.start, tr.end, ev.name))
    if not dev:
        return dict(busy_s=None, window_s=span_s, kernels=[], idle_gaps=[])
    t_lo = min([s for s, _, _ in host] + [s for s, _, _ in dev])
    t_hi = t_lo + span_s * 1e6
    d = np.asarray([(max(s, t_lo), min(e, t_hi)) for s, e, _ in dev], float)
    busy = _union(d[d[:, 1] > d[:, 0]])
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e6
    per: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.Counter()
    for s, e, name in dev:
        per[name] += (e - s) / 1e6
        count[name] += 1
    kernels = sorted(((n, t, count[n]) for n, t in per.items()), key=lambda x: -x[1])
    # idle gaps: before the first busy interval, between, and after the last
    edges = np.concatenate([[t_lo], busy.ravel(), [t_hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return dict(busy_s=busy_s, window_s=span_s, kernels=kernels,
                idle_gaps=_name_gaps(gaps, host, top))


def _name_gaps(gaps: np.ndarray, host: List[Tuple[float, float, str]],
               top: int) -> List[list]:
    if gaps.shape[0] == 0:
        return []
    hs = np.asarray([h[0] for h in host], float)
    he = np.asarray([h[1] for h in host], float)
    names = [h[2] for h in host]
    is_bench = np.asarray([n.startswith("bench.") for n in names], bool)
    length = he - hs
    totals: Dict[str, float] = collections.defaultdict(float)
    n_of: Dict[str, int] = collections.Counter()
    for lo in range(0, gaps.shape[0], 256):
        g = gaps[lo:lo + 256]
        mid = (g[:, 0] + g[:, 1]) / 2
        cover = (hs[None, :] <= mid[:, None]) & (he[None, :] >= mid[:, None])
        for k in range(g.shape[0]):
            idx = np.nonzero(cover[k])[0]
            b = idx[is_bench[idx]]
            o = idx[~is_bench[idx]]
            label = names[b[np.argmin(length[b])]] if b.size else "host"
            if o.size:
                label += " > " + names[o[np.argmin(length[o])]]
            totals[label] += (g[k, 1] - g[k, 0]) / 1e6
            n_of[label] += 1
    out = sorted(totals.items(), key=lambda x: -x[1])[:top]
    return [[f"{name} (x{n_of[name]})", sec] for name, sec in out]
