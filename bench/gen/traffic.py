"""The one traffic generator: a mix file's parameters to a query stream.

A mix (``bench/traffic/<mix>.json``) names its templates and their integer
shares, its loop (``open`` at ``rate_qps``, or ``closed`` with ``clients``),
the most queries of one template the front end hands the server per flush
(``max_batch``), optionally the server's temporal ``mode``, and how many
answers of each template a run judges (``judge_per_template``).

Templates follow in blocks that hold each one exactly ``share`` times, each
block shuffled, so every seed serves the same mix in another order.  Open-loop
arrivals are a Poisson process over the window conditioned on its expected
count: ``rate * seconds`` uniform times, sorted.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import queries as QB
from .ldbc import GraphData

LOOPS = ("open", "closed")


def check_mix(mix: Dict) -> None:
    """Raise on a mix file that the generator cannot serve."""
    if mix["loop"] not in LOOPS:
        raise ValueError(f"loop must be one of {LOOPS}")
    if mix["loop"] == "open" and not mix["rate_qps"] > 0:
        raise ValueError("an open loop needs rate_qps > 0")
    if mix["loop"] == "closed" and not mix["clients"] >= 1:
        raise ValueError("a closed loop needs clients >= 1")
    if mix.get("mode") not in (None, "static", "bucket", "interval"):
        raise ValueError(f"unknown mode {mix['mode']!r}")
    for t, share in mix["templates"].items():
        base = t.partition("-")[0]
        if base not in QB.BUILDERS or int(share) != share or share < 1:
            raise ValueError(f"bad template or share: {t}: {share}")
    if mix["max_batch"] < 1 or mix["judge_per_template"] < 1:
        raise ValueError("max_batch and judge_per_template must be >= 1")


def templates(mix: Dict, g: GraphData) -> Dict[str, int]:
    """The mix's templates and shares that the graph can serve (Q8 reads a
    dynamic property, so a static graph skips it)."""
    return {t: int(s) for t, s in mix["templates"].items()
            if g.params.dynamic or t.partition("-")[0] not in QB.DYNAMIC_ONLY}


def template_order(mix: Dict, g: GraphData, n: int, rng) -> List[str]:
    """``n`` template names in shuffled blocks of the exact shares."""
    block = [t for t, s in templates(mix, g).items() for _ in range(s)]
    out: List[str] = []
    while len(out) < n:
        out.extend(block[i] for i in rng.permutation(len(block)))
    return out[:n]


def build_stream(mix: Dict, g: GraphData, n: int, rng) -> List[dict]:
    """``n`` query dicts of the mix, parameters drawn from ``rng``."""
    pool = QB.pools(g)
    return [QB.build(t, rng, pool) for t in template_order(mix, g, n, rng)]


def arrivals(mix: Dict, seconds: float, rng) -> np.ndarray:
    """Open-loop arrival offsets (seconds from the window's start)."""
    n = int(round(mix["rate_qps"] * seconds))
    return np.sort(rng.uniform(0.0, seconds, size=n))
