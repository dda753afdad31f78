"""Hop-kernel launches (``kernels.hop_scatter.LAUNCHES``, B1-B4) in the
window per query answered."""


def read(run):
    n = run["window"].n_done
    total = sum(run["launches"].values())
    return total / n if n and total else None
