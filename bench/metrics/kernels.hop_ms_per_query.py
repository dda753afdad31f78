"""Device milliseconds of the hop kernels B1-B4 (``csrc/hop_scatter.cu``) in
the traced slice, per query the slice's flushes answered."""
import re

HOP_KERNELS = re.compile(r"\b(narrow_kernel|wide_kernel|interval_warp_kernel|"
                         r"interval_block_kernel|extremum_seed_kernel|extremum_kernel)\b")


def read(run):
    tr = run["trace"]
    if not tr or not tr["kernels"] or not tr.get("flushes"):
        return None
    lo, hi = tr["flushes"]
    n = sum(f["n"] for f in run["window"].flushes[lo:hi])
    sec = sum(s for name, s, _ in tr["kernels"] if HOP_KERNELS.search(name))
    return sec * 1e3 / n if n and sec else None
