"""95th percentile of query latency (ms) over every query answered in the
run: from its due time (open loop) or issue time (closed loop) to the return
of the flush that answered it."""
import numpy as np


def read(run):
    lat = run["window"].latencies_ms()
    return float(np.percentile(lat, 95)) if lat.size else None
