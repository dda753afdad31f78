"""Median query latency (ms) over every query answered in the run."""
import numpy as np


def read(run):
    lat = run["window"].latencies_ms()
    return float(np.percentile(lat, 50)) if lat.size else None
