"""Seconds to warm the server: every template of the mix at every padded
batch size up to its ``max_batch``, through ``flush(warm=True)``."""


def read(run):
    return run["setup"]["warm_s"]
