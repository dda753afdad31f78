"""Seconds to construct the ``BatchScheduler``: the graph fingerprint, the
planner's ``GraphStats`` histograms and its ``Planner``."""


def read(run):
    return run["setup"]["server_s"]
