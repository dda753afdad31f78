"""Seconds to build the program's host tables (traversal arrays, ETR rank
tables) and upload them (``core.engine.prepare_gdev``), to a synchronise."""


def read(run):
    return run["setup"]["tables_s"]
