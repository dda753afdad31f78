"""Queries answered per second: every answer of the run over the time from
the window's start to the last answer."""


def read(run):
    win = run["window"]
    return win.n_done / win.elapsed_s if win.n_done and win.elapsed_s > 0 else None
