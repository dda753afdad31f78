"""Mean real queries a batched call (``GroupDispatch.n_real``) in the window."""


def read(run):
    rows = [d for f in run["window"].flushes for d in f["dispatches"]]
    return sum(d["n_real"] for d in rows) / len(rows) if rows else None
