"""CUDA-event milliseconds of the batched calls (``GroupDispatch.event_ms``)
per query they answered, over the window."""


def read(run):
    rows = [d for f in run["window"].flushes for d in f["dispatches"]
            if d["event_ms"] is not None]
    n = sum(d["n_real"] for d in rows)
    return sum(d["event_ms"] for d in rows) / n if n else None
