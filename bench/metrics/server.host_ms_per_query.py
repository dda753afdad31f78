"""Host milliseconds a query spends in ``flush`` outside the batched calls:
(sum of each flush's wall time - sum of its dispatches' ``service_s``) over
the queries those flushes answered.  Grouping, planning lookups, parameter
packing, result copies."""


def read(run):
    fl = run["window"].flushes
    n = sum(f["n"] for f in fl)
    if not n:
        return None
    host = sum(f["end"] - f["start"] - sum(d["service_s"] for d in f["dispatches"])
               for f in fl)
    return host * 1e3 / n
