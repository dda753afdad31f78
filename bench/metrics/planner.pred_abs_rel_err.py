"""Mean |predicted - measured| / measured of the window's batched calls: the
cost model's ``predicted_ms`` (recorded by the traced run's telemetry
buffer, which never refits) against the call's CUDA-event ``event_ms``."""


def read(run):
    rows = [d for f in run["window"].flushes for d in f["dispatches"]
            if d["event_ms"] and d["predicted_ms"]]
    if not rows:
        return None
    return sum(abs(d["predicted_ms"] - d["event_ms"]) / d["event_ms"] for d in rows) / len(rows)
