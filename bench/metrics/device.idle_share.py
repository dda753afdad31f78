"""Share of the traced slice in which no device operation ran: 1 - (union of
device busy intervals) / (slice length)."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["busy_s"] or not tr["window_s"]:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
