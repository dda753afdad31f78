"""95th percentile (ms) of how late the open-loop generator woke for an
arrival that came while the server was idle."""
import numpy as np


def read(run):
    late = run["window"].wake_late_s
    return float(np.percentile(np.asarray(late) * 1e3, 95)) if late else None
