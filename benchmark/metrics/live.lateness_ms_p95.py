"""Load generator: how late the schedule started a chunk's step past the
chunk's due time, 95th percentile over the window's chunks."""

import numpy as np


def read(r):
    ms = r.host.get("lateness_ms")
    return float(np.percentile(ms, 95)) if ms else None
