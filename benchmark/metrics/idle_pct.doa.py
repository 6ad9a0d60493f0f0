"""Device: the share of a DoA cell's traced stretch in which no operation
ran on the card (kernels, copies and sets, from the profiler)."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or not r.trace.ops:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
