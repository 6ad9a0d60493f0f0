"""Unfused stream engines: device kernels in one replay of the graphed
step (a count)."""


def read(r):
    if r.trace is None or not r.trace.iterations:
        return None
    ops = r.trace.device_ops("kernel")
    if not ops:
        return None
    return len(ops) / r.trace.iterations
