"""Unfused stream engines: device time of the kernels of one replay."""


def read(r):
    if r.trace is None or not r.trace.iterations:
        return None
    ops = r.trace.device_ops("kernel")
    if not ops:
        return None
    return sum(o[3] for o in ops) / 1e3 / r.trace.iterations
