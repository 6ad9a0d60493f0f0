"""SRP scoring: the profiler's device time of the GEMM kernels a call (the
steering product; the GCC and GN kernels are the program's own)."""


def read(r):
    if r.trace is None or not r.trace.iterations:
        return None
    ops = r.trace.device_ops("kernel", lambda n: "gemm" in n.lower())
    if not ops:
        return None
    return sum(o[3] for o in ops) / 1e3 / r.trace.iterations
