"""Chunk ingest: the profiler's device time of host-to-device copies a
step (the chunk that ``GraphedStep.__call__`` copies)."""


def read(r):
    if r.trace is None or not r.trace.iterations:
        return None
    ops = r.trace.device_ops("gpu_memcpy", lambda n: "HtoD" in n)
    if not ops:
        return None
    return sum(o[3] for o in ops) / 1e3 / r.trace.iterations
