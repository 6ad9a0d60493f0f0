"""GCC kernel without peaks (row 2) in a DoA cell: its share of the
roofline, from the profiler's device time of the ``gcc_kernel`` launches a
call, against the bound of the cell's shapes (``roofline.gcc_bound``
without the peak outputs, the DFT and the synthesis as split-fp32
tensor-core products)."""

import re

from benchmark.roofline import gcc_bound

NAME = re.compile(r"\bgcc_kernel\b")


def read(r):
    if r.trace is None:
        return None
    ops = r.trace.device_ops("kernel", lambda n: bool(NAME.search(n)))
    if not ops:
        return None
    ms = sum(o[3] for o in ops) / 1e3 / len(ops)
    s = r.shapes
    bnd = gcc_bound(s["frames"], s["mics"], s["n"], s["bins"], s["pairs"],
                    s["lags"], with_peaks=False)
    return 100.0 * bnd["bound_ms"] / ms
