"""Detector: the prefix-sum kernel's share of its roofline (bytes: the
[S, M, window] samples read once, both prefix sums written), from the
profiler's device time of ``detector_scan_kernel`` a step."""

from benchmark.roofline import scan_bound


def read(r):
    if r.trace is None:
        return None
    ops = r.trace.device_ops("kernel", lambda n: "detector_scan_kernel" in n)
    if not ops:
        return None
    ms = sum(o[3] for o in ops) / 1e3 / len(ops)
    s = r.shapes
    return 100.0 * scan_bound(s["streams"] * s["mics"] * s["window"])[
        "bound_ms"] / ms
