"""Entry: the host's time from the start of a step (chunk copy, replay) to
its outputs on the host, median over the window's chunks."""

import statistics


def read(r):
    ms = r.host.get("step_ms")
    return statistics.median(ms) if ms else None
