"""Device: the card's idle time inside the program's ``stream.replay``
spans (no operation running while the host launches the graph), from the
trace's device operations and host spans, a step."""

from benchmark.spans import device_idle_ms_in


def read(r):
    return device_idle_ms_in(r, "stream.replay")
