"""Entry: the host's time in the program's ``stream.replay`` span
(``GraphedStep.__call__``'s graph replay), a step."""

from benchmark.spans import host_ms_a_step


def read(r):
    return host_ms_a_step(r, "stream.replay")
