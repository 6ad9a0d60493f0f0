"""Chunk ingest: the host's time in the program's ``stream.ingest`` span
(``GraphedStep.__call__``'s copy of the chunk to the card), a step."""

from benchmark.spans import host_ms_a_step


def read(r):
    return host_ms_a_step(r, "stream.ingest")
