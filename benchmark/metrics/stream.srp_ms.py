"""The stream step's ``stream.srp`` stage: the SRP scores of the smoothed
correlograms and the grid peak.  Its device time a graph replay, from the
span's CUDA events captured in the graph, the median over the traced
stretch's replays."""

from benchmark.spans import replay_stage_ms


def read(r):
    return replay_stage_ms(r, "stream.srp")
