"""The stream step's ``stream.solve`` stage: the solver tail (the batched
solve and its covariance).  Its device time a graph replay, from the
span's CUDA events captured in the graph, the median over the traced
stretch's replays."""

from benchmark.spans import replay_stage_ms


def read(r):
    return replay_stage_ms(r, "stream.solve")
