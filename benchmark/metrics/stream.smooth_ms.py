"""The stream step's ``stream.smooth`` stage: the best lags, the taper, the
shift gate, the EMA and the new best shifts.  Its device time a graph
replay, from the span's CUDA events captured in the graph, the median over
the traced stretch's replays."""

from benchmark.spans import replay_stage_ms


def read(r):
    return replay_stage_ms(r, "stream.smooth")
