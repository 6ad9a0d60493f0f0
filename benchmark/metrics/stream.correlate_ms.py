"""The stream step's ``stream.correlate`` stage: ``condition_frames`` and
``correlate_frames`` on every event slot's frame.  Its device time a
graph replay, from the span's CUDA events captured in the graph, the
median over the traced stretch's replays."""

from benchmark.spans import replay_stage_ms


def read(r):
    return replay_stage_ms(r, "stream.correlate")
