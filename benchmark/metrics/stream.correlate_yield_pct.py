"""Unfused stream engines: the share of the frames the graphed step
correlated (every stream's every event slot, each replay) that were
accepted events, from the program's counts over the run's traced
replays."""

from benchmark.spans import program_profiling


def read(r):
    prof = program_profiling()
    if prof is None:
        return None
    counts = prof.counters()
    frames = counts.get("stream.frames_correlated", 0)
    if not frames:
        return None
    return 100.0 * counts.get("stream.events_accepted", 0) / frames
