"""What the per-layer readers of the program's own spans and counts share.

The program's spans (``audio_triangulation_tpu_torch.utils.profiling``)
are on in a ``--trace 1`` run.  Host spans reach the profiler's trace as
``record_function`` ranges (``Trace.host``); device times and counts are
read from the program's records.  A program without them (an older one)
gives None, never an error.
"""

from __future__ import annotations

import statistics


def program_profiling():
    """The program's profiling module if it keeps records, else None."""
    try:
        from audio_triangulation_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "records") else None


def host_ms(r, name: str) -> list:
    """The traced stretch's ``name`` host spans, each its length in ms."""
    if r.trace is None:
        return []
    return [d / 1e3 for n, _, d in r.trace.host if n == name]


def host_ms_a_step(r, name: str):
    """The ``name`` host spans' ms in the traced stretch, a step."""
    ms = host_ms(r, name)
    if not ms or not r.trace.iterations:
        return None
    return sum(ms) / r.trace.iterations


def device_ms_a_call(r, name: str):
    """The device ms of the last ``iterations`` records named ``name`` (a
    span once a call: the traced stretch's calls), their median."""
    prof = program_profiling()
    if prof is None or r.trace is None or not r.trace.iterations:
        return None
    ms = [rec.device_ms for rec in prof.records()
          if rec.name == name and rec.device_ms is not None]
    ms = ms[-r.trace.iterations:]
    return statistics.median(ms) if ms else None


def replay_stage_ms(r, name: str):
    """The device ms of the stage ``name`` a graph replay (its records
    replayed as children of ``stream.replay``), the median over the last
    ``iterations`` replays (the traced stretch's)."""
    prof = program_profiling()
    if prof is None or r.trace is None or not r.trace.iterations:
        return None
    by_call: dict = {}
    for rec in prof.records():
        if (rec.parent == "stream.replay" and rec.name == name
                and rec.device_ms is not None):
            by_call[rec.call] = by_call.get(rec.call, 0.0) + rec.device_ms
    ms = list(by_call.values())[-r.trace.iterations:]
    return statistics.median(ms) if ms else None


def device_idle_ms_in(r, name: str):
    """The device's idle ms inside the traced stretch's ``name`` host
    spans (no kernel, copy or set running), a step."""
    tr = r.trace
    if tr is None or not tr.iterations or not tr.ops:
        return None
    spans = [(s, s + d) for n, s, d in tr.host if n == name]
    if not spans:
        return None
    busy = []  # the union of the device's operations, disjoint, in order
    for _, _, s, d in sorted(tr.ops, key=lambda o: o[2]):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], s + d)
        else:
            busy.append([s, s + d])
    idle = 0.0
    for a, b in spans:
        covered = sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy
                      if s < b and e > a)
        idle += (b - a) - covered
    return idle / 1e3 / tr.iterations
