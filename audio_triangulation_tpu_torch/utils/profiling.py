"""Profiling and runtime observability.

Counterpart of the JAX package's ``utils/profiling``, on torch:

- :func:`trace` — a ``torch.profiler`` session for everything in the
  with-block, written as a Chrome trace (``trace_*.json``) into
  ``log_dir``; the host's ops and, unless ``host``, the card's kernels
- :func:`annotate` — a named region in that timeline (``record_function``)
- :class:`StageTimer` — named per-stage accounting (counts + total time),
  timed on the card with CUDA events around each stage, or by the host
  clock without a card; ``report()`` prints the reference's table
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of a card,
  ``None`` on the CPU
- :class:`ThroughputMeter` — frames/s accounting, as in the reference
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, host: bool = False):
    """Capture a ``torch.profiler`` trace of the with-block into
    ``log_dir`` (default: ``torch-trace`` under the temporary directory);
    yields the directory.  ``host=True`` records the host's ops only."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if not host and torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available() and not host:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the profiler timeline (``record_function``)."""
    with torch.profiler.record_function(name):
        yield


class StageTimer:
    """Accumulating per-stage timer.

    >>> t = StageTimer()
    >>> with t.stage("xcorr"):
    ...     out = f(x)
    >>> t.report()

    Where there is a card, each stage is timed by two CUDA events recorded
    on the current stream around it, and its exit waits for the second (the
    reference's ``block_until_ready`` fence, for every stage); without one,
    by the host clock.  The holder the stage yields takes a ``result`` as
    in the reference; the events fence it already."""

    def __init__(self):
        self.total_s = defaultdict(float)
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        holder: dict = {}
        if not torch.cuda.is_available():
            t0 = time.perf_counter()
            try:
                yield holder
            finally:
                self.total_s[name] += time.perf_counter() - t0
                self.calls[name] += 1
            return
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        try:
            yield holder
        finally:
            stop.record()
            stop.synchronize()
            self.total_s[name] += start.elapsed_time(stop) / 1e3
            self.calls[name] += 1

    def report(self) -> str:
        lines = ["stage                 calls    total_ms     ms/call"]
        for name in sorted(self.total_s, key=self.total_s.get, reverse=True):
            t, c = self.total_s[name] * 1e3, self.calls[name]
            lines.append(f"{name:20s} {c:6d} {t:11.2f} {t / max(c, 1):11.3f}")
        return "\n".join(lines)

    def reset(self):
        self.total_s.clear()
        self.calls.clear()


def device_memory_stats(device=None) -> Optional[dict]:
    """``torch.cuda.memory_stats`` of a CUDA device (the first card by
    default); None on the CPU or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = "cuda"
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)


class ThroughputMeter:
    """Frames/sec accounting for streaming runs (the 'scope on the GPIO pin'
    equivalent for sustained-rate verification)."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.frames = 0
        self.events = 0

    def add(self, frames: int = 0, events: int = 0):
        self.frames += frames
        self.events += events

    @property
    def frames_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.frames / dt if dt > 0 else 0.0
