"""Profiling and runtime observability.

Counterpart of the JAX package's ``utils/profiling``, on torch, with one
span system under it:

- :func:`annotate` — a named span.  Off by default: on when switched on
  (:func:`enable`, :func:`tracing`) and while a ``torch.profiler`` session
  records.  Off, a span costs two flag checks and makes nothing.  On, it
  opens a ``record_function`` (the span in a ``torch.profiler``
  trace, on the clock of the device's operations), records a pair of
  timing CUDA events on the current stream when given a CUDA ``device``
  (captured into a CUDA graph as event nodes, so that each replay times
  its stages again) and keeps a :class:`Record`: name, parent span, call
  or step id, host start and end, device time
- :func:`records`, :func:`totals`, :func:`counters` — the newest records,
  per-name totals (count, host, device and self time) and counts; device
  times are read from the events only here, never inside a span
- :func:`capture` / :func:`replayed` / :func:`resolve` — the spans of a
  CUDA graph captured with tracing on, one record each a replay
- :func:`trace` — a ``torch.profiler`` session for everything in the
  with-block, written as a Chrome trace (``trace_*.json``) into
  ``log_dir``, the spans in it
- :class:`StageTimer` — the reference's named per-stage accounting
  (counts + total time, ``report()``'s table), the read-out of its own
  records: on the card the events' time, else the host clock
- :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of a card,
  ``None`` on the CPU
- :class:`ThroughputMeter` — frames/s accounting, as in the reference
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import tempfile
import threading
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.autograd import profiler as _torch_profiler

# records kept (the newest), and unresolved records held before the oldest
# are resolved (which may wait for the device)
RING = 8192
PENDING = 2048

# a record_function range through torch's fast binding (about a tenth of
# the cost), where torch has one
_RECORD_FUNCTION = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)


@dataclasses.dataclass(eq=False)
class Record:
    """One span: its name, its parent's name (None at the top), the id its
    call or step shares with the spans inside it, host start and end
    (``time.perf_counter_ns``; both the replay's launch for a span replayed
    from a graph), and device and self times in ms once resolved
    (``device_ms`` None without events).  Self time is the span's time less
    its children's, host time against host time and device against
    device."""

    name: str
    parent: Optional[str]
    call: int
    host_start_ns: int
    host_end_ns: int = 0
    device_ms: Optional[float] = None
    host_self_ms: float = 0.0
    device_self_ms: Optional[float] = None
    events: Optional[tuple] = dataclasses.field(default=None, repr=False)
    pooled: bool = dataclasses.field(default=False, repr=False)
    up: Optional["Record"] = dataclasses.field(default=None, repr=False)
    child_host_ns: int = dataclasses.field(default=0, repr=False)
    child_device_ms: float = dataclasses.field(default=0.0, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.host_end_ns - self.host_start_ns) / 1e6


@dataclasses.dataclass
class Total:
    """A name's resolved records summed: how many, their host time and
    host self time, and of those with events their count, device time and
    device self time (ms)."""

    count: int = 0
    host_ms: float = 0.0
    host_self_ms: float = 0.0
    device_count: int = 0
    device_ms: float = 0.0
    device_self_ms: float = 0.0


class Recorder:
    """Spans, their records and totals, and counts.  One serves the
    process (:func:`annotate`); each :class:`StageTimer` has its own."""

    def __init__(self):
        self.generation = 0  # moves on each reset()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count()
        self._ring = collections.deque(maxlen=RING)
        self._pending = collections.deque()
        self._totals: dict = {}
        self._counts: dict = defaultdict(int)
        self._at_read: list = []
        # timing event pairs free for reuse, by CUDA device
        self._free: dict = defaultdict(list)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def call_id(self) -> int:
        """The open span's id, else a new one."""
        stack = self._stack()
        return stack[-1].call if stack else next(self._ids)

    def span(self, name: str, device=None, call: Optional[int] = None):
        return _Span(self, name, device, call)

    @contextlib.contextmanager
    def capture(self):
        """Collects the spans opened with a CUDA device while the current
        stream captures a graph (their events become the graph's nodes);
        yields the list, for :meth:`replayed`."""
        spans: list = []
        self._local.capture = spans
        try:
            yield spans
        finally:
            self._local.capture = None

    def replayed(self, spans: list) -> list:
        """One record for each captured span of a graph replay just
        launched, children of the open span and with its id; resolve them
        (:meth:`resolve`) before the graph's next replay."""
        if not spans:
            return []
        stack = self._stack()
        up = stack[-1] if stack else None
        call = up.call if up is not None else next(self._ids)
        now = time.perf_counter_ns()
        new = {id(s): Record(s.name, None, call, now, now, events=s.events)
               for s in spans}
        for s in spans:
            r = new[id(s)]
            r.up = new.get(id(s.up), up) if s.up is not None else up
            r.parent = r.up.name if r.up is not None else None
        recs = [new[id(s)] for s in spans]
        for r in recs:
            self._close(r)
        return recs

    def _close(self, r: Record) -> None:
        with self._lock:
            dur = r.host_end_ns - r.host_start_ns
            r.host_self_ms = (dur - r.child_host_ns) / 1e6
            if r.up is not None:
                r.up.child_host_ns += dur
            self._ring.append(r)
            if r.events is None:
                self._finish(r)
                return
            self._pending.append(r)
            # (no wait for the device while a stream captures a graph)
            if len(self._pending) > PENDING and not (
                    torch.cuda.is_initialized()
                    and torch.cuda.is_current_stream_capturing()):
                while len(self._pending) > PENDING:
                    self._resolve_one(self._pending.popleft())

    def _resolve_one(self, r: Record) -> None:
        if r.events is None:
            return
        start, end = r.events
        end.synchronize()
        r.device_ms = start.elapsed_time(end)
        r.device_self_ms = r.device_ms - r.child_device_ms
        if r.up is not None:
            r.up.child_device_ms += r.device_ms
        if r.pooled:
            self._free[start.device.index].append(r.events)
        self._finish(r)

    def event_pair(self) -> tuple:
        """Two timing events for the current CUDA device, reused once
        their record is read."""
        free = self._free[torch.cuda.current_device()]
        try:
            return free.pop()
        except IndexError:
            return (torch.cuda.Event(enable_timing=True),
                    torch.cuda.Event(enable_timing=True))

    def _finish(self, r: Record) -> None:
        r.events = r.up = None
        t = self._totals.setdefault(r.name, Total())
        t.count += 1
        t.host_ms += r.host_ms
        t.host_self_ms += r.host_self_ms
        if r.device_ms is not None:
            t.device_count += 1
            t.device_ms += r.device_ms
            t.device_self_ms += r.device_self_ms

    def resolve(self, recs=None) -> None:
        """Read the device times of ``recs`` (default: every unresolved
        record), waiting for their events."""
        with self._lock:
            if recs is None:
                while self._pending:
                    self._resolve_one(self._pending.popleft())
            else:
                for r in recs:
                    self._resolve_one(r)

    def records(self) -> list:
        """The newest records (up to ``RING``), oldest first, resolved."""
        self.resolve()
        with self._lock:
            return list(self._ring)

    def totals(self) -> dict:
        """name -> :class:`Total` of every record resolved."""
        self.resolve()
        with self._lock:
            return {n: dataclasses.replace(t) for n, t in self._totals.items()}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] += n

    def count_at_read(self, name: str, fn) -> None:
        """Adds ``fn()`` to the count ``name`` whenever counts are read."""
        with self._lock:
            self._at_read.append((name, fn))

    def counters(self) -> dict:
        with self._lock:
            out = dict(self._counts)
            at_read = list(self._at_read)
        for name, fn in at_read:
            out[name] = out.get(name, 0) + fn()
        return out

    def reset(self) -> None:
        """Forget every record, total and count."""
        with self._lock:
            self._ring.clear()
            self._pending.clear()
            self._totals.clear()
            self._counts.clear()
            self._at_read.clear()
            self.generation += 1


class _Span:
    """A span of a recorder that is on (see :func:`annotate`)."""

    __slots__ = ("rec", "name", "cuda", "call", "_rf", "_r", "_captured",
                 "_stream")

    def __init__(self, rec: Recorder, name: str, device, call):
        self.rec, self.name, self.call = rec, name, call
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self) -> Record:
        rec = self.rec
        self._rf = _RECORD_FUNCTION(self.name)
        self._rf.__enter__()
        stack = rec._stack()
        up = stack[-1] if stack else None
        call = (self.call if self.call is not None
                else up.call if up is not None else next(rec._ids))
        events = None
        # a CUDA span inside a graph's capture with a collector (see
        # Recorder.capture) is captured, not recorded: its events become
        # the graph's nodes; elsewhere in a capture it has no events
        self._captured = False
        if self.cuda and torch.cuda.is_current_stream_capturing():
            if getattr(rec._local, "capture", None) is not None:
                self._captured = True
                events = tuple(torch.cuda.Event(enable_timing=True,
                                                external=True)
                               for _ in range(2))
        elif self.cuda:
            events = rec.event_pair()
        if events is not None:
            self._stream = torch.cuda.current_stream()
            events[0].record(self._stream)
        self._r = Record(self.name, up.name if up is not None else None,
                         call, time.perf_counter_ns(), events=events,
                         pooled=not self._captured, up=up)
        stack.append(self._r)
        return self._r

    def __exit__(self, *exc) -> bool:
        r = self._r
        if r.events is not None:
            r.events[1].record(self._stream)
        r.host_end_ns = time.perf_counter_ns()
        self.rec._stack().pop()
        self._rf.__exit__(*exc)
        if self._captured:
            self.rec._local.capture.append(r)
        else:
            self.rec._close(r)
        return False


# the process's spans (annotate and the functions below) and its switch
_PROCESS = Recorder()
_OFF = contextlib.nullcontext()
_switched_on = False


def enable(on: bool = True) -> None:
    """Turn the process's spans and counts on (or off)."""
    global _switched_on
    _switched_on = bool(on)


def enabled() -> bool:
    """Whether spans and counts are made: switched on, or while a
    ``torch.profiler`` session records."""
    return _switched_on or _torch_profiler._is_profiler_enabled


@contextlib.contextmanager
def tracing(on: bool = True):
    """Switched on (or off) inside the with-block, then as it was."""
    before = _switched_on
    enable(on)
    try:
        yield
    finally:
        enable(before)


def annotate(name: str, device=None, call: Optional[int] = None):
    """A named span (a context manager; its ``as`` target is the
    :class:`Record`, or None with tracing off).  ``device``: the device the
    span's work runs on; a CUDA device times it with events.  ``call``:
    the id to record (default: the open span's, else a new one; see
    :func:`call_id`)."""
    if not (_switched_on or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _PROCESS.span(name, device, call)


def call_id() -> Optional[int]:
    """The id sibling spans of one call or step share: the open span's,
    else a new one; None with tracing off."""
    return _PROCESS.call_id() if enabled() else None


def capture():
    """See :meth:`Recorder.capture`."""
    return _PROCESS.capture()


def replayed(spans: list) -> list:
    """See :meth:`Recorder.replayed` (nothing with tracing off)."""
    return _PROCESS.replayed(spans) if enabled() else []


def resolve(recs=None) -> None:
    """See :meth:`Recorder.resolve`."""
    if recs is None or recs:
        _PROCESS.resolve(recs)


def records() -> list:
    return _PROCESS.records()


def totals() -> dict:
    return _PROCESS.totals()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` (nothing with tracing off)."""
    if enabled():
        _PROCESS.count(name, n)


def count_at_read(name: str, fn) -> None:
    _PROCESS.count_at_read(name, fn)


def counters() -> dict:
    return _PROCESS.counters()


def generation() -> int:
    """Moves each :func:`reset`: counts registered with
    :func:`count_at_read` before it are gone."""
    return _PROCESS.generation


def reset() -> None:
    _PROCESS.reset()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None, host: bool = False):
    """Capture a ``torch.profiler`` trace of the with-block into
    ``log_dir`` (default: ``torch-trace`` under the temporary directory),
    spans and all; yields the directory.  ``host=True`` records the host's
    ops only."""
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


class StageTimer:
    """Accumulating per-stage timer.

    >>> t = StageTimer()
    >>> with t.stage("xcorr"):
    ...     out = f(x)
    >>> t.report()

    Each stage is a span of the timer's own recorder, always on, whatever
    the process's switch says: where there is a card, timed by two CUDA
    events on the current stream, read (waiting for them) only when
    ``total_s``, ``calls`` or ``report()`` is read; without one, by the
    host clock.  The holder the stage yields takes a ``result`` as in the
    reference, which needs no fence here."""

    def __init__(self):
        self._rec = Recorder()
        self._device = "cuda" if torch.cuda.is_available() else None

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        holder: dict = {}
        with self._rec.span(name, self._device):
            yield holder

    @property
    def total_s(self) -> dict:
        return defaultdict(float, {
            n: (t.device_ms if t.device_count else t.host_ms) / 1e3
            for n, t in self._rec.totals().items()})

    @property
    def calls(self) -> dict:
        return defaultdict(int, {n: t.count
                                 for n, t in self._rec.totals().items()})

    def report(self) -> str:
        total_s, calls = self.total_s, self.calls
        lines = ["stage                 calls    total_ms     ms/call"]
        for name in sorted(total_s, key=total_s.get, reverse=True):
            t, c = total_s[name] * 1e3, calls[name]
            lines.append(f"{name:20s} {c:6d} {t:11.2f} {t / max(c, 1):11.3f}")
        return "\n".join(lines)

    def reset(self):
        self._rec.reset()


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
