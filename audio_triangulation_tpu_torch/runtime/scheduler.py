"""Cooperative task scheduler with counting semaphores (a copy of the JAX
package's ``runtime/scheduler``).

Host-side capability parity with the reference's vendored protothreads
runtime (``src/lib/pico/pt_cornell_rp2040_v1_3.h``): registered tasks run
round-robin (or by priority), yield cooperatively, rendezvous through
counting semaphores, and per-task execution statistics are collected (the
``sched_stats`` counters, :1022's execution counts + cumulative time).

In this framework the scheduler coordinates host-side pipelines — ingest,
batching, device dispatch, rendering — while the device work itself rides
the CUDA stream's asynchronous launches.  Tasks are plain generators:
``yield`` hands control back (PT_YIELD); ``yield sem.wait()`` blocks on a
semaphore (PT_SEM_WAIT).
"""

from __future__ import annotations

import time

from dataclasses import dataclass, field
from typing import Generator, Optional


class Semaphore:
    """Counting semaphore (PT_SEM_INIT/WAIT/SIGNAL parity)."""

    def __init__(self, count: int = 0):
        self.count = count

    def signal(self) -> None:
        self.count += 1

    def try_wait(self) -> bool:
        if self.count > 0:
            self.count -= 1
            return True
        return False

    def wait(self) -> "_SemWait":
        return _SemWait(self)


@dataclass
class _SemWait:
    sem: Semaphore


@dataclass
class TaskStats:
    runs: int = 0
    total_s: float = 0.0


@dataclass
class _Task:
    name: str
    gen: Generator
    priority: int
    stats: TaskStats = field(default_factory=TaskStats)
    blocked_on: Optional[Semaphore] = None
    done: bool = False


class Scheduler:
    """Cooperative round-robin / priority scheduler.

    >>> sched = Scheduler()
    >>> sem = Semaphore()
    >>> def producer():
    ...     for i in range(3):
    ...         sem.signal()
    ...         yield
    >>> def consumer():
    ...     while True:
    ...         yield sem.wait()
    ...         ...
    >>> sched.add("prod", producer())
    >>> sched.add("cons", consumer())
    >>> sched.run(max_rounds=10)
    """

    def __init__(self, priority_mode: bool = False):
        self.tasks: list[_Task] = []
        self.priority_mode = priority_mode

    def add(self, name: str, gen: Generator, priority: int = 0) -> _Task:
        t = _Task(name=name, gen=gen, priority=priority)
        self.tasks.append(t)
        if self.priority_mode:
            self.tasks.sort(key=lambda q: q.priority)
        return t

    def _step_task(self, t: _Task) -> None:
        if t.done:
            return
        if t.blocked_on is not None:
            if not t.blocked_on.try_wait():
                return
            t.blocked_on = None
        t0 = time.perf_counter()
        try:
            out = next(t.gen)
            if isinstance(out, _SemWait):
                # immediately consume if available, else block
                if not out.sem.try_wait():
                    t.blocked_on = out.sem
        except StopIteration:
            t.done = True
        finally:
            t.stats.runs += 1
            t.stats.total_s += time.perf_counter() - t0

    def round(self) -> bool:
        """One scheduling round.  Returns True while any task is alive."""
        alive = False
        for t in self.tasks:
            self._step_task(t)
            alive |= not t.done
        return alive

    def run(self, max_rounds: Optional[int] = None) -> None:
        rounds = 0
        while self.round():
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                return

    def stats_report(self) -> str:
        lines = ["task                  runs    total_ms"]
        for t in self.tasks:
            lines.append(
                f"{t.name:20s} {t.stats.runs:6d} "
                f"{t.stats.total_s * 1e3:11.2f}")
        return "\n".join(lines)
