"""What every traffic kind shares: the run's description, what the metric
readers read, a run's outcome and the correctness checks."""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import math
import time
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class Run:
    """One run of one cell: its entries and files, the command's
    arguments, the device, where a trace file may go, and when the process
    started (``time.perf_counter``).  ``margins`` are the cell's decision
    margins: how clear of a tie a decision of the reference must be to be
    judged."""

    spec: dict
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    margins: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    scratch: Path
    t_start: float
    marks: list = dataclasses.field(default_factory=list)

    def mark(self, name: str) -> None:
        """The end of a part of set-up, for the record of where it went."""
        self.marks.append((name, time.perf_counter()))

    def setup_done(self) -> float:
        return time.perf_counter() - self.t_start

    def setup_parts(self) -> dict:
        """Seconds of each marked part of set-up, in order."""
        parts, t = {}, self.t_start
        for name, at in self.marks:
            parts[name] = at - t
            t = at
        return parts


@dataclasses.dataclass
class Readings:
    """What the per-layer metric readers read: the cell's files, its shapes
    (``frames``, ``mics``, ``n``, ``bins``, ``pairs``, ``lags``, ``streams``,
    ``window``), the traced stretch (None in an untraced run) and the
    host-clock series of the window (name -> list of ms)."""

    cell: dict
    config: dict
    traffic: dict
    shapes: dict
    trace: object
    host: dict


@dataclasses.dataclass
class Outcome:
    """A run's end-to-end values, counts, checks and readings."""

    end_to_end: dict
    attempted: int
    failed: int
    checks: "Checks"
    readings: Readings
    memory_peak_bytes: int
    extra: dict = dataclasses.field(default_factory=dict)


class Checks:
    """The numbers compared with the reference, each beside its limit, and
    ``extra`` counts of what was judged.  A number passes when it is finite
    and at most its limit; a number without a limit never passes."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}
        self.extra: dict = {}

    def add(self, name: str, value: float) -> None:
        self.values[name] = float(value)

    def passed(self, name: str) -> bool:
        v, lim = self.values[name], self.limits.get(name)
        return lim is not None and math.isfinite(v) and v <= lim

    @property
    def correct(self) -> bool:
        return bool(self.values) and all(self.passed(n) for n in self.values)

    def table(self) -> dict:
        return {n: {"value": v, "limit": self.limits.get(n)}
                for n, v in self.values.items()}

    def lines(self) -> list:
        return [f"check {n}: {v!r} (limit {self.limits.get(n)!r}) "
                f"{'ok' if self.passed(n) else 'FAILED'}"
                for n, v in self.values.items()]


@contextlib.contextmanager
def quiet_gc():
    """No cyclic garbage collection inside a measured window: the objects
    made in set-up are frozen out of it and collection is off until the
    window closes, so that no collector pause lands in a step."""
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()
        gc.unfreeze()


def port_configs(config: dict):
    """The program's (PipelineConfig, GridConfig, SolverConfig) of a
    configuration file."""
    from audio_triangulation_tpu_torch import (GridConfig, PipelineConfig,
                                               SolverConfig)

    pipeline = {k: tuple(v) if isinstance(v, list) else v
                for k, v in config["pipeline"].items()}
    return (PipelineConfig(**pipeline), GridConfig(**config["grid"]),
            SolverConfig(**config["solver"]))


def mics_of(config: dict) -> np.ndarray:
    return np.asarray(config["mic_positions_m"], np.float32)


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch

    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free_device(device) -> None:
    import gc

    import torch

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def pinned(shape, dtype, device):
    """A host tensor to copy device results into: page-locked when the
    device is a card."""
    import torch

    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")
