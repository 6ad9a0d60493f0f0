"""Offline batch localization: calls of ``Localizer.forward`` on frame
batches held on the card, issued ahead with at most ``in_flight`` calls in
flight, each call's ``xy`` read back to the host.

End to end, ``frames_per_s``: the frames of every call whose ``xy``
reached the host inside the window, over the window's seconds.  The check:
a sample of the window's calls, drawn from the seed (a reservoir), every
frame of each against the float64 reference chain on the same frames:
``tdoa_gap`` (samples), ``grid_gap`` (how far below the reference's best
score, as a share of it, the reference scores the program's grid cell) and
``xy_gap_m``.
"""

from __future__ import annotations

import collections
import time

import numpy as np

from .. import reference, scenes, trace as trace_mod
from ..harness import (Checks, Outcome, Readings, free_device, memory_peak,
                       mics_of, pinned, port_configs, quiet_gc, sync)

WARMUP_CALLS = 2


def build(run):
    """The program's localizer and the frame pool, on the run's device."""
    from audio_triangulation_tpu_torch import Localizer

    pipeline, grid, solver = port_configs(run.config)
    loc = Localizer.create(mics_of(run.config), pipeline, grid, solver,
                           device=run.device,
                           init_grid_stride=run.config["init_grid_stride"])
    run.mark("program objects")
    pool = scenes.frame_pool(run.config, run.traffic, run.seed, run.device)
    sync(run.device)
    run.mark("inputs")
    return loc, pool


class Loop:
    """Calls issued ahead: ``call()`` issues one and, while ``in_flight``
    are pending, waits for the oldest; ``drain()`` waits for the rest.
    ``done`` holds (call index, host time its ``xy`` was read)."""

    def __init__(self, loc, pool, in_flight: int, device, keep):
        import torch

        self.loc, self.pool, self.device = loc, pool, device
        self.in_flight = in_flight
        self.keep = keep
        b = pool[0].shape[0]
        self.bufs = [pinned((b, 2), torch.float32, device)
                     for _ in range(in_flight + 1)]
        self.pending = collections.deque()
        self.done = []
        self.entry_ms = []
        self.issued = 0
        self.cuda = torch.device(device).type == "cuda"

    def call(self):
        import torch

        i = self.issued
        frames = self.pool[i % len(self.pool)]
        with torch.profiler.record_function("bench.call"):
            t0 = time.perf_counter()
            out = self.loc(frames)
            self.entry_ms.append((time.perf_counter() - t0) * 1e3)
        buf = self.bufs[i % len(self.bufs)]
        buf.copy_(out["xy"], non_blocking=self.cuda)
        ev = torch.cuda.Event() if self.cuda else None
        if ev is not None:
            ev.record()
        self.keep(i, out)
        self.pending.append((i, ev))
        self.issued += 1
        while len(self.pending) >= self.in_flight:
            self._wait()

    def _wait(self):
        import torch

        i, ev = self.pending.popleft()
        with torch.profiler.record_function("bench.readback"):
            if ev is not None:
                ev.synchronize()
        self.done.append((i, time.perf_counter()))

    def drain(self):
        while self.pending:
            self._wait()


class Reservoir:
    """A uniform sample of ``k`` calls' outputs (tdoa, grid xy, xy), drawn
    from the seed as the calls come."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 1])
        self.kept = {}
        self.active = True

    def __call__(self, i: int, out: dict):
        if not self.active:
            return
        item = (out["tdoa_samples"], out["xy_grid"], out["xy"])
        if len(self.kept) < self.k:
            self.kept[i] = item
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = item


def run(run) -> Outcome:
    from audio_triangulation_tpu_torch.tools.bench_configs import route_of

    tr = run.traffic
    loc, pool = build(run)
    b = pool[0].shape[0]
    for k in range(WARMUP_CALLS):
        loc(pool[k % len(pool)])["xy"].cpu()
    sync(run.device)
    path = route_of(loc, pool[0])
    run.mark("warm-up (kernel library built or loaded)")
    setup_s = run.setup_done()

    sample = Reservoir(tr["check_calls"], run.seed)
    loop = Loop(loc, pool, tr["in_flight"], run.device, sample)
    with quiet_gc():
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while time.perf_counter() < deadline:
            loop.call()
    issued = loop.issued
    sample.active = False
    traced = None
    if run.trace:
        # the same loop, its calls still in flight
        traced = trace_mod.profile(loop.call, tr["trace_calls"],
                                   run.scratch)
    loop.drain()
    in_window = sum(1 for _, t in loop.done if t <= deadline)
    entry_ms = loop.entry_ms[:issued]
    shapes = shapes_of(run.config, b)
    peak = memory_peak(run.device)

    kept = {i: tuple(t.detach().double() for t in v)
            for i, v in sample.kept.items()}
    needed = sorted({i % len(pool) for i in kept})
    frames = {k: pool[k] for k in needed}
    del loc, loop, sample, pool
    free_device(run.device)

    checks, failed = check(run, frames, kept)
    e2e = {"frames_per_s": in_window * b / run.seconds, "setup_s": setup_s}
    readings = Readings(run.cell, run.config, tr, shapes, traced,
                        {"entry_ms": entry_ms})
    return Outcome(e2e, attempted=issued * b, failed=failed, checks=checks,
                   readings=readings, memory_peak_bytes=peak,
                   extra={"route": path})


def shapes_of(config: dict, b: int) -> dict:
    st = reference.settings(config)
    return dict(frames=b, mics=st.mics.shape[0], n=st.n,
                bins=len(reference.kept_bins(st)),
                pairs=st.pairs.shape[0], lags=st.num_lags)


def compare(chain, ref: dict, tdoa, xy_grid, xy):
    """Per-frame gaps of the program's outputs from the reference's:
    (tdoa gap [B] samples, grid gap [B], xy gap [B] m).  The grid and xy
    gaps are judged on frames whose integer peaks are clear (``ref``'s
    'clear'), 0 elsewhere: a near-tie moves the taper's centre, so the
    scores, the grid cell and the solve's start; the xy gap also needs the
    grid's best cell clear ('grid_clear')."""
    import torch

    st = chain.st
    tdoa_gap = (tdoa - ref["tdoa_samples"]).abs().amax(dim=-1)
    w = 2 * st.half_x + 1
    col = torch.round(xy_grid[:, 0] * st.cells_per_m + st.half_x).long()
    row = torch.round(st.half_y - xy_grid[:, 1] * st.cells_per_m).long()
    inside = (col >= 0) & (col < w) & (row >= 0) & (row <= 2 * st.half_y)
    cell = (row * w + col).clamp(0, ref["scores"].shape[-1] - 1)
    best = ref["scores"].gather(-1, ref["cell"][:, None])[:, 0]
    at = ref["scores"].gather(-1, cell[:, None])[:, 0]
    grid_gap = torch.where(inside, (best - at) / best.abs().clamp_min(1e-30),
                           torch.full_like(best, float("inf")))
    xy_gap = torch.linalg.vector_norm(xy - ref["xy"], dim=-1)
    clear = ref["clear"]
    return (tdoa_gap, torch.where(clear, grid_gap, torch.zeros_like(grid_gap)),
            torch.where(clear & ref["grid_clear"], xy_gap,
                        torch.zeros_like(xy_gap)))


NUMBERS = ("tdoa_gap", "grid_gap", "xy_gap_m")
MARGINS = ("peak_clear", "grid_clear")


def check(run, frames: dict, kept: dict):
    """The checks of the kept calls (call index -> program's tdoa, grid xy
    and xy) against the float64 reference on their pool batches
    (``frames``: pool index -> frames): (Checks, frames over a limit)."""
    import torch

    chain = reference.Chain(reference.settings(run.config), run.device)
    refs = {k: chain.localize(f, peak_clear=run.margins["peak_clear"],
                              grid_clear=run.margins["grid_clear"])
            for k, f in frames.items()}
    gaps = [[], [], []]
    frames_clear = 0
    for i, (tdoa, xy_grid, xy) in kept.items():
        ref = refs[i % run.traffic["pool_batches"]]
        for acc, g in zip(gaps, compare(chain, ref, tdoa, xy_grid, xy)):
            acc.append(g)
        frames_clear += int(ref["clear"].sum())
    checks, failed = judge(run.limits, gaps)
    checks.extra = {"frames": sum(int(t.shape[0]) for t, _, _ in
                                  kept.values()),
                    "frames_clear": frames_clear}
    return checks, failed


def judge(limits: dict, gaps: list):
    """(Checks of each number's largest gap, answers over any limit)."""
    import torch

    checks = Checks(limits)
    if not gaps[0]:
        return checks, 0
    cat = [torch.cat(g) for g in gaps]
    over = torch.zeros_like(cat[0], dtype=torch.bool)
    for name, g in zip(NUMBERS, cat):
        checks.add(name, float(g.max()))
        lim = limits.get(name)
        over |= ~(g <= (float("inf") if lim is None else lim))
    return checks, int(over.sum())
