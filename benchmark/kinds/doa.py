"""Offline far-field direction finding: calls of ``DoaEstimator.forward``
on frame batches held on the card, issued ahead with at most ``in_flight``
calls in flight, each call's ``azimuth_deg`` read back to the host.

Scenes: one source a frame, a plane wave from an azimuth drawn uniformly
over ``source.azimuth_deg`` in the array's plane, each mic's delay
-(m . u) / c relative to the array's centre (a phase shift of the chirp's
spectrum), white noise of ``noise_rms``.

End to end, ``frames_per_s`` and ``setup_s`` as ``kinds/batch.py`` defines
them.  The check: a sample of the window's calls, drawn from the seed,
every frame of each against the float64 reference (``reference_doa.py``)
on the same frames: ``tdoa_gap`` (samples), ``score_gap`` (how far below
the reference's best score, as a share of it, the reference scores the
program's argmax azimuth), ``azimuth_gap_deg`` (around the circle) and
``bearing_gap`` (the norm of the difference of the unit bearings), each
where the decisions it rests on are clear of a tie (``compare``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import reference, reference_doa, scenes, spans, trace as trace_mod
from ..harness import (Checks, Outcome, Readings, free_device, memory_peak,
                       mics_of, pinned, quiet_gc, sync)
from . import batch

NUMBERS = ("tdoa_gap", "score_gap", "azimuth_gap_deg", "bearing_gap")
MARGINS = ("peak_clear", "azimuth_clear", "phase_floor")
# the outputs a check compares, in order
KEPT = ("tdoa_samples", "scores", "azimuth_deg", "bearing")


def pipeline_of(config: dict):
    """The program's PipelineConfig of a configuration file."""
    from audio_triangulation_tpu_torch import PipelineConfig

    return PipelineConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in config["pipeline"].items()})


def plane_wave_delays(mics: np.ndarray, azimuth_rad: torch.Tensor,
                      c: float, fs: float) -> torch.Tensor:
    """Each mic's delay [B, M] in samples of plane waves from the bearings
    ``azimuth_rad`` [B] in the array's plane: -(m . u) / c."""
    m = torch.as_tensor(mics[:, :2], dtype=torch.float64,
                        device=azimuth_rad.device)
    u = torch.stack([torch.cos(azimuth_rad), torch.sin(azimuth_rad)], -1)
    return -(u @ m.T) / c * fs


def delayed(signal: torch.Tensor, delays: torch.Tensor,
            amplitude: float) -> torch.Tensor:
    """``signal`` [n] delayed by ``delays`` [B, M] samples, as
    ``scenes.received`` delays it: [B, M, n] float64."""
    n = signal.shape[-1]
    spec = torch.fft.rfft(signal)
    freqs = torch.arange(spec.shape[-1], dtype=torch.float64,
                         device=signal.device) / n
    shifted = spec * torch.exp(-2j * np.pi * freqs * delays[..., None])
    # DC and Nyquist read as real, on every device
    shifted[..., 0] = shifted[..., 0].real
    if n % 2 == 0:
        shifted[..., -1] = shifted[..., -1].real
    return amplitude * torch.fft.irfft(shifted, n=n)


def plane_wave_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """``pool_batches`` batches of ``frames_per_call`` frames [B, M, N]
    float32, one plane wave a frame, noise of ``noise_rms``."""
    p = config["pipeline"]
    mics = mics_of(config)
    n = 1 << p["frame_size_bits"]
    fs, c = float(p["sample_rate_hz"]), float(p["speed_of_sound_mps"])
    src = traffic["source"]
    b, batches = traffic["frames_per_call"], traffic["pool_batches"]
    gen = scenes.generator(seed, device)
    signal = scenes.chirp(n, fs, src, device)
    lo, hi = src["azimuth_deg"]
    az = torch.deg2rad(lo + (hi - lo) * torch.rand(
        b * batches, dtype=torch.float64, device=device, generator=gen))
    pool = []
    for k in range(batches):
        out = torch.empty((b, mics.shape[0], n), dtype=torch.float32,
                          device=device)
        for b0 in range(0, b, scenes.SYNTH_BLOCK):
            b1 = min(b, b0 + scenes.SYNTH_BLOCK)
            out[b0:b1] = delayed(signal, plane_wave_delays(
                mics, az[k * b + b0:k * b + b1], c, fs), src["amplitude"])
        noise = torch.randn(out.shape, dtype=torch.float32, device=device,
                            generator=gen)
        pool.append(out.add_(noise, alpha=float(traffic["noise_rms"])))
    return pool


def build(run):
    """The program's estimator and the frame pool, on the run's device."""
    from audio_triangulation_tpu_torch.models.doa import DoaEstimator

    est = DoaEstimator.create(mics_of(run.config), pipeline_of(run.config),
                              run.config["n_azimuths"], device=run.device)
    run.mark("program objects")
    pool = plane_wave_pool(run.config, run.traffic, run.seed, run.device)
    sync(run.device)
    run.mark("inputs")
    return est, pool


def route_of(est, frames: torch.Tensor) -> str:
    """The kernels (or plain torch stages) ``est(frames)`` runs, as
    ``models.doa`` decides them for this shape on this device."""
    from audio_triangulation_tpu_torch.models import localizer
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    cfg = est.pipeline
    flat = frames.reshape(-1, *frames.shape[-2:])
    on_kernel, on_large = localizer.gcc_routes(flat, cfg, est.pairs.shape[0],
                                               False)
    if on_kernel:
        gcc = ("gcc_stats_kernel" if gcc_kernel.needs_stats(cfg, False)
               else "gcc_kernel") + " without peaks"
    elif on_large:
        gcc = "gcc_large_kernel"
    else:
        gcc = "unfused GCC (torch)"
    return f"{gcc} + azimuth SRP (torch.matmul) + bearing solve (torch)"


class Loop(batch.Loop):
    """``batch.Loop`` reading back each call's ``azimuth_deg``."""

    def __init__(self, est, pool, in_flight: int, device, keep):
        super().__init__(est, pool, in_flight, device, keep)
        self.bufs = [pinned((pool[0].shape[0],), torch.float32, device)
                     for _ in range(in_flight + 1)]

    def call(self):
        i = self.issued
        frames = self.pool[i % len(self.pool)]
        with torch.profiler.record_function("bench.call"):
            t0 = time.perf_counter()
            out = self.loc(frames)
            self.entry_ms.append((time.perf_counter() - t0) * 1e3)
        buf = self.bufs[i % len(self.bufs)]
        buf.copy_(out["azimuth_deg"], non_blocking=self.cuda)
        ev = torch.cuda.Event() if self.cuda else None
        if ev is not None:
            ev.record()
        self.keep(i, out)
        self.pending.append((i, ev))
        self.issued += 1
        while len(self.pending) >= self.in_flight:
            self._wait()


class Reservoir(batch.Reservoir):
    """``batch.Reservoir`` of a DoA call's outputs (``KEPT``)."""

    def __call__(self, i: int, out: dict):
        if not self.active:
            return
        item = tuple(out[k] for k in KEPT)
        if len(self.kept) < self.k:
            self.kept[i] = item
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[i] = item


def program_counts() -> dict:
    """The program's ``doa.*`` counts (none from a program without
    them)."""
    prof = spans.program_profiling()
    if prof is None:
        return {}
    return {k: v for k, v in prof.counters().items() if k.startswith("doa.")}


def run(run) -> Outcome:
    tr = run.traffic
    # first, so that a configuration the reference does not write stops
    # the run before it is timed
    shapes = shapes_of(run.config, tr["frames_per_call"])
    est, pool = build(run)
    b = pool[0].shape[0]
    for k in range(batch.WARMUP_CALLS):
        est(pool[k % len(pool)])["azimuth_deg"].cpu()
    sync(run.device)
    path = route_of(est, pool[0])
    run.mark("warm-up (kernel library built or loaded)")
    setup_s = run.setup_done()

    sample = Reservoir(tr["check_calls"], run.seed)
    loop = Loop(est, pool, tr["in_flight"], run.device, sample)
    with quiet_gc():
        t0 = time.perf_counter()
        deadline = t0 + run.seconds
        while time.perf_counter() < deadline:
            loop.call()
    issued = loop.issued
    sample.active = False
    traced, extra = None, {"route": path}
    if run.trace:
        # the same loop, its calls still in flight
        traced = trace_mod.profile(loop.call, tr["trace_calls"],
                                   run.scratch)
        counts = program_counts()
        if counts:
            extra["counts"] = counts
    loop.drain()
    in_window = sum(1 for _, t in loop.done if t <= deadline)
    entry_ms = loop.entry_ms[:issued]
    peak = memory_peak(run.device)

    kept = {i: tuple(t.detach().double() for t in v)
            for i, v in sample.kept.items()}
    needed = sorted({i % len(pool) for i in kept})
    frames = {k: pool[k] for k in needed}
    del est, loop, sample, pool
    free_device(run.device)

    checks, failed = check(run, frames, kept)
    e2e = {"frames_per_s": in_window * b / run.seconds, "setup_s": setup_s}
    readings = Readings(run.cell, run.config, tr, shapes, traced,
                        {"entry_ms": entry_ms})
    return Outcome(e2e, attempted=issued * b, failed=failed, checks=checks,
                   readings=readings, memory_peak_bytes=peak, extra=extra)


def shapes_of(config: dict, b: int) -> dict:
    st = reference_doa.settings(config)
    return dict(frames=b, mics=st.mics.shape[0], n=st.n,
                bins=len(reference.kept_bins(st)), pairs=st.pairs.shape[0],
                lags=st.num_lags, azimuths=int(config["n_azimuths"]))


def circular_gap_deg(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The gap between azimuths in degrees, around the circle."""
    d = torch.remainder(a - b, 360.0)
    return torch.minimum(d, 360.0 - d)


def compare(ref: dict, tdoa, scores, azimuth_deg, bearing):
    """Per-frame gaps of the program's outputs from the reference's, in
    ``NUMBERS``' order.  Each is judged where float32 can decide what it
    rests on, 0 elsewhere: a TDOA where its pair's integer peak is clear of
    a tie and no bin of its mics is too weak for its phase to be resolved
    (``ref``'s 'pair_clear'; a near-tie moves the parabola's and the
    taper's centre, at times to a peak tens of lags away, and PHAT weighs
    a weak bin's unresolved phase fully), the scores and the bearing where
    every pair's is ('clear'), the azimuth where the best azimuth is clear
    too ('azimuth_clear')."""
    tdoa_gap = torch.where(ref["pair_clear"],
                           (tdoa - ref["tdoa_samples"]).abs(),
                           torch.zeros_like(tdoa)).amax(dim=-1)
    best = ref["scores"].gather(-1, ref["index"][:, None])[:, 0]
    at = ref["scores"].gather(-1, scores.argmax(dim=-1)[:, None])[:, 0]
    score_gap = (best - at) / best.abs().clamp_min(1e-30)
    azimuth_gap = circular_gap_deg(azimuth_deg, ref["azimuth_deg"])
    bearing_gap = torch.linalg.vector_norm(bearing - ref["bearing"], dim=-1)
    clear = ref["clear"]
    zero = torch.zeros_like(score_gap)
    return (tdoa_gap, torch.where(clear, score_gap, zero),
            torch.where(clear & ref["azimuth_clear"], azimuth_gap, zero),
            torch.where(clear, bearing_gap, zero))


def check(run, frames: dict, kept: dict):
    """The checks of the kept calls (call index -> the program's ``KEPT``
    outputs) against the float64 reference on their pool batches
    (``frames``: pool index -> frames): (Checks, frames over a limit)."""
    chain = reference_doa.DoaChain(run.config, run.device)
    refs = {k: chain.estimate(f, **run.margins) for k, f in frames.items()}
    gaps = [[] for _ in NUMBERS]
    frames_clear = pairs_clear = 0
    for i, outs in kept.items():
        ref = refs[i % run.traffic["pool_batches"]]
        for acc, g in zip(gaps, compare(ref, *outs)):
            acc.append(g)
        frames_clear += int(ref["clear"].sum())
        pairs_clear += int(ref["pair_clear"].sum())
    checks = Checks(run.limits)
    over = None
    for name, g in zip(NUMBERS, gaps):
        if not g:
            break
        g = torch.cat(g)
        checks.add(name, float(g.max()))
        lim = run.limits.get(name)
        bad = ~(g <= (float("inf") if lim is None else lim))
        over = bad if over is None else over | bad
    checks.extra = {"frames": sum(int(v[0].shape[0]) for v in kept.values()),
                    "frames_clear": frames_clear, "pairs_clear": pairs_clear}
    return checks, 0 if over is None else int(over.sum())


def control_numbers(run) -> dict:
    """The control's numbers on this run's seed: the checks of the
    reference at ``Precision.below()`` in the program's place, on the
    first ``check_calls`` calls' batches."""
    pool = plane_wave_pool(run.config, run.traffic, run.seed, run.device)
    ctl = reference_doa.DoaChain(run.config, run.device,
                                 reference.Precision.below())
    kept = {}
    for i in range(run.traffic["check_calls"]):
        out = ctl.estimate(pool[i % len(pool)])
        kept[i] = tuple(out[k].double() for k in KEPT)
    frames = {i % len(pool): pool[i % len(pool)] for i in kept}
    checks, _ = check(run, frames, kept)
    return {**checks.values, **checks.extra}
