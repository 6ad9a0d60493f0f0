#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port (audio_triangulation_tpu_torch).

Builds the CUDA kernels from ``audio_triangulation_tpu_torch/csrc`` with
nvcc, holds each kernel (the GCC kernel's base and spectral-stats modes,
the GN kernel) against its plain PyTorch version on the card, drives the
frame-batch Localizer at full size (16,384 frames of 4 x 1,024 samples) in
the three bench configurations (band-crop, full band, hands-free), checks
each against the known source and the port's own CPU path, and times it.

    python3 chip_smoke.py            # one CUDA card; exits non-zero on any failure

Phases print one line each.  The line before the last is a JSON object of
per-kernel results; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE_XY = (0.5, 0.4)  # plane point whose sphere projection is the source
FRAMES = 16384  # main-path batch: frames of 4 mics x 1,024 samples
CHECK_FRAMES = 1024  # frames per kernel-vs-plain comparison
# Band and gate decisions are thresholds on coherence (0..1): the stats
# kernel is compared with its plain version only where the plain version's
# value lies further than this from the threshold.
DECISION_MARGIN = 1e-3
TRIALS = 7  # timed trials of the main path per configuration
REPS = 20  # launches per kernel timing
SEED = 0
# Median |xy - SOURCE_XY| bound per main-path configuration.  Full-band PHAT
# whitens the out-of-band noise bins up to the chirp's level, which biases
# it on this band-limited source: the JAX package's Localizer itself gives
# a 1.64 cm median on 256 frames of this scene (CPU), so it gets a looser
# bound; its real check is the agreement with the CPU path below.  The
# hands-free line gives 0.0126 cm in the JAX package (256 frames, CPU).
MEDIAN_BOUND_M = {"bandcrop_800_6000": 0.01, "fullband": 0.03,
                  "handsfree_auto_hybrid": 0.001}

KERNEL_INFO = {
    "gcc_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gcc_kernel.cu",
        replaces="audio_triangulation_tpu/ops/pallas/gcc_kernel.py:92"),
    "gcc_stats_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gcc_kernel.cu",
        replaces="audio_triangulation_tpu/ops/pallas/gcc_kernel.py:247"),
    "gn_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gn_kernel.cu",
        replaces="audio_triangulation_tpu/ops/pallas/gn_kernel.py:29"),
}


def fail(phase: str, msg: str):
    print(f"[{phase}] FAILED: {msg}", flush=True)
    sys.exit(1)


def say(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def alternate_ms(plain, kernel):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, REPS)
    k1 = cuda_ms(kernel, REPS)
    k2 = cuda_ms(kernel, REPS)
    p2 = cuda_ms(plain, REPS)
    return (k1 + k2) / 2, (p1 + p2) / 2


def scene_frames(mics, n_frames, rng, *, fixed_source=None, noise=0.01):
    """Synthetic chirp frames [n_frames, M, 1024] f32 from sources on the
    radius-1.2 m sphere (random ones unless ``fixed_source`` is given)."""
    from audio_triangulation_tpu_torch.utils import synth

    if fixed_source is None:
        xy = rng.uniform(-1.0, 1.0, (n_frames, 2))
        v = np.concatenate([xy, np.full((n_frames, 1), 1.2)], axis=1)
    else:
        v = np.broadcast_to(np.asarray(fixed_source, np.float64),
                            (n_frames, 3))
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, noise_rms=noise,
                             seed=int(rng.integers(1 << 30))).astype(
                                 np.float32)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.ops.cuda import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail("1 device", f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    Localizer.create(geometry.square_array(0.3), device="cuda")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        fail("1 device", "TF32 is still on after building a CUDA Localizer")
    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    say("1 device", f"{torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}, torch {torch.__version__} "
        f"cuda {torch.version.cuda}; TF32 off; kernels built in "
        f"{time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, HERE)}")
    return card


def gcc_cases():
    from audio_triangulation_tpu_torch import PipelineConfig, geometry

    two = np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32)
    return [
        ("4mic_circular_phat_fullband", geometry.square_array(0.3),
         PipelineConfig(phat=True, fft_pad_mode="circular")),
        ("4mic_bandcrop_800_6000", geometry.square_array(0.3),
         PipelineConfig(phat=True, fft_pad_mode="circular",
                        band_hz=(800.0, 6000.0), band_crop=True)),
        ("3mic_reference_linear_nophat", geometry.reference_array(),
         PipelineConfig()),
        ("2mic_phat_per_pair", two,
         PipelineConfig(phat=True, fft_pad_mode="circular")),
    ]


def phase_gcc(rng, results):
    """The GCC kernel against its plain version on the same inputs.  The
    plain version is evaluated in float64 (the inputs cast up) as well as
    in fp32: on full-band PHAT the fp32 plain version's own rounding
    (cuBLAS sums 1,024 terms in a row) reaches 1.4e-4 of scale, while the
    kernel's two-level sums stay within 2e-5.  The stated tolerances hold
    the kernel to the float64 evaluation; the fp32 gaps are printed."""
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    worst = 0.0
    for name, mics, cfg in gcc_cases():
        frames = torch.from_numpy(
            scene_frames(mics, CHECK_FRAMES, rng)).cuda()
        pairs = torch.as_tensor(geometry.mic_pairs(mics.shape[0]),
                                device="cuda")
        window = torch.as_tensor(window_ops.window_for(cfg), device="cuda")
        win_gain, mats = gcc_kernel.operands(frames, window, cfg)
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)

        def plain(dtype, with_peaks):
            return gcc_kernel.gcc_reference(
                frames.to(dtype), win_gain.to(dtype), mats.to(dtype), pairs,
                **kw, with_peaks=with_peaks)

        def kernel(with_peaks):
            return gcc_kernel.launch(frames, win_gain, mats, pairs, **kw,
                                     with_peaks=with_peaks)

        raw64, ref64 = plain(torch.float64, False), plain(torch.float64, True)
        raw32, ref32 = plain(torch.float32, False), plain(torch.float32, True)
        raw, got = kernel(False), kernel(True)
        torch.cuda.synchronize()
        scale = float(raw64.abs().max())

        def err(a, b):
            return float((a.double() - b.double()).abs().max()) / scale

        err_raw, err_tap = err(raw, raw64), err(got[0], ref64[0])
        peak_err = err(got[3], ref64[3])
        top2 = raw64.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 1e-4 * scale
        shift_bad = int(((got[1] != ref64[1]) & clear).sum())
        tdoa_err = float(((got[2] - ref64[2]).abs() * clear).max())
        psr_rel = float((((got[4] - ref64[4]).abs() / ref64[4].abs())
                         * clear).max())
        say("2 gcc", f"{name}: {frames.shape[0]} frames vs the plain version"
            f" in float64: corr/scale err raw {err_raw:.2e} tapered "
            f"{err_tap:.2e}, peak {peak_err:.2e}, shift mismatches "
            f"{shift_bad} (near ties excluded: {int((~clear).sum())}), tdoa "
            f"err {tdoa_err:.2e} samples, psr rel err {psr_rel:.2e}; fp32 "
            f"plain vs float64 {err(raw32, raw64):.2e}, kernel vs fp32 plain "
            f"{err(raw, raw32):.2e}, shifts equal to fp32 plain on clear "
            f"rows {bool(((got[1] == ref32[1]) | ~clear).all())}")
        if not (err_raw <= 1e-4 and err_tap <= 1e-4 and peak_err <= 1e-4
                and shift_bad == 0 and tdoa_err <= 1e-3
                and psr_rel <= 1e-3):
            fail("2 gcc", f"{name}: kernel disagrees with its plain version")
        worst = max(worst, err_raw, err_tap)
    results["gcc_kernel"]["max_abs_err"] = worst


def stats_cases():
    from audio_triangulation_tpu_torch import PipelineConfig, geometry

    two = np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32)
    phat = dict(phat=True, fft_pad_mode="circular")
    return [
        ("4mic_circular_auto_hybrid", geometry.square_array(0.3),
         PipelineConfig(**phat, band_hz="auto", subsample_method="hybrid")),
        ("4mic_linear_auto_phase", geometry.square_array(0.3),
         PipelineConfig(phat=True, band_hz="auto", subsample_method="phase")),
        ("4mic_static_800_6000_hybrid", geometry.square_array(0.3),
         PipelineConfig(**phat, band_hz=(800.0, 6000.0),
                        subsample_method="hybrid")),
        ("3mic_reference_auto_nophat", geometry.reference_array(),
         PipelineConfig(band_hz="auto")),
        ("2mic_auto_hybrid_per_pair_phat", two,
         PipelineConfig(**phat, band_hz="auto", subsample_method="hybrid")),
    ]


def clear_decisions(terms, sp, corr64, scale):
    """Masks of what rounding cannot decide differently, from the float64
    plain version: (frames whose auto band is settled [B], bins whose band
    weight is settled [B, F], rows whose shift and hybrid gate are settled
    [B, P])."""
    import torch
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    b, p, _ = corr64.shape
    frame_ok = torch.ones(b, dtype=torch.bool, device=corr64.device)
    bins_ok = None
    if sp.band_auto:
        g2m, thr = terms["g2m"], terms["thr"]
        f = g2m.shape[-1]
        k = torch.arange(f, device=g2m.device)
        interior = (k > 0) & (k < f - 1)
        unclear = interior & ((g2m - thr).abs() <= DECISION_MARGIN)
        n_unc = unclear.sum(dim=-1)
        cnt = ((g2m >= thr) & interior).sum(dim=-1)
        enough = cnt >= sp.min_bins
        enough_ok = ((cnt - n_unc >= sp.min_bins)
                     | (cnt + n_unc < sp.min_bins))
        frame_ok = enough_ok & ((n_unc == 0) | ~enough)
        bins_ok = enough_ok[:, None] & (~unclear | ~enough[:, None])
    top2 = corr64.topk(2, dim=-1).values
    rows_ok = frame_ok[:, None] & ((top2[..., 0] - top2[..., 1])
                                   > 1e-4 * scale)
    if sp.phase and sp.hybrid:
        coh = gcc_kernel.hybrid_coherence(terms)
        rows_ok &= (coh - sp.hybrid_min).abs() > DECISION_MARGIN
    return frame_ok, bins_ok, rows_ok


def phase_stats(rng, results):
    """The GCC kernel's stats mode against its plain version evaluated in
    float64, with peaks (and without, for the auto band).  Correlograms
    within 1e-4 of scale on frames whose auto band is settled, shifts
    equal and tdoa within 1e-3 samples on rows whose shift and hybrid gate
    are settled, band weights equal on settled bins; the unsettled counts
    are printed."""
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    worst = 0.0
    for name, mics, cfg in stats_cases():
        frames = torch.from_numpy(
            scene_frames(mics, CHECK_FRAMES, rng)).cuda()
        pairs = torch.as_tensor(geometry.mic_pairs(mics.shape[0]),
                                device="cuda")
        window = torch.as_tensor(window_ops.window_for(cfg), device="cuda")
        win_gain, mats = gcc_kernel.operands(frames, window, cfg)
        sp = gcc_kernel.stats_params(cfg, True)
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                  with_band=True)
        ops64 = (frames.double(), win_gain.double(), mats.to(torch.float64),
                 pairs, sp)
        raw64 = gcc_kernel.gcc_stats_reference(*ops64, **kw,
                                               with_peaks=False)[0]
        ref64 = gcc_kernel.gcc_stats_reference(*ops64, **kw, with_peaks=True)
        terms = gcc_kernel.stats_terms(*ops64, phat_eps=cfg.phat_eps)
        got = gcc_kernel.launch_stats(frames, win_gain, mats, pairs, sp,
                                      **kw, with_peaks=True)
        # without peaks the stats mode runs only for the auto band (the
        # base mode serves a static band; phase 2 holds that)
        sp_raw = gcc_kernel.stats_params(cfg, False)
        raw = None if sp_raw is None else gcc_kernel.launch_stats(
            frames, win_gain, mats, pairs, sp_raw, **kw, with_peaks=False)[0]
        torch.cuda.synchronize()
        scale = float(raw64.abs().max())
        frame_ok, bins_ok, rows_ok = clear_decisions(terms, sp, raw64, scale)

        def err(a, b, mask):
            d = (a.double() - b.double()).abs()
            return float((d * mask.reshape(*mask.shape, *[1] * (
                d.ndim - mask.ndim))).max())

        err_raw = 0.0 if raw is None else err(raw, raw64, frame_ok) / scale
        raw_msg = "n/a (base mode)" if raw is None else f"{err_raw:.2e}"
        err_tap = err(got[0], ref64[0], rows_ok) / scale
        shift_bad = int(((got[1] != ref64[1]) & rows_ok).sum())
        tdoa_err = err(got[2], ref64[2], rows_ok)
        band_bad, band_msg = 0, "no auto band"
        if sp.band_auto:
            band_bad = int(((got[5] != ref64[5]) & bins_ok).sum())
            band_msg = (f"band mismatches {band_bad} (unsettled bins "
                        f"excluded: {int((~bins_ok).sum())})")
        say("2 stats", f"{name}: {frames.shape[0]} frames vs the plain "
            f"version in float64: corr/scale err raw {raw_msg} tapered "
            f"{err_tap:.2e}, shift mismatches {shift_bad}, tdoa err "
            f"{tdoa_err:.2e} samples, {band_msg}; unsettled frames "
            f"{int((~frame_ok).sum())}, rows {int((~rows_ok).sum())} of "
            f"{rows_ok.numel()}")
        if not (err_raw <= 1e-4 and err_tap <= 1e-4 and shift_bad == 0
                and tdoa_err <= 1e-3 and band_bad == 0
                and int(rows_ok.sum()) * 2 > rows_ok.numel()):
            fail("2 stats", f"{name}: kernel disagrees with its plain "
                 "version (or too few settled rows to tell)")
        worst = max(worst, err_raw, err_tap)
    results["gcc_stats_kernel"]["max_abs_err"] = worst


def phase_gn(rng, results):
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.core.config import SolverConfig
    from audio_triangulation_tpu_torch.ops import solver as solver_ops
    from audio_triangulation_tpu_torch.ops.cuda import gn_kernel

    worst = 0.0
    for mics in (geometry.reference_array(), geometry.square_array(0.3)):
        for sphere in (True, False):
            cfg = SolverConfig(constrain_to_sphere=sphere)
            b = CHECK_FRAMES
            m_t = torch.as_tensor(mics, device="cuda")
            pairs = torch.as_tensor(geometry.mic_pairs(mics.shape[0]),
                                    device="cuda")
            xy_true = torch.as_tensor(rng.uniform(-1.0, 1.0, (b, 2)),
                                      dtype=torch.float32, device="cuda")
            mic3 = torch.zeros((mics.shape[0], 3), device="cuda")
            mic3[:, :2] = m_t
            tau = solver_ops.predicted_tdoas(xy_true, mic3, pairs, 343.0,
                                             1.2, sphere)
            tau = tau + torch.as_tensor(
                rng.normal(0.0, 2e-7, tau.shape), dtype=torch.float32,
                device="cuda")
            init = xy_true * 0.9 + 0.02
            kw = dict(c=343.0, h=1.2, iters=cfg.iterations,
                      damping=cfg.damping, sphere=sphere)
            ref = gn_kernel.gn_reference(tau, init, m_t, pairs, **kw)
            got = gn_kernel.launch(tau, init, m_t, pairs, **kw)
            torch.cuda.synchronize()
            exy = float((got[0] - ref[0]).abs().max())
            erms = float((got[1] - ref[1]).abs().max())
            say("3 gn", f"{mics.shape[0]} mics, sphere={sphere}: {b} frames,"
                f" xy err {exy:.2e} m, rms err {erms:.2e} m")
            if not (exy <= 1e-5 and erms <= 1e-6):
                fail("3 gn", "kernel disagrees with its plain version")
            worst = max(worst, exy)
    results["gn_kernel"]["max_abs_err"] = worst


def main_configs():
    from audio_triangulation_tpu_torch import PipelineConfig

    base = dict(phat=True, fft_pad_mode="circular", srp_dtype="bfloat16")
    return [
        ("bandcrop_800_6000", PipelineConfig(
            **base, band_hz=(800.0, 6000.0), band_crop=True)),
        ("fullband", PipelineConfig(**base)),
        ("handsfree_auto_hybrid", PipelineConfig(
            **base, band_hz="auto", subsample_method="hybrid")),
    ]


# the kernels each main-path configuration must launch
PATH_KERNELS = {"bandcrop_800_6000": ("gcc_kernel", "gn_kernel"),
                "fullband": ("gcc_kernel", "gn_kernel"),
                "handsfree_auto_hybrid": ("gcc_stats_kernel", "gn_kernel")}


def launch_counts():
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gn_kernel

    return {"gcc_kernel": gcc_kernel.launches,
            "gcc_stats_kernel": gcc_kernel.stats_launches,
            "gn_kernel": gn_kernel.launches}


def reset_counts():
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gn_kernel

    gcc_kernel.launches = gcc_kernel.stats_launches = gn_kernel.launches = 0


def phase_main(rng, results):
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry

    mics = geometry.square_array(0.3)
    frames_np = scene_frames(mics, FRAMES, rng,
                             fixed_source=(*SOURCE_XY, 1.2))
    frames = torch.from_numpy(frames_np).cuda()
    locs = [(name, Localizer.create(mics, cfg, device="cuda",
                                    init_grid_stride=3))
            for name, cfg in main_configs()]
    torch.cuda.synchronize()

    outs = []
    for k in results:
        results[k]["launches"] = 0
    for name, loc in locs:
        # each path's kernels are counted from 0 around its own run
        reset_counts()
        out = loc(frames)
        torch.cuda.synchronize()
        counts = launch_counts()
        outs.append((name, out))
        for k, v in counts.items():
            results[k]["launches"] += v
        say("4 main", f"{name}: {FRAMES} frames, launches {counts}")
        if min(counts[k] for k in PATH_KERNELS[name]) < 1:
            fail("4 main", f"{name}: a kernel of its path was never "
                 "launched")

    n_cpu = 64
    for (name, out), (_, loc) in zip(outs, locs):
        xy = out["xy"]
        if (xy.shape != (FRAMES, 2) or not bool(torch.isfinite(
                xy).all()) or not bool(torch.isfinite(out["scores"]).all())):
            fail("4 main", f"{name}: non-finite or misshapen output")
        err = (xy - torch.tensor(SOURCE_XY, device="cuda")).norm(dim=-1)
        med = float(err.median())
        cpu_loc = Localizer.create(mics, loc.pipeline, device="cpu",
                                   init_grid_stride=3)
        ref = cpu_loc(torch.from_numpy(frames_np[:n_cpu]))
        dxy = float((xy[:n_cpu].cpu() - ref["xy"]).abs().max())
        shift_eq = bool((out["best_shift"][:n_cpu].cpu()
                         == ref["best_shift"]).all())
        dtdoa = float((out["tdoa_samples"][:n_cpu].cpu()
                       - ref["tdoa_samples"]).abs().max())
        say("4 main", f"{name}: median |xy - (0.5, 0.4)| = {med * 100:.4f} "
            f"cm; vs CPU path on {n_cpu} frames: xy {dxy:.2e} m, shifts "
            f"equal {shift_eq}, tdoa {dtdoa:.2e} samples")
        if not (med < MEDIAN_BOUND_M[name] and dxy <= 2e-4 and shift_eq
                and dtdoa <= 1e-3):
            fail("4 main", f"{name}: result check failed")
    return locs, frames


def phase_timing(card, locs, frames, results):
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gn_kernel

    for name, loc in locs:
        for _ in range(2):
            loc(frames)
        torch.cuda.synchronize()
        rates = []
        for _ in range(TRIALS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loc(frames)
            torch.cuda.synchronize()
            rates.append(frames.shape[0] / (time.perf_counter() - t0))
        q1, med, q3 = np.percentile(rates, [25, 50, 75])
        say("5 timing", f"{name}: {med:.1f} frames/s median, IQR "
            f"{q1:.1f}-{q3:.1f} over {TRIALS} trials of "
            f"{frames.shape[0]} frames ({card})")

    # each kernel against its plain version at the main path's shapes
    pairs = torch.as_tensor(geometry.mic_pairs(4), device="cuda")
    for name, loc in locs:
        cfg = loc.pipeline
        ops = (*gcc_kernel.operands(frames, loc.window, cfg), pairs)
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                  with_peaks=True)
        sp = gcc_kernel.stats_params(cfg, True)
        if sp is None:
            kernel, k_ms, p_ms = "gcc_kernel", *alternate_ms(
                lambda: gcc_kernel.gcc_reference(frames, *ops, **kw),
                lambda: gcc_kernel.launch(frames, *ops, **kw))
        else:
            kernel, k_ms, p_ms = "gcc_stats_kernel", *alternate_ms(
                lambda: gcc_kernel.gcc_stats_reference(frames, *ops, sp,
                                                       **kw),
                lambda: gcc_kernel.launch_stats(frames, *ops, sp, **kw))
        say("5 timing", f"{kernel} {name} ({frames.shape[0]} frames): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms ({card})")
        if "ms" not in results[kernel]:  # the first config of each kernel
            results[kernel].update(ms=k_ms, plain_ms=p_ms)

    loc = locs[0][1]
    b = frames.shape[0]
    xy0 = torch.rand((b, 2), device="cuda") * 2 - 1
    mic3 = torch.zeros((4, 3), device="cuda")
    mic3[:, :2] = loc.mic_positions
    from audio_triangulation_tpu_torch.ops import solver as solver_ops

    tau = solver_ops.predicted_tdoas(xy0, mic3, pairs, 343.0, 1.2, True)
    init = xy0 * 0.9 + 0.02
    kw = dict(c=343.0, h=1.2, iters=loc.solver.iterations,
              damping=loc.solver.damping, sphere=True)
    k_ms, p_ms = alternate_ms(
        lambda: gn_kernel.gn_reference(tau, init, loc.mic_positions, pairs,
                                       **kw),
        lambda: gn_kernel.launch(tau, init, loc.mic_positions, pairs, **kw))
    say("5 timing", f"gn_kernel ({b} frames): kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms ({card})")
    results["gn_kernel"].update(ms=k_ms, plain_ms=p_ms)


def main():
    card = phase_device()
    import torch

    rng = np.random.default_rng(SEED)
    results = {k: {"name": k, "route": "cuda", **v}
               for k, v in KERNEL_INFO.items()}
    phase_gcc(rng, results)
    phase_stats(rng, results)
    phase_gn(rng, results)
    locs, frames = phase_main(rng, results)
    phase_timing(card, locs, frames, results)

    print(json.dumps({"kernels": [
        {k: results[n][k] for k in ("name", "route", "source", "replaces",
                                    "launches", "max_abs_err", "ms",
                                    "plain_ms")}
        for n in KERNEL_INFO]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
