#!/usr/bin/env python3
"""On-GPU smoke test of the PyTorch port (audio_triangulation_tpu_torch).

Builds the CUDA kernels from ``audio_triangulation_tpu_torch/csrc`` with
nvcc and holds each kernel (the GCC kernel's base, spectral-stats and
in-kernel SRP modes, the GN kernel, the large-array GCC kernel, the
SRP-argmax kernel, the DFT-product kernel, the pipelined GCC kernel, the
detector's prefix-sum kernel) against its plain PyTorch version on the
card.  Then it
drives the frame-batch Localizer at full size: 16,384 frames of 4 x 1,024
samples in the three bench configurations (band-crop, full band,
hands-free) and with ``fused_srp='on'``, and 256 frames of 64 x 4,096
samples (2,016 pairs) in the three large-array configurations (full band,
band-crop, auto band); and ``srp_argmax`` on 16,384 frames against the
101 x 101 grid.  Each path is checked against the known source and the
port's own CPU path, its kernel launches are counted from 0, and it is
timed.  The two tool kernels (the DFT-shaped f32 / bf16 / int8 product and
the persistent, self-pipelined GCC kernel) are held against their plain
versions and driven through their tools.  The streaming path
(``StreamingLocalizer.step_many``, whose detector launches the prefix-sum
kernel) runs 2,048 streams of 3 mics for 24 chunks of 512 samples with planted
events in its three bench pipelines, is checked against the planted events,
the known sources, the port's CPU path and its own replay as a CUDA graph,
and is timed at 1,024, 2,048 and 4,096 streams, eager and graphed.  The
tracked streaming path (``TrackedStreamingLocalizer``: the stream step and
the Kalman tracker bank) runs 2,048 streams with three bursts of one source
in every fourth, is checked against the untracked step (bit-equal
localization), the planted sources, the port's CPU path (in three banks:
nearest, IMM, soft association) and its replays as CUDA graphs of one and
of four chunk steps, and is timed like the stream step, and as the
four-step graph.  Simultaneous and moving sources: ``localize_multi`` on
16,384 two-source frames of an 8-mic array (the GCC kernel without peaks)
and on 16 frames of the 64-mic array (the large-array kernel without
peaks), ``localize_moving`` on 2,048 frames (33 scales), and the stream
and tracked steps with ``n_sources=2``, ``solve_velocity``, the JPDA
update and ``fuse_velocity`` on 1,024 streams, each checked against the
known sources, the port's CPU path and, for the steps, their CUDA-graph
replays, and timed.  The firmware's integer path: ``localize_frames_int``
on 16,384 8-bit frames of 3 x 1,024 samples (the golden 101 x 101 LUT),
every output bit-equal to the port's CPU path and to the golden model,
timed with its peak device memory, and ``localize_stream`` on a 60 s
stream of 3 x 3,000,000 samples against the CPU path.  Then the port's
tools: the accuracy sweep (``tools/bench_accuracy``, each scene against
the CPU path, each row's medians against the JAX package's rows), the
frame-batch bench (``tools/bench``, whose timing function phase 5 shares)
and a tracked soak (``tools/soak_streaming``: 2,048 streams, 200 graphed
steps, a dead channel half-way; every gate).

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
# the large-array paths: grid_array(8, 8, 0.05), 64 mics, 2,016 pairs
LARGE_SAMPLES = 4096
LARGE_FRAMES = 256  # frames a call
LARGE_STRIDE = 2  # init_grid_stride: 31 x 31 cells of the 63 x 63 grid
LARGE_CHECK_FRAMES = 16  # frames per kernel-vs-plain comparison (float64)
LARGE_CPU_FRAMES = 4  # frames held to the CPU path
LARGE_REPS = 5  # launches per timing of the large-array kernel
SRP_CHECK_FRAMES = 4096  # frames per SRP-argmax comparison (float64)
# a general matrix whose sizes no tile divides: frames, K (odd: rows aligned
# to 4 bytes only), columns, cells counted
SRP_RAGGED = (1000, 557, 1531, 1400)
# published peaks of one H100 SXM (NVIDIA's data sheet): fp32 outside the
# tensor cores, dense TF32, bf16 and int8 in them, and device memory.  The
# SRP-argmax kernel (three TF32 products in f32 mode, one bf16 product in
# bf16 mode) and the bf16 and int8 type sets of the DFT product compute on
# the tensor cores and are bounded by their rates; every other kernel
# computes on the CUDA cores.
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12
# the DFT-shaped product: rows x n x f, grid row tiles (the tool's defaults)
DFT_ROWS, DFT_N, DFT_F = 256, 1024, 512
DFT_CHECK_GRID = 16  # row tiles of the kernel-vs-plain comparison
DFT_RAGGED_ROWS = 16 * 256 - 91  # and a row count that no block tile divides
DFT_GRID = 256  # row tiles timed: 65,536 rows, 137.4 GFLOP a call
DFT_REPS = 10
DFT_TOOL_ITERS = 6  # chained calls per type set when the tool is driven
PIPE_TOOL_ITERS = 10
# the streaming paths: geometry.reference_array() (3 mics), 50 kHz,
# 512-sample chunks, one event planted in every fourth stream
STREAM_CHUNK = 512
STREAM_CHECK_STREAMS = 2048
STREAM_STEPS = 24
STREAM_PLANT_EVERY = 4
STREAM_STARTS = (300, 1211, 2750, 4100, 5632, 7000, 8801, 10000)
STREAM_CPU_STREAMS = 32  # streams held to the port's CPU path
STREAM_COUNTS = (1024, 2048, 4096)  # streams a timed step
STREAM_TRIALS, STREAM_TIMED_STEPS = 7, 20
# the tracked streaming path: the streaming check's shape with every fourth
# stream holding three bursts of one source, the first at one of
# TRACK_STARTS and each next one TRACK_BURST_GAP samples on (past the
# detector's hold-off of a frame), the rest silent
TRACK_SEED = SEED + 10
TRACK_STARTS = (300, 1211, 2750)
TRACK_BURST_GAP = 4100
TRACK_BURSTS = 3
TRACK_SCAN_K = 4  # chunk steps a replay of the K-step graph
TRACK_SCAN_COUNTS = (1024, 2048)  # streams a timed K-step replay
TRACK_IMM_Q = (0.05, 8.0)
# the detector's prefix-sum kernel: the streaming window [S, 3, 1,535] and
# row lengths that end inside a block, fill blocks exactly and take the block
# totals past one tile of 16; values up to 2^15, so that the sums round
SCAN_WINDOW = 1535
SCAN_RAGGED = ((7, 100), (5, 128), (3, 2, 4096), (4, 5000))
# and the shapes of the pipelined kernel's paths: rows no multiple of 4 at
# the streaming length, fewer row groups than CTAs, one sample a row, rows
# longer than one unit of 64 blocks, and the longest row it takes
SCAN_UNITS = ((1023, SCAN_WINDOW), (3, SCAN_WINDOW), (130, 1), (3, 9000),
              (2, 524288))
SCAN_PLAIN_REPS = 2  # the plain version is one small op per position
# outputs of the step replayed as a CUDA graph that are held bit-equal to
# the eager step's
GRAPH_EQUAL_KEYS = ("event_trigger_abs", "events", "best_shift", "xy")
# Median |xy - truth| bound of the accepted planted events per pipeline,
# twice the JAX package's own medians on the 512 planted streams of this
# scene on the CPU: 0.5412 cm default, 0.9125 cm band-cropped PHAT,
# 0.6306 cm PHAT with the auto band, 0.1197 cm on the tetrahedral array,
# all 512 events accepted; the port's CPU path gives the same within
# 3.1e-6 m (tests/witness_stream.py).  And of |xyz - source| on the
# tetrahedral array: the JAX package's median is 1.7331 cm (largest 71.80
# cm: range from a 30 cm array is ill-conditioned), the port's CPU path's
# 1.7524 cm.
STREAM_MEDIAN_BOUND_M = {"default": 0.011, "band_crop_phat": 0.018,
                         "band_auto_phat": 0.013, "xyz_tetra": 0.0024}
STREAM_XYZ_MEDIAN_BOUND_M = 0.035
# Median |track_xy - truth| bound of the planted streams' confirmed tracks at
# the end of the tracked scene, twice the JAX package's own median on its
# 512 planted streams on the CPU: 0.5207 cm (largest 1.8182 cm), every
# planted stream ending with exactly one confirmed track; the port's CPU
# path gives the same within 3.52e-6 m (tests/witness_stream.py tracked)
TRACK_MEDIAN_BOUND_M = 0.0104
# Median |xy - SOURCE_XY| bound per main-path configuration.  Full-band PHAT
# whitens the out-of-band noise bins up to the chirp's level, which biases
# it on this band-limited source: the JAX package's Localizer itself gives
# a 1.64 cm median on 256 frames of this scene (CPU), so it gets a looser
# bound; its real check is the agreement with the CPU path below.  The
# hands-free line gives 0.0126 cm in the JAX package (256 frames, CPU).
# The 64-mic lines: the JAX package's Localizer gives medians of 0.0831 cm
# (largest 0.2054) full band, 0.0227 cm (0.0318) band-crop and 0.0127 cm
# (0.0225) auto band on 8 frames of this scene on the CPU, and the port's CPU
# path the same within 1e-6 m (tests/witness_large64.py); the bounds are
# about three times those medians.
MEDIAN_BOUND_M = {"bandcrop_800_6000": 0.01, "fullband": 0.03,
                  "handsfree_auto_hybrid": 0.001,
                  "bandcrop_800_6000_fused_srp": 0.01,
                  "large64_fullband": 0.0025,
                  "large64_bandcrop_800_6000": 0.0007,
                  "large64_auto": 0.0004}

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
    "gcc_large_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gcc_large.cu",
        replaces="audio_triangulation_tpu/ops/pallas/gcc_large.py:73"),
    "srp_argmax_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/srp_kernel.cu",
        replaces="audio_triangulation_tpu/ops/pallas/srp_kernel.py:34"),
    "gcc_srp_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gcc_kernel.cu",
        replaces="audio_triangulation_tpu/ops/pallas/gcc_kernel.py:467"),
    "gcc_pipelined_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/gcc_kernel.cu",
        replaces="tools/emit_pipeline_probe.py:84"),
    **{f"dft_matmul_kernel_{t}": dict(
        source="audio_triangulation_tpu_torch/csrc/dft_matmul.cu",
        replaces="tools/int8_microbench.py:29")
       for t in ("f32", "bf16", "int8")},
    # no Pallas kernel: the reference's triangular matmul on the MXU
    "detector_scan_kernel": dict(
        source="audio_triangulation_tpu_torch/csrc/detector_scan.cu",
        replaces="audio_triangulation_tpu/ops/detector.py:31"),
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


def alternate_ms(plain, kernel, reps=REPS):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, reps)
    k1 = cuda_ms(kernel, reps)
    k2 = cuda_ms(kernel, reps)
    p2 = cuda_ms(plain, reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flops: float, nbytes: float, rate: float = PEAK_FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of the operations
    over its peak ``rate`` for their type (fp32 on the CUDA cores unless
    given) and the bytes (inputs read once, outputs written once) over its
    memory rate."""
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def share_of_bound(phase: str, what: str, k_ms: float, bnd: dict) -> float:
    """Percent of its bound's rate that a kernel timed at ``k_ms`` reaches.
    No kernel can beat its bound, so a time under it means the bound counts
    too few operations or bytes, or too high a rate: the run fails."""
    if k_ms < bnd["bound_ms"]:
        fail(phase, f"{what}: {k_ms:.4f} ms is under its bound of "
             f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']}: the bound is "
             "wrong")
    return 100 * bnd["bound_ms"] / k_ms


def gcc_bound(b, m, n, f, p, l, *, stats_hw=None, srp_cells=0,
              with_peaks=True, split_products=False) -> dict:
    """Bound of one GCC kernel launch on [b, m, n] frames: the DFT (re and
    im of f bins per sample), the cross-power and the lag synthesis (cos
    and sin terms per bin and lag), with the stats mode's window sums over
    2 hw + 1 bins for m periodograms and p complex cross-spectra, and the
    SRP mode's p additions per cell and its [b, cells] scores written.
    Without peaks the four [b, p] peak outputs are not written.  With
    ``split_products`` the two matrix products, the DFT and the lag
    synthesis, are each counted as three TF32 products on the tensor cores
    (where the card could run both as the split-fp32 products the kernels
    use) and the rest on the fp32 CUDA cores, one after the other."""
    products = b * 4 * (m * n * f + p * f * l)
    flops = b * 6 * p * f + products
    nbytes = 4 * (b * m * n + n + 2 * n * f + 2 * f * l + 2 * p
                  + b * p * l + (4 * b * p if with_peaks else 0))
    if stats_hw is not None:
        flops += b * 2 * (m + 2 * p) * f * (2 * stats_hw + 1)
    if srp_cells:
        flops += b * p * srp_cells
        nbytes += 4 * (p * srp_cells + 2 * b + b * srp_cells)
    if split_products:
        # the time of both parts at their rates, as one fp32-rate count
        flops = (flops - products
                 + 3 * products * PEAK_FP32_FLOPS / PEAK_TF32_FLOPS)
    return bound(flops, nbytes)


def scene_frames(mics, n_frames, rng, *, fixed_source=None, noise=0.01,
                 n=1024):
    """Synthetic chirp frames [n_frames, M, n] f32 from sources on the
    radius-1.2 m sphere (random ones unless ``fixed_source`` is given), with
    noise drawn anew for every frame."""
    from audio_triangulation_tpu_torch.utils import synth

    if fixed_source is None:
        xy = rng.uniform(-1.0, 1.0, (n_frames, 2))
        v = np.concatenate([xy, np.full((n_frames, 1), 1.2)], axis=1)
    else:
        v = np.broadcast_to(np.asarray(fixed_source, np.float64),
                            (n_frames, 3))
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, n=n, noise_rms=noise,
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
    from audio_triangulation_tpu_torch.tools.bench import smi_line

    try:
        card = smi_line(0)
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        fail("1 device", f"nvidia-smi failed: {e}")
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
        # localize_moving's position pass: 15 pairs, no window
        ("6mic_moving_bandcrop_700_9500", *moving_setup()),
    ]


def phase_gcc(rng, results):
    """The GCC kernel's base mode against its plain version on the same
    inputs, at CHECK_FRAMES frames and at a batch that no frames-a-block
    divides.  The plain version is evaluated in float64 (the inputs cast
    up) as well as in fp32: on full-band PHAT the fp32 plain version's own
    rounding (cuBLAS sums 1,024 terms in a row) reaches 1.4e-4 of scale.
    The stated tolerances hold the kernel to the float64 evaluation (1e-4
    of scale; the CUDA-core DFT that the tensor-core one replaced was
    3.04e-05); the fp32 gaps are printed.  The plain version in the
    kernel's own arithmetic (``gcc_reference(split=True)``) is not held
    here: on a frame whose spectrum has a bin at rounding level (frame 267
    of the 1,027 full-band frames of this seed), PHAT gives that bin a phase
    that rounding decides, and fp32 evaluations in other orders land on
    either side (there the split plain version and cuBLAS's fp32 plain
    version are 6.4e-03 of scale from float64, the kernel 2.2e-05); the
    tests hold it on bench scenes."""
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    worst = 0.0
    for (name, mics, cfg), n_frames in (
            (case, n) for case in gcc_cases()
            for n in (CHECK_FRAMES, CHECK_FRAMES + 3)):
        frames = torch.from_numpy(
            scene_frames(mics, n_frames, rng)).cuda()
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
            f"{err_tap:.2e} (the CUDA-core DFT's: 3.04e-05), peak "
            f"{peak_err:.2e}, shift mismatches "
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
    are printed.  And against the plain version that repeats the synthesis
    stage's arithmetic (a split-fp32 product on float64 spectra and
    statistics), within 2e-5 of scale on the settled frames: what is left
    is the kernel's fp32 DFT under PHAT and the tensor cores' adds.  And
    against the plain version that repeats both tensor-core stages on the
    f32 operands (the DFT as a split-fp32 product with its flushes, then
    f32 statistics, then the split synthesis), raw and tapered within 2e-5
    of scale on the same frames and rows: what is left there is the order
    of the adds inside a step of 8 and the tensor cores' cut addends."""
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
        split = gcc_kernel.gcc_stats_reference(
            *ops64, **kw, with_peaks=True, split=True)[0]
        ops32 = (frames, win_gain, mats, pairs)
        split32 = gcc_kernel.gcc_stats_reference(
            *ops32, sp, **kw, with_peaks=True, split=True)[0]
        raw32 = None if raw is None else gcc_kernel.gcc_stats_reference(
            *ops32, sp_raw, **kw, with_peaks=False, split=True)[0]
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
        err_split = err(got[0], split, rows_ok) / scale
        err_both = err(got[0], split32, rows_ok) / scale
        if raw is not None:
            err_both = max(err_both, err(raw, raw32, frame_ok) / scale)
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
            f"{rows_ok.numel()}; tapered vs the plain version in the "
            f"synthesis stage's arithmetic {err_split:.2e}, raw and tapered "
            f"vs the plain version in the DFT and synthesis stages' "
            f"arithmetic {err_both:.2e}")
        if not (err_raw <= 1e-4 and err_tap <= 1e-4 and shift_bad == 0
                and err_split <= 2e-5 and err_both <= 2e-5
                and tdoa_err <= 1e-3 and band_bad == 0
                and int(rows_ok.sum()) * 2 > rows_ok.numel()):
            fail("2 stats", f"{name}: kernel disagrees with its plain "
                 "version (or too few settled rows to tell)")
        worst = max(worst, err_raw, err_tap)
    results["gcc_stats_kernel"]["max_abs_err"] = worst


GN_CHECK_SIZES = (CHECK_FRAMES, 1027, FRAMES + 27)  # and ragged batches


def phase_gn(rng, results):
    """The GN kernel (solve and covariance) against its plain version on
    3-, 4-, 6- (``localize_moving``'s) and 11-mic arrays, sphere and plane, at batches no block divides
    too: xy within 1e-5 m, rms within 1e-6 m, cov within 1e-4 of itself
    plus 1e-6 of its largest entry.  The kernel rounds every operation as
    the plain version's tensor ops do, so the line names the outputs that
    are bit-equal too (on the card torch divides by a scalar as a multiply
    by its reciprocal, which can move rms by an ulp)."""
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.core.config import SolverConfig
    from audio_triangulation_tpu_torch.ops import solver as solver_ops
    from audio_triangulation_tpu_torch.ops.cuda import gn_kernel

    worst = 0.0
    for mics in (geometry.reference_array(), geometry.square_array(0.3),
                 moving_setup()[0], geometry.circular_array(11, 0.25)):
        pairs = geometry.mic_pairs(mics.shape[0])
        mic3 = torch.zeros((mics.shape[0], 3), device="cuda")
        mic3[:, :2] = torch.as_tensor(mics, device="cuda")
        for sphere in (True, False):
            gn = gn_kernel.GnSolver.create(
                mics, pairs, speed_of_sound=343.0, height=1.2,
                cfg=SolverConfig(constrain_to_sphere=sphere))
            for b in GN_CHECK_SIZES:
                xy_true = torch.as_tensor(rng.uniform(-1.0, 1.0, (b, 2)),
                                          dtype=torch.float32, device="cuda")
                tau = solver_ops.predicted_tdoas(
                    xy_true, mic3, torch.as_tensor(pairs, device="cuda"),
                    343.0, 1.2, sphere)
                tau = tau + torch.as_tensor(
                    rng.normal(0.0, 2e-7, tau.shape), dtype=torch.float32,
                    device="cuda")
                init = xy_true * 0.9 + 0.02
                ref = gn.reference(tau, init)
                got = gn.launch(tau, init)
                torch.cuda.synchronize()
                exy = float((got[0] - ref[0]).abs().max())
                erms = float((got[1] - ref[1]).abs().max())
                scale = float(ref[2].abs().max())
                over = float(((got[2] - ref[2]).abs()
                              / (1e-4 * ref[2].abs() + 1e-6 * scale)).max())
                same = [k for k, g, r in zip(("xy", "rms", "cov"), got, ref)
                        if torch.equal(g, r)]
                say("3 gn", f"{mics.shape[0]} mics, sphere={sphere}: {b} "
                    f"frames, xy err {exy:.2e} m, rms err {erms:.2e} m, cov "
                    f"err {over:.2f} of its tolerance; bit-equal: "
                    f"{', '.join(same) or 'none'}")
                if not (exy <= 1e-5 and erms <= 1e-6 and over <= 1.0):
                    fail("3 gn", "kernel disagrees with its plain version")
                worst = max(worst, exy)
    results["gn_kernel"]["max_abs_err"] = worst


def large_configs():
    """(mics [64, 2], grid, [(name, PipelineConfig)]): the three 64-mic
    bench configurations: 8 x 8 grid array at 5 cm pitch, 4,096-sample
    frames, the lag window of the aperture (74 -> 149 lags), PHAT,
    circular padding, bf16 SRP scoring, on the 63 x 63 grid at 16 cells/m."""
    from audio_triangulation_tpu_torch import (GridConfig, PipelineConfig,
                                               geometry)

    mics = geometry.grid_array(8, 8, 0.05)
    base = dict(frame_size_bits=12,
                max_shift_samples=geometry.max_lag_for_array(
                    mics, PipelineConfig()),
                phat=True, fft_pad_mode="circular", srp_dtype="bfloat16")
    grid = GridConfig(half_cells_x=31, half_cells_y=31, cells_per_m=16.0)
    return mics, grid, [
        ("large64_fullband", PipelineConfig(**base)),
        ("large64_bandcrop_800_6000", PipelineConfig(
            **base, band_hz=(800.0, 6000.0), band_crop=True)),
        ("large64_auto", PipelineConfig(**base, band_hz="auto")),
    ]


def large_operands(frames, window, pairs, cfg):
    """The large-array kernel's operands for raw frames on the card:
    (re, im, sync, syns, keyword arguments, the packed synthesis matrix that
    the kernel reads), as its wrapper makes them."""
    from audio_triangulation_tpu_torch.models.localizer import (
        condition_frames)
    from audio_triangulation_tpu_torch.ops.cuda import gcc_large

    return (*gcc_large.operands(condition_frames(frames, window, cfg), pairs,
                                cfg),
            gcc_large.packed_synthesis(cfg, str(frames.device)))


def phase_large(rng, results):
    """The large-array GCC kernel against its plain version evaluated in
    float64 on the kernel's own operands (whitened, banded spectra), at 64
    mics x 4,096 samples, 2,016 pairs: without and with peaks.  Correlograms
    within 1e-4 of scale (1e-3 in the bf16 mode, where a cross-power value
    that differs in its last fp32 bits can round to the next bf16), shifts
    equal on rows whose two best values are clear of rounding, tdoa within
    1e-3 lags, psr within 1e-3 relative on those rows.  And the raw
    correlograms against the plain version that repeats the kernel's
    arithmetic (split TF32 operands, fp32 sums per step of K, flushed every
    64 steps), within 2e-5 of scale: inside a step the tensor cores add in
    another order and cut, not round, the aligned addends."""
    import dataclasses

    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_large

    mics, _, configs = large_configs()
    cases = configs + [("large64_fullband_bf16", dataclasses.replace(
        configs[0][1], matmul_dtype="bfloat16"))]
    pairs = torch.as_tensor(geometry.mic_pairs(mics.shape[0]), device="cuda")
    frames = torch.from_numpy(scene_frames(
        mics, LARGE_CHECK_FRAMES, rng, n=LARGE_SAMPLES)).cuda()
    worst = 0.0
    for name, cfg in cases:
        window = torch.as_tensor(window_ops.window_for(cfg), device="cuda")
        re, im, sync, syns, kw, packed = large_operands(frames, window, pairs,
                                                        cfg)
        ops64 = (re.double(), im.double(), pairs, sync.double(),
                 syns.double())
        raw64 = gcc_large.gcc_large_reference(*ops64, **kw, with_peaks=False)
        ref64 = gcc_large.gcc_large_reference(*ops64, **kw, with_peaks=True)
        raw = gcc_large.launch(re, im, pairs, sync, syns, **kw,
                               packed=packed, with_peaks=False)
        got = gcc_large.launch(re, im, pairs, sync, syns, **kw,
                               packed=packed, with_peaks=True)
        split = gcc_large.gcc_large_split_reference(
            re, im, pairs, sync, syns, **kw, with_peaks=False)
        torch.cuda.synchronize()
        scale = float(raw64.abs().max())
        tol = 1e-3 if kw["bf16"] else 1e-4

        def err(a, b):
            return float((a.double() - b.double()).abs().max()) / scale

        err_raw = err(raw, raw64)
        # in the bf16 mode a cross-power value that the kernel's and the
        # plain version's fp32 products leave a bit apart can round to the
        # next bf16, as against float64
        err_split, split_tol = err(raw, split), (tol if kw["bf16"] else 2e-5)
        top2 = raw64.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 10 * tol * scale
        err_tap = float(((got[0].double() - ref64[0]).abs().amax(dim=-1)
                         * clear).max()) / scale
        shift_bad = int(((got[1] != ref64[1]) & clear).sum())
        tdoa_err = float(((got[2] - ref64[2]).abs() * clear).max())
        peak_err = err(got[3], ref64[3])
        psr_rel = float((((got[4] - ref64[4]).abs() / ref64[4].abs())
                         * clear).max())
        say("2 large", f"{name}: {frames.shape[0]} frames x {pairs.shape[0]} "
            f"pairs, {re.shape[-1]} bins vs the plain version in float64: "
            f"corr/scale err raw {err_raw:.2e} tapered {err_tap:.2e}, peak "
            f"{peak_err:.2e}, shift mismatches {shift_bad} (near ties "
            f"excluded: {int((~clear).sum())} of {clear.numel()}), tdoa err "
            f"{tdoa_err:.2e} lags, psr rel err {psr_rel:.2e}; raw vs the "
            f"plain version in the kernel's arithmetic {err_split:.2e}")
        if not (err_raw <= tol and err_tap <= tol and peak_err <= tol
                and err_split <= split_tol
                and shift_bad == 0 and tdoa_err <= 10 * tol
                and psr_rel <= 10 * tol
                and int(clear.sum()) * 2 > clear.numel()):
            fail("2 large", f"{name}: kernel disagrees with its plain "
                 "version (or too few clear rows to tell)")
        if not kw["bf16"]:
            worst = max(worst, err_raw, err_tap)
        del raw64, ref64, raw, got, split
    results["gcc_large_kernel"]["max_abs_err"] = worst


def srp_inputs(corr_t):
    """The full 101 x 101 steering matrix [558, 10,201] of the 4-mic array
    for tapered correlograms [B, 6, 93] on the card."""
    import torch
    from audio_triangulation_tpu_torch import (GridConfig, PipelineConfig,
                                               geometry)

    mics = geometry.square_array(0.3)
    grid, cfg = GridConfig(), PipelineConfig()
    lut = geometry.lag_lut(grid, mics, geometry.mic_pairs(4), cfg)
    onehot = torch.as_tensor(geometry.lag_onehot(lut, cfg.num_lags),
                             device=corr_t.device)
    if (onehot.shape != (corr_t.shape[1] * corr_t.shape[2], 10201)
            or grid.num_cells != 10201):
        fail("srp", f"unexpected steering matrix {tuple(onehot.shape)}")
    return onehot, grid.num_cells


def srp_check(phase, name, corr_t, onehot, cells, bf16):
    """The SRP-argmax kernel against its plain version in float64: best
    score within 1e-4 of the score scale, the cell equal wherever the
    float64 top-two gap is clear of rounding; and its score against the
    plain version in the kernel's own arithmetic.  Returns the float64
    score error."""
    import torch
    from audio_triangulation_tpu_torch.ops.cuda import srp_kernel

    b = corr_t.shape[0]
    val, cell = srp_kernel.srp_argmax(corr_t, onehot, cells, bf16=bf16)
    torch.cuda.synchronize()
    flat, w = corr_t.reshape(b, -1).double(), onehot.double()
    if bf16:
        flat, w = flat.bfloat16().double(), w.bfloat16().double()
    scores = torch.matmul(flat, w)[:, :cells]
    top2 = scores.topk(2, dim=-1)
    smax = float(scores.abs().max())
    clear = (top2.values[:, 0] - top2.values[:, 1]) > 1e-4 * smax
    verr = float((val.double() - top2.values[:, 0]).abs().max()) / smax
    picked = scores.gather(-1, cell.long()[:, None])[:, 0]
    pick_err = float((picked - top2.values[:, 0]).abs().max()) / smax
    cell_bad = int(((cell.long() != scores.argmax(dim=-1)) & clear).sum())
    # and against the plain version that repeats the kernel's arithmetic
    # (split TF32 or bf16 operands, fp32 sums per step of K), within 2e-5
    # of scale: inside a step the tensor cores add in another order and
    # cut, not round, the aligned addends
    sval, _ = srp_kernel.srp_argmax_split_reference(
        corr_t.reshape(b, -1), onehot, cells, bf16=bf16)
    serr = float((val - sval).abs().max()) / smax
    say(phase, f"{name}: {b} frames x {onehot.shape[0]} x {cells} cells vs "
        f"the plain version in float64: score/scale err {verr:.2e}, cell "
        f"mismatches {cell_bad} (near ties excluded: {int((~clear).sum())}), "
        f"score of the chosen cell below the best by {pick_err:.2e}; vs the "
        f"plain version in the kernel's arithmetic {serr:.2e}")
    if not (verr <= 1e-4 and pick_err <= 1e-4 and cell_bad == 0
            and serr <= 2e-5 and int(clear.sum()) * 2 > b):
        fail(phase, f"{name}: kernel disagrees with its plain version")
    return verr


def phase_srp(rng, results):
    """The SRP-argmax kernel in f32 and bf16 on tapered correlograms of
    random-source frames against the 101 x 101 grid (10,201 cells: no
    multiple of any tile), on a general random matrix whose every size is
    ragged (1,000 frames, K = 557, 1,531 columns of which 1,400 count), and
    planted ties that the first cell must win."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, srp_kernel

    mics = geometry.square_array(0.3)
    cfg = PipelineConfig(phat=True, fft_pad_mode="circular")
    frames = torch.from_numpy(scene_frames(mics, SRP_CHECK_FRAMES,
                                           rng)).cuda()
    corr_t = gcc_kernel.fused_gcc(
        frames, torch.as_tensor(window_ops.window_for(cfg), device="cuda"),
        torch.as_tensor(geometry.mic_pairs(4), device="cuda"), cfg,
        with_peaks=True)[0]
    onehot, cells = srp_inputs(corr_t)
    worst = 0.0
    rb, rk, rg, rcells = SRP_RAGGED
    ragged_a = torch.from_numpy(rng.standard_normal(
        (rb, 1, rk), dtype=np.float32)).cuda()
    ragged_w = torch.from_numpy(rng.standard_normal(
        (rk, rg), dtype=np.float32)).cuda()
    for bf16 in (False, True):
        mode = "bf16" if bf16 else "f32"
        worst = max(worst, srp_check("2 srp", mode, corr_t, onehot, cells,
                                     bf16))
        worst = max(worst, srp_check("2 srp", f"{mode}, general matrix",
                                     ragged_a, ragged_w, rcells, bf16))
    # ties: all-zero scores -> cell 0; two equal best columns, 8,963 cells
    # apart -> the earlier one; a best column past num_cells never wins
    zeros = torch.zeros_like(corr_t[:300])
    _, cell0 = srp_kernel.srp_argmax(zeros, onehot, cells)
    tied = onehot.clone()
    tied[:, 37] = tied[:, 9000] = 2.0
    pos = corr_t[:300].abs() + 1e-3
    _, cell1 = srp_kernel.srp_argmax(pos, tied, cells)
    _, cell2 = srp_kernel.srp_argmax(pos, tied, cells, bf16=True)
    tied[:, 37] = 0.0
    _, cell3 = srp_kernel.srp_argmax(pos, tied, 9000)
    ref3 = torch.matmul(pos.reshape(pos.shape[0], -1), tied)[:, :9000].argmax(dim=-1)
    torch.cuda.synchronize()
    ok = (bool((cell0 == 0).all()) and bool((cell1 == 37).all())
          and bool((cell2 == 37).all()) and bool((cell3 < 9000).all())
          and float((cell3.long() == ref3).float().mean()) > 0.99)
    say("2 srp", f"ties on {pos.shape[0]} frames: zero scores -> cell 0 "
        f"{bool((cell0 == 0).all())}; equal columns 37 and 9,000 -> 37 "
        f"{bool((cell1 == 37).all())}, in bf16 "
        f"{bool((cell2 == 37).all())}; a larger column past num_cells "
        f"never wins {bool((cell3 < 9000).all())}")
    if not ok:
        fail("2 srp", "the first maximum did not win")
    results["srp_argmax_kernel"]["max_abs_err"] = worst


def phase_gcc_srp(rng, results):
    """The GCC kernel's SRP mode against its plain version.  Its first five
    outputs must equal the base mode's bit for bit.  Its scoring must equal
    the plain scoring of its own tapered rows (the same fp32 sums in the
    same order): cell equal, best score and every score of the [B, G]
    output within 1e-6 of scale.  Against the plain
    version in float64 on the frames, the cell must agree wherever the
    float64 top-two gap exceeds 1e-2 of the score scale: a tapered value
    that differs in its last fp32 bits can round to the next bf16 (2^-8 of
    it) before it is summed.  The count left out is printed."""
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    mics = geometry.square_array(0.3)
    frames = torch.from_numpy(scene_frames(mics, CHECK_FRAMES, rng)).cuda()
    worst = 0.0
    for name, cfg in main_configs()[:2]:
        loc = Localizer.create(mics, cfg, device="cuda", init_grid_stride=3)
        win_gain, mats = gcc_kernel.operands(frames, loc.window, cfg)
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
        if not gcc_kernel.srp_mode_fits(frames, cfg, loc.pairs.shape[0]):
            fail("2 gcc srp", f"{name}: the SRP mode does not fit")
        got = gcc_kernel.launch_srp(frames, win_gain, mats, loc.pairs,
                                    loc.lut_flat, **kw)
        base = gcc_kernel.launch(frames, win_gain, mats, loc.pairs, **kw,
                                 with_peaks=True)
        own_cell, own_score, own_scores = gcc_kernel.srp_first_max(
            got[0], loc.lut_flat)
        ref64 = gcc_kernel.gcc_srp_reference(
            frames.double(), win_gain.double(), mats.to(torch.float64),
            loc.pairs, loc.lut_flat, **kw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(base, got[:5]))
        tap64 = ref64[0].bfloat16().double()
        scores64 = sum(tap64[:, p, :].index_select(-1, loc.lut_flat[p].long())
                       for p in range(loc.pairs.shape[0]))
        smax = float(scores64.abs().max())
        top2 = scores64.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 1e-2 * smax
        cell_bad = int(((got[5] != ref64[5]) & clear).sum())
        serr = float((got[6].double() - ref64[6]).abs().max()) / smax
        own_bad = int((got[5] != own_cell).sum())
        own_err = float((got[6] - own_score).abs().max()) / smax
        scores_err = float((got[7] - own_scores).abs().max()) / smax
        scores_ok = got[7].shape == own_scores.shape
        say("2 gcc srp", f"{name}: {frames.shape[0]} frames, "
            f"{loc.lut_flat.shape[1]} cells: first five outputs equal to the "
            f"base mode's {same}; vs the plain scoring of its own rows: cell "
            f"mismatches {own_bad}, score/scale err {own_err:.2e}, scores "
            f"{tuple(got[7].shape)} err {scores_err:.2e}; vs the "
            f"plain version in float64: cell mismatches {cell_bad} (near "
            f"ties excluded: {int((~clear).sum())}), score/scale err "
            f"{serr:.2e}")
        if not (same and own_bad == 0 and own_err <= 1e-6 and scores_ok
                and scores_err <= 1e-6 and cell_bad == 0
                and serr <= 1e-2 and int(clear.sum()) * 2 > clear.numel()):
            fail("2 gcc srp", f"{name}: kernel disagrees with its plain "
                 "version")
        worst = max(worst, own_err, scores_err)
    results["gcc_srp_kernel"]["max_abs_err"] = worst


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


def fused_srp_config():
    """The first bench line with scoring and the grid argmax in the GCC
    kernel."""
    import dataclasses

    name, cfg = main_configs()[0]
    return name + "_fused_srp", dataclasses.replace(cfg, fused_srp="on")


# the kernels each main path must launch
PATH_KERNELS = {"bandcrop_800_6000": ("gcc_kernel", "gn_kernel"),
                "fullband": ("gcc_kernel", "gn_kernel"),
                "handsfree_auto_hybrid": ("gcc_stats_kernel", "gn_kernel"),
                "bandcrop_800_6000_fused_srp": ("gcc_srp_kernel",
                                                "gn_kernel"),
                "large64_fullband": ("gcc_large_kernel",),
                "large64_bandcrop_800_6000": ("gcc_large_kernel",),
                "large64_auto": ("gcc_large_kernel",),
                "srp_argmax_101x101": ("srp_argmax_kernel",),
                "tool_int8_microbench": ("dft_matmul_kernel_f32",
                                         "dft_matmul_kernel_bf16",
                                         "dft_matmul_kernel_int8"),
                "tool_emit_pipeline_probe": ("gcc_pipelined_kernel",
                                             "gcc_kernel"),
                **{f"stream_{name}": ("detector_scan_kernel",)
                   for name in ("default", "band_crop_phat",
                                "band_auto_phat", "xyz_tetra", "tracked",
                                "multi", "velocity", "tracked_multi",
                                "tracked_velocity")},
                "multi_8mic": ("gcc_kernel",),
                "multi_64mic": ("gcc_large_kernel",),
                "moving": ("gcc_kernel", "gn_kernel"),
                # the port's tools: the accuracy sweep's five methods and
                # the bench's three configurations (base and stats modes),
                # the tracked soak's stream step
                "tool_bench_accuracy": ("gcc_kernel", "gcc_stats_kernel",
                                        "gn_kernel"),
                "tool_bench": ("gcc_kernel", "gcc_stats_kernel",
                               "gn_kernel"),
                "tool_soak_streaming": ("detector_scan_kernel",),
                # the integer path is plain torch (no kernel: its count is
                # recorded); the offline stream's events go through the
                # Localizer's GCC base mode and GN kernel
                "localize_frames_int": (),
                "localize_stream": ("gcc_kernel", "gn_kernel")}


def launch_counts():
    from audio_triangulation_tpu_torch.ops.cuda import (
        detector_scan, dft_matmul, gcc_kernel, gcc_large, gn_kernel,
        srp_kernel)

    return {"detector_scan_kernel": detector_scan.launches,
            "gcc_kernel": gcc_kernel.launches,
            "gcc_stats_kernel": gcc_kernel.stats_launches,
            "gn_kernel": gn_kernel.launches,
            "gcc_large_kernel": gcc_large.launches,
            "srp_argmax_kernel": srp_kernel.launches,
            "gcc_srp_kernel": gcc_kernel.srp_launches,
            "gcc_pipelined_kernel": gcc_kernel.pipelined_launches,
            **{f"dft_matmul_kernel_{t}": n
               for t, n in dft_matmul.launches.items()}}


def reset_counts():
    from audio_triangulation_tpu_torch.ops.cuda import (
        detector_scan, dft_matmul, gcc_kernel, gcc_large, gn_kernel,
        srp_kernel)

    detector_scan.launches = 0
    gcc_kernel.launches = gcc_kernel.stats_launches = 0
    gcc_kernel.srp_launches = gn_kernel.launches = 0
    gcc_kernel.pipelined_launches = 0
    gcc_large.launches = srp_kernel.launches = 0
    for t in dft_matmul.launches:
        dft_matmul.launches[t] = 0


def counted(name, results, fn):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; add the counts to the results and fail if a kernel of the path
    ``name`` was not launched.  Calls of the SRP scoring product and of the
    batched solver and covariance outside the kernels are counted too: a
    path whose kernel scores must make no scoring product, and a path that
    takes the GN kernel neither solver call (the kernel writes the
    covariance)."""
    import torch
    from audio_triangulation_tpu_torch.ops import solver, srp

    reset_counts()
    spied = {"srp_scores_matmul": srp, "solve_tdoa_batched": solver,
             "solution_covariance": solver}
    calls = dict.fromkeys(spied, 0)
    originals = {k: getattr(mod, k) for k, mod in spied.items()}

    def spy(k):
        def call(*args, **kwargs):
            calls[k] += 1
            return originals[k](*args, **kwargs)
        return call

    for k, mod in spied.items():
        setattr(mod, k, spy(k))
    try:
        out = fn()
    finally:
        for k, mod in spied.items():
            setattr(mod, k, originals[k])
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, v in counts.items():
        results[k]["launches"] += v
        if v:  # the path that launched it
            results[k].setdefault("launches_by_path", {})[name] = v
    say("4 main", f"{name}: launches {counts}; calls outside the kernels "
        f"{calls}")
    if any(counts[k] < 1 for k in PATH_KERNELS[name]):
        fail("4 main", f"{name}: a kernel of its path was never launched")
    if "gcc_srp_kernel" in PATH_KERNELS[name] and calls["srp_scores_matmul"]:
        fail("4 main", f"{name}: the scores were formed again outside the "
             "kernel")
    if "gn_kernel" in PATH_KERNELS[name] and (
            calls["solve_tdoa_batched"] or calls["solution_covariance"]):
        fail("4 main", f"{name}: the solve or the covariance ran outside the "
             "GN kernel")
    return out


def check_localizer(name, loc, out, frames_np, n_cpu, create_kw,
                    clear_rows=None):
    """One path's result: finite, of the expected shape, its median error
    under the configuration's bound, and held to the port's CPU path on the
    first ``n_cpu`` frames (xy within 2e-4 m, tdoa within 1e-3 samples,
    equal best shifts; with ``clear_rows``, a function of the CPU localizer
    and frames that marks the rows clear of a near tie, on those rows)."""
    import torch
    from audio_triangulation_tpu_torch import Localizer

    n_frames = frames_np.shape[0]
    xy = out["xy"]
    if (xy.shape != (n_frames, 2) or not bool(torch.isfinite(xy).all())
            or not bool(torch.isfinite(out["scores"]).all())):
        fail("4 main", f"{name}: non-finite or misshapen output")
    err = (xy - torch.tensor(SOURCE_XY, device="cuda")).norm(dim=-1)
    med = float(err.median())
    cpu_loc = Localizer.create(
        loc.mic_positions.cpu().numpy(), loc.pipeline, device="cpu",
        **create_kw)
    cpu_frames = torch.from_numpy(frames_np[:n_cpu])
    ref = cpu_loc(cpu_frames)
    dxy = float((xy[:n_cpu].cpu() - ref["xy"]).abs().max())
    shift_ne = out["best_shift"][:n_cpu].cpu() != ref["best_shift"]
    left_out = ""
    if clear_rows is not None:
        clear = clear_rows(cpu_loc, cpu_frames)
        left_out = (f" on rows clear of a near tie ({int((~clear).sum())} of "
                    f"{clear.numel()} left out)")
        shift_ne &= clear
    shift_eq = not bool(shift_ne.any())
    dtdoa = float((out["tdoa_samples"][:n_cpu].cpu()
                   - ref["tdoa_samples"]).abs().max())
    say("4 main", f"{name}: median |xy - (0.5, 0.4)| = {med * 100:.4f} "
        f"cm; vs CPU path on {n_cpu} frames: xy {dxy:.2e} m, shifts "
        f"equal {shift_eq}{left_out}, tdoa {dtdoa:.2e} samples")
    if not (med < MEDIAN_BOUND_M[name] and dxy <= 2e-4 and shift_eq
            and dtdoa <= 1e-3):
        fail("4 main", f"{name}: result check failed")


def large_clear_rows(cpu_loc, cpu_frames):
    """Rows [B, P] whose two best raw correlogram values lie further apart
    than 1e-3 of scale, from the CPU path's plain large-array engine: over
    2,016 pairs some true delays fall half-way between two lags, and there
    fp32 rounding decides the integer shift (the sub-sample tdoa is the
    same either way)."""
    from audio_triangulation_tpu_torch.models.localizer import (
        condition_frames)
    from audio_triangulation_tpu_torch.ops.cuda import gcc_large

    raw = gcc_large.xcorr_large(
        condition_frames(cpu_frames, cpu_loc.window, cpu_loc.pipeline),
        cpu_loc.pairs, cpu_loc.pipeline)
    top2 = raw.topk(2, dim=-1).values
    return (top2[..., 0] - top2[..., 1]) > 1e-3 * float(raw.abs().max())


def phase_main(rng, results):
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.ops.cuda import srp_kernel

    for k in results:
        results[k]["launches"] = 0

    # ---- the 4-mic paths: 16,384 frames of 4 x 1,024 ----------------------
    mics = geometry.square_array(0.3)
    frames_np = scene_frames(mics, FRAMES, rng,
                             fixed_source=(*SOURCE_XY, 1.2))
    frames = torch.from_numpy(frames_np).cuda()
    small_kw = dict(init_grid_stride=3)
    locs = [(name, Localizer.create(mics, cfg, device="cuda", **small_kw))
            for name, cfg in main_configs() + [fused_srp_config()]]
    torch.cuda.synchronize()
    outs = {}
    for name, loc in locs:
        outs[name] = counted(name, results, lambda: loc(frames))
    for name, loc in locs:
        check_localizer(name, loc, outs[name], frames_np, 64, small_kw)
    fused, plain = outs[locs[3][0]], outs[locs[0][0]]
    same = sorted(fused) == sorted(plain) and all(
        torch.equal(fused[k], plain[k]) for k in plain
        if k not in ("scores", "xy_grid", "xy", "rms_m", "xy_cov"))
    smax = float(plain["scores"].abs().max())
    scores_err = float((fused["scores"] - plain["scores"]).abs().max()) / smax
    cell_eq = float((fused["xy_grid"] == plain["xy_grid"]).all(
        dim=-1).float().mean())
    say("4 main", f"{locs[3][0]}: keys and outputs before the scores equal "
        f"to {locs[0][0]}'s {same}; scores {scores_err:.2e} of scale from "
        f"the outside product's; the kernel's cell is the outside argmax's "
        f"on {cell_eq * 100:.3f}% of frames")
    # the kernel sums each score's six bf16 values in pair order, the outside
    # product in its own order; two cells whose scores differ by that fp32
    # rounding may swap
    if not (same and scores_err <= 1e-6 and cell_eq >= 0.999
            and fused["scores"].shape == plain["scores"].shape
            and fused["scores"].dtype == plain["scores"].dtype):
        fail("4 main", "in-kernel SRP changed the result")

    # ---- srp_argmax on the full 101 x 101 grid ------------------------------
    corr_t = outs["fullband"]["correlograms"]
    onehot, cells = srp_inputs(corr_t)
    val, cell = counted(
        "srp_argmax_101x101", results,
        lambda: srp_kernel.srp_argmax(corr_t, onehot, cells))
    srp_check("4 main", "srp_argmax_101x101", corr_t[:SRP_CHECK_FRAMES],
              onehot, cells, False)
    xy_cell = torch.stack([(cell % 101 - 50) / 24.0,
                           (50 - cell // 101) / 24.0], dim=-1)
    off = float((xy_cell - torch.tensor(SOURCE_XY, device="cuda")).norm(
        dim=-1).median())
    say("4 main", f"srp_argmax_101x101: median |best cell - (0.5, 0.4)| = "
        f"{off * 100:.2f} cm (cells are 4.17 cm)")
    if not (val.shape == cell.shape == (FRAMES,)
            and bool(torch.isfinite(val).all()) and off < 0.1):
        fail("4 main", "srp_argmax_101x101: result check failed")
    srp_args = (corr_t, onehot, cells)
    del outs, fused, plain

    # ---- the 64-mic paths: 256 frames of 64 x 4,096 -------------------------
    mics64, grid64, configs64 = large_configs()
    large_np = scene_frames(mics64, LARGE_FRAMES, rng,
                            fixed_source=(*SOURCE_XY, 1.2), n=LARGE_SAMPLES)
    large = torch.from_numpy(large_np).cuda()
    large_kw = dict(grid=grid64, init_grid_stride=LARGE_STRIDE)
    large_locs = []
    for name, cfg in configs64:
        loc = Localizer.create(mics64, cfg, device="cuda", **large_kw)
        out = counted(name, results, lambda: loc(large))
        check_localizer(name, loc, out, large_np, LARGE_CPU_FRAMES, large_kw,
                        clear_rows=large_clear_rows)
        large_locs.append((name, loc))
        del out
    return locs, frames, large_locs, large, srp_args


def time_path(card, name, fn, n_frames, phase="5 timing"):
    """Frames/s of ``fn()`` by the bench tool's timing function (median and
    quartiles of ``TRIALS`` calls, host clock around a synchronise)."""
    from audio_triangulation_tpu_torch.tools.bench import frames_per_s

    med, q1, q3 = frames_per_s(fn, n_frames, TRIALS, "cuda")
    say(phase, f"{name}: {med:.1f} frames/s median, IQR "
        f"{q1:.1f}-{q3:.1f} over {TRIALS} trials of {n_frames} frames "
        f"({n_frames / med * 1e3:.4f} ms a call) ({card})")


def gn_inputs(loc, b):
    """TDOAs [b, P] (seconds) of random plane points under ``loc``'s array
    with 2e-7 s noise, and inits near them: the solver tail's inputs."""
    import torch
    from audio_triangulation_tpu_torch.ops import solver as solver_ops

    g = torch.Generator(device="cuda").manual_seed(SEED)
    xy0 = torch.rand((b, 2), device="cuda", generator=g) * 2 - 1
    m_n = loc.mic_positions.shape[0]
    mic3 = torch.zeros((m_n, 3), device="cuda")
    mic3[:, :2] = loc.mic_positions[:, :2]
    tau = solver_ops.predicted_tdoas(
        xy0, mic3, loc.pairs, loc.pipeline.speed_of_sound_mps,
        loc.grid.height_m, loc.solver.constrain_to_sphere)
    tau = tau + 2e-7 * torch.randn(tau.shape, device="cuda", generator=g)
    return tau.contiguous(), (xy0 * 0.9 + 0.02).contiguous()


def device_kernels(fn):
    """One call of ``fn()`` under torch.profiler: (kernels launched, their
    device milliseconds, their names)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cpu = torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages() if e.device_type != cpu
               and e.self_device_time_total > 0]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels) / 1e3,
            [e.key for e in kernels])


def phase_timing(card, locs, frames, large_locs, large, srp_args, results):
    import dataclasses

    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import xcorr
    from audio_triangulation_tpu_torch.ops.cuda import (
        gcc_kernel, gcc_large, srp_kernel)

    from audio_triangulation_tpu_torch.tools import bench

    # each 4-mic path on this run's scene frames (a noise draw a frame),
    # then on the bench tool's own input (one event replicated), so that
    # the tool's lines in phase 11 have their counterpart here
    replicated = bench.bench_frames(frames.shape[0], "cuda")
    for name, loc in locs:
        time_path(card, name, lambda: loc(frames), frames.shape[0])
        time_path(card, f"{name} on the bench tool's frames",
                  lambda: loc(replicated), frames.shape[0])
    del replicated
    time_path(card, "srp_argmax_101x101",
              lambda: srp_kernel.srp_argmax(*srp_args), frames.shape[0])
    for name, loc in large_locs:
        time_path(card, name, lambda: loc(large), large.shape[0])

    def smaller_bound(kernel, name, k_ms, cores, tensor, how):
        """The kernel's two bounds (everything on the fp32 CUDA cores; its
        products on the tensor cores, ``how``), printed; the smaller one,
        which the kernel is held to."""
        bnd = min(cores, tensor, key=lambda d: d["bound_ms"])
        pct = share_of_bound("5 timing", f"{kernel} {name}", k_ms, bnd)
        say("5 timing", f"{kernel} {name}: bound on the fp32 CUDA cores "
            f"{cores['bound_ms']:.4f} ms, {how} {tensor['bound_ms']:.4f} ms; "
            f"the kernel runs at {pct:.1f}% of the smaller")
        return bnd

    def report(kernel, name, k_ms, p_ms, bnd, library_ms=None, **extra):
        lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
        share_of_bound("5 timing", f"{kernel} {name}", k_ms, bnd)
        say("5 timing", f"{kernel} {name}: kernel {k_ms:.4f} ms, plain "
            f"{p_ms:.4f} ms{lib}, bound {bnd['bound_ms']:.4f} ms by "
            f"{bnd['bound_by']} ({card})")
        if "ms" not in results[kernel]:  # the first config of each kernel
            results[kernel].update(ms=k_ms, plain_ms=p_ms, **bnd,
                                   library_ms=library_ms, **extra)

    # each kernel against its plain version at the main path's shapes
    b, m, n = frames.shape
    pairs = torch.as_tensor(geometry.mic_pairs(4), device="cuda")
    for name, loc in locs:
        cfg = loc.pipeline
        ops = (*gcc_kernel.operands(frames, loc.window, cfg), pairs)
        f, l = ops[1][2].shape
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
        sp = gcc_kernel.stats_params(cfg, True)
        # the base and SRP modes multiply their DFT on the tensor cores
        # (three TF32 products) and could their synthesis: each is held to
        # the smaller of its all-fp32 bound and that one
        split_how = "with the DFT and the synthesis as three TF32 products each"
        if cfg.fused_srp == "on":
            lut = loc.lut_flat
            k_ms, p_ms = alternate_ms(
                lambda: gcc_kernel.gcc_srp_reference(frames, *ops, lut, **kw),
                lambda: gcc_kernel.launch_srp(frames, *ops, lut, **kw))
            cores = gcc_bound(b, m, n, f, 6, l, srp_cells=lut.shape[1])
            bnd = smaller_bound(
                "gcc_srp_kernel", name, k_ms, cores,
                gcc_bound(b, m, n, f, 6, l, srp_cells=lut.shape[1],
                          split_products=True), split_how)
            report("gcc_srp_kernel", name, k_ms, p_ms, bnd,
                   bound_ms_fp32_cores=cores["bound_ms"])
        elif sp is None:
            k_ms, p_ms = alternate_ms(
                lambda: gcc_kernel.gcc_reference(frames, *ops, **kw,
                                                 with_peaks=True),
                lambda: gcc_kernel.launch(frames, *ops, **kw,
                                          with_peaks=True))
            cores = gcc_bound(b, m, n, f, 6, l)
            bnd = smaller_bound("gcc_kernel", name, k_ms, cores,
                                gcc_bound(b, m, n, f, 6, l,
                                          split_products=True), split_how)
            report("gcc_kernel", name, k_ms, p_ms, bnd,
                   bound_ms_fp32_cores=cores["bound_ms"])
            # the same kernel without its peak stage (no bench line asks
            # for it: they all taper and sub-sample)
            k_ms, p_ms = alternate_ms(
                lambda: gcc_kernel.gcc_reference(frames, *ops, **kw,
                                                 with_peaks=False),
                lambda: gcc_kernel.launch(frames, *ops, **kw,
                                          with_peaks=False))
            bnd = gcc_bound(b, m, n, f, 6, l, with_peaks=False,
                            split_products=True)
            pct = share_of_bound("5 timing", f"gcc_kernel {name} without "
                                 "peaks", k_ms, bnd)
            say("5 timing", f"gcc_kernel {name} without peaks: kernel "
                f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} ({split_how}),"
                f" {pct:.1f}% of it ({card})")
        else:
            # the stats mode multiplies its DFT and its synthesis stage on
            # the tensor cores (three TF32 products each) and does the rest,
            # window sums and cross-power, on the CUDA cores
            k_ms, p_ms = alternate_ms(
                lambda: gcc_kernel.gcc_stats_reference(
                    frames, *ops, sp, **kw, with_peaks=True),
                lambda: gcc_kernel.launch_stats(
                    frames, *ops, sp, **kw, with_peaks=True))
            cores = gcc_bound(b, m, n, f, 6, l, stats_hw=sp.half_width)
            bnd = smaller_bound(
                "gcc_stats_kernel", name, k_ms, cores,
                gcc_bound(b, m, n, f, 6, l, stats_hw=sp.half_width,
                          split_products=True),
                "with the DFT and the synthesis as three TF32 products each")
            report("gcc_stats_kernel", name, k_ms, p_ms, bnd,
                   bound_ms_fp32_cores=cores["bound_ms"])

    # row 5 on the band-crop line's Localizer, both forms timed alike (CUDA
    # events, in turns): the plain version and the kernel through its
    # wrapper, which is the whole solver tail (PR 8's split tail is timed by
    # ``chip_variants.py gn``)
    loc = locs[0][1]
    m_n, p_n = loc.mic_positions.shape[0], loc.pairs.shape[0]
    tau, init = gn_inputs(loc, b)
    iters = loc.solver.iterations
    forms = {"plain": lambda: loc.gn.reference(tau, init),
             "tail": lambda: loc.gn(tau, init)}
    order = tuple(forms)
    t = {k: [] for k in forms}
    for k in (*order, *order[::-1]):
        t[k].append(cuda_ms(forms[k], REPS))
    ms = {k: float(np.mean(v)) for k, v in t.items()}
    launches, kernel_ms, names = device_kernels(forms["tail"])
    if launches != 1 or not all("gn_kernel" in n for n in names):
        fail("5 timing", f"the solver tail launched {names}, not the GN "
             "kernel alone")
    say("5 timing", f"gn_kernel solver tail (the kernel through its "
        f"wrapper): {ms['tail']:.4f} ms a call (CUDA events, "
        f"{t['tail'][0]:.4f} / {t['tail'][1]:.4f} in turns), {launches} "
        f"kernel launch a call, {kernel_ms:.4f} ms of device time ({card})")
    bnd = bound(b * ((iters + 1) * (30 + 22 * m_n + 16 * p_n) + 2 * p_n
                     + 15 * iters + 22), 4 * b * (p_n + 2 + 2 + 1 + 4))
    report("gn_kernel", f"({b} frames, through the wrapper)", ms["tail"],
           ms["plain"], bnd, device_ms=kernel_ms,
           launches_per_call=launches)
    pct = share_of_bound("5 timing", "gn_kernel device time", kernel_ms, bnd)
    say("5 timing", f"gn_kernel device time {kernel_ms:.4f} ms, {pct:.1f}% "
        f"of its bound ({card})")

    # the SRP-argmax kernel; its library yardstick is two calls, a matmul
    # that stores [B, G] and an argmax over it (for the bf16 mode on
    # operands already rounded to bf16).  The f32 mode has two bounds, the
    # product once on the fp32 CUDA cores or three times on the TF32 tensor
    # cores; it is held to the smaller.
    corr_t, onehot, cells = srp_args
    flat = corr_t.reshape(b, -1)
    k_dim, g = onehot.shape
    flops, nbytes = 2 * b * k_dim * g, 4 * (b * k_dim + k_dim * g + 2 * b)
    k_ms, p_ms = alternate_ms(
        lambda: srp_kernel.srp_argmax_reference(flat, onehot, cells),
        lambda: srp_kernel.launch(flat, onehot, cells))
    lib_ms = cuda_ms(lambda: torch.matmul(flat, onehot).argmax(dim=-1), REPS)
    cores, tensor = bound(flops, nbytes), bound(3 * flops, nbytes,
                                                PEAK_TF32_FLOPS)
    bnd = min(cores, tensor, key=lambda d: d["bound_ms"])
    report("srp_argmax_kernel", f"({b} frames, {g} cells)", k_ms, p_ms, bnd,
           library_ms=lib_ms, library="torch.matmul + argmax (two calls)")
    pct = share_of_bound("5 timing", "srp_argmax_kernel f32 mode", k_ms, bnd)
    say("5 timing", f"srp_argmax_kernel f32 mode: bound on the fp32 CUDA "
        f"cores {cores['bound_ms']:.4f} ms, as three TF32 products "
        f"{tensor['bound_ms']:.4f} ms; the kernel runs at "
        f"{pct:.1f}% of the smaller")
    kb_ms, pb_ms = alternate_ms(
        lambda: srp_kernel.srp_argmax_reference(flat, onehot, cells,
                                                bf16=True),
        lambda: srp_kernel.launch(flat, onehot, cells, bf16=True))
    flat_b, onehot_b = flat.bfloat16(), onehot.bfloat16()
    libb_ms = cuda_ms(
        lambda: torch.matmul(flat_b, onehot_b).argmax(dim=-1), REPS)
    bnd_b = bound(flops, nbytes, PEAK_BF16_FLOPS)
    pct = share_of_bound("5 timing", "srp_argmax_kernel bf16 mode", kb_ms,
                         bnd_b)
    say("5 timing", f"srp_argmax_kernel bf16 mode ({b} frames, {g} cells): "
        f"kernel {kb_ms:.4f} ms, plain {pb_ms:.4f} ms, library "
        f"{libb_ms:.4f} ms (bf16 torch.matmul + argmax on operands already "
        f"in bf16), bound {bnd_b['bound_ms']:.4f} ms by "
        f"{bnd_b['bound_by']}, "
        f"{pct:.1f}% of it ({card})")
    results["srp_argmax_kernel"].update(
        bound_ms_fp32_cores=cores["bound_ms"], bf16_ms=kb_ms,
        bf16_plain_ms=pb_ms, bf16_library_ms=libb_ms,
        bf16_bound_ms=bnd_b["bound_ms"])
    del flat_b, onehot_b

    # the large-array kernel, with peaks as the Localizer calls it; and on
    # the band-crop line both peak routes: in the kernel, or the plain peak
    # ops after it
    lb, lm, _ = large.shape
    for name, loc in large_locs:
        cfg = loc.pipeline
        re, im, sync, syns, kw, packed = large_operands(
            large, loc.window, loc.pairs, cfg)
        f, l = sync.shape
        p = loc.pairs.shape[0]
        flops = lb * p * f * (6 + 4 * l)
        nbytes = 4 * (2 * lb * lm * f + 2 * f * l + 2 * p + lb * p * l
                      + 4 * lb * p)
        k_ms, p_ms = alternate_ms(
            lambda: gcc_large.gcc_large_reference(
                re, im, loc.pairs, sync, syns, **kw, with_peaks=True),
            lambda: gcc_large.launch(re, im, loc.pairs, sync, syns, **kw,
                                     packed=packed, with_peaks=True),
            LARGE_REPS)
        cores = bound(flops, nbytes)
        bnd = smaller_bound("gcc_large_kernel", name, k_ms, cores,
                            bound(3 * flops, nbytes, PEAK_TF32_FLOPS),
                            "as three TF32 products")
        report("gcc_large_kernel", name, k_ms, p_ms, bnd,
               bound_ms_fp32_cores=cores["bound_ms"])
        if not cfg.band_crop and not cfg.band_auto:
            # the bf16 mode of the same line: one TF32 product
            bcfg = dataclasses.replace(cfg, matmul_dtype="bfloat16")
            bre, bim, bsync, bsyns, bkw, bpacked = large_operands(
                large, loc.window, loc.pairs, bcfg)
            kb_ms, pb_ms = alternate_ms(
                lambda: gcc_large.gcc_large_reference(
                    bre, bim, loc.pairs, bsync, bsyns, **bkw,
                    with_peaks=True),
                lambda: gcc_large.launch(bre, bim, loc.pairs, bsync, bsyns,
                                         **bkw, packed=bpacked,
                                         with_peaks=True), LARGE_REPS)
            bnd_b = bound(flops, nbytes, PEAK_TF32_FLOPS)
            pct = share_of_bound("5 timing", "gcc_large_kernel bf16 mode",
                                 kb_ms, bnd_b)
            say("5 timing", f"gcc_large_kernel {name} bf16 mode: kernel "
                f"{kb_ms:.4f} ms, plain {pb_ms:.4f} ms, bound "
                f"{bnd_b['bound_ms']:.4f} ms by {bnd_b['bound_by']} (one TF32 "
                f"product), {pct:.1f}% of it ({card})")
            results["gcc_large_kernel"].update(
                bf16_ms=kb_ms, bf16_plain_ms=pb_ms,
                bf16_bound_ms=bnd_b["bound_ms"])
            del bre, bim
        if cfg.band_crop:
            k = cfg.max_shift

            def outside():
                corr = gcc_large.launch(re, im, loc.pairs, sync, syns, **kw,
                                        packed=packed, with_peaks=False)
                shifts = xcorr.best_lag(corr, k)
                return (xcorr.peak_taper(corr, k, cfg.taper_denom, shifts),
                        shifts, *xcorr.subsample_peak(corr, k),
                        xcorr.peak_confidence(corr, k))

            in_ms, out_ms = alternate_ms(
                outside, lambda: gcc_large.launch(
                    re, im, loc.pairs, sync, syns, **kw, packed=packed,
                    with_peaks=True), LARGE_REPS)
            say("5 timing", f"gcc_large_kernel {name} peak routes: peaks in "
                f"the kernel {in_ms:.4f} ms, kernel without peaks then the "
                f"plain peak ops {out_ms:.4f} ms ({card})")


def dft_bound(name, rows, n, f, *, split=False) -> dict:
    """Bound of one DFT-product call: 2 x 2 rows n f operations at the rate
    the card has for the operand type (fp32 CUDA cores; bf16 and int8
    tensor cores), and x, w1, w2 read once and the 4-byte output written
    once.  ``split``: f32 as three TF32 products on the tensor cores, the
    split-fp32 product the f32 kernel runs."""
    rate, size = {"f32": (PEAK_FP32_FLOPS, 4), "bf16": (PEAK_BF16_FLOPS, 2),
                  "int8": (PEAK_INT8_OPS, 1)}[name]
    ops = 4 * rows * n * f
    if split:
        ops, rate = 3 * ops, PEAK_TF32_FLOPS
    return bound(ops, size * (rows * n + 2 * n * f) + 4 * rows * f, rate)


def phase_dft_matmul(card, results):
    """The DFT-product kernel against its plain version at rows 256 x 16
    (s = 0), at 4,005 rows, which no block tile divides (s = 2), and at the
    65,536 rows that the tool and the timing below give it (s = 1), n 1,024,
    f 512: int8 bit-equal; f32 and bf16 within 1e-5 of the output
    scale of a float64 evaluation of the same type-rounded operands (a
    1,024-term fp32 sum; the x + s add is made in x's type on both sides);
    f32 also within 1e-5 of scale of ``dft_matmul_split_reference``, its
    arithmetic in plain PyTorch, and its packed split copies of w1, w2
    equal to the plain version's.
    Then timed at 65,536 rows in turns with the plain version, and beside
    the library form: two ``torch.matmul`` and an add (for bf16 with bf16
    outputs, the only form one call gives), ``torch._int_mm`` for int8."""
    import torch
    from audio_triangulation_tpu_torch.ops.cuda import dft_matmul
    from audio_triangulation_tpu_torch.tools import int8_microbench

    for name in dft_matmul.TYPE_SETS:
        key = f"dft_matmul_kernel_{name}"
        x, w1, acc_dt = int8_microbench.make_inputs(
            name, DFT_ROWS, DFT_N, DFT_F, DFT_GRID, "cuda", seed=SEED)
        w2 = w1.flip(0).contiguous()  # a second matrix, not the first again
        worst = 0.0
        for sv, rows in ((0, DFT_CHECK_GRID * DFT_ROWS), (2, DFT_RAGGED_ROWS),
                         (1, x.shape[0])):
            s = torch.full((1,), sv, dtype=acc_dt, device="cuda")
            xc = x[:rows]
            got = dft_matmul.launch(xc, w1, w2, s)
            ref = dft_matmul.dft_matmul_reference(xc, w1, w2, s)
            torch.cuda.synchronize()
            if name == "int8":
                same = bool(torch.equal(got, ref))
                say("2 dft", f"{name} s={sv}: {tuple(got.shape)} equal to the "
                    f"plain version bit for bit: {same}")
                if not same:
                    fail("2 dft", f"{name}: kernel disagrees with its plain "
                         "version")
            else:
                xs = (xc + s.to(xc.dtype)).double()
                r64 = xs @ w1.double() + xs @ w2.double()
                scale = float(r64.abs().max())
                e_k = float((got.double() - r64).abs().max()) / scale
                e_p = float((ref.double() - r64).abs().max()) / scale
                say("2 dft", f"{name} s={sv}: {tuple(got.shape)} vs float64: "
                    f"kernel {e_k:.2e} of scale (tolerance 1e-5), plain "
                    f"version {e_p:.2e}")
                if not e_k <= 1e-5:
                    fail("2 dft", f"{name}: kernel disagrees with the float64 "
                         "evaluation")
                worst = max(worst, e_k)
                if name == "f32":
                    sp = dft_matmul.dft_matmul_split_reference(xc, w1, w2, s)
                    e_s = float((got.double() - sp.double()).abs().max()
                                ) / scale
                    say("2 dft", f"{name} s={sv}: kernel vs the split plain "
                        f"version {e_s:.2e} of scale (tolerance 1e-5); that "
                        f"version vs float64 "
                        f"{float((sp.double() - r64).abs().max()) / scale:.2e}")
                    if not e_s <= 1e-5:
                        fail("2 dft", f"{name}: kernel disagrees with "
                             "dft_matmul_split_reference")
                    del sp
                del xs, r64
            del got, ref
        results[key]["max_abs_err"] = worst
        if name != "f32":  # the K-major copies the wgmma kernel reads
            km = dft_matmul.k_major(w1, w2)
            same = bool(torch.equal(km[0], w1.t()) and torch.equal(km[1],
                                                                    w2.t()))
            say("2 dft", f"{name}: K-major copies of w1, w2 "
                f"{tuple(km.shape)} equal to their transposes: {same}")
            if not same:
                fail("2 dft", f"{name}: k_major disagrees with w.T")
        else:  # the split K-major copies
            km = dft_matmul.split_k_major(w1, w2)
            same = bool(torch.equal(
                km, dft_matmul.split_k_major_reference(w1, w2)))
            say("2 dft", f"{name}: split K-major copies of w1, w2 "
                f"{tuple(km.shape)} equal to the plain version's: {same}")
            if not same:
                fail("2 dft", f"{name}: split_k_major disagrees with its "
                     "plain version")

        s = torch.full((1,), 1, dtype=acc_dt, device="cuda")
        k_ms, p_ms = alternate_ms(
            lambda: dft_matmul.dft_matmul_reference(x, w1, w2, s),
            lambda: dft_matmul.launch(x, w1, w2, s), DFT_REPS)
        xs = x + s.to(x.dtype)
        lib_ms, lib = None, "none"
        if name == "int8":
            if hasattr(torch, "_int_mm"):
                lib = "torch._int_mm twice and an add"
                lib_ms = cuda_ms(lambda: torch._int_mm(xs, w1)
                                 + torch._int_mm(xs, w2), DFT_REPS)
        else:
            lib = ("two torch.matmul and an add" if name == "f32" else
                   "two bf16 torch.matmul (bf16 outputs) and an f32 add")
            lib_ms = cuda_ms(lambda: torch.matmul(xs, w1).float()
                             + torch.matmul(xs, w2).float(), DFT_REPS)
            if name == "bf16":
                # the same with f32 outputs, where this PyTorch takes it; a
                # fault left by an earlier kernel surfaces here, not inside
                torch.cuda.synchronize()
                try:
                    f32_ms = cuda_ms(
                        lambda: torch.mm(xs, w1, out_dtype=torch.float32)
                        + torch.mm(xs, w2, out_dtype=torch.float32),
                        DFT_REPS)
                    say("5 timing", f"{key}: two torch.mm(out_dtype=float32) "
                        f"and an add {f32_ms:.4f} ms ({card})")
                    results[key]["library_f32_out_ms"] = f32_ms
                except (TypeError, NotImplementedError) as exc:
                    say("5 timing", f"{key}: torch.mm(out_dtype=float32) is "
                        f"not taken here ({type(exc).__name__})")
        bnd = dft_bound(name, x.shape[0], DFT_N, DFT_F)
        ops = 4 * x.shape[0] * DFT_N * DFT_F
        lib_msg = "none" if lib_ms is None else f"{lib_ms:.4f} ms ({lib})"
        if name == "f32":  # held to the smaller of its two bounds
            split = dft_bound(name, x.shape[0], DFT_N, DFT_F, split=True)
            say("5 timing", f"{key}: bound on the fp32 CUDA cores "
                f"{bnd['bound_ms']:.4f} ms, as three TF32 products "
                f"{split['bound_ms']:.4f} ms; the kernel runs at "
                f"{100 * split['bound_ms'] / k_ms:.1f}% of the split bound")
            results[key]["bound_ms_fp32_cores"] = bnd["bound_ms"]
            bnd = min(bnd, split, key=lambda d: d["bound_ms"])
        pct = share_of_bound("5 timing", key, k_ms, bnd)
        say("5 timing", f"{key} ({x.shape[0]} x {DFT_N} x {DFT_F} twice): "
            f"kernel {k_ms:.4f} ms ({ops / k_ms / 1e9:.1f} T(FL)OP/s), plain "
            f"{p_ms:.4f} ms, library {lib_msg}, bound {bnd['bound_ms']:.4f} "
            f"ms by {bnd['bound_by']}, "
            f"{pct:.1f}% of it ({card})")
        results[key].update(ms=k_ms, plain_ms=p_ms, **bnd, library_ms=lib_ms,
                            library=lib)
        del x, xs


def phase_gcc_pipelined(card, rng, results):
    """The persistent, self-pipelined GCC kernel: bit-equal to the base mode
    on 1,024 frames (band-crop and full band) and, like it, within 1e-4 of
    scale of the float64 plain version; then timed in turns with the base
    mode at 16,384 frames."""
    import torch
    from audio_triangulation_tpu_torch.core import geometry
    from audio_triangulation_tpu_torch.ops import window as window_ops
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    mics = geometry.square_array(0.3)
    pairs = torch.as_tensor(geometry.mic_pairs(4), device="cuda")
    small = torch.from_numpy(scene_frames(mics, CHECK_FRAMES + 3, rng)).cuda()
    big = torch.from_numpy(scene_frames(
        mics, FRAMES, rng, fixed_source=(*SOURCE_XY, 1.2))).cuda()
    worst = 0.0
    for name, cfg in main_configs()[:2]:
        window = torch.as_tensor(window_ops.window_for(cfg), device="cuda")
        win_gain, mats = gcc_kernel.operands(small, window, cfg)
        kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                  max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
        base = gcc_kernel.launch(small, win_gain, mats, pairs, **kw,
                                 with_peaks=True)
        pipe = gcc_kernel.launch_pipelined(small, win_gain, mats, pairs, **kw)
        ref64 = gcc_kernel.gcc_reference(
            small.double(), win_gain.double(), mats.to(torch.float64), pairs,
            **kw, with_peaks=True)
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(base, pipe)]
        err = (float((pipe[0].double() - ref64[0]).abs().max())
               / float(ref64[0].abs().max()))
        say("2 pipelined", f"{name}: {small.shape[0]} frames: outputs equal "
            f"to the base mode's bit for bit {same}; tapered correlograms "
            f"vs the plain version in float64 {err:.2e} of scale")
        if not (all(same) and err <= 1e-4):
            fail("2 pipelined", f"{name}: kernel disagrees")
        worst = max(worst, err)

        def run_base():
            return gcc_kernel.launch(big, win_gain, mats, pairs, **kw,
                                     with_peaks=True)

        def run_pipe():
            return gcc_kernel.launch_pipelined(big, win_gain, mats, pairs,
                                               **kw)

        p_ms, b_ms = alternate_ms(run_base, run_pipe)
        plain_ms = cuda_ms(lambda: gcc_kernel.gcc_reference(
            big, win_gain, mats, pairs, **kw, with_peaks=True), REPS)
        f, l = mats.sync.shape
        bnd = gcc_bound(*big.shape, f, 6, l, split_products=True)
        pct = share_of_bound("5 timing", "gcc_pipelined_kernel", p_ms, bnd)
        say("5 timing", f"gcc_pipelined_kernel {name}: pipelined {p_ms:.4f} "
            f"ms, base mode {b_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} (the DFT and the "
            f"synthesis as three TF32 products each), {pct:.1f}% of it "
            f"({card})")
        if "ms" not in results["gcc_pipelined_kernel"]:
            results["gcc_pipelined_kernel"].update(
                ms=p_ms, plain_ms=plain_ms, **bnd, library_ms=None)
    results["gcc_pipelined_kernel"]["max_abs_err"] = worst


def phase_tools(results):
    """The two tools, as a user runs them (fewer iterations), with the
    launch counts from 0."""
    from audio_triangulation_tpu_torch.tools import (emit_pipeline_probe,
                                                     int8_microbench)

    counted("tool_int8_microbench", results, lambda: int8_microbench.main(
        ["--iters", str(DFT_TOOL_ITERS)]))
    counted("tool_emit_pipeline_probe", results,
            lambda: emit_pipeline_probe.main(
                ["--iters", str(PIPE_TOOL_ITERS)]))


def phase_scan(card, rng, results):
    """The detector's prefix-sum kernel against its plain version (the
    port's CPU path, evaluated on the CPU): both prefix sums equal bit for
    bit on the streaming window [2,048, 3, 1,535], on the ragged sizes
    and on the shapes of the kernel's unit paths, on values up to 2^15.  Then timed at 1,024 and 4,096 streams against its
    bound (x read once, two arrays written) and beside the library
    yardstick, one ``torch.cumsum`` each of x and x * x, which sums in
    another order and is not bit-equal."""
    import torch
    from audio_triangulation_tpu_torch.ops.cuda import detector_scan

    for shape in ((STREAM_CHECK_STREAMS, 3, SCAN_WINDOW), *SCAN_RAGGED,
                  *SCAN_UNITS):
        x = torch.from_numpy(rng.uniform(
            -2.0 ** 15, 2.0 ** 15, shape).astype(np.float32))
        want = detector_scan.prefix_sums_reference(x)
        got = detector_scan.launch(x.cuda())
        torch.cuda.synchronize()
        same = [bool(torch.equal(g.cpu(), w)) for g, w in zip(got, want)]
        rounded = not bool(torch.equal(
            want[1][..., -1].double(), (x.double() ** 2).sum(dim=-1)))
        say("2 scan", f"{tuple(shape)}: prefix sums of x and of x * x equal "
            f"to the CPU path's bit for bit {same} (the sums round: "
            f"{rounded})")
        if not (all(same) and rounded):
            fail("2 scan", "kernel disagrees with its plain version")
    results["detector_scan_kernel"]["max_abs_err"] = 0.0
    for n_streams in (STREAM_COUNTS[0], STREAM_COUNTS[-1]):
        x = torch.from_numpy(rng.integers(
            0, 256, (n_streams, 3, SCAN_WINDOW)).astype(np.float32)).cuda()
        k1 = cuda_ms(lambda: detector_scan.launch(x), REPS)
        lib_ms = cuda_ms(lambda: (torch.cumsum(x, dim=-1),
                                  torch.cumsum(x * x, dim=-1)), REPS)
        k_ms = (k1 + cuda_ms(lambda: detector_scan.launch(x), REPS)) / 2
        p_ms = cuda_ms(lambda: detector_scan.prefix_sums_reference(x),
                       SCAN_PLAIN_REPS)
        bnd = bound(2 * x.numel(), 3 * 4 * x.numel())
        pct = share_of_bound("5 timing", "detector_scan_kernel", k_ms, bnd)
        say("5 timing", f"detector_scan_kernel ({n_streams} streams x 3 x "
            f"{SCAN_WINDOW}): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"library {lib_ms:.4f} ms (two torch.cumsum, another order), "
            f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']}, "
            f"{pct:.1f}% of it ({card})")
        if n_streams == STREAM_COUNTS[-1]:  # the largest step's shape
            results["detector_scan_kernel"].update(
                ms=k_ms, plain_ms=p_ms, **bnd, library_ms=lib_ms,
                library="two torch.cumsum (another order, not bit-equal)")


def stream_setups():
    """The streaming pipelines, name -> (mics, PipelineConfig,
    StreamConfig): the reference streaming bench's three on its 3-mic
    array, and the free 3-D solve on a tetrahedral array, its lag window
    widened to the array's 0.49 m baselines (the default 46 lags fit the
    reference's 32 cm array; the JAX package's volumetric and DoA models
    widen it the same way)."""
    from audio_triangulation_tpu_torch import (PipelineConfig, StreamConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.tools import bench_streaming

    stream = StreamConfig(chunk_size=STREAM_CHUNK)
    setups = {name: (geometry.reference_array(), cfg, stream)
              for name, cfg in bench_streaming.PIPELINES.items()}
    tetra = geometry.tetrahedral_array(0.3)
    setups["xyz_tetra"] = (tetra, PipelineConfig(
        max_shift_samples=geometry.max_lag_for_array(tetra, PipelineConfig())),
        StreamConfig(chunk_size=STREAM_CHUNK, solve_xyz=True))
    return setups


def stream_localizers(device="cuda"):
    from audio_triangulation_tpu_torch import StreamingLocalizer

    return [(name, StreamingLocalizer.create(mics, cfg, stream=stream,
                                             device=device))
            for name, (mics, cfg, stream) in stream_setups().items()]


def quiet_chunks(rng, n_streams, n_mics=3):
    """[S, M, 512] f32 on the card: the ADC's idle level, +- 1 count (the
    reference bench's input; the step's work does not depend on it)."""
    import torch

    return torch.from_numpy(rng.integers(
        127, 130, (n_streams, n_mics, STREAM_CHUNK)).astype(
            np.float32)).cuda()


def stream_scene(n_streams=STREAM_CHECK_STREAMS, seed=SEED, mics=None):
    """The streaming check's scene, from its own seed: (streams [S, M, T]
    f32 ADC counts, planted stream indices [E], their sources' plane
    points [E, 2], the sources [E, 3]).  Every stream idles at 127-129
    counts; every ``STREAM_PLANT_EVERY``-th holds one chirp burst of a
    source on the 1.2 m sphere (plane radius 0.3-1.0 m, so no pair's delay
    is near zero and the shift gate passes), starting at one of
    ``STREAM_STARTS``.  ``mics`` defaults to the reference array."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    if mics is None:
        mics = geometry.reference_array()
    t_len = STREAM_STEPS * STREAM_CHUNK
    x = rng.integers(127, 130, (n_streams, mics.shape[0], t_len),
                     dtype=np.uint8).astype(np.float32)
    planted = np.arange(0, n_streams, STREAM_PLANT_EVERY)
    ang = rng.uniform(0, 2 * np.pi, planted.size)
    rad = rng.uniform(0.3, 1.0, planted.size)
    xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    v = np.concatenate([xy, np.full((planted.size, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    bursts = synth.synth_scene(src, mics, noise_rms=0.005,
                               seed=int(rng.integers(1 << 30)))
    starts = np.asarray(STREAM_STARTS)[np.arange(planted.size)
                                       % len(STREAM_STARTS)]
    for at in STREAM_STARTS:
        sel = starts == at
        x[planted[sel]] += (110.0 * synth.embed_burst_in_stream(
            bursts[sel], t_len, at)).astype(np.float32)
    x[planted] = np.clip(np.round(x[planted]), 0, 255)
    return x, planted, xy.astype(np.float32), src.astype(np.float32)


def expected_trigger_steps(x, cfg):
    """The chunk in which each stream of x [E, M, T] first triggers, by a
    plain float64 numpy evaluation of the detector (mic-summed outgoing
    power > threshold + mic-summed incoming power, from the first full
    frame on): [E] step indices, -1 where it never does."""
    n, half = cfg.frame_size, cfg.frame_size // 2
    xd = x.astype(np.float64)

    def windowed(a):
        c = np.cumsum(a, axis=-1)
        c[..., half:] -= c[..., :-half].copy()
        return c

    s1, s2 = windowed(xd), windowed(xd * xd)
    inc = (half * s2 - s1 * s1).sum(axis=-2)
    out = np.pad(inc, [(0, 0), (half, 0)])[:, :inc.shape[-1]]
    if cfg.trigger_mode != "absolute":
        raise ValueError("the check plants events for the absolute trigger")
    fire = out > cfg.detect_threshold + inc
    fire[:, :n - 1] = False
    first = fire.argmax(axis=-1)
    return np.where(fire.any(axis=-1), first // STREAM_CHUNK, -1)


def predicted_tdoas_np(xyz, mics):
    """float64 TDOAs [..., P] (seconds, 343 m/s) of positions [..., 3] at
    mics [M, 3]."""
    from audio_triangulation_tpu_torch import geometry

    pairs = geometry.mic_pairs(mics.shape[0])
    d = np.linalg.norm(np.asarray(xyz, np.float64)[..., None, :] - mics,
                       axis=-1)
    return (d[..., pairs[:, 1]] - d[..., pairs[:, 0]]) / 343.0


def phase_stream(card, results):
    """The streaming path in the three bench pipelines and ``xyz_tetra``
    (the free 3-D solve on a tetrahedral array): 2,048 streams x 24 chunks
    with planted events, checked (a) against the planted events: a
    planted stream triggers in the chunk a float64 numpy detector says and
    in no other, no other stream triggers, and at least 98% of the planted
    events pass the shift gate; (b) the median |xy - truth| of the accepted
    events under the pipeline's bound, and for ``xyz_tetra`` the median
    |xyz - source| too; (c) against the port's CPU path on the first 32
    streams, every step: trigger positions, ``events`` and ``best_shift``
    equal, ``xy`` within 2e-4 m, ``ema_corr`` within 1e-5 of scale, and
    ``xyz`` in measurement space: its predicted TDOAs within 3e-7 s and
    ``xyz_rms_m`` within 5e-5 m (a 30 cm array's range is ill-conditioned
    in float32: tests/test_torch_solver_xyz.py), its distance printed; (d)
    the same 24 chunks through the step replayed as a CUDA graph
    (``graph_step_many``): trigger positions, ``events``, ``best_shift``,
    ``xy`` (and ``xyz``) equal to the eager step's bit for bit.  The eager
    run's launches of the detector's prefix-sum kernel are counted from 0
    (one a step; the CPU path beside it launches none).  Then ``step_many``
    is timed at 1,024 / 2,048 / 4,096 streams, eager and graphed in
    turns."""
    import torch
    from audio_triangulation_tpu_torch.tools import bench_streaming

    n_cpu = STREAM_CPU_STREAMS
    cpu_locs = dict(stream_localizers("cpu"))
    rng = np.random.default_rng(SEED + 1)
    scenes = {}
    for name, sl in stream_localizers():
        mics_np = sl.params.mic_positions.cpu().numpy()
        key = mics_np.tobytes()
        if key not in scenes:
            scenes = {key: stream_scene(mics=mics_np)}  # one held at a time
        x_np, planted, truth, src = scenes[key]
        s_n, m_n = x_np.shape[:2]
        x = torch.from_numpy(x_np).cuda()
        mic3 = np.zeros((m_n, 3))
        mic3[:, :mics_np.shape[1]] = mics_np
        xyz_on = sl.stream.solve_xyz
        keys = GRAPH_EQUAL_KEYS + (("xyz",) if xyz_on else ())
        want = np.full(s_n, -1)
        want[planted] = expected_trigger_steps(x_np[planted], sl.pipeline)
        if (want[planted] < 0).any():
            fail("6 stream", f"{name}: a planted event never triggers in the "
                 "float64 detector")
        cpu_sl = cpu_locs[name]
        trig, acc, xys, xyzs, eager = [], [], [], [], []
        worst = dict(xy=0.0, ema=0.0, exact=True, xyz_tdoa=0.0, xyz_m=0.0,
                     xyz_rms=0.0)

        def run_eager():
            st, cst = sl.init_states(s_n), cpu_sl.init_states(n_cpu)
            for i in range(STREAM_STEPS):
                sl_ = slice(i * STREAM_CHUNK, (i + 1) * STREAM_CHUNK)
                st, out = sl.step_many(st, x[:, :, sl_])
                cst, cout = cpu_sl.step_many(
                    cst, torch.from_numpy(x_np[:n_cpu, :, sl_]))
                trig.append(out["triggered"])
                acc.append(out["event"])
                xys.append(out["xy"])
                eager.append([out[k] for k in keys])
                for k in ("event_trigger_abs", "events", "best_shift"):
                    worst["exact"] &= bool(
                        torch.equal(out[k][:n_cpu].cpu(), cout[k]))
                worst["xy"] = max(worst["xy"], float(
                    (out["xy"][:n_cpu].cpu() - cout["xy"]).abs().max()))
                scale = max(float(cst.ema_corr.abs().max()), 1e-30)
                worst["ema"] = max(worst["ema"], float(
                    (st.ema_corr[:n_cpu].cpu() - cst.ema_corr).abs().max())
                    / scale)
                if xyz_on:
                    xyzs.append(out["xyz"])
                    g = out["xyz"][:n_cpu].cpu().numpy()
                    c = cout["xyz"].numpy()
                    worst["xyz_tdoa"] = max(worst["xyz_tdoa"], float(np.abs(
                        predicted_tdoas_np(g, mic3)
                        - predicted_tdoas_np(c, mic3)).max()))
                    worst["xyz_m"] = max(worst["xyz_m"], float(
                        np.abs(g - c).max()))
                    worst["xyz_rms"] = max(worst["xyz_rms"], float(
                        (out["xyz_rms_m"][:n_cpu].cpu()
                         - cout["xyz_rms_m"]).abs().max()))
            return st

        st = counted(f"stream_{name}", results, run_eager)
        exact = worst["exact"]
        torch.cuda.synchronize()
        trig, acc = torch.stack(trig).cpu().numpy(), torch.stack(acc).cpu()
        xys = torch.stack(xys).cpu()
        if not (bool(torch.isfinite(xys).all()) and xys.shape
                == (STREAM_STEPS, s_n, 2)):
            fail("6 stream", f"{name}: non-finite or misshapen output")
        want_mask = np.arange(STREAM_STEPS)[:, None] == want[None, :]
        wrong = int((trig != want_mask).sum())
        steps_t = torch.from_numpy(want[planted])
        planted_t = torch.from_numpy(planted)
        took = acc[steps_t, planted_t].numpy()
        err = (xys[steps_t, planted_t]
               - torch.from_numpy(truth)).norm(dim=-1).numpy()
        med = float(np.median(err[took]))
        say("6 stream", f"{name}: {s_n} streams x {STREAM_STEPS} chunks of "
            f"{STREAM_CHUNK}: {planted.size} planted events, trigger flags "
            f"that differ from the planted steps {wrong} of {trig.size}, "
            f"accepted {int(took.sum())}; median |xy - truth| of the "
            f"accepted {med * 100:.4f} cm; vs CPU path on {n_cpu} streams: "
            f"trigger positions, events, best shifts equal {exact}, xy "
            f"{worst['xy']:.2e} m, ema_corr {worst['ema']:.2e} of scale")
        xyz_ok = True
        if xyz_on:
            xyzs = torch.stack(xyzs).cpu()
            xyz_err = (xyzs[steps_t, planted_t]
                       - torch.from_numpy(src)).norm(dim=-1).numpy()
            xyz_med = float(np.median(xyz_err[took]))
            say("6 stream", f"{name}: median |xyz - source| of the accepted "
                f"{xyz_med * 100:.4f} cm (largest "
                f"{xyz_err[took].max() * 100:.4f}); vs CPU path: xyz's "
                f"predicted TDOAs {worst['xyz_tdoa']:.2e} s, xyz_rms_m "
                f"{worst['xyz_rms']:.2e} m, xyz itself {worst['xyz_m']:.2e} "
                "m apart")
            xyz_ok = (bool(torch.isfinite(xyzs).all())
                      and xyz_med < STREAM_XYZ_MEDIAN_BOUND_M
                      and worst["xyz_tdoa"] <= 3e-7
                      and worst["xyz_rms"] <= 5e-5)
        if not (wrong == 0 and took.sum() >= 0.98 * planted.size
                and int(acc.sum()) == int(took.sum())
                and med < STREAM_MEDIAN_BOUND_M[name] and exact
                and worst["xy"] <= 2e-4 and worst["ema"] <= 1e-5 and xyz_ok):
            fail("6 stream", f"{name}: result check failed")
        graphed = sl.graph_step_many(sl.init_states(s_n),
                                     x[:, :, :STREAM_CHUNK])
        same = True
        for i in range(STREAM_STEPS):
            out = graphed(x[:, :, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK])
            same &= all(bool(torch.equal(out[k], e))
                        for k, e in zip(keys, eager[i]))
        same &= bool(torch.equal(graphed.states.ema_corr, st.ema_corr))
        say("6 stream", f"{name}: the step replayed as a CUDA graph over the "
            f"same chunks: {', '.join(keys)} and the final ema_corr equal to "
            f"the eager step's bit for bit: {same}")
        if not same:
            fail("6 stream", f"{name}: the graphed step disagrees with the "
                 "eager step")
        del st, graphed, eager, x
        chunk_ms = STREAM_CHUNK / sl.pipeline.sample_rate_hz * 1e3
        for n_streams in STREAM_COUNTS:
            chunks = quiet_chunks(rng, n_streams, m_n)
            for how, timer in (
                    ("eager", lambda: bench_streaming.time_steps(
                        sl.step_many, sl.init_states(n_streams), chunks,
                        STREAM_TRIALS, STREAM_TIMED_STEPS, "cuda")),
                    ("graphed", lambda: bench_streaming.time_graphed_steps(
                        sl, n_streams, chunks, STREAM_TRIALS,
                        STREAM_TIMED_STEPS))):
                med_s, q1, q3 = timer()
                say("5 timing", f"stream {name} {n_streams} streams, {how}: "
                    f"step_ms {med_s * 1e3:.4f} median, IQR {q1 * 1e3:.4f}-"
                    f"{q3 * 1e3:.4f} over {STREAM_TRIALS} trials of "
                    f"{STREAM_TIMED_STEPS} steps; streams sustained in real "
                    f"time {chunk_ms / (med_s * 1e3) * n_streams:.1f} "
                    f"({card})")


def run_steps(sl, n_streams, source):
    """``STREAM_STEPS`` chained ``step_many`` calls of ``n_streams`` fresh
    streams on chunks ``source(i)``: (final state, every step's outputs)."""
    st, outs = sl.init_states(n_streams), []
    for i in range(STREAM_STEPS):
        st, out = sl.step_many(st, source(i))
        outs.append(out)
    return st, outs


def tracked_scene(n_streams=STREAM_CHECK_STREAMS, seed=TRACK_SEED):
    """The tracked check's scene on the reference array: (streams [S, 3, T]
    f32 ADC counts, planted stream indices [E], their sources' plane points
    [E, 2]).  Every stream idles at 127-129 counts; every
    ``STREAM_PLANT_EVERY``-th holds ``TRACK_BURSTS`` chirp bursts of one
    source on the 1.2 m sphere (plane radius 0.3-1.0 m), each with its own
    noise, ``TRACK_BURST_GAP`` samples apart, so that the default
    ``confirm_hits=2`` confirms a track well inside ``max_coast_s``."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    mics = geometry.reference_array()
    t_len = STREAM_STEPS * STREAM_CHUNK
    x = rng.integers(127, 130, (n_streams, mics.shape[0], t_len),
                     dtype=np.uint8).astype(np.float32)
    planted = np.arange(0, n_streams, STREAM_PLANT_EVERY)
    ang = rng.uniform(0, 2 * np.pi, planted.size)
    rad = rng.uniform(0.3, 1.0, planted.size)
    xy = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    v = np.concatenate([xy, np.full((planted.size, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    first = np.asarray(TRACK_STARTS)[np.arange(planted.size)
                                     % len(TRACK_STARTS)]
    for b in range(TRACK_BURSTS):
        bursts = synth.synth_scene(src, mics, noise_rms=0.005,
                                   seed=int(rng.integers(1 << 30)))
        for at in TRACK_STARTS:
            sel = first == at
            x[planted[sel]] += (110.0 * synth.embed_burst_in_stream(
                bursts[sel], t_len, at + b * TRACK_BURST_GAP)).astype(
                    np.float32)
    x[planted] = np.clip(np.round(x[planted]), 0, 255)
    return x, planted, xy.astype(np.float32)


def tracked_banks(device="cuda"):
    """The tracked pipelines, name -> TrackedStreamingLocalizer on the
    reference array at 512-sample chunks: the default bank (nearest
    association), the IMM bank and soft association."""
    from audio_triangulation_tpu_torch import (StreamConfig,
                                               TrackedStreamingLocalizer,
                                               TrackerConfig, geometry)

    return {name: TrackedStreamingLocalizer.create(
        geometry.reference_array(), stream=StreamConfig(
            chunk_size=STREAM_CHUNK), tracker_cfg=cfg, device=device)
        for name, cfg in (("nearest", None),
                          ("imm", TrackerConfig(imm_q=TRACK_IMM_Q)),
                          ("soft", TrackerConfig(association="soft")))}


def confirmed_tracks(out):
    """From one step's outputs: (confirmed tracks a stream [S], the first
    confirmed track's position [S, 2])."""
    import torch

    conf = out["track_confirmed"]
    slot = torch.argmax(conf.to(torch.uint8), dim=-1)
    return conf.sum(dim=-1), out["track_xy"].gather(
        1, slot[:, None, None].expand(-1, 1, 2))[:, 0]


def phase_tracked(card, results):
    """Tracked streaming (``TrackedStreamingLocalizer``: the stream step and
    the Kalman tracker bank in one step) on the tracked scene, 2,048
    streams x 24 chunks, checked: (a) every localization key equal bit for
    bit to the untracked ``StreamingLocalizer``'s on the same chunks, the
    reference's equality contract; (b) each planted stream ends with exactly
    one confirmed track whose hits equal its accepted events, and a silent
    stream holds no track and reports ``assigned == -1`` at every step; (c)
    the median |track_xy - truth| of the planted streams under
    ``TRACK_MEDIAN_BOUND_M``; (d) against the port's CPU path on the first
    32 streams at every step: integer and bool outputs equal, ``track_xy``
    within 2e-4 m, ``track_vel`` within 2e-3 m/s (``model_prob`` within
    1e-4), for the default bank, the IMM bank and soft association; (e) the
    step replayed as a CUDA graph, one chunk a replay and ``TRACK_SCAN_K``,
    bit-equal to the eager steps.  The eager run's launches of the
    detector's prefix-sum kernel are counted from 0.  Then the tracked step
    is timed at 1,024 / 2,048 / 4,096 streams, eager and graphed, and the
    K-step graph at 1,024 / 2,048 (per chunk step)."""
    import torch
    from audio_triangulation_tpu_torch.models.streaming import state_leaves
    from audio_triangulation_tpu_torch.tools import bench_streaming

    x_np, planted, truth = tracked_scene()
    s_n, n_cpu = x_np.shape[0], STREAM_CPU_STREAMS
    x = torch.from_numpy(x_np).cuda()
    banks, cpu_banks = tracked_banks(), tracked_banks("cpu")
    tsl = banks["nearest"]

    def chunk(i):
        return x[:, :, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]

    st, outs = counted("stream_tracked", results,
                       lambda: run_steps(tsl, s_n, chunk))
    torch.cuda.synchronize()
    # (a) the equality contract: the untracked localizer inside
    _, plain = run_steps(tsl.sl, s_n, chunk)
    contract = all(torch.equal(o[k], p[k]) for o, p in zip(outs, plain)
                   for k in p)
    del plain
    # (b) confirmed tracks, hits and silent streams
    events = torch.stack([o["event"] for o in outs]).sum(dim=0)
    n_conf, track_xy = confirmed_tracks(outs[-1])
    active = st.track.active
    hits = (st.track.hits * active).sum(dim=-1)
    silent = torch.ones(s_n, dtype=torch.bool, device="cuda")
    silent[torch.from_numpy(planted).cuda()] = False
    quiet_ok = all(bool((o["assigned"][silent] == -1).all()) for o in outs)
    planted_t = torch.from_numpy(planted).cuda()
    tracks_ok = (bool((n_conf[planted_t] == 1).all())
                 and bool((active[planted_t].sum(dim=-1) == 1).all())
                 and bool(torch.equal(hits, events))
                 and not bool(active[silent].any()) and quiet_ok)
    accepted = int(events[planted_t].sum())
    # (c) position of the tracks
    err = (track_xy[planted_t].cpu() - torch.from_numpy(truth)).norm(dim=-1)
    med = float(err.median())
    say("6 tracked", f"nearest: {s_n} streams x {STREAM_STEPS} chunks of "
        f"{STREAM_CHUNK}: {planted.size} planted streams, accepted "
        f"{accepted} of {planted.size * TRACK_BURSTS} bursts; localization "
        f"keys equal to the untracked step's bit for bit: {contract}; one "
        f"confirmed track a planted stream, hits = accepted events, silent "
        f"streams trackless and unassigned: {tracks_ok}; median |track_xy - "
        f"truth| {med * 100:.4f} cm (largest {float(err.max()) * 100:.4f})")
    if not (contract and tracks_ok and med < TRACK_MEDIAN_BOUND_M
            and accepted >= 0.98 * planted.size * TRACK_BURSTS
            and bool(torch.isfinite(track_xy).all())):
        fail("6 tracked", "nearest: result check failed")

    # (d) against the CPU path, the three banks
    def cpu_chunk(i):
        return torch.from_numpy(
            x_np[:n_cpu, :, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK])

    tol = {"track_xy": 2e-4, "track_vel": 2e-3, "model_prob": 1e-4}
    for name, bank in banks.items():
        g_outs = outs if name == "nearest" else run_steps(bank, s_n,
                                                          chunk)[1]
        _, c_outs = run_steps(cpu_banks[name], n_cpu, cpu_chunk)
        exact, worst = True, dict.fromkeys(tol, 0.0)
        for g, c in zip(g_outs, c_outs):
            for k in c:
                got = g[k][:n_cpu].cpu()
                if k in tol:
                    worst[k] = max(worst[k], float((got - c[k]).abs().max()))
                elif not got.is_floating_point():
                    exact &= bool(torch.equal(got, c[k]))
        say("6 tracked", f"{name}: vs CPU path on {n_cpu} streams, every "
            f"chunk: integer and bool outputs equal {exact}, " + ", ".join(
                f"{k} {v:.2e}" for k, v in worst.items() if k in c_outs[0]))
        if not (exact and all(v <= tol[k] for k, v in worst.items())):
            fail("6 tracked", f"{name}: disagrees with the CPU path")
        del g_outs, c_outs

    # (e) the graphed forms
    one = tsl.graph_step_many(tsl.init_states(s_n), chunk(0))
    same = True
    for i in range(STREAM_STEPS):
        gout = one(chunk(i))
        same &= all(bool(torch.equal(gout[k], outs[i][k])) for k in gout)
    k_n = TRACK_SCAN_K
    kstep = tsl.graph_step_many_scan(
        tsl.init_states(s_n), torch.stack([chunk(i) for i in range(k_n)], 1))
    for j in range(0, STREAM_STEPS, k_n):
        gout = kstep(torch.stack([chunk(i) for i in range(j, j + k_n)], 1))
        same &= all(bool(torch.equal(gout[k][i], outs[j + i][k]))
                    for k in gout for i in range(k_n))
    for g in (one, kstep):
        same &= all(bool(torch.equal(a, b)) for a, b in zip(
            state_leaves(g.states), state_leaves(st)))
    say("6 tracked", f"nearest: the step replayed as a CUDA graph, one chunk "
        f"a replay and {k_n}, over the same chunks: every output and the "
        f"final state equal to the eager steps' bit for bit: {same}")
    if not same:
        fail("6 tracked", "a graphed form disagrees with the eager step")
    del one, kstep, outs, st, x

    chunk_ms = STREAM_CHUNK / tsl.sl.pipeline.sample_rate_hz * 1e3
    rng = np.random.default_rng(TRACK_SEED + 1)

    def line(what, n_streams, med_s, q1, q3, k=1):
        med_s, q1, q3 = med_s / k, q1 / k, q3 / k
        say("5 timing", f"stream tracked {what} {n_streams} streams: "
            f"step_ms {med_s * 1e3:.4f} median (per chunk step), IQR "
            f"{q1 * 1e3:.4f}-{q3 * 1e3:.4f} over {STREAM_TRIALS} trials of "
            f"{STREAM_TIMED_STEPS} calls; streams sustained in real time "
            f"{chunk_ms / (med_s * 1e3) * n_streams:.1f} ({card})")

    for n_streams in STREAM_COUNTS:
        chunks = quiet_chunks(rng, n_streams)
        line("eager", n_streams, *bench_streaming.time_steps(
            tsl.step_many, tsl.init_states(n_streams), chunks,
            STREAM_TRIALS, STREAM_TIMED_STEPS, "cuda"))
        line("graphed", n_streams, *bench_streaming.time_graphed_steps(
            tsl, n_streams, chunks, STREAM_TRIALS, STREAM_TIMED_STEPS))
        if n_streams in TRACK_SCAN_COUNTS:
            chunks = torch.stack([quiet_chunks(rng, n_streams)
                                  for _ in range(TRACK_SCAN_K)], dim=1)
            line(f"graphed K={TRACK_SCAN_K}", n_streams,
                 *bench_streaming.time_graphed_steps(
                     tsl, n_streams, chunks, STREAM_TRIALS,
                     STREAM_TIMED_STEPS), k=TRACK_SCAN_K)


# ---- simultaneous and moving sources -------------------------------------
MULTI_FRAMES = 16384  # localize_multi: frames of 8 x 1,024 a call
MULTI_CPU_FRAMES = 1024  # of them held to the port's CPU path
# the two simultaneous sources' plane points (on the 1.2 m sphere): the JAX
# package's tests/test_multisource.py scene, with fresh noise every frame
MULTI_XY = ((0.5, 0.4), (-0.6, -0.3))
MULTI_NOISE = 0.005
MULTI64_FRAMES = 16  # the 64-mic localize_multi: frames of 64 x 4,096
MULTI64_CPU_FRAMES = 2
MOVING_FRAMES = 2048  # localize_moving: frames of 6 x 1,024 a call
MOVING_CPU_FRAMES = 4
MOVING_SCALES = 33
MOVING_SOURCE = (0.3, 0.2, 1.2)  # examples/advanced.py's moving source
MOVING_V = (2.5, -1.5, 0.0)
# the JAX package's own bound on |velocity - truth| at 33 scales (its
# tests/test_caf.py), held on the median
MOVING_VEL_BOUND = 1.2
# the card against the port's CPU path: velocity and pair_rel_speed (m/s),
# alpha and tdoa_doppler (lags), the tests' tolerances against the JAX
# package (tests/test_torch_caf.py); the largest gaps read on the H100 are
# 3.58e-05 m/s, 5.96e-08 and 7.63e-06 lags
VEL_TOL = {"velocity": 1e-3, "pair_rel_speed": 1e-3, "alpha": 1e-6,
           "tdoa_doppler": 1e-3}
SOURCE_STREAMS = 1024  # streams of the n_sources / solve_velocity checks
SOURCE_CPU_STREAMS = 16  # of them held to the port's CPU path
SOURCE_BURST_GAIN = 0.6 * 110.0  # two sources add up: keep inside 8 bits
MULTI_STREAM_COUNTS = (1024, 4096)  # streams a timed n_sources=2 step
VELOCITY_STREAM_COUNTS = (256, 1024)  # streams a timed solve_velocity step
CAF_REPS = 5


def place(xy, h=1.2):
    """A plane point's projection on the radius-h sphere, [3]."""
    p = np.array([xy[0], xy[1], h], np.float64)
    return p * (h / np.linalg.norm(p))


def two_source_frame(mics, n=1024):
    """[M, n] f32: two simultaneous, spectrally distinct chirps from
    ``MULTI_XY`` (the JAX package's multi-source test scene), no noise."""
    from audio_triangulation_tpu_torch.utils import synth

    f1 = synth.synth_scene(place(MULTI_XY[0]), mics, n=n)
    sig2 = synth.chirp_burst(n, 50_000.0, f0=2000, f1=9000, center=0.45)
    f2 = synth.synth_scene(place(MULTI_XY[1]), mics, n=n, signal=sig2)
    return (f1 + f2)[0].astype(np.float32)


def moving_frame(mics, at=MOVING_SOURCE):
    """[M, 1,024] f32 of the source at ``at`` moving at ``MOVING_V`` (the
    per-mic delay and Doppler scale of ``synth_moving_scene``), no noise."""
    from audio_triangulation_tpu_torch.utils import synth

    return synth.synth_moving_scene(np.asarray(at), np.asarray(MOVING_V),
                                    mics)[0].astype(np.float32)


def noisy(frame, n_frames, seed):
    """[n_frames, M, N] on the card: ``frame`` plus fresh white noise of
    rms ``MULTI_NOISE`` in every frame, drawn from ``seed``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.from_numpy(frame).cuda() + MULTI_NOISE * torch.randn(
        (n_frames, *frame.shape), device="cuda", generator=g)


def same(a, b) -> bool:
    """Bit-equal tensors (NaN where the other has NaN counts as equal)."""
    import torch

    if a.is_floating_point():
        return a.shape == b.shape and bool(torch.equal(
            torch.isnan(a), torch.isnan(b))) and bool(torch.equal(
                torch.nan_to_num(a), torch.nan_to_num(b)))
    return bool(torch.equal(a, b))


def top_k_margin(scores, cells, k, radius):
    """Per row of scores [B, G], the smallest gap over ``srp.top_k_peaks``'s
    k rounds between the best live cell and the next: the rows whose
    candidates no rounding of the scores can move are those where it is
    clear of zero."""
    import torch

    s, gaps = scores.clone(), []
    for _ in range(k):
        top2 = s.topk(2, dim=-1)
        gaps.append(top2.values[:, 0] - top2.values[:, 1])
        xy = cells[top2.indices[:, 0]]
        s = torch.where(((cells - xy[:, None]) ** 2).sum(-1) <= radius ** 2,
                        torch.full_like(s, -3e38), s)
    return torch.stack(gaps, -1).amin(-1)


def found_sources(xy, tol=0.1):
    """xy [B, S, 2] -> (share of rows with every ``MULTI_XY`` source within
    ``tol`` of a slot, median distance per source [2])."""
    import torch

    truth = torch.tensor(MULTI_XY, device=xy.device, dtype=xy.dtype)
    d = (xy[:, :, None, :] - truth).norm(dim=-1).amin(dim=1)  # [B, 2]
    return (float((d < tol).all(dim=-1).float().mean()),
            d.median(dim=0).values.tolist())


def check_multi(out, ref, n_sources, radius):
    """A localize_multi result against the port's CPU path on its first
    rows: the grid candidates equal on the rows whose top-K decisions are
    clear of a near tie (1e-3 of the score scale), xy within 2e-4 m on
    those rows, source_score within 1e-3 of scale on every row.  Returns
    the line's text and whether it passed."""
    import torch
    from audio_triangulation_tpu_torch.models.localizer import cell_xy

    n = ref["xy"].shape[0]
    scale = float(ref["scores"].abs().max())
    cells = torch.from_numpy(cell_xy(ref["grid"]))
    clear = top_k_margin(ref["scores"], cells, n_sources,
                         radius) > 1e-3 * scale
    grid_eq = (out["xy_grid"][:n].cpu() == ref["xy_grid"]).all(-1).all(-1)
    dxy = float((out["xy"][:n].cpu() - ref["xy"]).abs().amax(
        dim=(-1, -2))[clear].max()) if bool(clear.any()) else 0.0
    dscore = float((out["source_score"][:n].cpu()
                    - ref["source_score"]).abs().max()) / scale
    ok = (bool(grid_eq[clear].all()) and dxy <= 2e-4 and dscore <= 1e-3
          and bool(clear.any()))
    return (f"vs CPU path on {n} frames: grid candidates equal on the "
            f"{int(clear.sum())} rows clear of a near tie "
            f"{bool(grid_eq[clear].all())} (equal on "
            f"{int(grid_eq.sum())} of all {n}), xy {dxy:.2e} m there, "
            f"source_score {dscore:.2e} of scale"), ok


def phase_multi(card, results):
    """``Localizer.localize_multi(n_sources=2)`` on the 8-mic circular array
    (15 cm) at 16,384 frames of the two-source scene: the GCC kernel without
    peaks (row 2) once a call, then top-K, the windowed TDOA re-measurement
    and the batched solve.  Checked: both sources found within 10 cm in at
    least 99% of frames (the JAX package's test bound), and against the
    port's CPU path on 1,024 frames (``check_multi``).  Then a 64-mic
    array (2,016 pairs, 4,096 samples) at 16 frames takes the large-array
    kernel without peaks (row 6), held the same way on 2 frames.  Both
    timed."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    mics = geometry.circular_array(8, 0.15)
    cfg = PipelineConfig(phat=True)
    frames = noisy(two_source_frame(mics), MULTI_FRAMES, SEED + 20)
    loc = Localizer.create(mics, cfg, device="cuda")
    cpu_loc = Localizer.create(mics, cfg, device="cpu")
    out = counted("multi_8mic", results, lambda: loc.localize_multi(frames))
    n_launch = launch_counts()["gcc_kernel"]
    share, med = found_sources(out["xy"])
    ref = cpu_loc.localize_multi(frames[:MULTI_CPU_FRAMES].cpu())
    ref["grid"] = loc.grid
    text, cpu_ok = check_multi(out, ref, 2, 0.4)
    say("7 multi", f"multi_8mic: {MULTI_FRAMES} frames of 8 x 1,024: GCC "
        f"kernel launches (row 2, no peaks) {n_launch} in the call; both "
        f"sources within 10 cm in {share * 100:.3f}% of frames, median "
        f"|xy - truth| {med[0] * 100:.4f} / {med[1] * 100:.4f} cm; {text}")
    if not (n_launch == 1 and share >= 0.99 and cpu_ok
            and out["xy"].shape == (MULTI_FRAMES, 2, 2)
            and bool(torch.isfinite(out["xy"]).all())):
        fail("7 multi", "multi_8mic: result check failed")
    del out, ref
    time_path(card, "multi_8mic localize_multi(n_sources=2)",
              lambda: loc.localize_multi(frames), MULTI_FRAMES)
    # row 2 at this path's shapes, against its plain version in float64
    # (phase 2's tolerance) and its bound
    ops = (*gcc_kernel.operands(frames, loc.window, cfg), loc.pairs)
    f, l = ops[1][2].shape
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, with_peaks=False)
    head = frames[:CHECK_FRAMES]
    raw = gcc_kernel.launch(head, *ops, **kw)
    raw64 = gcc_kernel.gcc_reference(
        *(o.to(torch.float64) for o in (head, *ops[:2])), ops[2], **kw)
    raw_err = float((raw.double() - raw64).abs().max()) / float(
        raw64.abs().max())
    say("7 multi", f"gcc_kernel multi_8mic without peaks: {CHECK_FRAMES} "
        f"frames vs the plain version in float64: corr/scale err "
        f"{raw_err:.2e} (tolerance 1e-4)")
    if not raw_err <= 1e-4:
        fail("7 multi", "multi_8mic: row 2 disagrees with its plain version")
    results["gcc_kernel"]["max_abs_err"] = max(
        results["gcc_kernel"]["max_abs_err"], raw_err)
    del raw, raw64
    k_ms, p_ms = alternate_ms(
        lambda: gcc_kernel.gcc_reference(frames, *ops, **kw),
        lambda: gcc_kernel.launch(frames, *ops, **kw))
    p_n = loc.pairs.shape[0]
    bnd = gcc_bound(MULTI_FRAMES, mics.shape[0], frames.shape[-1], f, p_n, l,
                    with_peaks=False, split_products=True)
    pct = share_of_bound("5 timing", "gcc_kernel multi_8mic", k_ms, bnd)
    say("5 timing", f"gcc_kernel multi_8mic without peaks (row 2: "
        f"{MULTI_FRAMES} frames of 8 x 1,024, {p_n} pairs, {f} bins, {l} "
        f"lags): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
        f"{bnd['bound_ms']:.4f} ms by {bnd['bound_by']} (the DFT and the "
        f"synthesis as three TF32 products each), {pct:.1f}% of it ({card})")
    results["gcc_kernel"]["multi_8mic_no_peaks"] = dict(
        ms=k_ms, plain_ms=p_ms, max_abs_err=raw_err, **bnd)
    del frames

    mics64, grid64, configs64 = large_configs()
    cfg64 = configs64[0][1]
    frames = noisy(two_source_frame(mics64, n=LARGE_SAMPLES),
                   MULTI64_FRAMES, SEED + 21)
    loc64 = Localizer.create(mics64, cfg64, grid64, device="cuda")
    out = counted("multi_64mic", results,
                  lambda: loc64.localize_multi(frames))
    n_launch = launch_counts()["gcc_large_kernel"]
    share, med = found_sources(out["xy"])
    cpu64 = Localizer.create(mics64, cfg64, grid64, device="cpu")
    ref = cpu64.localize_multi(frames[:MULTI64_CPU_FRAMES].cpu())
    ref["grid"] = grid64
    text, cpu_ok = check_multi(out, ref, 2, 0.4)
    say("7 multi", f"multi_64mic: {MULTI64_FRAMES} frames of 64 x "
        f"{LARGE_SAMPLES} (2,016 pairs): large-array kernel launches (row "
        f"6, no peaks) {n_launch} in the call; both sources within 10 cm in "
        f"{share * 100:.3f}% of frames, median {med[0] * 100:.4f} / "
        f"{med[1] * 100:.4f} cm; {text}")
    if not (n_launch >= 1 and share >= 0.99 and cpu_ok
            and bool(torch.isfinite(out["xy"]).all())):
        fail("7 multi", "multi_64mic: result check failed")
    time_path(card, "multi_64mic localize_multi(n_sources=2)",
              lambda: loc64.localize_multi(frames), MULTI64_FRAMES)


def caf_bound(b, m, n, f, p, l, s, spectral) -> dict:
    """Bound of one ``caf.estimate_delay_doppler`` call on [b, m, n] frames
    at s scales, f bins, p pairs, l lags, on the fp32 CUDA cores: the
    unscaled spectra (re and im), the scaled ones (one product against the
    spectral fold, or the resampling product and then the DFT), the
    whitened cross-power and the lag synthesis of every (scale, pair); the
    frames and the operator read once, the CAF written once."""
    flops = 4 * b * m * n * f  # unscaled spectra
    if spectral:
        flops += 4 * s * b * m * n * f
        op_bytes = 4 * 2 * s * n * f
    else:
        flops += 2 * s * b * m * n * n + 4 * s * b * m * n * f
        op_bytes = 4 * s * n * n
    flops += s * b * (6 * p * f + 4 * p * f * l)
    nbytes = 4 * (b * m * n + b * p * s * l) + op_bytes
    return bound(flops, nbytes)


def time_caf(card, name, window, frames, pairs, cfg, resample, n_scales):
    """The CAF stage alone (``caf.estimate_delay_doppler``) on ``frames``,
    timed with CUDA events beside its fp32 bound."""
    from audio_triangulation_tpu_torch.ops import caf, mxu_fft

    b, m, n = frames.shape
    crop = mxu_fft.crop_bins(cfg)
    f = (crop[1] - crop[0]) if crop else cfg.fft_length // 2 + 1
    ms = cuda_ms(lambda: caf.estimate_delay_doppler(
        frames, window, pairs, cfg, v_max=8.0, n_scales=n_scales,
        resample=resample), CAF_REPS)
    bnd = caf_bound(b, m, n, f, pairs.shape[0], cfg.num_lags, n_scales,
                    isinstance(resample, tuple))
    say("5 timing", f"{name}: CAF stage (caf.estimate_delay_doppler, "
        f"{n_scales} scales, {b} frames of {m} x {n}, "
        f"{'spectral fold' if isinstance(resample, tuple) else 'time-domain resampling'}"
        f") {ms:.4f} ms, bound {bnd['bound_ms']:.4f} ms by "
        f"{bnd['bound_by']} at the fp32 CUDA-core rate "
        f"({100 * bnd['bound_ms'] / ms:.1f}% of it) ({card})")
    return ms, bnd


def moving_setup():
    """(mics, PipelineConfig) of the moving source: ``circular_array(6,
    0.35)`` with the 700-9,500 Hz band crop of ``examples/advanced.py``."""
    from audio_triangulation_tpu_torch import PipelineConfig, geometry

    mics = geometry.circular_array(6, 0.35)
    return mics, PipelineConfig(
        phat=True, window_enabled=False, band_hz=(700.0, 9500.0),
        band_crop=True,
        max_shift_samples=geometry.max_lag_for_array(mics, PipelineConfig()))


def phase_moving(card, results):
    """``Localizer.localize_moving`` on ``circular_array(6, 0.35)`` with the
    700-9,500 Hz band crop of ``examples/advanced.py``, 33 scales, at 2,048
    frames of the moving source (fresh noise a frame): the position pass
    through the GCC kernel with peaks (row 1) and the GN kernel (row 5),
    then the CAF (spectral fold) and the velocity solve.  Checked: the
    median |velocity - truth| under ``MOVING_VEL_BOUND``, and against the
    port's CPU path on 4 frames: velocity, pair_rel_speed, alpha and
    tdoa_doppler within ``VEL_TOL``, xy within 2e-4 m.  Timed per call, and the CAF stage alone beside its
    bound."""
    import torch
    from audio_triangulation_tpu_torch import Localizer

    mics, cfg = moving_setup()
    frames = noisy(moving_frame(mics), MOVING_FRAMES, SEED + 22)
    loc = Localizer.create(mics, cfg, device="cuda")
    out = counted("moving", results, lambda: loc.localize_moving(
        frames, n_scales=MOVING_SCALES))
    v_true = torch.tensor(MOVING_V[:2], device="cuda")
    v_err = (out["velocity"] - v_true).norm(dim=-1)
    xy_err = (out["xy"] - torch.tensor(MOVING_SOURCE[:2],
                                       device="cuda")).norm(dim=-1)
    cpu = Localizer.create(mics, cfg, device="cpu")
    ref = cpu.localize_moving(frames[:MOVING_CPU_FRAMES].cpu(),
                              n_scales=MOVING_SCALES)
    diff = {k: float((out[k][:MOVING_CPU_FRAMES].cpu() - ref[k]).abs().max())
            for k in (*VEL_TOL, "xy")}
    tol = {**VEL_TOL, "xy": 2e-4}
    say("7 moving", f"moving: {MOVING_FRAMES} frames of 6 x 1,024, "
        f"{MOVING_SCALES} scales: median |velocity - (2.5, -1.5)| "
        f"{float(v_err.median()):.4f} m/s (largest "
        f"{float(v_err.max()):.4f}), median |xy - truth| "
        f"{float(xy_err.median()) * 100:.4f} cm; vs CPU path on "
        f"{MOVING_CPU_FRAMES} frames: " + ", ".join(
            f"{k} {v:.2e}" for k, v in diff.items()))
    if not (float(v_err.median()) < MOVING_VEL_BOUND
            and out["velocity"].shape == (MOVING_FRAMES, 2)
            and bool(torch.isfinite(out["velocity"]).all())
            and all(diff[k] <= tol[k] for k in tol)):
        fail("7 moving", "moving: result check failed")
    del out, ref
    time_path(card, f"moving localize_moving(n_scales={MOVING_SCALES})",
              lambda: loc.localize_moving(frames, n_scales=MOVING_SCALES),
              MOVING_FRAMES)
    resample = loc._moving_operator(8.0, MOVING_SCALES)[0]
    time_caf(card, "moving", loc.window, frames, loc.pairs, cfg, resample,
             MOVING_SCALES)


def source_stream(mics, bursts, n_streams=SOURCE_STREAMS, seed=SEED + 30):
    """[S, M, T] f32 ADC counts on the host: every stream idles at 127-129
    counts; every ``STREAM_PLANT_EVERY``-th holds the bursts [E, M, 1,024]
    (burst e at one of ``TRACK_STARTS`` plus e ``TRACK_BURST_GAP``), scaled
    by ``SOURCE_BURST_GAIN``.  Returns (streams, planted indices)."""
    rng = np.random.default_rng(seed)
    t_len = STREAM_STEPS * STREAM_CHUNK
    x = rng.integers(127, 130, (n_streams, mics.shape[0], t_len)).astype(
        np.float32)
    planted = np.arange(0, n_streams, STREAM_PLANT_EVERY)
    first = np.asarray(TRACK_STARTS)[np.arange(planted.size)
                                     % len(TRACK_STARTS)]
    for e, burst in enumerate(bursts):
        for p, at in zip(planted, first + e * TRACK_BURST_GAP):
            x[p, :, at:at + burst.shape[-1]] += SOURCE_BURST_GAIN * burst
    x[planted] = np.clip(np.round(x[planted]), 0, 255)
    return x, planted


def source_setups():
    """name -> (mics, PipelineConfig, StreamConfig, bursts of the scene):
    two simultaneous sources on the 8-mic circular array, and the moving
    source on ``circular_array(6, 0.35)`` with the velocity band crop (the
    spectral fold), 33 scales."""
    from audio_triangulation_tpu_torch import (PipelineConfig, StreamConfig,
                                               geometry)

    mics8 = geometry.circular_array(8, 0.15)
    mics6, cfg6 = moving_setup()
    gap_s = TRACK_BURST_GAP / 50_000.0
    moving = [moving_frame(mics6, np.asarray(MOVING_SOURCE)
                           + np.asarray(MOVING_V) * e * gap_s)
              for e in range(TRACK_BURSTS)]
    return {
        "multi": (mics8, PipelineConfig(phat=True), StreamConfig(
            chunk_size=STREAM_CHUNK, n_sources=2),
            [two_source_frame(mics8)] * TRACK_BURSTS),
        "velocity": (mics6, cfg6, StreamConfig(
            chunk_size=STREAM_CHUNK, solve_velocity=True,
            velocity_n_scales=MOVING_SCALES), moving),
    }


def held_diff(outs, cpu_outs, n_cpu, keys):
    """Largest |card - CPU| per key over the steps, on accepted events
    (``multi_*`` on valid slots), and whether the integer and bool outputs
    are equal."""
    import torch

    worst, exact = dict.fromkeys(keys, 0.0), True
    for g, c in zip(outs, cpu_outs):
        for k in c:
            got = g[k][:n_cpu].cpu()
            if k in keys:
                held = c["multi_valid" if k.startswith("multi_")
                         else "event"]
                if bool(held.any()):
                    worst[k] = max(worst[k], float(
                        (got[held] - c[k][held]).abs().max()))
            elif not got.is_floating_point():
                exact &= bool(torch.equal(got, c[k]))
    return worst, exact


def phase_stream_sources(card, results):
    """The stream step with ``n_sources=2`` and with ``solve_velocity``, and
    the tracked step with the JPDA update and with ``fuse_velocity``, on
    1,024 streams x 24 chunks of ``source_setups``' scenes (three bursts
    in every fourth stream).  Checked, per class: the planted events
    accepted; the sources found (two within 10 cm of ``MULTI_XY`` in each
    accepted slot, or the median |velocity - truth| under
    ``MOVING_VEL_BOUND``); against the port's CPU path on 16 streams,
    integer and bool outputs equal, multi_xy within 2e-4 m and multi_score
    within 1e-3 of scale on valid slots, velocity and pair_rel_speed within
    ``VEL_TOL`` on events (track_xy 2e-4 m, track_vel 1e-3 m/s); the
    eager run's detector launches counted from 0; the step replayed as a
    CUDA graph (and the tracked K-step graph) bit-equal to the eager steps;
    the tracked localization keys bit-equal to the untracked step's; the
    two-rate class with both fields the same as without.  Then timed:
    ``n_sources=2`` at 1,024 / 4,096 streams and ``solve_velocity`` at 256
    / 1,024 streams of ``reference_array()`` (default pipeline: the CAF's
    time-domain operator), eager and graphed, the CAF stage alone at 1,024
    streams beside its bound, and the tracked graphs at 1,024 streams."""
    import torch
    from audio_triangulation_tpu_torch import (
        StreamConfig, StreamingLocalizer, TrackedStreamingLocalizer,
        TrackerConfig, TwoRateStreamingLocalizer, geometry)
    from audio_triangulation_tpu_torch.models.streaming import state_leaves
    from audio_triangulation_tpu_torch.tools import bench_streaming

    n_cpu = SOURCE_CPU_STREAMS
    tracker_cfgs = {"multi": TrackerConfig(max_tracks=4, confirm_hits=2),
                    "velocity": TrackerConfig(velocity_noise=0.6)}
    for name, (mics, cfg, stream, bursts) in source_setups().items():
        x_np, planted = source_stream(mics, bursts)
        x = torch.from_numpy(x_np).cuda()
        s_n = x.shape[0]

        def chunk(i):
            return x[:, :, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]

        def cpu_chunk(i):
            return torch.from_numpy(
                x_np[:n_cpu, :, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK])

        sl = StreamingLocalizer.create(mics, cfg, stream=stream,
                                       device="cuda")
        st, outs = counted(f"stream_{name}", results,
                           lambda: run_steps(sl, s_n, chunk))
        torch.cuda.synchronize()
        events = torch.stack([o["event"] for o in outs])  # [T, S]
        n_acc = int(events[:, planted].sum())
        stray = int(events.sum()) - n_acc
        if name == "multi":
            share = [found_sources(o["multi_xy"][o["event"]][:, 0])[0]
                     for o in outs if bool(o["event"].any())]
            quality = (f"both sources within 10 cm of the truth in "
                       f"{min(share) * 100:.3f}% of the accepted slots "
                       f"(worst step)")
            good = min(share) >= 0.99
            keys = ("multi_xy", "multi_score")
        else:
            v = torch.cat([o["velocity"][o["event"]] for o in outs])
            v_err = float((v - torch.tensor(MOVING_V[:2],
                                            device="cuda")).norm(
                                                dim=-1).median())
            quality = f"median |velocity - truth| {v_err:.4f} m/s"
            good = v_err < MOVING_VEL_BOUND
            keys = ("velocity", "pair_rel_speed")
        cpu_sl = StreamingLocalizer.create(mics, cfg, stream=stream,
                                           device="cpu")
        _, c_outs = run_steps(cpu_sl, n_cpu, cpu_chunk)
        worst, exact = held_diff(outs, c_outs, n_cpu, keys)
        if name == "multi":
            scale = max(float(c["multi_score"].abs().max()) for c in c_outs)
            worst["multi_score"] /= scale
        tol = {"multi_xy": 2e-4, "multi_score": 1e-3, **VEL_TOL}
        graphed = sl.graph_step_many(sl.init_states(s_n), chunk(0))
        g_same = all(same(v, outs[i][k]) for i in range(STREAM_STEPS)
                     for k, v in graphed(chunk(i)).items())
        say("8 sources", f"stream_{name}: {s_n} streams x {STREAM_STEPS} "
            f"chunks: accepted {n_acc} of {planted.size * TRACK_BURSTS} "
            f"planted bursts, {stray} elsewhere; {quality}; vs CPU path on "
            f"{n_cpu} streams: integer and bool outputs equal {exact}, "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
            + f"; the step replayed as a CUDA graph: every output equal to "
            f"the eager step's bit for bit: {g_same}")
        if not (n_acc >= 0.98 * planted.size * TRACK_BURSTS and stray == 0
                and good and exact and g_same
                and all(worst[k] <= tol[k] for k in keys)):
            fail("8 sources", f"stream_{name}: result check failed")
        del graphed

        # the two-rate class takes both fields and ignores them
        plain_stream = StreamConfig(chunk_size=STREAM_CHUNK)
        tr_out = []
        for stc in (stream, plain_stream):
            tr = TwoRateStreamingLocalizer.create(mics, cfg, stream=stc,
                                                  device="cuda")
            tst, evs = tr.init_states(s_n), []
            for i in range(STREAM_STEPS):
                tst, det = tr.detect_many(tst, chunk(i))
                tst, ev = tr.localize_triggered(tst, det)
                evs.append(ev)
            tr_out.append(evs)
        tr_same = all(same(a[k], b[k]) for a, b in zip(*tr_out) for k in a)
        say("8 sources", f"two-rate with {name}'s StreamConfig: every "
            f"output equal to the default StreamConfig's: {tr_same}")
        if not tr_same:
            fail("8 sources", f"two-rate {name}: the fields changed a result")
        del tr_out

        # the tracked step
        tsl = TrackedStreamingLocalizer.create(
            mics, cfg, stream=stream, tracker_cfg=tracker_cfgs[name],
            fuse_velocity=name == "velocity", device="cuda")
        t_st, t_outs = counted(f"stream_tracked_{name}", results,
                               lambda: run_steps(tsl, s_n, chunk))
        contract = all(same(o[k], p[k]) for o, p in zip(t_outs, outs)
                       for k in p)
        conf = t_outs[-1]["track_confirmed"]
        want = 2 if name == "multi" else 1
        n_ok = int((conf[planted].sum(dim=-1) == want).sum())
        silent = torch.ones(s_n, dtype=torch.bool, device="cuda")
        silent[torch.from_numpy(planted).cuda()] = False
        cpu_tsl = TrackedStreamingLocalizer.create(
            mics, cfg, stream=stream, tracker_cfg=tracker_cfgs[name],
            fuse_velocity=name == "velocity", device="cpu")
        _, ct_outs = run_steps(cpu_tsl, n_cpu, cpu_chunk)
        t_tol = {"track_xy": 2e-4, "track_vel": VEL_TOL["velocity"]}
        t_worst, t_exact = dict.fromkeys(t_tol, 0.0), True
        for g, c in zip(t_outs, ct_outs):
            for k in t_tol:
                t_worst[k] = max(t_worst[k], float(
                    (g[k][:n_cpu].cpu() - c[k]).abs().max()))
            for k in ("track_active", "track_confirmed", "track_id",
                      "assigned", "events"):
                t_exact &= bool(torch.equal(g[k][:n_cpu].cpu(), c[k]))
        one = tsl.graph_step_many(tsl.init_states(s_n), chunk(0))
        g_same = True
        for i in range(STREAM_STEPS):
            g_same &= all(same(v, t_outs[i][k])
                          for k, v in one(chunk(i)).items())
        k_n = TRACK_SCAN_K
        kstep = tsl.graph_step_many_scan(
            tsl.init_states(s_n),
            torch.stack([chunk(i) for i in range(k_n)], 1))
        for j in range(0, STREAM_STEPS, k_n):
            gout = kstep(torch.stack([chunk(i) for i in range(j, j + k_n)],
                                     1))
            g_same &= all(same(gout[k][i], t_outs[j + i][k])
                          for k in gout for i in range(k_n))
        for g in (one, kstep):
            g_same &= all(same(a, b) for a, b in zip(
                state_leaves(g.states), state_leaves(t_st)))
        say("8 sources", f"stream_tracked_{name}: localization keys equal to "
            f"the untracked step's bit for bit: {contract}; planted streams "
            f"ending with {want} confirmed track(s) {n_ok} of {planted.size}"
            f", silent streams trackless "
            f"{not bool(conf[silent].any())}; vs CPU path on {n_cpu} "
            f"streams: integer outputs equal {t_exact}, " + ", ".join(
                f"{k} {v:.2e}" for k, v in t_worst.items())
            + f"; one-chunk and {k_n}-chunk graphs bit-equal to the eager "
            f"steps: {g_same}")
        if not (contract and n_ok >= 0.98 * planted.size and t_exact
                and not bool(conf[silent].any()) and g_same
                and all(t_worst[k] <= t_tol[k] for k in t_tol)):
            fail("8 sources", f"stream_tracked_{name}: result check failed")
        chunks = quiet_chunks(np.random.default_rng(SEED + 31),
                              SOURCE_STREAMS, mics.shape[0])
        med_s, q1, q3 = bench_streaming.time_graphed_steps(
            tsl, SOURCE_STREAMS, chunks, STREAM_TRIALS, STREAM_TIMED_STEPS)
        say("5 timing", f"stream tracked_{name} {SOURCE_STREAMS} streams, "
            f"graphed: step_ms {med_s * 1e3:.4f} median, IQR "
            f"{q1 * 1e3:.4f}-{q3 * 1e3:.4f} over {STREAM_TRIALS} trials of "
            f"{STREAM_TIMED_STEPS} steps ({card})")
        del one, kstep, t_outs, ct_outs, outs, c_outs, x, st, t_st

    # timing on the reference array, default pipeline
    rng = np.random.default_rng(SEED + 32)
    chunk_ms = STREAM_CHUNK / 50_000.0 * 1e3
    for what, stream, counts in (
            ("n_sources=2", StreamConfig(chunk_size=STREAM_CHUNK,
                                         n_sources=2), MULTI_STREAM_COUNTS),
            ("solve_velocity", StreamConfig(chunk_size=STREAM_CHUNK,
                                            solve_velocity=True),
             VELOCITY_STREAM_COUNTS)):
        sl = StreamingLocalizer.create(geometry.reference_array(),
                                       stream=stream, device="cuda")
        for n_streams in counts:
            chunks = quiet_chunks(rng, n_streams)
            for how, timer in (
                    ("eager", lambda: bench_streaming.time_steps(
                        sl.step_many, sl.init_states(n_streams), chunks,
                        STREAM_TRIALS, STREAM_TIMED_STEPS, "cuda")),
                    ("graphed", lambda: bench_streaming.time_graphed_steps(
                        sl, n_streams, chunks, STREAM_TRIALS,
                        STREAM_TIMED_STEPS))):
                med_s, q1, q3 = timer()
                say("5 timing", f"stream {what} {n_streams} streams, {how}: "
                    f"step_ms {med_s * 1e3:.4f} median, IQR "
                    f"{q1 * 1e3:.4f}-{q3 * 1e3:.4f} over {STREAM_TRIALS} "
                    f"trials of {STREAM_TIMED_STEPS} steps; streams "
                    f"sustained in real time "
                    f"{chunk_ms / (med_s * 1e3) * n_streams:.1f} ({card})")
        if stream.solve_velocity:
            frames = torch.from_numpy(scene_frames(
                geometry.reference_array(), counts[-1], rng)).cuda()
            time_caf(card, f"stream solve_velocity {counts[-1]} streams",
                     sl.params.window, frames, sl.params.pairs,
                     sl.pipeline, sl.caf_resample,
                     stream.velocity_n_scales)


GOLDEN_FRAMES = 16384  # localize_frames_int: 8-bit frames of 3 x 1,024
GOLDEN_CPU_FRAMES = 1024  # of them held to the port's CPU path
GOLDEN_MODEL_FRAMES = 64  # and to the golden model
GOLDEN_SATURATED = 8  # frames of square waves between the rails
GOLDEN_STREAM_SAMPLES = 3_000_000  # localize_stream: 60 s at 50 kHz
GOLDEN_STREAM_BURSTS = 12
GOLDEN_INT_KEYS = ("frames_conditioned", "correlograms", "correlograms_raw",
                   "best_shift", "gate", "scores", "heat_levels")
SOAK_ARGS = ["--streams", "2048", "--steps", "200", "--track",
             "--fault-at", "0.5"]


def golden_frames(mics, rng):
    """[GOLDEN_FRAMES, 3, 1,024] uint8 as the ADC delivers them: chirps from
    random sources (``to_adc_u8``), the first ``GOLDEN_SATURATED`` square
    waves between 0 and 255, each mic a few samples after the one before
    (the largest correlation sums)."""
    from audio_triangulation_tpu_torch.utils import synth

    u8 = synth.to_adc_u8(scene_frames(mics, GOLDEN_FRAMES, rng))
    t = np.arange(u8.shape[-1])
    for i in range(GOLDEN_SATURATED):
        for j in range(3):
            u8[i, j] = np.where(((t + 3 * j + i) // (5 + i)) % 2, 255, 0)
    return u8


def phase_golden(card, results):
    """The firmware's integer path on the card at full width:
    ``localize_frames_int`` on 16,384 8-bit frames (the golden model's
    mics, Q15 window and 101 x 101 LUT, +-46 shifts), all seven outputs
    equal (``torch.equal``) to the port's CPU path on 1,024 of them and to
    the golden model on 64, timed, with its peak device memory.  Then
    ``localize_stream`` on a 60 s stream with planted bursts: trigger
    indices and valid flags equal to the CPU path's, xy within 2e-4 m.
    The first call of each is counted (``PATH_KERNELS``): the stream's
    events must go through the GCC and GN kernels."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.models.localizer import (
        localize_frames_int, localize_stream)
    from audio_triangulation_tpu_torch.utils import golden, synth
    from audio_triangulation_tpu_torch.utils.golden_event import golden_event

    rng = np.random.default_rng(SEED + 40)
    cfg = PipelineConfig()
    mics = golden.mic_locations()
    table = golden.window_table_q15()
    luts = golden.heatmap_luts(mics)
    host = (golden_frames(mics, rng), np.asarray(((0, 1), (0, 2), (1, 2)),
                                                 np.int32),
            table, luts.reshape(3, -1).astype(np.int32))
    args = [torch.from_numpy(a).cuda() for a in host]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    out = counted("localize_frames_int", results,
                  lambda: localize_frames_int(*args, cfg))
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    cpu = localize_frames_int(
        torch.from_numpy(host[0][:GOLDEN_CPU_FRAMES]),
        *[torch.from_numpy(a) for a in host[1:]], cfg)
    cpu_eq = [k for k in GOLDEN_INT_KEYS
              if not torch.equal(out[k][:GOLDEN_CPU_FRAMES].cpu(), cpu[k])]
    model_eq = []
    for b in range(GOLDEN_MODEL_FRAMES):
        ref = golden_event(host[0][b], luts)
        model_eq += [(b, k) for k in GOLDEN_INT_KEYS
                     if not np.array_equal(out[k][b].cpu().numpy(), ref[k])
                     or out[k].dtype != torch.from_numpy(
                         np.asarray(ref[k])).dtype]
    say("9 golden", f"localize_frames_int: {GOLDEN_FRAMES} frames of 3 x "
        f"1,024 8-bit samples, {luts[0].size} cells, +-{cfg.max_shift} "
        f"shifts; outputs unequal to the CPU path on {GOLDEN_CPU_FRAMES} "
        f"frames: {cpu_eq or 'none'}; to the golden model on "
        f"{GOLDEN_MODEL_FRAMES}: {model_eq[:4] or 'none'}; gate open on "
        f"{float(out['gate'].float().mean()) * 100:.1f}% of frames, "
        f"|raw correlogram| up to {int(out['correlograms_raw'].abs().max())}"
        f"; peak device memory {peak_gb:.3f} GB above its inputs "
        f"({torch.cuda.max_memory_allocated() / 1e9:.3f} GB in all)")
    if cpu_eq or model_eq:
        fail("9 golden", "the integer path differs from the CPU path or the "
             "golden model")
    del out, cpu
    time_path(card, "localize_frames_int",
              lambda: localize_frames_int(*args, cfg), GOLDEN_FRAMES,
              phase="9 golden")
    del args

    # ---- localize_stream: a 60 s stream, bursts from known sources --------
    arr = geometry.reference_array()
    stream = rng.integers(127, 130, (3, GOLDEN_STREAM_SAMPLES)).astype(
        np.float64)
    starts = np.linspace(50_000, GOLDEN_STREAM_SAMPLES - 60_000,
                         GOLDEN_STREAM_BURSTS).astype(np.int64)
    planes = rng.uniform(-0.8, 0.8, (GOLDEN_STREAM_BURSTS, 2))
    v = np.concatenate([planes, np.full((len(planes), 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    bursts = synth.synth_scene(src, arr, noise_rms=0.0, seed=SEED + 41)
    for at, fr in zip(starts, bursts):
        stream[:, at: at + fr.shape[-1]] += 110.0 * fr
    stream = torch.from_numpy(np.clip(np.round(stream), 0, 255).astype(
        np.float32))
    loc = Localizer.create(arr, cfg, device="cuda")
    sc = stream.cuda()
    got = counted("localize_stream", results,
                  lambda: localize_stream(loc, sc))
    ref = localize_stream(Localizer.create(arr, cfg, device="cpu"), stream)
    valid = ref["valid"]
    same = (torch.equal(got["trigger_idx"].cpu(), ref["trigger_idx"])
            and torch.equal(got["valid"].cpu(), valid))
    dxy = float((got["xy"].cpu()[valid] - ref["xy"][valid]).abs().max())
    err = (float(np.abs(got["xy"].cpu()[valid].numpy() - planes).max())
           if int(valid.sum()) == GOLDEN_STREAM_BURSTS else float("inf"))
    say("9 golden", f"localize_stream: [3, {GOLDEN_STREAM_SAMPLES}] samples, "
        f"{int(valid.sum())} of {GOLDEN_STREAM_BURSTS} bursts found; "
        f"triggers and valid flags equal to the CPU path {same}; xy "
        f"{dxy:.2e} m from it, {err * 100:.2f} cm from the sources at most")
    if not (same and dxy <= 2e-4 and err < 0.25):
        fail("9 golden", "localize_stream: result check failed")
    time_path(card, "localize_stream (calls/s)",
              lambda: localize_stream(loc, sc), 1, phase="9 golden")


def phase_accuracy(card, results):
    """The port's accuracy sweep on the card (``tools/bench_accuracy``: 256
    scenes, six SNRs, five methods, strides 1 and 3, the 8-bit ADC row),
    launches counted.  Each scene held to the port's CPU path on the same
    frames (xy within 2e-4 m, tdoa within 1e-3 samples) where its best lags
    and grid cell are 1e-3 of scale clear of the next; each row's medians
    to the JAX package's rows (``off_reference``).  Near ties are counted;
    fewer than a tenth of the scenes may be (3.5% on the CPU: PHAT at low
    SNR flattens the grid)."""
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.tools import bench_accuracy

    keep = ("xy", "tdoa_samples")
    points = counted("tool_bench_accuracy", results, lambda: [
        (row, {k: out[k].cpu() for k in keep}, frames, loc.pipeline, stride)
        for row, out, frames, loc, stride in bench_accuracy.points(
            device="cuda")])
    mics = geometry.square_array(0.3)
    rows, worst, ties = [], [0.0, 0.0], 0
    for row, out, frames, cfg, stride in points:
        ref = Localizer.create(mics, cfg, device="cpu",
                               init_grid_stride=stride)(
            torch.from_numpy(frames))
        clear = bench_accuracy.clear_of_ties(ref["correlograms"],
                                             ref["scores"])
        ties += int((~clear).sum())
        worst[0] = max(worst[0], float(
            (out["xy"] - ref["xy"])[clear].abs().max()))
        worst[1] = max(worst[1], float(
            (out["tdoa_samples"] - ref["tdoa_samples"])[clear].abs().max()))
        rows.append(row)
    off = bench_accuracy.off_reference(rows)
    for snr in bench_accuracy.SNRS:
        say("10 accuracy", f"SNR {snr} dB, median tdoa (samples) / xy (cm) "
            "by method at strides 1, 3: " + "; ".join(
                f"{r['method']}:{r['init_grid_stride']} "
                f"{r['tdoa_err_median_samples']} / {r['xy_err_median_cm']}"
                for r in rows if r["snr_db"] == snr))
    adc = rows[-1]
    n_scenes = sum(r["scenes"] for r in rows)
    say("10 accuracy", f"8-bit ADC: {adc['tdoa_err_median_samples']} / "
        f"{adc['xy_err_median_cm']}; {len(rows)} rows; against the CPU path "
        f"on {n_scenes - ties} of {n_scenes} scenes clear of a near tie: xy "
        f"{worst[0]:.2e} m, tdoa {worst[1]:.2e} samples; rows off the JAX "
        f"package's by more than {bench_accuracy.MEDIAN_TOLERANCE}: "
        f"{off or 'none'} ({card})")
    if not (worst[0] <= 2e-4 and worst[1] <= 1e-3 and not off
            and ties <= 0.1 * n_scenes):
        fail("10 accuracy", "the sweep differs from the CPU path or from the "
             "JAX package's rows")


def phase_bench(results):
    """The frame-batch bench tool as a user runs it: its three lines, from
    the timing function phase 5 shares, with launches counted."""
    from audio_triangulation_tpu_torch.tools import bench

    lines = counted("tool_bench", results, lambda: bench.main([]))
    names = [ln["metric"] for ln in lines]
    if not (len(lines) == 3 and names[-1] == bench.METRIC
            and all(ln["value"] > 0 and ln["unit"] == "frames/s"
                    and ln["trials"] >= 5 and ln["power_limit_w"]
                    and "vs_baseline" not in ln for ln in lines)):
        fail("11 bench", f"malformed lines: {lines}")
    say("11 bench", "three lines, the band-cropped headline last")


def phase_soak(results):
    """The tracked soak tool on the card: 2,048 streams, 200 graphed steps,
    channel 1 dead after half of them; every gate must pass."""
    from audio_triangulation_tpu_torch.tools import soak_streaming

    res = counted("tool_soak_streaming", results,
                  lambda: soak_streaming.main(SOAK_ARGS))
    say("12 soak", f"gates {res['gates']}; step_ms p50 "
        f"{res['step_ms_p50']:.4f}, VmRSS growth {res['rss_growth_mb']} MB, "
        f"device memory growth {res['device_mem_growth_mb']} MB")
    if not (res["ok"] and res["graphed"] and res["steps"] == 200):
        fail("12 soak", "a gate failed")


# further keys of an entry that has them: what the library yardstick is, the
# SRP-argmax kernel's other bound and its bf16 mode, the bf16 DFT product's
# library form with f32 outputs
EXTRA_KEYS = ("library", "bound_ms_fp32_cores", "bf16_ms", "bf16_plain_ms",
              "bf16_library_ms", "bf16_bound_ms", "library_f32_out_ms",
              "device_ms", "launches_per_call", "launches_by_path",
              "multi_8mic_no_peaks")
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def main():
    card = phase_device()
    import torch

    rng = np.random.default_rng(SEED)
    results = {k: {"name": k, "route": "cuda", **v}
               for k, v in KERNEL_INFO.items()}
    phase_gcc(rng, results)
    phase_stats(rng, results)
    phase_gn(rng, results)
    phase_large(rng, results)
    phase_srp(rng, results)
    phase_gcc_srp(rng, results)
    phase_scan(card, rng, results)
    state = phase_main(rng, results)
    phase_timing(card, *state, results)
    del state
    torch.cuda.empty_cache()
    phase_dft_matmul(card, results)
    phase_gcc_pipelined(card, rng, results)
    phase_tools(results)
    phase_stream(card, results)
    phase_tracked(card, results)
    phase_multi(card, results)
    phase_moving(card, results)
    phase_stream_sources(card, results)
    phase_golden(card, results)
    phase_accuracy(card, results)
    phase_bench(results)
    phase_soak(results)

    print(json.dumps({"kernels": [
        {k: results[n][k] for k in (*KERNEL_KEYS, *(
            e for e in EXTRA_KEYS if e in results[n]))}
        for n in KERNEL_INFO]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
