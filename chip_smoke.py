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
steps, a dead channel half-way; every gate).  Last, phase 13: the
estimators beside the localizer at the JAX package's published widths:
``DoaEstimator`` (8-mic circle, and ``smp=True`` on an 8-mic line),
``Doa3dEstimator`` (the CLI's tetrahedron, 2,048 bearings),
``VolumeLocalizer`` (``examples/advanced.py``'s 12,005-cell box in its
gather form, peak device memory recorded) and ``ArrayFusionLocalizer`` (two
squares 2 m apart) on 16,384 frames or events a call, ``localize_sync`` on
256 events of three free-running arrays (offset only and with drift), the
subspace and frequency-domain spectra (MUSIC, MUSIC with MDL source
counting, MVDR, frequency SRP, CSSM, azimuth MUSIC) and
``register_arrays``, each against the planted truth, the port's CPU path
and its launch table (the GCC kernel without peaks once a call on the
row-2 paths), and timed; row 2 at these shapes against float64 and its
bound.  Phase 14, the reverberant-room slice at its published widths:
``room.simulate_batch`` (1,024 sources, ``max_order=6``), block WPE (64
recordings of 4 x 16,384 samples and one of 2^21), ``StreamingDereverb``
at 1 / 256 / 1,024 streams feeding ``StreamingLocalizer.step_many``,
``Localizer.extract`` (DAS and MVDR on the 8-mic two-source scene, rows 1
and 5 once a call), ``StreamingExtractor.step_many`` at 1,024 streams,
the two-rate localizer's event audio at 1,024 streams and
``ReflectorMapper`` (echo delays at 16,384 frames, the map of 64 events);
each against the JAX tests' bounds and the port's CPU path on a cut
(block WPE against float64), its launches counted, timed, its peak
device memory recorded.  Phase 15, the training side at the JAX
package's published sizes: ``Calibrator.train_step`` on 4,096 events of
8 x 1,024 (no kernel; peak memory with and without the checkpoint; the
card against the CPU path on 64 events and on all 4,096), the CLI's
``calibrate`` defaults, ``fit_em`` (256 events, 3 x 50 steps; rows 1 and
5 once a round) and ``fit_tracked`` (36 events, 250 steps; rows 1 and 5
once) against the reference tests' gates, ``estimate_speed_of_sound`` on
4,096 events, ``NeuralLocalizer.train_step`` on 1,024 frames (row 2 once
a step; the loss falling over 50 steps) and ``predict`` on 16,384 frames
against row 2's plain version, and the CLI's ``design`` defaults with a
201 x 201 CRLB map; each timed, its peak memory and launches recorded
and held to the CPU path.  Phase 16 serves (HTTP, the feeder, graph
capture and export, checkpoints, native ingest).  Phase 17, multi-device
execution: an NCCL world of one runs grid-parallel localize (row 7 a
rank), pair sharding of the 64-mic array (row 6), ``fusion_2x4``, sharded
streaming (plain, and tracked with health and velocity) and data-parallel
calibration and neural steps, each held to the unsharded call; then the
grid, pair and fusion model axes run four ways on the one card, shard by
shard, held to the world of one (a world of two or more cards runs only
where there are that many).  Phase 18, the command line: each subcommand
in process on the card against ``--device cpu``, ``serve`` in a
subprocess answering one request bit-equal to ``loc(frames)``, a FIFO
source, ``bench`` and the module entry.  Phase 19, the root tools, benches
and examples: ``tools/bench_configs`` (the seven records of the five
``BASELINE.json`` configurations, each held to the CPU path on 256 frames),
``tools/bench_latency`` (1 and 1,024 streams, the device step under the
synchronized p50), ``tools/bench_robustness`` (20 rows against its CPU
run), ``tools/int8_dft_accuracy`` (row 8's int8 mode bit-equal to numpy's
int32 products), 30 s of ``tools/soak_transport``, ``tools/make_eval_dataset``
(within one count of the committed WAVs, then ``evaluate`` inside its
floors) and the five examples against ``--device cpu``; then the
replicated-frames probe (one event replicated against a noise draw a
frame, timed in turns and profiled).

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
    from audio_triangulation_tpu_torch.runtime import native_rt
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
    t0 = time.perf_counter()
    try:
        native = native_rt.build()
    except RuntimeError as e:
        fail("1 device", f"the native ingest runtime did not build: {e}")
    say("1 device", f"native ingest runtime built with g++ in "
        f"{time.perf_counter() - t0:.1f} s -> {os.path.relpath(native, HERE)}")
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
                "localize_stream": ("gcc_kernel", "gn_kernel"),
                # phase 13: row 2 once a call on the four frame-batch
                # estimators and the sync fusion, no kernel elsewhere
                **{name: ("gcc_kernel",) for name in (
                    "doa_8mic", "doa3d_tetra", "volume_8mic", "fusion_2x4",
                    "fusion_sync_3x4", "fusion_sync_3x4_drift")},
                **{name: () for name in (
                    "doa_smp_line8", "music_8mic", "music_8mic_auto",
                    "mvdr_8mic", "freq_8mic", "music_coherent", "doa_music",
                    "register")},
                # phase 14: rows 1 and 5 once a Localizer call, the scan
                # once a stream step, no kernel elsewhere
                **{name: ("gcc_kernel", "gn_kernel") for name in (
                    "extract_8mic_das", "extract_8mic_mvdr",
                    "mapping_6mic")},
                **{name: ("detector_scan_kernel",) for name in (
                    "dereverb_stream", "tworate_audio")},
                # phase 15: rows 1 and 5 once a Localizer call of the EM and
                # tracked calibrations, row 2 once a neural step and
                # prediction, no kernel on the gradient paths
                **{name: ("gcc_kernel", "gn_kernel") for name in (
                    "calib_em_8mic", "calib_tracked_8mic")},
                **{name: ("gcc_kernel",) for name in (
                    "neural_train", "neural_predict")},
                **{name: () for name in (
                    "calib_step_8mic", "calib_cli", "speed_of_sound",
                    "design_cli", "design_crlb_map")},
                **{name: () for name in (
                    "room_batch", "wpe_block", "wpe_long",
                    "extractor_stream_das", "extractor_stream_mvdr",
                    "mapping_echo")},
                # phase 16: rows 1 and 5 once a /localize request and an
                # EventPump or feeder batch, the scan once a session step
                **{name: ("gcc_kernel", "gn_kernel") for name in (
                    "serve_pump", "serve_localize_b1", "serve_localize_b64",
                    "serve_localize_b4096", "serve_clients",
                    "serve_feeder")},
                **{name: ("detector_scan_kernel",) for name in (
                    "serve_sessions", "serve_checkpoint")},
                # phase 17: the parallel paths in a world of one, and the
                # model axis four ways on the card (rows 7, 6 and 2 at the
                # shards' shapes)
                "par_grid": ("gcc_kernel", "srp_argmax_kernel", "gn_kernel"),
                "par_spmd_grid": ("gcc_kernel", "srp_argmax_kernel"),
                "par4_grid": ("srp_argmax_kernel",),
                **{name: ("gcc_large_kernel",) for name in (
                    "par_pairs_64mic", "par4_pairs")},
                **{name: ("gcc_kernel",) for name in (
                    "par_fusion_2x4", "par4_fusion", "par_neural_step")},
                **{name: ("detector_scan_kernel",) for name in (
                    "par_stream", "par_stream_tracked")},
                "par_calib_step_8mic": ()}


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


def counted(name, results, fn, phase="4 main"):
    """Run ``fn`` with every launch count set to 0 just before and read just
    after; add the counts to the results and fail if a kernel of the path
    ``name`` was not launched (the lines carry ``phase``).  Calls of the
    SRP scoring product and of the batched solver and covariance outside
    the kernels are counted too: a path whose kernel scores must make no
    scoring product, and a path that takes the GN kernel neither solver
    call (the kernel writes the covariance)."""
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
    say(phase, f"{name}: launches {counts}; calls outside the kernels "
        f"{calls}")
    if any(counts[k] < 1 for k in PATH_KERNELS[name]):
        fail(phase, f"{name}: a kernel of its path was never launched")
    if "gcc_srp_kernel" in PATH_KERNELS[name] and calls["srp_scores_matmul"]:
        fail(phase, f"{name}: the scores were formed again outside the "
             "kernel")
    if "gn_kernel" in PATH_KERNELS[name] and (
            calls["solve_tdoa_batched"] or calls["solution_covariance"]):
        fail(phase, f"{name}: the solve or the covariance ran outside the "
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


# host time inside a profiler session before and after the call it traces:
# a session of a few microseconds around one launch now and then records
# no device activity, one with this padding has not (``python3
# chip_profile.py sessions`` counts both; PERF.md, PR 16)
PROFILE_PAD_S = 0.01


def profiled_kernels(fn):
    """(kernels a torch.profiler session recorded during ``fn()``, the
    session's key averages of them).  The session holds ``PROFILE_PAD_S``
    of host time before and after the call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    cpu = torch.autograd.DeviceType.CPU
    kernels = [e for e in prof.key_averages() if e.device_type != cpu
               and e.self_device_time_total > 0]
    return sum(e.count for e in kernels), kernels


def device_kernels(fn):
    """One call of ``fn()`` under torch.profiler (``profiled_kernels``):
    (kernels launched, their device milliseconds, their names).  Fails with
    a reason when the trace holds fewer kernel launches than the wrappers
    counted in that call: an empty or short trace must not read as
    "launched nothing"."""
    import torch

    fn()
    torch.cuda.synchronize()
    reset_counts()
    launches, kernels = profiled_kernels(fn)
    want = {k: v for k, v in launch_counts().items() if v}
    if launches < sum(want.values()):
        fail("5 timing", f"the profiler recorded {launches} kernel launches "
             f"where the wrappers counted {want}: the trace lost device "
             "activity")
    return (launches, sum(e.self_device_time_total for e in kernels) / 1e3,
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


def burst_stream(rng, n_bursts, seed, n_samples=GOLDEN_STREAM_SAMPLES):
    """A live stream of ``geometry.reference_array()`` at 50 kHz: 8-bit
    idle noise (127..129) with ``n_bursts`` chirps from random plane points
    added at even spacing, rounded and clipped to 0..255.  (stream [3, T]
    float64, plane points [n_bursts, 2])."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import synth

    stream = rng.integers(127, 130, (3, n_samples)).astype(np.float64)
    starts = np.linspace(50_000, n_samples - 60_000, n_bursts).astype(
        np.int64)
    planes = rng.uniform(-0.8, 0.8, (n_bursts, 2))
    v = np.concatenate([planes, np.full((len(planes), 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    bursts = synth.synth_scene(src, geometry.reference_array(),
                               noise_rms=0.0, seed=seed)
    for at, fr in zip(starts, bursts):
        stream[:, at: at + fr.shape[-1]] += 110.0 * fr
    return np.clip(np.round(stream), 0, 255), planes


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
    from audio_triangulation_tpu_torch.utils import golden
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
    stream, planes = burst_stream(rng, GOLDEN_STREAM_BURSTS, SEED + 41)
    stream = torch.from_numpy(stream.astype(np.float32))
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


# ---- phase 13: the estimators beside the localizer --------------------------

EST_FRAMES = 16384  # frames (fusion: events) a call of the row-2 paths
EST_CPU_FRAMES = 256  # of them held to the port's CPU path
EST_KERNEL_REPS = 5  # launches per timing of row 2 at these shapes
EST_SNAPSHOTS = 12  # snapshots of the subspace scenes (examples/advanced.py)
FREQ_FRAMES = 1024  # frames a localize_freq call
SYNC_EVENTS = 256  # events a localize_sync call
SYNC_DURATION_S = 30.0  # capture times of the drift call
SYNC_OFFSETS = (0.0, 3.7, -2.2)  # clock offsets (samples), array 0 the reference
SYNC_DRIFTS = (0.0, 25e-6, -40e-6)  # clock drifts (s/s)
SYNC_SOURCES = ((0.8, 0.9), (-0.6, 1.6), (1.8, -0.4), (0.2, 2.2),
                (-1.2, -0.8), (2.4, 1.2), (0.5, 0.2), (-1.8, 1.0))
REG_ARRAYS, REG_EVENTS = 4, 64
DOA_AZ = 117.0  # examples/advanced.py's far-field bearing
SMP_AZ = 60.0
DOA3D_BEARING = (310.0, 40.0)  # (azimuth, elevation) degrees
VOLUME_SOURCE = (0.3, 0.2, 0.8)  # examples/advanced.py's 3-D source
FUSION_SOURCE = (0.3, 1.5)  # examples/advanced.py's fusion source
SUBSPACE_SOURCES = ((0.9, 0.3), (-0.7, -0.6))  # examples/advanced.py:37-38
MUSIC_DOA_AZ = (60.0, 200.0)
# the JAX package's test bounds on the planted truth (tests/test_doa*.py,
# test_smp_doa.py, test_volume.py, test_fusion.py, test_sync_fusion.py,
# test_srp_freq.py, test_registration.py)
EST_TRUTH = {"doa_deg": 3.0, "smp_deg": 4.0, "doa3d_deg": 3.0,
             "volume_m": 0.05, "fusion_m": 0.08, "sync_m": 0.08,
             "sync_offset_samples": 0.6, "sync_drift": 3e-6,
             "spectrum_m": 0.15, "music_doa_deg": 6.0, "reg_rot": 5e-3,
             "reg_trans_m": 0.02}


def plane_wave_frame(mics, az_deg, el_deg=0.0):
    """[M, 1,024] f32: a chirp from the far-field bearing (az, el), per-mic
    delays -m.u/c (the JAX package's tests/test_doa3d.py scene), no noise."""
    from audio_triangulation_tpu_torch.utils import synth

    az, el = np.radians(az_deg), np.radians(el_deg)
    u = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)])
    m3 = np.zeros((mics.shape[0], 3))
    m3[:, :mics.shape[1]] = mics
    tau = -(m3 @ u) / 343.0 * 50_000.0
    return synth.fractional_delay(np.broadcast_to(
        synth.chirp_burst(1024, 50_000.0), (mics.shape[0], 1024)),
        tau).astype(np.float32)


def estimator_paths():
    """The frame-batch estimator paths of phase 13: {name: (make(device) ->
    estimator, one noise-free event [.., M, 1,024] f32, kernels a call)}.
    The row-2 paths launch the GCC kernel without peaks once a call; the
    SMP path runs unfused spectra (no kernel)."""
    from audio_triangulation_tpu_torch import (PipelineConfig, VolumeConfig,
                                               VolumeLocalizer, geometry)
    from audio_triangulation_tpu_torch.models import doa
    from audio_triangulation_tpu_torch.models.fusion import (
        ArrayFusionLocalizer)
    from audio_triangulation_tpu_torch.utils import synth

    mics8 = geometry.circular_array(8, 0.15)
    line8 = np.zeros((8, 2), np.float32)
    line8[:, 0] = (np.arange(8) - 3.5) * 0.04
    tetra = geometry.tetrahedral_array(0.3)
    big8 = geometry.circular_array(8, 0.5)
    vol = VolumeConfig(half_cells_x=24, half_cells_y=24, cells_per_m=16.0,
                       z_min_m=0.4, z_max_m=1.2, z_cells=5)
    arrays = [geometry.square_array(0.25) + np.array([-1.0, 0.0], np.float32),
              geometry.square_array(0.25) + np.array([1.0, 0.0], np.float32)]
    src_far = 50.0 * np.array([np.cos(np.radians(DOA_AZ)),
                               np.sin(np.radians(DOA_AZ)), 0.0])
    fusion_event = synth.synth_scene(
        np.array([*FUSION_SOURCE, 1.2]), np.concatenate(arrays))[0]
    cli3d = PipelineConfig(phat=True, window_enabled=False)
    return {
        "doa_8mic": (lambda dev: doa.DoaEstimator.create(mics8, device=dev),
                     synth.synth_scene(src_far, mics8)[0].astype(np.float32),
                     ("gcc_kernel",)),
        "doa_smp_line8": (
            lambda dev: doa.DoaEstimator.create(line8, smp=True, device=dev),
            plane_wave_frame(line8, SMP_AZ), ()),
        "doa3d_tetra": (
            lambda dev: doa.Doa3dEstimator.create(tetra, cli3d, n_dirs=2048,
                                                  device=dev),
            plane_wave_frame(tetra, *DOA3D_BEARING), ("gcc_kernel",)),
        "volume_8mic": (
            lambda dev: VolumeLocalizer.create(big8, PipelineConfig(), vol,
                                               device=dev),
            synth.synth_scene(np.array(VOLUME_SOURCE), big8)[0].astype(
                np.float32), ("gcc_kernel",)),
        "fusion_2x4": (
            lambda dev: ArrayFusionLocalizer.create(
                arrays, PipelineConfig(phat=True), device=dev),
            fusion_event.reshape(2, 4, 1024).astype(np.float32),
            ("gcc_kernel",)),
    }


def sync_arrays():
    """tests/test_sync_fusion.py's three 4-mic squares."""
    from audio_triangulation_tpu_torch import geometry

    return [geometry.square_array(0.3),
            geometry.square_array(0.3) + np.array([3.0, 0.5], np.float32),
            geometry.square_array(0.3) + np.array([-1.0, 3.0], np.float32)]


def sync_scene(n_events, seed, drift):
    """(frames [E, 3, 4, 1,024] f32, capture times [E] or None, sources
    [E, 2]): tests/test_sync_fusion.py's eight sources in turn, the arrays'
    clock offsets applied, with drift over ``SYNC_DURATION_S`` when asked."""
    from audio_triangulation_tpu_torch.utils import synth

    cat = np.concatenate(sync_arrays())
    aid = np.repeat(np.arange(3), 4)
    src = np.resize(np.array(SYNC_SOURCES), (n_events, 2))
    times = np.linspace(0.0, SYNC_DURATION_S, n_events) if drift else None
    clean = synth.synth_scene(np.concatenate(
        [src, np.full((n_events, 1), 1.2)], -1), cat, noise_rms=0.004,
        seed=seed)
    clock = np.asarray(SYNC_OFFSETS)[None] / 50_000.0
    if drift:
        clock = clock + np.asarray(SYNC_DRIFTS)[None] * times[:, None]
    ev = synth.fractional_delay(clean, np.broadcast_to(
        clock[:, aid] * 50_000.0, clean.shape[:-1]))
    return ev.reshape(n_events, 3, 4, 1024).astype(np.float32), times, src


def est_truth(name, out) -> tuple[str, bool]:
    """Share of rows within the JAX package's test bound of the planted
    truth (its tests hold one noise draw each), and the median error:
    (text, whether the median and 95% of rows are within it)."""
    import torch

    def ang(a, b):
        return ((a - b + 180.0) % 360.0 - 180.0).abs()

    if name == "doa_8mic":
        err = ang(out["azimuth_deg"], DOA_AZ)
        bound, unit = EST_TRUTH["doa_deg"], "deg"
    elif name == "doa_smp_line8":  # a line cannot tell u from its mirror
        err = torch.minimum(ang(out["azimuth_deg"], SMP_AZ),
                            ang(out["azimuth_deg"], -SMP_AZ))
        bound, unit = EST_TRUTH["smp_deg"], "deg"
    elif name == "doa3d_tetra":
        err = torch.maximum(ang(out["azimuth_deg"], DOA3D_BEARING[0]),
                            (out["elevation_deg"] - DOA3D_BEARING[1]).abs())
        bound, unit = EST_TRUTH["doa3d_deg"], "deg"
    elif name == "volume_8mic":
        err = (out["xyz"] - torch.tensor(VOLUME_SOURCE, device=out[
            "xyz"].device)).norm(dim=-1)
        bound, unit = EST_TRUTH["volume_m"], "m"
    else:
        err = (out["xy"] - torch.tensor(FUSION_SOURCE, device=out[
            "xy"].device)).norm(dim=-1)
        bound, unit = EST_TRUTH["fusion_m"], "m"
    share = float((err < bound).float().mean())
    med = float(err.median())
    return (f"{share * 100:.3f}% of rows within {bound} {unit} of the "
            f"truth, median {med:.5f} {unit}"), share >= 0.95 and med < bound


def predicted_samples(xyz, mics):
    """TDOAs in samples [B, P] (float64) of sources xyz [B, 3]."""
    import torch
    from audio_triangulation_tpu_torch import geometry

    m3 = torch.zeros((mics.shape[0], 3), dtype=torch.float64)
    m3[:, :mics.shape[1]] = torch.as_tensor(mics, dtype=torch.float64)
    d = (xyz.double()[:, None] - m3).norm(dim=-1)
    pairs = torch.as_tensor(geometry.mic_pairs(mics.shape[0])).long()
    return (d[:, pairs[:, 1]] - d[:, pairs[:, 0]]) / 343.0 * 50_000.0


def est_cpu_check(name, cpu_est, frames, out) -> tuple[str, bool]:
    """A row-2 / SMP path's card result against the port's CPU path on its
    first ``EST_CPU_FRAMES`` rows, at the Tier-1 tests' tolerances, on the
    rows where both paths take the same integer decisions (every best
    shift and the score argmax; at least 95% of rows: the others hold a
    near tie that fp32 rounding decides): TDOAs 1e-3 samples (5e-3 under
    PHAT over the full band, which amplifies the products' rounding, as in
    tests/test_torch_multi.py), scores 1e-4
    of scale (5e-3 for the CLI's spherical configuration, PHAT over the
    full band of unwindowed frames, where each fp32 path lies up to 1.9e-3
    of scale from float64: 3.55e-3 apart on the H100), angles 1e-3 degrees, bearings 1e-5, grid peaks 1e-6 m, xy
    2e-4 m, free 3-D positions in measurement space (0.01 samples) and 2e-3
    m, rms 1e-5 m (5e-5 for the 3-D solve)."""
    import torch

    n = EST_CPU_FRAMES
    ref = cpu_est(frames[:n].cpu())
    got = {k: v[:n].cpu() for k, v in out.items()}
    shifts = got["best_shift"].reshape(n, -1) == ref["best_shift"].reshape(
        n, -1)
    clear = shifts.all(dim=-1) & (got["scores"].argmax(-1)
                                  == ref["scores"].argmax(-1))
    errs = {}

    def held(key, tol, *, rel_scale=False, rows=True):
        a, b = got[key].double(), ref[key].double()
        if rows:
            a, b = a[clear], b[clear]
        d = float((a - b).abs().max()) if a.numel() else 0.0
        if rel_scale:
            d /= float(ref[key].abs().max())
        errs[key] = d
        return d <= tol

    cfg = cpu_est.pipeline
    ok = bool(clear.float().mean() >= 0.95)
    ok &= held("tdoa_samples", 5e-3 if cfg.phat and cfg.band_hz is None
               else 1e-3)
    ok &= held("scores", 5e-3 if name == "doa3d_tetra" else 1e-4,
               rel_scale=True)
    if name.startswith("doa"):
        for k in ("azimuth_deg", "elevation_deg"):
            if k in ref:
                d = ((got[k] - ref[k] + 180.0) % 360.0 - 180.0)[clear].abs()
                errs[k] = float(d.max()) if d.numel() else 0.0
                ok &= errs[k] <= 1e-3
        ok &= held("bearing", 1e-5)
    elif name == "volume_8mic":
        mics = cpu_est.mic_positions.numpy()
        ok &= held("xyz_grid", 1e-6)
        dp = float((predicted_samples(got["xyz"][clear], mics)
                    - predicted_samples(ref["xyz"][clear], mics)).abs().max())
        errs["xyz_predicted_tdoa"] = dp
        ok &= dp <= 1e-2 and held("xyz", 2e-3) and held("rms_m", 5e-5)
    else:
        ok &= held("xy_grid", 1e-6) and held("xy", 2e-4)
        ok &= held("rms_m", 1e-5)
        c = (got["confidence"][clear] / ref["confidence"][clear] - 1).abs()
        errs["confidence_rel"] = float(c.max()) if c.numel() else 0.0
        ok &= errs["confidence_rel"] <= 1e-4
    text = (f"vs CPU path on {n} rows (same integer decisions on "
            f"{int(clear.sum())}): " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()))
    return text, bool(ok)


def row2_at_shape(card, results, name, flat, window, pairs, cfg,
                  float64_check):
    """Row 2 (the GCC kernel without peaks) at a path's shape: held to its
    plain version in float64 on ``CHECK_FRAMES`` frames when asked, at
    phase 2's 1e-4 of scale or within twice the plain version's own fp32
    distance from float64 where that is larger (PHAT over the full band of
    unwindowed frames: fp32 itself lies 1e-3 of scale away there), then
    timed in turns with the plain version against its bound."""
    import torch
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    ops = (*gcc_kernel.operands(flat, window, cfg), pairs)
    f, l = ops[1][2].shape
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, with_peaks=False)
    entry = {}
    if float64_check:
        head = flat[:CHECK_FRAMES]
        raw = gcc_kernel.launch(head, *ops, **kw)
        raw64 = gcc_kernel.gcc_reference(
            *(o.to(torch.float64) for o in (head, *ops[:2])), ops[2], **kw)
        scale = float(raw64.abs().max())
        err = float((raw.double() - raw64).abs().max()) / scale
        plain = gcc_kernel.gcc_reference(head, *ops, **kw)
        plain_err = float((plain.double() - raw64).abs().max()) / scale
        tol = max(1e-4, 2.0 * plain_err)
        say("13 estimators", f"gcc_kernel {name} without peaks: "
            f"{CHECK_FRAMES} frames vs the plain version in float64: "
            f"corr/scale err {err:.2e} (the plain version in fp32 "
            f"{plain_err:.2e}; tolerance {tol:.2e})")
        if not err <= tol:
            fail("13 estimators", f"{name}: row 2 disagrees with its plain "
                 "version")
        results["gcc_kernel"]["max_abs_err"] = max(
            results["gcc_kernel"]["max_abs_err"], err)
        entry["max_abs_err"] = err
        del raw, raw64, plain
    k_ms, p_ms = alternate_ms(
        lambda: gcc_kernel.gcc_reference(flat, *ops, **kw),
        lambda: gcc_kernel.launch(flat, *ops, **kw), reps=EST_KERNEL_REPS)
    b, m, n = flat.shape
    bnd = gcc_bound(b, m, n, f, pairs.shape[0], l, with_peaks=False,
                    split_products=True)
    pct = share_of_bound("13 estimators", f"gcc_kernel {name}", k_ms, bnd)
    say("13 estimators", f"gcc_kernel {name} without peaks (row 2: {b} "
        f"frames of {m} x {n}, {pairs.shape[0]} pairs, {f} bins, {l} lags; "
        f"{gcc_kernel._lib().att_gcc_frames_per_block(m, pairs.shape[0], l)}"
        f" frames a block): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {bnd['bound_ms']:.4f} ms by {bnd['bound_by']} (split), "
        f"{pct:.1f}% of it ({card})")
    results["gcc_kernel"][f"{name}_no_peaks"] = dict(
        ms=k_ms, plain_ms=p_ms, **entry, **bnd)


def expect_counts(name, kernels, phase="13 estimators") -> str:
    """Fail unless this call's launches equal the table: each of
    ``kernels`` once, every other kernel never."""
    return count_only(phase, name, dict.fromkeys(kernels, 1))


def host_reads(fn):
    """(fn(), the device-to-host reads it made): each synchronising op
    warns under ``torch.cuda.set_sync_debug_mode('warn')``."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in seen)


def subspace_snapshots(mics, n_snap=EST_SNAPSHOTS):
    """[S, M, 1,024] f32: ``examples/advanced.py``'s two independent sources
    on the 1.2 m sphere, a colored burst each per snapshot, noise 0.02."""
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(7)
    out = []
    for t in range(n_snap):
        acc = np.zeros((mics.shape[0], 1024))
        for k, xy in enumerate(SUBSPACE_SOURCES):
            sig = synth.colored_burst(1024, 50_000.0, seed=100 * (k + 1) + t)
            acc = acc + synth.synth_scene(place(xy), mics, signal=sig)[0]
        out.append(acc + rng.normal(0, 0.02, acc.shape))
    return np.stack(out).astype(np.float32)


def far_snapshots(mics, az_list, n_snap=EST_SNAPSHOTS):
    """[S, M, 1,024] f32: tests/test_doa_multisource.py's MUSIC scene,
    sources 60 m away with independent bursts (1,500 Hz tilt)."""
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(3)
    out = []
    for s in range(n_snap):
        acc = np.zeros((mics.shape[0], 1024))
        for k, az in enumerate(az_list):
            sig = synth.colored_burst(1024, 50_000.0, cutoff_hz=1500.0,
                                      seed=3 + 1000 * (k + 1) + s)
            a = np.radians(az)
            acc = acc + synth.synth_scene(
                np.array([60.0 * np.cos(a), 60.0 * np.sin(a), 0.0]), mics,
                signal=sig)[0]
        out.append(acc + rng.normal(0, 0.02, acc.shape))
    return np.stack(out).astype(np.float32)


def spectrum_check(kind, got, ref, grid=None) -> tuple[str, bool]:
    """A subspace or frequency spectrum on the card against the port's CPU
    path at the Tier-1 tests' tolerances: MVDR and CSSM (a band-limited
    configuration) per cell within 1e-4 and 1e-3 relative; frequency SRP
    1e-4 of scale; MUSIC over the full band its reciprocal within 2e-3
    (the fp32 eigensolvers of the CPU and the card each move the cells
    near the floor by up to 2e-2 and 3.4e-2 relative of float64:
    chip_precision.py, tests/test_torch_srp_freq.py); the refined peak
    within 2e-4 m, or the bearings equal, where the top cell is 1e-3 of
    scale clear."""
    g, r = got["scores"].double().cpu(), ref["scores"].double()
    if kind in ("mvdr", "cssm"):
        err = float(((g - r).abs() / r.abs()).max())
        ok = err <= {"mvdr": 1e-4, "cssm": 1e-3}[kind]
    elif kind == "freq":
        err = float((g - r).abs().max() / r.abs().max())
        ok = err <= 1e-4
    else:  # MUSIC over the full band: its reciprocal
        err = float((1.0 / g - 1.0 / r).abs().max())
        rel = float(((g - r).abs() / r).max())
        ok = err <= 2e-3
    flat = r.reshape(-1, r.shape[-1])
    top = flat.topk(2, dim=-1).values
    clear = (top[:, 0] - top[:, 1]) > DECISION_MARGIN * float(flat.abs().max())
    if "azimuth_deg" in ref:
        peak_ok = bool(np.array_equal(got["azimuth_deg"], ref["azimuth_deg"]))
        dpeak = 0.0 if peak_ok else float("inf")
    else:
        gxy = got["xy_grid"].cpu().reshape(-1, 2)[clear]
        rxy = ref["xy_grid"].reshape(-1, 2)[clear]
        dpeak = float((gxy - rxy).abs().max()) if gxy.numel() else 0.0
        peak_ok = dpeak <= 2e-4
    unit = (f"reciprocal abs ({rel:.2e} rel)" if kind == "music" else
            {"mvdr": "rel", "cssm": "rel", "freq": "of scale"}[kind])
    return (f"vs CPU path: spectrum {err:.2e} {unit}, peak {dpeak:.2e} on "
            f"{int(clear.sum())} of {clear.numel()} clear"), (
                ok and peak_ok and bool(clear.any()))


def phase_estimators(card, results):
    """The estimators beside the localizer at the published widths: the
    four row-2 frame-batch paths (``DoaEstimator``, ``Doa3dEstimator``,
    ``VolumeLocalizer`` in its gather form, ``ArrayFusionLocalizer``) and
    the SMP path at 16,384 frames, ``localize_sync`` on 256 events of three
    unsynchronised arrays (offset only and with drift), the subspace and
    frequency-domain spectra on ``examples/advanced.py``'s snapshots and
    ``register_arrays``.  Each path against the planted truth (the JAX
    package's test bounds) and the port's CPU path, its launches counted
    from 0 against the table (row 2 once a call on the row-2 paths, no
    kernel elsewhere), timed (median and IQR of 7 trials); row 2 held to
    float64 at the volume and spherical shapes and timed at all four."""
    import torch
    from audio_triangulation_tpu_torch import GridConfig, PipelineConfig
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models import doa, fusion
    from audio_triangulation_tpu_torch.models.fusion import (
        ArrayFusionLocalizer)
    from audio_triangulation_tpu_torch.ops import srp_freq
    from audio_triangulation_tpu_torch.utils import synth

    t0 = time.perf_counter()
    phase = "13 estimators"
    failures = []  # every path runs; the phase fails at its end
    for seed, (name, (make, event, kernels)) in enumerate(
            estimator_paths().items()):
        est, cpu_est = make("cuda"), make("cpu")
        frames = noisy(event, EST_FRAMES, SEED + 40 + seed)
        extra = ""
        if name == "volume_8mic":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        out = counted(name, results, lambda: est(frames))
        calls = expect_counts(name, kernels)
        if name == "volume_8mic":
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            g = est.pairs.shape[0] * est.volume.num_cells * 4 * EST_FRAMES
            extra = (f"; peak device memory {peak:.3f} GB above its inputs "
                     f"(the whole [B, P, G] gather would be {g / 1e9:.1f} GB)")
            if peak > 8.0:  # the whole gather never formed
                failures.append(f"{name} memory")
        truth, truth_ok = est_truth(name, out)
        text, cpu_ok = est_cpu_check(name, cpu_est, frames, out)
        finite = all(bool(torch.isfinite(v).all()) for v in out.values()
                     if v.is_floating_point())
        say(phase, f"{name}: {EST_FRAMES} x {tuple(event.shape)}: {calls} "
            f"in the call; {truth}; {text}{extra}")
        if not (truth_ok and cpu_ok and finite):
            failures.append(name)
        del out
        time_path(card, name, lambda: est(frames), EST_FRAMES, phase)
        if kernels:
            flat = frames.reshape(-1, *event.shape[-2:])
            row2_at_shape(card, results, name, flat, est.window, est.pairs,
                          est.pipeline, name in ("volume_8mic",
                                                 "doa3d_tetra"))
        del frames, est
        torch.cuda.empty_cache()

    # ---- localize_sync: 256 events of three free-running arrays ------------
    cfg = PipelineConfig(phat=True, band_hz=(700.0, 7000.0))
    fus = ArrayFusionLocalizer.create(sync_arrays(), cfg, device="cuda")
    cpu_fus = ArrayFusionLocalizer.create(sync_arrays(), cfg, device="cpu")
    for name, drift in (("fusion_sync_3x4", False),
                        ("fusion_sync_3x4_drift", True)):
        # the truth on the JAX package's own scenes (tests/test_sync_fusion.py:
        # six events offset only, eight over 30 s with drift), whose bounds
        # hold there; parity and timing on 256 events of its eight sources
        n_small = 8 if drift else 6
        small, t_small, src_small = sync_scene(n_small, 11 if drift else 7,
                                               drift)
        res = fus.localize_sync(torch.from_numpy(small).cuda(),
                                event_times_s=t_small)
        e_xy = float((res["xy_sync"].cpu() - torch.from_numpy(
            src_small).float()).norm(dim=-1).max())
        if drift:
            e_clock = float((res["clock_drift"].cpu().double() - torch.tensor(
                SYNC_DRIFTS[1:])).abs().max())
            truth_ok = e_clock < EST_TRUTH["sync_drift"]
            truth = f"drift {e_clock:.2e} s/s"
        else:
            e_clock = float((res["clock_offsets_s"].cpu().double()
                             - torch.tensor(SYNC_OFFSETS[1:]) / 50_000.0)
                            .abs().max()) * 50_000.0
            truth_ok = e_clock < EST_TRUTH["sync_offset_samples"]
            truth = f"offsets {e_clock:.4f} samples"
        truth_ok &= e_xy < EST_TRUTH["sync_m"]
        ev, t, src = sync_scene(SYNC_EVENTS, SEED + 51, drift)
        frames = torch.from_numpy(ev).cuda()
        out = counted(name, results,
                      lambda: fus.localize_sync(frames, event_times_s=t))
        calls = expect_counts(name, ("gcc_kernel",))
        ref = cpu_fus.localize_sync(frames.cpu(), event_times_s=t)
        got = {k: v.cpu() for k, v in out.items()}
        errs = {"clock_offsets_samples": float(
            (got["clock_offsets_s"] - ref["clock_offsets_s"]).abs().max())
            * 50_000.0}
        for k, tol in (("xy_sync", 2e-4), ("tdoa_cross", 1e-3),
                       ("sync_rms_m", 1e-5), ("clock_drift", 1e-9)):
            if k in ref:
                errs[k] = float((got[k] - ref[k]).abs().max())
        ok = (errs["clock_offsets_samples"] <= 1e-3 and errs["xy_sync"] <= 2e-4
              and errs["tdoa_cross"] <= 1e-3 and errs["sync_rms_m"] <= 1e-5
              and errs.get("clock_drift", 0.0) <= 1e-9)
        err = (got["xy_sync"] - torch.from_numpy(src).float()).norm(dim=-1)
        share = float((err < EST_TRUTH["sync_m"]).float().mean())
        say(phase, f"{name}: {SYNC_EVENTS} events of 3 x 4 x 1,024: {calls}"
            f" in the call; the JAX package's {n_small}-event scene: {truth}"
            f" and xy_sync {e_xy:.4f} m from the truth; here xy_sync within "
            f"8 cm on {share * 100:.2f}% (median {float(err.median()):.4f} "
            f"m); vs CPU path on the whole scene: " + ", ".join(
                f"{k} {v:.2e}" for k, v in errs.items()))
        if not (ok and truth_ok and float(err.median()) < EST_TRUTH["sync_m"]):
            failures.append(name)
        time_path(card, name, lambda: fus.localize_sync(
            frames, event_times_s=t), SYNC_EVENTS, phase)

    # ---- the subspace and frequency-domain spectra (no kernel) -------------
    mics8 = geometry.circular_array(8, 0.15)
    grid = GridConfig(half_cells_x=40, half_cells_y=40, cells_per_m=20.0)
    snaps = subspace_snapshots(mics8)
    far = far_snapshots(mics8, MUSIC_DOA_AZ)
    s1 = synth.synth_scene(place(SUBSPACE_SOURCES[0]), mics8)[0].astype(
        np.float32)
    freq_frames = noisy(s1, FREQ_FRAMES, SEED + 52)
    band = PipelineConfig(band_hz=(800.0, 6000.0))
    spectra = {
        "music_8mic": ("music", snaps, lambda f: srp_freq.localize_music(
            f, mics8, grid, PipelineConfig(), n_sources=2)),
        "music_8mic_auto": ("music", snaps, lambda f: srp_freq.localize_music(
            f, mics8, grid, PipelineConfig(), n_sources="auto")),
        "mvdr_8mic": ("mvdr", snaps, lambda f: srp_freq.localize_mvdr(
            f, mics8, grid, PipelineConfig())),
        "freq_8mic": ("freq", None, lambda f: srp_freq.localize_freq(
            f, mics8, grid, PipelineConfig(phat=True))),
        "music_coherent": ("cssm", snaps, lambda f: srp_freq.localize_music(
            f, mics8, grid, band, n_sources=2, coherent=True)),
        "doa_music": ("music", far, lambda f: doa.estimate_doa_music(
            f, mics8, PipelineConfig(), n_sources=2)),
    }
    for name, (kind, frames_np, fn) in spectra.items():
        frames = (freq_frames if frames_np is None
                  else torch.from_numpy(frames_np).cuda())
        fn(frames)  # the constants on the card, once
        torch.cuda.synchronize()
        (out, reads) = counted(name, results, lambda: host_reads(
            lambda: fn(frames)))
        calls = expect_counts(name, ())
        ref = fn(frames.cpu())
        text, ok = spectrum_check(kind, out, ref)
        if name == "doa_music":
            err = max(float(np.abs((out["azimuth_deg"] - az + 180.0) % 360.0
                                   - 180.0).min()) for az in MUSIC_DOA_AZ)
            truth_ok = err < EST_TRUTH["music_doa_deg"]
            truth = f"bearings {out['azimuth_deg']}, {err:.2f} deg off"
        else:
            xy = out["xy_grid"].reshape(-1, 2).cpu()
            d = torch.stack([(xy - torch.tensor(s)).norm(dim=-1)
                             for s in SUBSPACE_SOURCES]).amin(0)
            truth_ok = float((d < EST_TRUTH["spectrum_m"]).float().mean()
                             ) >= 0.99
            truth = (f"peak within {float(d.median()):.4f} m of a source "
                     f"(median)")
        n_src = out.get("n_sources_estimated", out.get("n_sources", ""))
        say(phase, f"{name}: {tuple(frames.shape)}: {calls}; host reads "
            f"{reads}; sources {n_src}; {truth}; {text}")
        if not (ok and truth_ok):
            failures.append(name)
        time_path(card, name, lambda: fn(frames), frames.shape[0], phase)

    # ---- register_arrays: K = 4 arrays, E = 64 events ----------------------
    rng = np.random.default_rng(SEED + 53)
    angs = rng.uniform(-np.pi, np.pi, REG_ARRAYS)
    angs[0] = 0.0
    trs = rng.uniform(-2.0, 2.0, (REG_ARRAYS, 2))
    trs[0] = 0.0
    world = rng.uniform(-2.0, 2.0, (REG_EVENTS, 2))
    local = np.stack([(world - t) @ np.array([[np.cos(a), -np.sin(a)],
                                               [np.sin(a), np.cos(a)]])
                      for a, t in zip(angs, trs)])
    local = (local + rng.normal(0, 0.01, local.shape)).astype(np.float32)
    local_t = torch.from_numpy(local).cuda()
    out = counted("register", results,
                  lambda: fusion.register_arrays(local_t))
    calls = expect_counts("register", ())
    ref = fusion.register_arrays(torch.from_numpy(local))
    d = max(float((out[k].cpu() - ref[k]).abs().max()) for k in ref)
    rot_true = np.stack([[[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
                         for a in angs])
    e_rot = float(np.abs(out["rot"].cpu().numpy() - rot_true).max())
    e_tr = float(np.abs(out["trans"].cpu().numpy() - trs).max())
    say(phase, f"register: {REG_ARRAYS} arrays x {REG_EVENTS} events: "
        f"{calls}; rot {e_rot:.2e}, trans {e_tr:.2e} m from the truth; vs "
        f"CPU path {d:.2e}")
    if not (d <= 1e-5 and e_rot < EST_TRUTH["reg_rot"]
            and e_tr < EST_TRUTH["reg_trans_m"]):
        failures.append("register")
    time_path(card, "register", lambda: fusion.register_arrays(local_t),
              REG_EVENTS, phase)
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


ROOM_SOURCES = 1024  # simulate_batch: sources of 1,024 samples a call
ROOM_SHIFT = (3.0, 2.5, 0.3)  # examples/advanced.py: the array in the room
ROOM_CPU_SOURCES = 8  # of them held to the port's CPU path
ROOM_NUMPY_SOURCES = 4  # and to the float64 numpy simulate
WPE_BATCH = 64  # wpe: recordings of 4 x WPE_SAMPLES a call
WPE_SAMPLES = 16384
WPE_LONG_SAMPLES = 1 << 21  # and one recording of 42 s
WPE_KW = dict(frame=1024, hop=256, taps=10, delay=4)  # iters: the default 3
WPE_TAIL = slice(6000, 16000)  # the example's reverberant tail
# the JAX package's float32 cut of the example's tail (tests/witness_wpe.py)
WPE_TAIL_FLOOR_DB = 20.60
DVB_COUNTS = (256, 1024)  # streams a timed StreamingDereverb.step_many
DVB_STREAMS = 1024  # dereverbed streams fed to the StreamingLocalizer
DVB_CPU_STREAMS = 8  # of them held to the port's CPU path
DVB_CPU_CHUNKS = 4  # chunks held to it: 8 RLS frames
DVB_DRIFT_CHUNKS = 200  # one stream, card and CPU: the RLS drift
EXTRACT_DAS_FRAMES = 16384  # Localizer.extract, xy omitted
EXTRACT_MVDR_FRAMES = 4096
EXTRACT_CPU_FRAMES = 8
EXTRACTOR_STREAMS = 1024  # StreamingExtractor.step_many
EXTRACTOR_CPU_STREAMS = 4
EXTRACTOR_SAMPLES = 8192  # examples/production.py's stream
TWORATE_STREAMS = 1024  # TwoRateStreamingLocalizer with_audio
TWORATE_BURST_EVERY = 16
TWORATE_CPU_STREAMS = 64
MAP_FRAMES = 16384  # ReflectorMapper.echo_delays
MAP_EVENTS = 64  # ReflectorMapper.map
# the JAX tests' two-wall room (tests/test_mapping.py:124-136): walls at
# 1.2 m along +x and 1.5 m along -y of the array
MAP_CENTER = (4.8, 1.5)
MAP_ABSORPTION = (0.99, 0.02, 0.02, 0.99, 0.99, 0.99)
MAP_TEST_SOURCES = ((0.3, 0.2), (0.1, -0.4), (-0.4, 0.35))
MAP_WALLS = (((1.0, 0.0), 1.2, 0.2), ((0.0, -1.0), 1.5, 0.2))


def time_ms(fn):
    """(median, q1, q3) ms a call of ``fn()`` over ``TRIALS`` calls: the
    bench tool's host clock around a synchronised device."""
    from audio_triangulation_tpu_torch.tools.bench import frames_per_s

    med, q1, q3 = frames_per_s(fn, 1, TRIALS, "cuda")
    return 1e3 / med, 1e3 / q3, 1e3 / q1


def ms_text(t) -> str:
    return f"{t[0]:.4f} ms a call (IQR {t[1]:.4f}-{t[2]:.4f}, {TRIALS} trials)"


def peak_gb(fn):
    """(fn(), its peak device memory in GB above what was allocated
    before)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def rel_gap(got, ref) -> float:
    """max |got - ref| over ref's largest magnitude, on the CPU."""
    import torch

    ref = torch.as_tensor(ref).cpu().to(torch.float64)
    got = torch.as_tensor(got).cpu().to(torch.float64)
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def count_only(phase, name, want) -> str:
    """Fail unless this run's launches equal ``want`` ({kernel: n}, every
    other kernel 0)."""
    counts = launch_counts()
    full = {k: want.get(k, 0) for k in counts}
    if counts != full:
        fail(phase, f"{name}: launches {counts}, expected "
             f"{ {k: v for k, v in full.items() if v} or 'none'}")
    return ", ".join(f"{k} x{v}" for k, v in want.items()) or "no kernel"


def wpe_example_scene():
    """[4, 16,384] float64: ``examples/advanced.py``'s WPE scene: a tiled
    chirp at (4.2, 3.4, 1.2) in the 6 x 5 x 3 m room of RT60 0.45 s
    (``max_order=6``), 4 mics of a 0.25 m circle at 1.2 m, noise 0.002."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import room, synth

    size = (6.0, 5.0, 3.0)
    rm = room.ShoeboxRoom(size=size, absorption=room.absorption_for_rt60(
        size, 0.45), max_order=6)
    return room.simulate(np.array([4.2, 3.4, 1.2]), wpe_mics3(), rm,
                         n=WPE_SAMPLES, signal=np.tile(
                             synth.chirp_burst(4096, 50_000.0), 4),
                         noise_rms=0.002)[0]


def wpe_mics3():
    from audio_triangulation_tpu_torch import geometry

    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = np.asarray(geometry.circular_array(4, 0.25)) + [3.0, 2.5]
    mic3[:, 2] = 1.2
    return mic3


def tail_cut_db(wet, dry) -> float:
    """The example's print: how far WPE cut the reverberant tail, in dB."""
    wet, dry = np.asarray(wet, np.float64), np.asarray(dry, np.float64)
    return float(-10 * np.log10(np.mean(dry[..., WPE_TAIL] ** 2)
                                / np.mean(wet[..., WPE_TAIL] ** 2)))


def reverb_room(phase, card, results, failures):
    """``room.simulate_batch``: 1,024 sources in the example's room."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import room, synth

    mic3 = np.zeros((4, 3))
    mic3[:, :2] = geometry.square_array(0.3)
    mic3 += ROOM_SHIFT
    rm = room.ShoeboxRoom(size=(6.0, 5.0, 3.0), absorption=0.3, max_order=6)
    rng = np.random.default_rng(SEED + 60)
    src = np.concatenate([rng.uniform(-1.0, 1.0, (ROOM_SOURCES, 2)),
                          np.full((ROOM_SOURCES, 1), 1.2)], 1) + ROOM_SHIFT
    sig = synth.colored_burst(1024, 50_000.0, seed=5)

    def run():
        return room.simulate_batch(src, mic3, rm, signal=sig, device="cuda")

    out, peak = peak_gb(lambda: counted("room_batch", results, run))
    calls = count_only(phase, "room_batch", {})
    k = room.image_sources(src[0], rm)[0].shape[0]
    per = room.slice_sources(4, k, 513)
    ref64 = np.concatenate([room.simulate(s, mic3, rm, signal=sig)
                            for s in src[:ROOM_NUMPY_SOURCES]])
    e64 = float(np.abs(out[:ROOM_NUMPY_SOURCES].cpu().numpy() - ref64).max())
    cpu = room.simulate_batch(src[:ROOM_CPU_SOURCES], mic3, rm, signal=sig,
                              device="cpu")
    ecpu = rel_gap(out[:ROOM_CPU_SOURCES], cpu)
    finite = bool(torch.isfinite(out).all()) and out.shape == (
        ROOM_SOURCES, 4, 1024)
    t = time_ms(run)
    say(phase, f"room_batch: {ROOM_SOURCES} sources x 4 mics x 1,024, "
        f"{k} images, {per} sources a slice ({-(-ROOM_SOURCES // per)} "
        f"slice(s)): {calls}; vs float64 simulate on "
        f"{ROOM_NUMPY_SOURCES}: {e64:.2e} (JAX test bound 2e-4); vs CPU path "
        f"on {ROOM_CPU_SOURCES}: {ecpu:.2e} of scale (1e-4); {ms_text(t)}; "
        f"peak {peak:.3f} GB ({card})")
    if not (finite and e64 < 2e-4 and ecpu <= 1e-4):
        failures.append("room_batch")


def reverb_wpe(phase, card, results, failures):
    """Block WPE at the example's configuration: 64 recordings of 16,384
    samples a call, and one of 2^21."""
    import torch
    from audio_triangulation_tpu_torch.ops import dereverb
    from audio_triangulation_tpu_torch.utils import room, synth

    wet = wpe_example_scene()
    wet_t = torch.from_numpy(wet.astype(np.float32)).cuda()
    dry = dereverb.wpe(wet_t, **WPE_KW)
    cut = tail_cut_db(wet, dry.cpu().numpy())
    # placed in float64: the port's CPU float32 and the card against the
    # CPU float64 recursion (float32 block WPE is unstable here)
    cpu32 = dereverb.wpe(wet_t.cpu(), **WPE_KW)
    f64 = dereverb.wpe(torch.from_numpy(wet), **WPE_KW)
    g_card, g_cpu = rel_gap(dry, f64), rel_gap(cpu32, f64)
    placed = g_card <= 4.0 * g_cpu + 1e-5
    say(phase, f"wpe_block: the example's scene: tail cut {cut:.2f} dB on "
        f"the card (floor {WPE_TAIL_FLOOR_DB} dB: the JAX package's float32;"
        f" port CPU float32 {tail_cut_db(wet, cpu32.numpy()):.2f}, float64 "
        f"{tail_cut_db(wet, f64.numpy()):.2f}); from float64, of scale: card "
        f"{g_card:.3e}, CPU float32 {g_cpu:.3e}, card vs CPU "
        f"{rel_gap(dry, cpu32):.3e} (the card within 4x the CPU's: "
        f"{placed})")
    if not (cut >= WPE_TAIL_FLOOR_DB and placed
            and bool(torch.isfinite(dry).all())):
        failures.append("wpe_block example")
    # 64 recordings: the example's chirp from 64 points near its source
    rng = np.random.default_rng(SEED + 61)
    src = np.array([4.2, 3.4, 1.2]) + np.concatenate(
        [rng.uniform(-0.4, 0.4, (WPE_BATCH, 2)), np.zeros((WPE_BATCH, 1))],
        1)
    size = (6.0, 5.0, 3.0)
    rm = room.ShoeboxRoom(size=size, absorption=room.absorption_for_rt60(
        size, 0.45), max_order=6)
    batch = room.simulate_batch(src, wpe_mics3(), rm, n=WPE_SAMPLES,
                                signal=np.tile(synth.chirp_burst(
                                    4096, 50_000.0), 4), device="cuda")
    batch += torch.from_numpy(rng.normal(0.0, 0.002, batch.shape).astype(
        np.float32)).cuda()
    out, peak = peak_gb(lambda: counted(
        "wpe_block", results, lambda: dereverb.wpe(batch, **WPE_KW)))
    calls = count_only(phase, "wpe_block", {})
    cuts = [tail_cut_db(w, d) for w, d in zip(batch.cpu().numpy(),
                                              out.cpu().numpy())]
    t = time_ms(lambda: dereverb.wpe(batch, **WPE_KW))
    say(phase, f"wpe_block: {WPE_BATCH} x 4 x {WPE_SAMPLES} (61 frames, 513"
        f" bins, MK = 40, 3 passes): {calls}; tail cut median "
        f"{np.median(cuts):.2f} dB (min {min(cuts):.2f}); {ms_text(t)}; "
        f"peak {peak:.3f} GB ({card})")
    if not (bool(torch.isfinite(out).all()) and min(cuts) > 0.0):
        failures.append("wpe_block batch")
    del batch, out
    reps = WPE_LONG_SAMPLES // WPE_SAMPLES
    long = wet_t.repeat(1, reps)  # the chirp train is periodic: exact
    long += torch.from_numpy(rng.normal(0.0, 0.002, long.shape).astype(
        np.float32)).cuda()
    out, peak = peak_gb(lambda: counted(
        "wpe_long", results, lambda: dereverb.wpe(long, **WPE_KW)))
    calls = count_only(phase, "wpe_long", {})
    t = time_ms(lambda: dereverb.wpe(long, **WPE_KW))
    say(phase, f"wpe_long: 4 x {WPE_LONG_SAMPLES} ({WPE_LONG_SAMPLES / 5e4:.1f}"
        f" s, {(WPE_LONG_SAMPLES - 1024) // 256 + 1} frames): {calls}; tail "
        f"cut of its first period "
        f"{tail_cut_db(long[:, :WPE_SAMPLES].cpu(), out[:, :WPE_SAMPLES].cpu()):.2f}"
        f" dB; {ms_text(t)}; peak {peak:.3f} GB ({card})")
    if not bool(torch.isfinite(out).all()):
        failures.append("wpe_long")


def carried(step, states):
    """A call that steps ``states`` on: ``step(states) -> (states, out)``."""
    box = [states]

    def call():
        box[0], out = step(box[0])
        return out

    return call


def reverb_dereverb_stream(phase, card, results, failures):
    """``StreamingDereverb`` (the CLI's ``stream --dereverb``) on the
    reference array, its chunks fed to ``StreamingLocalizer.step_many``."""
    import torch
    from audio_triangulation_tpu_torch import (StreamConfig,
                                               StreamingLocalizer, geometry)
    from audio_triangulation_tpu_torch.ops import dereverb
    from audio_triangulation_tpu_torch.utils import convert

    c = STREAM_CHUNK
    sd = dereverb.StreamingDereverb(3, frame=1024, hop=256, device="cuda")
    cpu_sd = dereverb.StreamingDereverb(3, frame=1024, hop=256, device="cpu")
    x, planted, xy_true, _ = stream_scene(DVB_STREAMS, SEED + 62)
    # samples about the ADC's midpoint, led by two chunks of idle samples:
    # the dereverberator's first latency_samples out are zeros, and the
    # localizer starts on its third chunk out, past that edge
    lead = np.random.default_rng(SEED + 62).integers(
        127, 130, (DVB_STREAMS, 3, 2 * c)).astype(np.float32)
    x = torch.from_numpy(np.concatenate([lead, x], -1) - 128.0).cuda()
    n_steps = x.shape[-1] // c
    # (1) the JAX tests' properties: the stream equals one long wpe_rls over
    # the lead-padded samples (1e-6 of scale), step_many equals a loop of
    # step (1e-6)
    one = x[0, :, :16 * c]
    st, ys = sd.init_state(), []
    for i in range(16):
        st, y = sd.step(st, one[:, i * c:(i + 1) * c])
        ys.append(y)
    lat = sd.latency_samples
    full, _ = dereverb.wpe_rls(torch.nn.functional.pad(one, (lat, 0)),
                               frame=1024, hop=256, taps=10, delay=4,
                               alpha=0.998)
    span = 16 * c - 1024  # the JAX test's span: all but the last frame
    e_oneshot = rel_gap(torch.cat(ys, -1)[:, lat:lat + span],
                        full[:, lat:lat + span])
    sts = sd.init_states(4)
    sts, ym = sd.step_many(sts, x[:4, :, :c])
    sts, ym = sd.step_many(sts, x[:4, :, c:2 * c])
    e_loop = 0.0
    for i in range(4):
        s1, _ = sd.step(sd.init_state(), x[i, :, :c])
        s1, y1 = sd.step(s1, x[i, :, c:2 * c])
        e_loop = max(e_loop, float((ym[i] - y1).abs().max()))
    # (2) the CPU path on a cut: 8 streams x 4 chunks (8 RLS frames)
    g_st, c_st = sd.init_states(DVB_CPU_STREAMS), cpu_sd.init_states(
        DVB_CPU_STREAMS)
    gys, cys = [], []
    for i in range(DVB_CPU_CHUNKS):
        chunk = x[:DVB_CPU_STREAMS, :, i * c:(i + 1) * c]
        g_st, gy = sd.step_many(g_st, chunk)
        c_st, cy = cpu_sd.step_many(c_st, chunk.cpu())
        gys.append(gy)
        cys.append(cy)
    e_cpu = rel_gap(torch.cat(gys, -1), torch.cat(cys, -1))
    ok = e_oneshot <= 1e-6 and e_loop <= 1e-6 and e_cpu <= 1e-4
    # (3) the RLS drift over a long run, placed in float64: one stream
    # (its 24 chunks in a cycle) through wpe_rls, the stream's recursion
    kw = dict(frame=1024, hop=256, taps=10, delay=4, alpha=0.998)
    src = x[planted[0]].repeat(1, -(-DVB_DRIFT_CHUNKS // n_steps))[
        :, :DVB_DRIFT_CHUNKS * c]
    yg, sg = dereverb.wpe_rls(src, **kw)
    yc, _ = dereverb.wpe_rls(src.cpu(), **kw)
    y64, _ = dereverb.wpe_rls(src.cpu().double(), **kw)
    scale = float(y64.abs().max())
    drift = []
    for n in sorted({4, 25, 100, DVB_DRIFT_CHUNKS}):
        if n > DVB_DRIFT_CHUNKS:
            continue
        seg = slice((n - 1) * c, n * c)
        drift.append(f"{n}: " + " / ".join(
            f"{float((a[:, seg].cpu().double() - b[:, seg]).abs().max()) / scale:.2e}"
            for a, b in ((yg, yc), (yg, y64), (yc, y64))))
    kinv = convert.dereverb_state_to_numpy(
        dereverb.DereverbState(wpe=sg, in_tail=src, out_tail=src))[
            "wpe"]["kinv"]
    herm = float(np.abs(kinv - np.conj(np.swapaxes(kinv, -1, -2))).max()
                 / np.abs(kinv).max())
    say(phase, f"dereverb_stream: vs one long wpe_rls {e_oneshot:.2e} of "
        f"scale (JAX test bound 1e-6); step_many vs step {e_loop:.2e} "
        f"(1e-6); vs CPU path on {DVB_CPU_STREAMS} streams x "
        f"{DVB_CPU_CHUNKS} chunks {e_cpu:.2e} of scale (1e-4); the RLS "
        f"drift on one stream, in chunk n, card vs CPU / card vs float64 / "
        f"CPU vs float64, of scale: " + ", ".join(drift) + f"; the card's "
        f"kinv's departure from Hermitian after {DVB_DRIFT_CHUNKS} chunks "
        f"{herm:.2e} of scale")
    if not ok:
        failures.append("dereverb_stream checks")
    # (4) dereverbed chunks through the streaming localizer, launches counted
    sl = StreamingLocalizer.create(geometry.reference_array(),
                                   stream=StreamConfig(chunk_size=c),
                                   device="cuda")

    def run():
        dst, lst, events = sd.init_states(DVB_STREAMS), sl.init_states(
            DVB_STREAMS), []
        for i in range(n_steps):
            dst, y = sd.step_many(dst, x[:, :, i * c:(i + 1) * c])
            if i >= 2:
                lst, out = sl.step_many(lst, y)
                events.append((out["event"], out["xy"]))
        return events

    events, peak = peak_gb(lambda: counted("dereverb_stream", results, run))
    calls = count_only(phase, "dereverb_stream",
                       {"detector_scan_kernel": n_steps - 2})
    ev = torch.stack([e for e, _ in events]).cpu().numpy()  # [T, S]
    xy = torch.stack([p for _, p in events]).cpu().numpy()  # [T, S, 2]
    # each burst's event: the first in the chunks where the burst (at
    # `start` in the scene, `start + lat` in the localizer's input) can
    # trigger; the RLS's output noise grows on idle input (the reference's
    # too: tests/witness_wpe.py), so idle streams may trigger elsewhere
    starts = np.asarray(STREAM_STARTS)[np.arange(planted.size)
                                       % len(STREAM_STARTS)]
    found, err = 0, []
    for s_idx, at, truth in zip(planted, starts, xy_true):
        lo = (at + lat) // c
        hits = np.nonzero(ev[lo:lo + 4, s_idx])[0]
        if hits.size:
            found += 1
            err.append(np.linalg.norm(xy[lo + hits[0], s_idx] - truth))
    quiet = np.setdiff1d(np.arange(DVB_STREAMS), planted)
    med = float(np.median(err)) if err else float("nan")
    say(phase, f"dereverb_stream -> StreamingLocalizer: {DVB_STREAMS} "
        f"streams x {n_steps} chunks of {c} (the localizer on the last "
        f"{n_steps - 2}): {calls}; the burst's event on {found} of "
        f"{planted.size} planted streams, median |xy - truth| "
        f"{med * 100:.4f} cm (bound "
        f"{STREAM_MEDIAN_BOUND_M['default'] * 100:.1f} cm); events on {int(ev[:, quiet].any(0).sum())} of {quiet.size} "
        f"idle streams; peak {peak:.3f} GB")
    if not (found == planted.size
            and med < STREAM_MEDIAN_BOUND_M["default"]):
        failures.append("dereverb_stream events")
    st1 = sd.init_state()
    t1 = time_ms(carried(lambda s: sd.step(s, x[0, :, :c]), st1))
    line = [f"step on 1 stream {ms_text(t1)}"]
    for n in DVB_COUNTS:
        t = time_ms(carried(lambda s: sd.step_many(s, x[:n, :, :c]),
                            sd.init_states(n)))
        line.append(f"step_many at {n} streams {ms_text(t)}, "
                    f"{n * 10.24 / t[0]:.0f} streams in real time")
    say(phase, "dereverb_stream: " + "; ".join(line) + f" ({card})")


SOURCE1_XY = (0.9, 0.3)  # examples/advanced.py's two sources
SOURCE2_XY = (-0.7, -0.6)


def advanced_two_sources(mics8):
    """``examples/advanced.py:36-42``: source 1 (a chirp) and source 2 (a
    2-9 kHz chirp) on the 1.2 m sphere: (both [M, 1,024] f32, source 1
    alone, source 1's emitted burst)."""
    from audio_triangulation_tpu_torch.utils import synth

    sig2 = synth.chirp_burst(1024, 50_000.0, f0=2000, f1=9000, center=0.45)
    one = synth.synth_scene(place(SOURCE1_XY), mics8, seed=2)[0]
    mixed = one + synth.synth_scene(place(SOURCE2_XY), mics8, signal=sig2,
                                    seed=3)[0]
    return (mixed.astype(np.float32), one.astype(np.float32),
            synth.chirp_burst(1024, 50_000.0))


def corr_peak(a, b) -> float:
    """tests/test_beamform.py's alignment-free similarity."""
    a, b = a - a.mean(), b - b.mean()
    c = np.correlate(a, b, mode="full")
    return float(np.max(np.abs(c)) / (np.linalg.norm(a) * np.linalg.norm(b)
                                       + 1e-12))


def loc_vs_cpu(loc, cpu_loc, frames) -> tuple[str, bool]:
    """Rows 1 and 5 on the card against their plain versions (the CPU
    path) on the same frames: xy within 2e-4 m, tdoa within 1e-3 samples,
    best shifts equal."""
    import torch

    out, ref = loc(frames), cpu_loc(frames.cpu())
    dxy = float((out["xy"].cpu() - ref["xy"]).abs().max())
    dt = float((out["tdoa_samples"].cpu() - ref["tdoa_samples"]).abs().max())
    eq = bool(torch.equal(out["best_shift"].cpu(), ref["best_shift"]))
    return (f"rows 1 and 5 vs their plain versions on {frames.shape[0]} "
            f"frames: xy {dxy:.2e} m, tdoa {dt:.2e} samples, shifts equal "
            f"{eq}", dxy <= 2e-4 and dt <= 1e-3 and eq)


def route_text(loc) -> str:
    from audio_triangulation_tpu_torch.models.localizer import kernel_route

    return (f"route: GCC kernel {kernel_route(loc.pipeline)}, GN kernel "
            f"{loc.gn is not None}")


def reverb_extract(phase, card, results, failures):
    """``Localizer.extract`` with ``xy`` omitted on the 8-mic circle."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.ops import beamform

    mics8 = geometry.circular_array(8, 0.15)
    cfg = PipelineConfig(phat=True)
    loc = Localizer.create(mics8, cfg, device="cuda")
    cpu_loc = Localizer.create(mics8, cfg, device="cpu")
    mixed, source1, sig1 = advanced_two_sources(mics8)
    frames = noisy(mixed, EXTRACT_DAS_FRAMES, SEED + 63)
    text, ok = loc_vs_cpu(loc, cpu_loc, frames[:256])
    say(phase, f"extract_8mic: {route_text(loc)}; {text}")
    head = frames[:EXTRACT_CPU_FRAMES]
    xy_head = loc(head)["xy"]
    fid = {}
    for method, n in (("das", EXTRACT_DAS_FRAMES),
                      ("mvdr", EXTRACT_MVDR_FRAMES)):
        name = f"extract_8mic_{method}"
        f = frames[:n]
        out, peak = peak_gb(lambda: counted(
            name, results, lambda: loc.extract(f, method=method)))
        calls = expect_counts(name, ("gcc_kernel", "gn_kernel"), phase)
        fid[method] = np.median([corr_peak(y, sig1)
                                 for y in out[:64].cpu().numpy()])
        # the beamformer alone against the CPU path: the card's positions
        # given to both
        e_cpu = rel_gap(loc.extract(head, xy_head, method=method),
                        cpu_loc.extract(head.cpu(), xy_head.cpu(),
                                        method=method))
        t = time_ms(lambda: loc.extract(f, method=method))
        say(phase, f"{name}: {n} frames of 8 x 1,024, xy omitted: {calls};"
            f" fidelity to source 1's burst, median of 64 frames "
            f"{fid[method]:.3f}; at the same positions vs CPU path on "
            f"{EXTRACT_CPU_FRAMES} frames {e_cpu:.2e} of scale (1e-4); "
            f"{ms_text(t)}; peak {peak:.3f} GB ({card})")
        ok &= e_cpu <= 1e-4 and bool(torch.isfinite(out).all())
        del out
    # tests/test_beamform.py's fidelity and suppression, steered at source
    # 1's position as the test steers: MVDR's fidelity over 0.6, its
    # residual after the target's projection under 0.6 of DAS's
    f = frames[:64]
    xy1 = torch.tensor(SOURCE1_XY, device="cuda").expand(64, 2)
    das = loc.extract(f, xy1).cpu().numpy()
    mv = loc.extract(f, xy1, method="mvdr").cpu().numpy()
    delays = beamform.source_delays(xy1[:1], loc.mic_positions, cfg,
                                    height=loc.grid.height_m)
    s1 = torch.from_numpy(source1).cuda()
    ref = beamform.extract_das(s1, delays[0], cfg).cpu().numpy()

    def resid(v):
        return float(np.var(v - ref * (np.dot(v, ref) / np.dot(ref, ref))))

    c_mv = float(np.median([corr_peak(y, sig1) for y in mv]))
    c_das = float(np.median([corr_peak(y, sig1) for y in das]))
    ratio = float(np.median([resid(a) / resid(b) for a, b in zip(mv, das)]))
    xy_med = loc(f)["xy"].median(0).values.cpu().numpy()
    say(phase, f"extract_8mic: steered at source 1 {SOURCE1_XY}, medians "
        f"of 64 frames: fidelity mvdr {c_mv:.3f}, das {c_das:.3f}; source "
        f"2's residual, mvdr / das {ratio:.3f} (bounds 0.6, 0.6); with xy "
        f"omitted the localizer puts the two-source frames at "
        f"{np.round(xy_med, 3)} (median), between the sources")
    if not (ok and c_mv > 0.6 and ratio < 0.6):
        failures.append("extract_8mic")


def production_stream():
    """``examples/production.py:117-145``: band-limited noise (300-8,000
    Hz) from (0.5, 0.4, 1.0) at the 4-mic square, fractional delays;
    (source [T], clean [4, T]) float32."""
    from audio_triangulation_tpu_torch import geometry

    rng = np.random.default_rng(SEED + 64)
    t_len, fs = EXTRACTOR_SAMPLES, 50_000.0
    sig = rng.standard_normal(t_len)
    spec = np.fft.rfft(sig)
    f_hz = np.fft.rfftfreq(t_len, 1 / fs)
    spec[(f_hz < 300) | (f_hz > 8000)] = 0
    sig = np.fft.irfft(spec, t_len).astype(np.float32)
    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = geometry.square_array(0.3)
    d = np.linalg.norm(np.array([0.5, 0.4, 1.0]) - mic3, axis=-1)
    tau = (d - d.mean()) / 343.0 * fs
    clean = np.stack([np.fft.irfft(np.fft.rfft(sig) * np.exp(
        -2j * np.pi * np.fft.rfftfreq(t_len) * tau[m]), t_len)
        for m in range(4)]).astype(np.float32)
    return sig, clean


def snr_db(ref, x) -> float:
    """examples/production.py's scale-invariant SNR of x against ref."""
    g = np.dot(x, ref) / np.dot(ref, ref)
    e = x - g * ref
    return float(10 * np.log10(np.dot(x, x) / np.dot(e, e)))


def interferer_stream():
    """tests/test_extraction_streaming.py's MVDR scene: band-limited noise
    (300-8,000 Hz) from (0.5, 0.4, 1.0) at the 4-mic square, three times
    as loud an interferer from (-0.6, -0.5, 1.0), noise 0.01; (source
    [T], stream [4, T]) float32, T = 8,192."""
    from audio_triangulation_tpu_torch import geometry

    t_len, fs = 8192, 50_000.0
    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = geometry.square_array(0.3)
    out, sigs = np.zeros((4, t_len), np.float32), []
    for seed, xy, gain in ((4, (0.5, 0.4), 1.0), (5, (-0.6, -0.5), 3.0)):
        rng = np.random.default_rng(seed)
        sig = rng.standard_normal(t_len).astype(np.float32)
        spec = np.fft.rfft(sig)
        f = np.fft.rfftfreq(t_len, 1 / fs)
        spec[(f < 300) | (f > 8000)] = 0
        sig = np.fft.irfft(spec, t_len).astype(np.float32)
        d = np.linalg.norm(np.array([*xy, 1.0], np.float32) - mic3, axis=-1)
        tau = (d - d.mean()) / 343.0 * fs
        for m in range(4):
            out[m] += gain * np.fft.irfft(np.fft.rfft(sig) * np.exp(
                -2j * np.pi * np.fft.rfftfreq(t_len) * tau[m]), t_len)
        sigs.append(sig)
    out += 0.01 * np.random.default_rng(6).standard_normal(
        out.shape).astype(np.float32)
    return sigs[0], out


def reverb_extractor(phase, card, results, failures):
    """``StreamingExtractor.step_many`` at 1,024 streams, DAS and MVDR."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models.extraction import (
        StreamingExtractor)
    from audio_triangulation_tpu_torch.ops import beamform

    mics4 = geometry.square_array(0.3)
    sig, clean = production_stream()
    g = torch.Generator(device="cuda").manual_seed(SEED + 65)
    streams = torch.from_numpy(clean).cuda() + 0.3 * torch.randn(
        (EXTRACTOR_STREAMS, *clean.shape), device="cuda", generator=g)
    c = STREAM_CHUNK
    streams = torch.nn.functional.pad(streams, (0, c))  # flush the latency
    xys = torch.tensor([0.5, 0.4], device="cuda").expand(
        EXTRACTOR_STREAMS, 2)
    in_snr = 10 * np.log10(np.var(clean[0]) / 0.09)
    sl = slice(1024, EXTRACTOR_SAMPLES - 1024)
    i_sig, i_stream = interferer_stream()
    i_snr = {}
    for method in ("das", "mvdr"):
        name = f"extractor_stream_{method}"
        kw = dict(height=1.0, constrain_sphere=False, method=method)
        ex = StreamingExtractor.create(mics4, device="cuda", **kw)
        cpu_ex = StreamingExtractor.create(mics4, device="cpu", **kw)

        def run():
            st, ys = ex.init_states(EXTRACTOR_STREAMS), []
            for i in range(streams.shape[-1] // c):
                st, y = ex.step_many(st, streams[..., i * c:(i + 1) * c], xys)
                ys.append(y)
            return torch.cat(ys, -1)[:, ex.latency_samples:][
                :, :EXTRACTOR_SAMPLES]

        out, peak = peak_gb(lambda: counted(name, results, run))
        calls = count_only(phase, name, {})
        n = EXTRACTOR_CPU_STREAMS
        st, ys = cpu_ex.init_states(n), []
        for i in range(streams.shape[-1] // c):
            st, y = cpu_ex.step_many(
                st, streams[:n, :, i * c:(i + 1) * c].cpu(), xys[:n].cpu())
            ys.append(y)
        ref = torch.cat(ys, -1)[:, ex.latency_samples:][:, :EXTRACTOR_SAMPLES]
        e_cpu = rel_gap(out[:n], ref)
        # each device rounds the mic distances (~1.1 m) to its own last
        # bit; centred, that moves a delay by ~1e-10 s and the phase of the
        # top bins by up to ~5e-5 rad: hence 1e-4 of scale, as extract_8mic
        tgt = [beamform.source_delays(xys[:1].to(dev), mics4, ex.pipeline,
                                      height=1.0, constrain_sphere=False)
               for dev in ("cuda", "cpu")]
        e_delay = float((tgt[0].cpu() - tgt[1]).abs().max())
        gains = [snr_db(sig[sl], y[sl]) - in_snr
                 for y in out[:64].cpu().numpy()]
        t = time_ms(carried(lambda s: ex.step_many(s, streams[..., :c], xys),
                            ex.init_states(EXTRACTOR_STREAMS)))
        i_snr[method] = snr_db(i_sig[sl], ex.run(i_stream, np.array(
            [0.5, 0.4], np.float32), chunk_size=c)[sl])
        say(phase, f"{name}: {EXTRACTOR_STREAMS} streams x 4 mics, chunks "
            f"of {c}: {calls}; the example's scene: SNR gain over one mic's "
            f"{in_snr:.2f} dB: median {np.median(gains):.2f} dB on 64 "
            f"streams (min {min(gains):.2f}); the JAX test's interferer "
            f"scene: SNR {i_snr[method]:.2f} dB; vs CPU path on {n} streams "
            f"{e_cpu:.2e} of scale (1e-4; the delays differ by {e_delay:.1e}"
            f" s); step_many {ms_text(t)}, "
            f"{EXTRACTOR_STREAMS * 10.24 / t[0]:.0f} streams in real time; "
            f"peak {peak:.3f} GB ({card})")
        # the JAX tests' bounds: DAS gains 4 dB over one mic in white noise,
        # MVDR beats DAS by 1 dB on the interferer
        truth = (min(gains) > 4.0 if method == "das"
                 else i_snr["mvdr"] > i_snr["das"] + 1.0)
        if not (truth and e_cpu <= 1e-4):
            failures.append(name)


def tworate_scene(n_streams, seed):
    """tests/test_tworate.py's scene on the reference array: idle noise
    (0.001) everywhere, a burst (x30) in every ``TWORATE_BURST_EVERY``-th
    stream at one of four staggered starts; (streams [S, 3, T] f32, burst
    streams)."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    mics = geometry.reference_array()
    t_len = 8 * STREAM_CHUNK
    base = rng.normal(size=(n_streams, 3, t_len)).astype(np.float32) * 1e-3
    src = np.array([0.5, -0.4, 1.2])
    frame = synth.synth_scene(src / np.linalg.norm(src) * 1.2, mics,
                              noise_rms=0.01, seed=3)[0]
    bursts = np.arange(0, n_streams, TWORATE_BURST_EVERY)
    for i, s in enumerate(bursts):
        at = 1500 + 300 * (i % 4)
        base[s, :, at:at + 1024] += frame * 30
    return base, bursts


def reverb_tworate(phase, card, results, failures):
    """The two-rate localizer with ``with_audio`` at 1,024 streams."""
    import torch
    from audio_triangulation_tpu_torch import (PipelineConfig, StreamConfig,
                                               TwoRateStreamingLocalizer,
                                               geometry)
    from audio_triangulation_tpu_torch.utils import synth

    kw = dict(stream=StreamConfig(chunk_size=STREAM_CHUNK),
              event_capacity=64, with_audio=True)
    cfg = PipelineConfig(fft_pad_mode="circular")
    tr = TwoRateStreamingLocalizer.create(geometry.reference_array(), cfg,
                                          device="cuda", **kw)
    cpu_tr = TwoRateStreamingLocalizer.create(geometry.reference_array(),
                                              cfg, device="cpu", **kw)
    x_np, bursts = tworate_scene(TWORATE_STREAMS, SEED + 66)
    x = torch.from_numpy(x_np).cuda()
    c = STREAM_CHUNK
    n_steps = x.shape[-1] // c

    def run(tr, x):
        st, evs = tr.init_states(x.shape[0]), []
        for i in range(n_steps):
            st, det = tr.detect_many(st, x[..., i * c:(i + 1) * c])
            if bool(det["triggered"].any()):
                st, ev = tr.localize_triggered(st, det)
                evs.append((i, det, ev))
        return st, evs

    (_, evs), peak = peak_gb(lambda: counted("tworate_audio", results,
                                             lambda: run(tr, x)))
    calls = count_only(phase, "tworate_audio",
                       {"detector_scan_kernel": n_steps})
    sig = synth.chirp_burst(1024, 50_000.0)
    corrs, got, overflow = [], set(), 0
    shaped = all(ev["audio"].shape == (64, 1024) for _, _, ev in evs)
    for _, _, ev in evs:
        audio = ev["audio"].cpu().numpy()
        overflow += int(ev["overflow"])
        for slot in torch.nonzero(ev["accepted"])[:, 0].tolist():
            got.add(int(ev["stream_idx"][slot]))
            corrs.append(corr_peak(audio[slot], sig))
    # the CPU path on the first streams: slot order, audio
    _, cpu_evs = run(cpu_tr, x[:TWORATE_CPU_STREAMS].cpu())
    _, g_evs = run(tr, x[:TWORATE_CPU_STREAMS])
    order_eq = [i for i, _, _ in cpu_evs] == [i for i, _, _ in g_evs]
    e_audio = 0.0
    for (_, _, a), (_, _, b) in zip(g_evs, cpu_evs):
        order_eq &= bool(torch.equal(a["stream_idx"].cpu(), b["stream_idx"])
                         and torch.equal(a["accepted"].cpu(), b["accepted"]))
        on = b["triggered"]
        e_audio = max(e_audio, rel_gap(a["audio"].cpu()[on], b["audio"][on]))
    # timing: the chunk rate (detect_many) and one event-rate call at E = 64
    det = evs[0][1]
    st = tr.init_states(TWORATE_STREAMS)
    t_det = time_ms(carried(lambda s: tr.detect_many(s, x[..., :c]), st))
    t_loc = time_ms(lambda: tr.localize_triggered(st, det))
    say(phase, f"tworate_audio: {TWORATE_STREAMS} streams x {n_steps} chunks"
        f" of {c}, capacity 64: {calls}; events on {len(got)} of "
        f"{bursts.size} burst streams (those exactly: "
        f"{got == set(bursts.tolist())}), overflow {overflow}; burst "
        f"correlation min {min(corrs):.3f} (bound 0.8); vs CPU path on "
        f"{TWORATE_CPU_STREAMS} streams: slot order equal {order_eq}, audio "
        f"{e_audio:.2e} of scale (1e-4); detect_many {ms_text(t_det)}; "
        f"localize_triggered with audio {ms_text(t_loc)}; peak {peak:.3f} "
        f"GB ({card})")
    if not (shaped and got == set(bursts.tolist()) and overflow == 0
            and min(corrs) > 0.8 and order_eq and e_audio <= 1e-4):
        failures.append("tworate_audio")


def mapping_setup(device):
    """tests/test_mapping.py's localizer: the 6-mic circle, a plane grid of
    81 x 81 cells at 24 cells/m, 700-7,000 Hz, window off, the lag window
    of the array's aperture, the solver off the sphere."""
    from audio_triangulation_tpu_torch import (GridConfig, Localizer,
                                               PipelineConfig, SolverConfig,
                                               geometry)

    mics = geometry.circular_array(6, 0.25)
    cfg = PipelineConfig(phat=True, band_hz=(700.0, 7000.0),
                         window_enabled=False,
                         max_shift_samples=geometry.max_lag_for_array(
                             mics, PipelineConfig()))
    grid = GridConfig(projection="plane", height_m=0.0, cells_per_m=24.0,
                      half_cells_x=40, half_cells_y=40)
    return Localizer.create(mics, cfg, grid,
                            SolverConfig(constrain_to_sphere=False),
                            device=device)


def mapping_events(sources, seed):
    """[E, 6, 1,024] f32 events of the two-wall room (``max_order=1``) at
    in-plane offsets ``sources`` from the array, tests/test_mapping.py's
    broadband burst, noise 0.003."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import room

    mics = geometry.circular_array(6, 0.25)
    center = np.array([*MAP_CENTER, 1.2])
    mic3 = np.zeros((6, 3))
    mic3[:, :2] = mics + center[:2]
    mic3[:, 2] = center[2]
    rm = room.ShoeboxRoom(size=(6.0, 5.0, 3.0), absorption=MAP_ABSORPTION,
                          max_order=1)
    n, start, length = 1024, 50, 400
    sig = np.zeros(n)
    sweep = 800.0 + (7000.0 - 800.0) * np.arange(length) / length
    sig[start:start + length] = np.hanning(length) * np.sin(
        2 * np.pi * np.cumsum(sweep) / 50_000.0)
    return np.concatenate([room.simulate(
        np.array([sx + center[0], sy + center[1], center[2]]), mic3, rm,
        noise_rms=0.003, seed=seed + i, signal=sig)
        for i, (sx, sy) in enumerate(sources)]).astype(np.float32)


def walls_found(walls) -> tuple[str, bool]:
    """tests/test_mapping.py's two-wall bounds."""
    ok, parts = True, []
    for normal, dist, tol in MAP_WALLS:
        hits = [w for w in walls if w.normal @ np.asarray(normal) > 0.95]
        d = hits[0].distance if hits else float("nan")
        parts.append(f"{normal}: {d:.4f} m (truth {dist}, support "
                     f"{hits[0].support if hits else 0})")
        ok &= bool(hits) and abs(d - dist) < tol
    return "; ".join(parts), ok


def reverb_mapping(phase, card, results, failures):
    """``ReflectorMapper``: echo delays at 16,384 frames, the map of 64
    events."""
    import torch
    from audio_triangulation_tpu_torch.models.mapping import ReflectorMapper

    loc, cpu_loc = mapping_setup("cuda"), mapping_setup("cpu")
    mapper = ReflectorMapper(loc, n_echoes=2, q_max=900)
    cpu_mapper = ReflectorMapper(cpu_loc, n_echoes=2, q_max=900)
    rng = np.random.default_rng(SEED + 67)
    ev = torch.from_numpy(mapping_events(
        rng.uniform(-0.5, 0.5, (MAP_EVENTS, 2)), SEED + 68)).cuda()
    text, ok = loc_vs_cpu(loc, cpu_loc, ev)
    say(phase, f"mapping_6mic: {route_text(loc)}; {text}")
    g = torch.Generator(device="cuda").manual_seed(SEED + 69)
    big = ev.repeat(MAP_FRAMES // MAP_EVENTS, 1, 1)
    big += 0.003 * torch.randn(big.shape, device="cuda", generator=g)
    (d, a), peak = peak_gb(lambda: counted(
        "mapping_echo", results, lambda: mapper.echo_delays(big)))
    calls = count_only(phase, "mapping_echo", {})
    dc, ac = cpu_mapper.echo_delays(big[:256].cpu())
    lag_eq = bool(torch.equal(d[:256].cpu().round(), dc.round()))
    e_d = float((d[:256].cpu() - dc).abs().max())
    t = time_ms(lambda: mapper.echo_delays(big))
    say(phase, f"mapping_echo: echo_delays on {MAP_FRAMES} x 6 x 1,024: "
        f"{calls}; vs CPU path on 256 frames: integer lags equal {lag_eq}, "
        f"delays {e_d:.2e} samples; {ms_text(t)}; peak {peak:.3f} GB ({card})")
    ok &= lag_eq and e_d <= 1e-3
    res, peak = peak_gb(lambda: counted("mapping_6mic", results,
                                        lambda: mapper.map(ev)))
    calls = expect_counts("mapping_6mic", ("gcc_kernel", "gn_kernel"), phase)
    walls, ok_walls = walls_found(res["walls"])
    t = time_ms(lambda: mapper.map(ev))
    t_dev = time_ms(lambda: (loc(ev), mapper.echo_delays(ev)))
    # the CPU path on the JAX tests' three events: the same walls
    small = torch.from_numpy(mapping_events(MAP_TEST_SOURCES, 0))
    r_g, r_c = mapper.map(small.cuda()), cpu_mapper.map(small)
    same_walls = len(r_g["walls"]) == len(r_c["walls"]) and all(
        a.support == b.support and abs(a.distance - b.distance) <= 1e-4
        for a, b in zip(r_g["walls"], r_c["walls"]))
    say(phase, f"mapping_6mic: map on {MAP_EVENTS} events: {calls}; "
        f"{len(res['walls'])} walls, {walls}; {ms_text(t)}, of which the "
        f"localizer and echo_delays {t_dev[0]:.4f} ms, the host "
        f"{(t[0] - t_dev[0]) / MAP_EVENTS:.4f} ms an event; peak {peak:.3f} "
        f"GB; the JAX tests' 3 events: card and CPU path give the same walls "
        f"{same_walls} ({card})")
    if not (ok and ok_walls and same_walls):
        failures.append("mapping_6mic")


def phase_reverb(card, results):
    """Phase 14: the reverberant-room slice at the published widths: the
    batched image-source simulator, block WPE, the streaming dereverberator
    feeding the streaming localizer, ``Localizer.extract`` (DAS, MVDR), the
    streaming extractor, the two-rate localizer's event audio and the
    reflector mapper.  Each path timed (ms a call, median and IQR of 7),
    its peak device memory, its launches (rows 1 and 5 once a
    ``Localizer`` call, the scan once a stream step, none elsewhere), its
    truth at the JAX tests' bounds and the port's CPU path on a cut; every
    path runs and the phase fails at its end."""
    import torch

    t0 = time.perf_counter()
    phase = "14 reverb"
    failures = []
    for part in (reverb_room, reverb_wpe, reverb_dereverb_stream,
                 reverb_extract, reverb_extractor, reverb_tworate,
                 reverb_mapping):
        part(phase, card, results, failures)
        torch.cuda.empty_cache()
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


# phase 15: the training side at the JAX package's published sizes
CALIB_EVENTS = 4096  # calib_step_8mic: events of 8 x 1,024 a step
CALIB_CPU_EVENTS = 64  # of them held to the CPU path step by step
CLI_EVENTS, CLI_STEPS = 48, 200  # cli/main.py's calibrate defaults
EM_EVENTS, EM_ROUNDS, EM_STEPS = 256, 3, 50  # tests/test_sharding.py:123-150
TRACKED_EVENTS, TRACKED_STEPS = 36, 250  # test_calibration_tracked.py:20-42
SOS_EVENTS = 4096  # estimate_speed_of_sound
NEURAL_BATCH = 1024  # neural_train: frames of 4 x 1,024 a step
NEURAL_BATCHES = 10  # distinct batches made before timing, cycled
NEURAL_STEPS = 50
NEURAL_CPU_FRAMES = 256  # a step held to the CPU path
NEURAL_PREDICT_FRAMES = 16384
DESIGN_CELLS, DESIGN_STEPS = 16, 300  # cli/main.py's design defaults
CRLB_MAP_SIDE = 201  # crlb_rms_m on 201 x 201 points
# the card against the CPU path (tests/test_torch_calibration.py's and
# test_torch_design.py's tolerances; under PHAT row 2 is held to 1e-4 of
# scale of float64, so the features within 2e-4)
CALIB_LOSS_REL, CALIB_GRAD_REL, GAIN_GRAD_SHARE = 1e-5, 2e-5, 1e-5
FIT_MIC_M, FIT_LOSS_REL = 2e-5, 1e-4
NEURAL_FEAT_ABS, NEURAL_LOSS_REL, NEURAL_PRED_M = 2e-4, 1e-4, 1e-3
DESIGN_HIST_REL, DESIGN_POS_M = 1e-4, 1e-5


def calib_scene(mics, n_events, seed, noise=0.003, guess_std=0.012):
    """(frames [B, M, 1,024] f32, plane points [B, 2], a guess of the mics
    [M, 2] f32): events at uniform plane points in +-1 m."""
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    planes = rng.uniform(-1.0, 1.0, (n_events, 2))
    frames = synth.synth_scene(np.stack([place(p) for p in planes]), mics,
                               noise_rms=noise, seed=seed + 1)
    guess = (mics + rng.normal(0, guess_std, mics.shape)).astype(np.float32)
    return frames.astype(np.float32), planes.astype(np.float32), guess


def calib_grads(calib, guess, frames, planes):
    """(loss, mic_xy gradient, log_gain gradient) of ``calib_loss`` at the
    guess on the calibrator's device, on the host."""
    import torch
    from audio_triangulation_tpu_torch.models import calibration

    params = calibration.init_params(guess, calib.device)
    batch = calibration.CalibBatch(
        torch.as_tensor(frames, device=calib.device),
        torch.as_tensor(planes, device=calib.device))
    loss = calibration.calib_loss(params, batch, calib.pairs, calib.window,
                                  calib.pipeline)
    loss.backward()
    return (loss.item(), params.mic_xy.grad.cpu().numpy(),
            params.log_gain.grad.cpu().numpy())


def grads_held(got, ref) -> tuple[str, bool]:
    """Loss and mic gradient of ``got`` against ``ref`` (both from
    :func:`calib_grads`), and the log_gain gradient's share of the mic
    gradient in each (the reference's trap: rounding noise)."""
    loss_rel = abs(got[0] - ref[0]) / abs(ref[0])
    scale = np.abs(ref[1]).max()
    grad_rel = float(np.abs(got[1] - ref[1]).max() / scale)
    gain = max(np.abs(got[2]).max(), np.abs(ref[2]).max()) / scale
    ok = (loss_rel <= CALIB_LOSS_REL and grad_rel <= CALIB_GRAD_REL
          and gain < GAIN_GRAD_SHARE)
    return (f"loss {loss_rel:.2e} rel, mic gradient {grad_rel:.2e} of "
            f"scale, log_gain gradient {gain:.2e} of the mic gradient"), ok


def training_calib_step(phase, card, results, failures):
    """``Calibrator.train_step`` on 4,096 events of the 8-mic circle: no
    kernel (the GCC chain is plain torch under autograd), its peak memory
    with and without the checkpoint, the card against the CPU path on 64
    events and on the whole batch (past the 2,048 transforms where cuFFT's
    batched inverse would read the DC and Nyquist imaginary parts)."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models import calibration

    mics = geometry.circular_array(8, 0.2)
    frames, planes, guess = calib_scene(mics, CALIB_EVENTS, SEED + 70,
                                        noise=0.01, guess_std=0.01)
    calib = calibration.Calibrator.create(8, device="cuda")
    cpu_calib = calibration.Calibrator.create(8, device="cpu")
    n = CALIB_CPU_EVENTS
    text_s, ok_s = grads_held(calib_grads(calib, guess, frames[:n],
                                          planes[:n]),
                              calib_grads(cpu_calib, guess, frames[:n],
                                          planes[:n]))
    text_b, ok_b = grads_held(calib_grads(calib, guess, frames, planes),
                              calib_grads(cpu_calib, guess, frames, planes))
    params, opt = calib.init(guess)
    batch = calibration.CalibBatch(torch.from_numpy(frames).cuda(),
                                   torch.from_numpy(planes).cuda())

    def step():
        return calib.train_step(params, opt, batch)

    def step_kept():
        opt.zero_grad(set_to_none=True)
        loss = calibration.calib_loss(params, batch, calib.pairs,
                                      calib.window, calib.pipeline,
                                      checkpoint=False)
        loss.backward()
        opt.step()

    (_, _, loss0), peak = peak_gb(lambda: counted("calib_step_8mic",
                                                   results, step))
    calls = count_only(phase, "calib_step_8mic", {})
    _, peak_kept = peak_gb(step_kept)
    t = time_ms(step)
    t_kept = time_ms(step_kept)
    loss_end = step()[2]  # after the 20 steps of the timing
    falling = bool(loss_end < loss0)
    say(phase, f"calib_step_8mic: train_step on {CALIB_EVENTS} events x 8 "
        f"mics x 1,024 (28 pairs, F = 1,025): {calls}; {ms_text(t)}, peak "
        f"{peak:.3f} GB with the checkpoint; without it {t_kept[0]:.4f} ms, "
        f"peak {peak_kept:.3f} GB; vs CPU path on {n} events: {text_s}; on "
        f"all {CALIB_EVENTS}: {text_b}; loss {float(loss0):.4f} -> "
        f"{float(loss_end):.4f} over the timed steps ({card})")
    if not (ok_s and ok_b and falling):
        failures.append("calib_step_8mic")


def training_calib_cli(phase, card, results, failures):
    """The CLI's ``calibrate`` defaults: ``reference_array()``, 48 events,
    200 steps, perturbation 0.01 m, noise 0.01, seed 0
    (``cli/main.py:898-928``), on the card and on the CPU path."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models import calibration
    from audio_triangulation_tpu_torch.utils import synth

    mics = geometry.reference_array()
    rng = np.random.default_rng(0)
    planes = rng.uniform(-1.0, 1.0, (CLI_EVENTS, 2))
    frames = synth.synth_scene(np.stack([place(p) for p in planes]), mics,
                               noise_rms=0.01, seed=0)
    guess = mics + rng.normal(0, 0.01, mics.shape).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        calib = calibration.Calibrator.create(mics.shape[0], device=dev)
        batch = calibration.CalibBatch(
            *(torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (frames, planes)))

        def fit():
            return calib.fit(guess, [batch], steps_per_batch=CLI_STEPS)

        if dev == "cuda":
            t_fit = time.perf_counter()
            (params, losses), peak = peak_gb(lambda: counted(
                "calib_cli", results, fit))
            t_fit = (time.perf_counter() - t_fit) * 1e3
            calls = count_only(phase, "calib_cli", {})
            p1, o1 = calib.init(guess)
            t = time_ms(lambda: calib.train_step(p1, o1, batch))
        else:
            params, losses = fit()
        out[dev] = params.mic_xy.detach().cpu().numpy(), np.asarray(losses)
    err0 = np.abs(guess - mics).mean() * 1e3
    err1 = np.abs(out["cuda"][0] - mics).mean() * 1e3
    d_mic = float(np.abs(out["cuda"][0] - out["cpu"][0]).max())
    d_loss = float(np.abs(out["cuda"][1] / out["cpu"][1] - 1).max())
    say(phase, f"calib_cli: {CLI_STEPS} steps on {CLI_EVENTS} events of "
        f"reference_array(): {calls}; {ms_text(t)} a step, the whole fit "
        f"{t_fit:.4f} ms once; peak {peak:.3f} GB; geometry error {err0:.2f} "
        f"mm -> {err1:.2f} mm; vs CPU path: mics {d_mic:.2e} m, losses "
        f"{d_loss:.2e} rel ({card})")
    if not (err1 < err0 and d_mic <= FIT_MIC_M and d_loss <= FIT_LOSS_REL):
        failures.append("calib_cli")


def training_calib_em(phase, card, results, failures):
    """``fit_em``: ``tests/test_sharding.py:123-150``'s scene at 256
    events, 3 rounds x 50 steps; rows 1 and 5 once a round."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models import calibration

    mics = geometry.circular_array(8, 0.2)
    frames, _, guess = calib_scene(mics, EM_EVENTS, 33)
    calib = calibration.Calibrator.create(8, device="cuda")
    cpu_calib = calibration.Calibrator.create(8, device="cpu")
    frames_t = torch.from_numpy(frames).cuda()

    def fit():
        return calib.fit_em(guess, frames_t, em_rounds=EM_ROUNDS,
                            inner_steps=EM_STEPS)

    (mic_est, losses), peak = peak_gb(lambda: counted(
        "calib_em_8mic", results, fit))
    calls = count_only(phase, "calib_em_8mic", {
        "gcc_kernel": EM_ROUNDS, "gn_kernel": EM_ROUNDS})
    t = time_ms(fit)
    cpu_est, cpu_losses = cpu_calib.fit_em(guess, frames,
                                           em_rounds=EM_ROUNDS,
                                           inner_steps=EM_STEPS)
    err0 = np.abs(guess - mics).mean()
    err1 = np.abs(mic_est - mics).mean()
    d_mic = float(np.abs(mic_est - cpu_est).max())
    d_loss = float(np.abs(np.asarray(losses) / np.asarray(cpu_losses)
                          - 1).max())
    say(phase, f"calib_em_8mic: fit_em on {EM_EVENTS} events, {EM_ROUNDS} "
        f"rounds x {EM_STEPS} steps: {calls}; {ms_text(t)}; peak "
        f"{peak:.3f} GB; geometry error {err0 * 1e3:.3f} -> "
        f"{err1 * 1e3:.3f} mm (ratio {err1 / err0:.3f}, gate 0.85); vs CPU "
        f"path: mics {d_mic:.2e} m, round losses {d_loss:.2e} rel ({card})")
    if not (err1 < 0.85 * err0 and d_mic <= FIT_MIC_M
            and d_loss <= FIT_LOSS_REL):
        failures.append("calib_em_8mic")


def training_calib_tracked(phase, card, results, failures):
    """``fit_tracked``: ``tests/test_calibration_tracked.py:20-42``'s
    moving source (36 events, 250 steps); rows 1 and 5 once."""
    import torch
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.models import calibration
    from audio_triangulation_tpu_torch.utils import synth

    mics = geometry.circular_array(8, 0.2)
    rng = np.random.default_rng(55)
    p0, v = np.array([-0.8, -0.3]), np.array([0.55, 0.3])
    times = np.sort(rng.uniform(0.0, 2.2, TRACKED_EVENTS)).astype(np.float32)
    traj = p0[None, :] + times[:, None] * v[None, :]
    frames = synth.synth_scene(np.stack([place(p) for p in traj]), mics,
                               noise_rms=0.003, seed=56).astype(np.float32)
    guess = (mics + rng.normal(0, 0.012, mics.shape)).astype(np.float32)
    calib = calibration.Calibrator.create(8, device="cuda")
    frames_t = torch.from_numpy(frames).cuda()

    def fit():
        return calib.fit_tracked(guess, frames_t, times, traj_order=1,
                                 steps=TRACKED_STEPS)

    (mic_est, coeffs, losses), peak = peak_gb(lambda: counted(
        "calib_tracked_8mic", results, fit))
    calls = count_only(phase, "calib_tracked_8mic", {
        "gcc_kernel": 1, "gn_kernel": 1})
    t = time_ms(fit)
    cpu = calibration.Calibrator.create(8, device="cpu").fit_tracked(
        guess, frames, times, traj_order=1, steps=TRACKED_STEPS)
    err0 = np.abs(guess - mics).mean()
    err1 = np.abs(mic_est - mics).mean()
    v_err = float(np.abs(coeffs[1] - v).max())
    d_mic = float(np.abs(mic_est - cpu[0]).max())
    d_coef = float(np.abs(coeffs - cpu[1]).max())
    d_loss = float(np.abs(np.asarray(losses) / np.asarray(cpu[2]) - 1).max())
    say(phase, f"calib_tracked_8mic: fit_tracked on {TRACKED_EVENTS} events,"
        f" {TRACKED_STEPS} steps: {calls}; {ms_text(t)}; peak {peak:.3f} "
        f"GB; geometry error ratio {err1 / err0:.3f} (gate 0.85), velocity "
        f"{v_err:.3f} m/s from the truth (gate 0.15), loss "
        f"{losses[0]:.3f} -> {losses[-1]:.3f}; vs CPU path: mics "
        f"{d_mic:.2e} m, trajectory {d_coef:.2e}, losses {d_loss:.2e} rel "
        f"({card})")
    if not (err1 < 0.85 * err0 and v_err < 0.15 and losses[-1] < losses[0]
            and d_mic <= FIT_MIC_M and d_coef <= 10 * FIT_MIC_M
            and d_loss <= FIT_LOSS_REL):
        failures.append("calib_tracked_8mic")


def training_speed_of_sound(phase, card, results, failures):
    """``estimate_speed_of_sound`` on 4,096 events synthesized at c = 350
    m/s (``tests/test_calibration_tracked.py:45-70``'s scene)."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.models import calibration
    from audio_triangulation_tpu_torch.utils import synth

    mics = geometry.square_array(0.3)
    rng = np.random.default_rng(31)
    planes = rng.uniform(-0.8, 0.8, (SOS_EVENTS, 2))
    frames = synth.synth_scene(np.stack([place(p) for p in planes]), mics,
                               speed_of_sound=350.0, noise_rms=0.005,
                               seed=32).astype(np.float32)
    frames_t = torch.from_numpy(frames).cuda()

    def run():
        return calibration.estimate_speed_of_sound(
            frames_t, planes, mics, PipelineConfig())

    (c, diag), peak = peak_gb(lambda: counted("speed_of_sound", results,
                                              run))
    calls = count_only(phase, "speed_of_sound", {})
    t = time_ms(run)
    c_cpu, d_cpu = calibration.estimate_speed_of_sound(
        frames, planes, mics, PipelineConfig(), device="cpu")
    say(phase, f"speed_of_sound: {SOS_EVENTS} events x 4 mics: {calls}; "
        f"{ms_text(t)}; peak {peak:.3f} GB; c {c:.4f} m/s (truth 350, gate "
        f"1), {diag['n_used']} pairs used, rms {diag['rms_samples']:.4f} "
        f"samples; vs CPU path: c {abs(c - c_cpu):.2e} m/s, n_used "
        f"{diag['n_used']} / {d_cpu['n_used']} ({card})")
    if not (abs(c - 350.0) < 1.0 and abs(c - c_cpu) <= 1e-3
            and diag["n_used"] == d_cpu["n_used"]):
        failures.append("speed_of_sound")


def row2_plain():
    """Context manager: row 2's launcher replaced by its plain version on
    the same CUDA operands (``gcc_reference``): the plain route on the
    card."""
    import contextlib

    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    @contextlib.contextmanager
    def swap():
        launch = gcc_kernel.launch
        gcc_kernel.launch = gcc_kernel.gcc_reference
        try:
            yield
        finally:
            gcc_kernel.launch = launch

    return swap()


def training_neural(phase, card, results, failures):
    """``NeuralLocalizer`` on ``square_array(0.3)`` with PHAT and the
    default (256, 128) MLP: ``train_step`` on batches of 1,024 frames made
    before timing (row 2 once a step), 50 steps; ``predict`` on 16,384
    frames (row 2 once) against the plain route on the card."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.models import neural

    mics = geometry.square_array(0.3)
    cfg = PipelineConfig(phat=True)
    net = neural.NeuralLocalizer.create(mics, cfg, device="cuda")
    cpu_net = neural.NeuralLocalizer.create(mics, cfg, device="cpu")
    data = [(torch.from_numpy(f).cuda(), torch.from_numpy(xy).cuda())
            for f, xy in neural.synthetic_batches(
                mics, n_batches=NEURAL_BATCHES, batch_size=NEURAL_BATCH,
                pipeline=cfg, bank=2 * NEURAL_BATCH, seed=SEED + 80)]
    # one step from the same weights on both devices
    n = NEURAL_CPU_FRAMES
    f0, xy0 = data[0][0][:n], data[0][1][:n]
    feats = {"cuda": net.features(f0), "cpu": cpu_net.features(f0.cpu())}
    d_feat = float((feats["cuda"].cpu() - feats["cpu"]).abs().max())
    step_loss = {}
    for dev, nt in (("cuda", net), ("cpu", cpu_net)):
        mlp = neural.init_mlp(0, nt.sizes, dev)
        step_loss[dev] = float(nt.train_step(mlp, nt.optimizer(mlp),
                                             f0.to(dev), xy0.to(dev))[2])
    d_loss = abs(step_loss["cuda"] / step_loss["cpu"] - 1)
    params, opt = net.init(seed=0)
    i = [0]

    def step():
        frames, xy = data[i[0] % NEURAL_BATCHES]
        i[0] += 1
        return net.train_step(params, opt, frames, xy)

    _, peak = peak_gb(lambda: counted("neural_train", results, step))
    calls = count_only(phase, "neural_train", {"gcc_kernel": 1})
    losses = [step()[2] for _ in range(NEURAL_STEPS - 1)]
    curve = torch.stack(losses).cpu().numpy()
    falling = bool(curve[-5:].mean() < 0.5 * curve[:5].mean())
    t = time_ms(step)
    say(phase, f"neural_train: train_step on {NEURAL_BATCH} frames x 4 x "
        f"1,024, PHAT, MLP {net.sizes}: {calls} a step; {ms_text(t)}; peak "
        f"{peak:.3f} GB; loss over {NEURAL_STEPS} steps {curve[0]:.4f} -> "
        f"{curve[-1]:.4f} (last 5 under half the first 5: {falling}); vs "
        f"CPU path on {n} frames: features {d_feat:.2e}, a step's loss "
        f"{d_loss:.2e} rel ({card})")
    if not (falling and d_feat <= NEURAL_FEAT_ABS
            and d_loss <= NEURAL_LOSS_REL):
        failures.append("neural_train")

    reps = NEURAL_PREDICT_FRAMES // NEURAL_BATCH
    big = torch.cat([f for f, _ in data[:reps]] * (
        -(-reps // NEURAL_BATCHES)))[:NEURAL_PREDICT_FRAMES]
    pred, peak = peak_gb(lambda: counted(
        "neural_predict", results, lambda: net.predict(params, big)))
    calls = count_only(phase, "neural_predict", {"gcc_kernel": 1})
    t = time_ms(lambda: net.predict(params, big))
    with row2_plain():
        plain = net.predict(params, big)
        t_plain = time_ms(lambda: net.predict(params, big))
    d_pred = float((pred - plain).abs().max())
    truth = torch.cat([xy for _, xy in data[:reps]] * (
        -(-reps // NEURAL_BATCHES)))[:NEURAL_PREDICT_FRAMES]
    rms = float(((pred - truth) ** 2).sum(-1).mean().sqrt())
    say(phase, f"neural_predict: {NEURAL_PREDICT_FRAMES} frames: {calls}; "
        f"{ms_text(t)} ({NEURAL_PREDICT_FRAMES / t[0] * 1e3:.1f} frames/s); "
        f"with row 2's plain version {t_plain[0]:.4f} ms; peak {peak:.3f} "
        f"GB; vs the plain route on the card: {d_pred:.2e} m; rms error "
        f"after {NEURAL_STEPS} steps {rms:.3f} m ({card})")
    if not (bool(torch.isfinite(pred).all()) and d_pred <= NEURAL_PRED_M):
        failures.append("neural_predict")


def training_design(phase, card, results, failures):
    """The CLI's ``design`` defaults (``cli/main.py:931-952``): 4 mics,
    aperture 0.15 m, separation 0.05 m, 33 x 33 coverage points over +-1.5
    m, 300 steps, 2 us; then ``crlb_rms_m`` of the result on 201 x 201
    points."""
    import torch
    from audio_triangulation_tpu_torch.core import design

    k, ext, ap = DESIGN_CELLS, 1.5, 0.15
    xs = np.linspace(-ext, ext, 2 * k + 1)
    pts = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)
    init = np.random.default_rng(0).uniform(-ap / 3, ap / 3, (4, 2)).astype(
        np.float32)
    kw = dict(aperture_m=ap, min_separation_m=0.05, steps=DESIGN_STEPS,
              sigma_tau_s=2e-6)

    def run():
        return design.optimize_array(init, pts, device="cuda", **kw)

    (pos, hist), peak = peak_gb(lambda: counted("design_cli", results, run))
    calls = count_only(phase, "design_cli", {})
    t = time_ms(run)
    pos_c, hist_c = design.optimize_array(init, pts, device="cpu", **kw)
    d_hist = float(np.abs(hist / hist_c - 1).max())
    d_pos = float(np.abs(pos - pos_c).max())
    side = np.linspace(-ext, ext, CRLB_MAP_SIDE)
    grid = np.stack(np.meshgrid(side, side), -1).reshape(-1, 2).astype(
        np.float32)
    mics_t, grid_t = torch.from_numpy(pos).cuda(), torch.from_numpy(grid)

    def crlb_map():
        return design.crlb_rms_m(mics_t, grid_t.cuda(), sigma_tau_s=2e-6)

    rms_map, peak_map = peak_gb(lambda: counted("design_crlb_map", results,
                                                crlb_map))
    count_only(phase, "design_crlb_map", {})
    t_map = time_ms(crlb_map)
    cpu_map = design.crlb_rms_m(torch.from_numpy(pos), grid_t,
                                sigma_tau_s=2e-6)
    d_map = rel_gap(rms_map, cpu_map)
    say(phase, f"design_cli: optimize_array, {DESIGN_STEPS} steps on "
        f"{len(pts)} points: {calls}; {ms_text(t)} "
        f"({t[0] / DESIGN_STEPS:.4f} ms a step); peak {peak:.3f} GB; mean "
        f"CRLB rms {hist[0] * 100:.2f} -> {hist[-1] * 100:.2f} cm; vs CPU "
        f"path: history {d_hist:.2e} rel, positions {d_pos:.2e} m; "
        f"crlb_rms_m on {len(grid)} points {ms_text(t_map)}, peak "
        f"{peak_map:.3f} GB, vs CPU path {d_map:.2e} of scale ({card})")
    if not (hist[-1] < hist[0] and d_hist <= DESIGN_HIST_REL
            and d_pos <= DESIGN_POS_M and d_map <= DESIGN_HIST_REL):
        failures.append("design_cli")


def phase_training(card, results):
    """Phase 15: the training side at the JAX package's published sizes:
    ``Calibrator.train_step`` on 4,096 events of 8 mics, the CLI's
    ``calibrate``, ``fit_em`` and ``fit_tracked`` on the reference tests'
    scenes, ``estimate_speed_of_sound`` on 4,096 events, the neural
    localizer's ``train_step`` and ``predict`` and the CLI's ``design``.
    Each path timed (ms a step or call, median and IQR of 7), its peak
    device memory, its launches (none on the calibration steps and the
    design, rows 1 and 5 once a ``Localizer`` call, row 2 once a neural
    step and prediction), its gates (the reference tests') and the card
    against the CPU path; every path runs and the phase fails at its
    end."""
    import torch

    t0 = time.perf_counter()
    phase = "15 training"
    failures = []
    for part in (training_calib_step, training_calib_cli, training_calib_em,
                 training_calib_tracked, training_speed_of_sound,
                 training_neural, training_design):
        part(phase, card, results, failures)
        torch.cuda.empty_cache()
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


SERVE_SEED = SEED + 90
SERVE_BURSTS = 96  # planted events in the 60 s ingest stream
SERVE_PUMP_BATCH = 64  # EventPump batches: one full, one padded
SERVE_QUEUE = 256  # the ingest runtime's event queue holds every event
SERVE_BATCHES = (1, 64, 4096)  # frames a POST /localize (4,096: 64 MiB)
SERVE_REQUESTS = {1: 64, 64: 32, 4096: 6}  # timed requests per batch size
SERVE_CLIENTS = 8  # client threads at once
SERVE_CLIENT_REQUESTS = 4  # batch-64 requests each
SERVE_SESSIONS = 16  # streaming sessions stepped at once
SERVE_CHUNKS = 16  # 512-sample chunks a session
FEED_BATCHES = 32  # DoubleBufferedFeeder: batches of 4,096 x 4 x 1,024
FEED_DISTINCT = 4  # distinct host batches, cycled
AOT_BATCH = 4096
EXPORT_BATCHES = (3, 4096)
CKPT_STREAMS = 256  # streams of the checkpointed card state
CKPT_CHUNKS = 12  # chunks stepped; the state is saved after half
SERVE_KEYS = ("xy", "tdoa_samples", "best_shift", "rms_m", "xy_cov")


def ingest_reference(kind):
    """The events of phase 16's 60 s stream by the port's NumPy runtime
    (``kind="python"``: with its counters) or by the golden model
    (``"golden"``: the detector restarted after each trigger, as the runtime
    resets its rings): ([(frame [3, 1,024] int16, stamp)], counters or
    None).  Both take about a minute of one host core, so ``main`` runs them
    in worker processes from its start."""
    from audio_triangulation_tpu_torch.runtime import native_rt
    from audio_triangulation_tpu_torch.utils import golden

    stream, _ = burst_stream(np.random.default_rng(SERVE_SEED), SERVE_BURSTS,
                             SERVE_SEED + 1)
    if kind == "python":
        rt = native_rt.PyIngestRuntime(3, queue_capacity=SERVE_QUEUE)
        rt.push(stream.T.astype(np.int16))
        events = []
        while (ev := rt.poll()) is not None:
            events.append(ev)
        return events, (rt.sample_count, rt.events_detected,
                        rt.events_dropped)
    u8 = stream.astype(np.uint8)
    events, start = [], 0
    while True:
        gp = golden.GoldenPipeline()
        idx = gp.detect_index(u8[:, start:])
        if idx is None:
            return events, None
        events.append((np.stack([
            np.concatenate([r.buffer[r.head:], r.buffer[:r.head]])
            for r in gp.rings]).astype(np.int16), start + idx))
        start += idx + 1


def start_ingest_reference():
    """The two ``ingest_reference`` runs in worker processes (spawned: the
    card stays in this process): (pool, {kind: future})."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    return pool, {k: pool.submit(ingest_reference, k)
                  for k in ("python", "golden")}


def http(srv, path, data=None, headers=None, method=None):
    """(status, JSON body) of one request to a server on 127.0.0.1."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", data=data,
        method=method or ("POST" if data is not None else "GET"))
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def octet(arr) -> dict:
    """Request arguments of a float32 array as an octet-stream body."""
    return dict(data=np.ascontiguousarray(arr, np.float32).tobytes(),
                headers={"Content-Type": "application/octet-stream",
                         "X-Shape": ",".join(str(d) for d in arr.shape)})


def served_equal(resp, out) -> bool:
    """Whether a /localize response holds exactly ``out``'s values."""
    import torch

    return all(k in resp and torch.equal(
        torch.tensor(resp[k], dtype=out[k].dtype), out[k].cpu())
        for k in ("xy", "tdoa_samples", "best_shift", "rms_m"))


def pct(times_s, q) -> float:
    return float(np.percentile(np.asarray(times_s) * 1e3, q))


def serving_ingest(phase, card, results, failures, refs):
    """A 60 s, 50 kHz PCM stream of ``reference_array()`` with 96 planted
    bursts through a FIFO into the native ingest runtime
    (``transport.open_source``), its events through ``EventPump(batch_size=
    64)`` into the card's Localizer: stamps and frames equal to the port's
    NumPy runtime and to the golden model, positions within phase 9's bound
    for this scene and equal to the CPU path's, rows 1 and 5 once a batch."""
    import shutil
    import tempfile

    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.runtime import native_rt, transport
    from audio_triangulation_tpu_torch.runtime.feeder import EventPump

    stream, planes = burst_stream(np.random.default_rng(SERVE_SEED),
                                  SERVE_BURSTS, SERVE_SEED + 1)
    pcm = np.ascontiguousarray(stream.T.astype(np.int16))
    rt = native_rt.create_ingest_runtime(3, queue_capacity=SERVE_QUEUE)
    if not isinstance(rt, native_rt.NativeIngestRuntime):
        fail(phase, f"create_ingest_runtime gave {type(rt).__name__}: the "
             "native runtime did not build")
    cfg = PipelineConfig()
    loc = Localizer.create(geometry.reference_array(), cfg, device="cuda")
    batches = []

    def on_batch(arr, stamps, valid):
        out = loc(arr)
        batches.append((arr, stamps, valid, {k: out[k] for k in SERVE_KEYS}))

    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "pcm.fifo")
        os.mkfifo(path)

        def ingest():
            src = transport.open_source(rt, f"fifo://{path}")
            if not isinstance(src, native_rt.NativeSource):
                fail(phase, "the FIFO source is not the native reader")
            writer = transport.stream_pcm_to_fifo(path, pcm)
            pump = EventPump(rt, batch_size=SERVE_PUMP_BATCH,
                             on_batch=on_batch)
            deadline = time.time() + 120
            while src.running and time.time() < deadline:
                pump.pump()
                time.sleep(0.002)
            pump.pump(flush=True)
            writer.join(timeout=30)
            src.stop()
            return src

        t0 = time.perf_counter()
        src = counted("serve_pump", results, ingest, phase)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    calls = count_only(phase, "serve_pump", {
        "gcc_kernel": len(batches), "gn_kernel": len(batches)})
    valid = [v for _, _, v, _ in batches]
    stamps = np.concatenate([s[v] for (_, s, v, _) in batches])
    frames = torch.cat([a[torch.from_numpy(v).cuda()]
                        for (a, _, v, _) in batches]).cpu().numpy()
    native = [(f.astype(np.int16), int(t)) for f, t in zip(frames, stamps)]
    py_events, py_counters = refs["python"].result(timeout=900)
    gold_events, _ = refs["golden"].result(timeout=900)

    def same(a, b):
        return len(a) == len(b) and all(
            sa == sb and np.array_equal(fa, fb)
            for (fa, sa), (fb, sb) in zip(a, b))

    counters = (rt.sample_count, rt.events_detected, rt.events_dropped)
    eq_py, eq_gold = same(native, py_events), same(native, gold_events)
    xy = torch.cat([o["xy"][torch.from_numpy(v).cuda()]
                    for (_, _, v, o) in batches]).cpu()
    err = (float(np.abs(xy.numpy() - planes).max())
           if xy.shape[0] == SERVE_BURSTS else float("inf"))
    cpu_loc = Localizer.create(geometry.reference_array(), cfg, device="cpu")
    ref = cpu_loc(torch.from_numpy(frames.astype(np.float32)))
    dxy = float((xy - ref["xy"]).abs().max())
    got_tdoa = torch.cat([o["tdoa_samples"][torch.from_numpy(v).cuda()]
                          for (_, _, v, o) in batches]).cpu()
    dtdoa = float((got_tdoa - ref["tdoa_samples"]).abs().max())
    seconds = pcm.shape[0] / 50_000
    say(phase, f"serve_pump: [3, {pcm.shape[0]}] samples ({seconds:.0f} s "
        f"at 50 kHz) "
        f"through fifo:// into the native runtime ({type(rt).__name__}, "
        f"{src.tuples_pushed} tuples, {src.bytes_read} bytes), counters "
        f"{counters}, {len(batches)} EventPump batches of "
        f"{SERVE_PUMP_BATCH} ({[int(v.sum()) for v in valid]} valid): "
        f"{calls}; stamps and frames equal to PyIngestRuntime {eq_py} "
        f"(counters {py_counters}), to the golden model {eq_gold} "
        f"({len(gold_events)} events); |xy - source| {err * 100:.2f} cm at "
        f"most (phase 9's bound 25 cm); vs CPU path xy {dxy:.2e} m, tdoa "
        f"{dtdoa:.2e} samples; {wall:.3f} s wall for the stream "
        f"({seconds / wall:.1f}x real time) ({card})")
    if not (eq_py and eq_gold and counters == py_counters
            and counters[1] == SERVE_BURSTS and counters[2] == 0
            and src.tuples_pushed == pcm.shape[0] and err < 0.25
            and dxy <= 2e-4 and dtdoa <= 1e-3):
        failures.append("serve_pump")
    rt.close()


def serving_http(phase, card, results, failures):
    """``LocalizerServer`` on the card, on port 0 of 127.0.0.1, serving the
    Localizer of the CLI's ``serve --array square --phat``: /healthz, POST
    /localize at 1, 64 and 4,096 frames (64 MiB, the default body cap) as
    octet-stream, bit-equal to the library call, rows 1 and 5 once a
    request, timed (p50 / p99 latency, requests/s); 8 client threads at
    once; 16 sessions stepping 512-sample chunks at once, each equal to the
    same chunks stepped in series, the scan once a step; 256 sessions and
    the 257th refused."""
    import threading

    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.models.streaming import (
        StreamingLocalizer)
    from audio_triangulation_tpu_torch.runtime.server import LocalizerServer
    from audio_triangulation_tpu_torch.utils import synth

    mics = geometry.square_array(0.3)
    loc = Localizer.create(mics, PipelineConfig(phat=True), device="cuda")
    srv = LocalizerServer(loc, host="127.0.0.1", port=0).start()
    rng = np.random.default_rng(SERVE_SEED + 2)
    try:
        code, health = http(srv, "/healthz")
        say(phase, f"serve_http: /healthz {code} {health}; body cap "
            f"{srv.max_body_bytes} B, max_batch {srv.max_batch}, "
            f"max_sessions {srv.max_sessions}")
        if (code, health) != (200, {"ok": True, "backend": "gpu",
                                    "mics": 4}):
            failures.append("serve_healthz")
        for b in SERVE_BATCHES:
            frames = scene_frames(mics, b, rng)
            req = octet(frames)
            name = f"serve_localize_b{b}"
            code, resp = counted(name, results,
                                 lambda: http(srv, "/localize", **req), phase)
            calls = count_only(phase, name, {"gcc_kernel": 1,
                                             "gn_kernel": 1})
            equal = code == 200 and served_equal(
                resp, loc(torch.from_numpy(frames).cuda()))
            times = []
            for _ in range(SERVE_REQUESTS[b]):
                t0 = time.perf_counter()
                code_t, _ = http(srv, "/localize", **req)
                times.append(time.perf_counter() - t0)
                equal &= code_t == 200
            say(phase, f"{name}: {len(req['data'])} B body; {calls} a "
                f"request; bit-equal to loc(frames) on the card {equal}; "
                f"latency p50 {pct(times, 50):.3f} ms, p99 "
                f"{pct(times, 99):.3f} ms over {len(times)} requests in "
                f"turn, {len(times) / sum(times):.1f} requests/s, "
                f"{b * len(times) / sum(times):.1f} frames/s ({card})")
            if not equal:
                failures.append(name)

        # 8 clients at once, each its own frames
        client_frames = [scene_frames(mics, 64, rng)
                         for _ in range(SERVE_CLIENTS)]
        want = [{k: v.cpu() for k, v in loc(torch.from_numpy(f).cuda())
                 .items()} for f in client_frames]
        ok = [True] * SERVE_CLIENTS

        def client(k):
            for _ in range(SERVE_CLIENT_REQUESTS):
                code, resp = http(srv, "/localize", **octet(client_frames[k]))
                ok[k] &= code == 200 and served_equal(resp, want[k])

        def clients():
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(SERVE_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return all(not t.is_alive() for t in threads)

        t0 = time.perf_counter()
        done = counted("serve_clients", results, clients, phase)
        wall = time.perf_counter() - t0
        n_req = SERVE_CLIENTS * SERVE_CLIENT_REQUESTS
        calls = count_only(phase, "serve_clients", {
            "gcc_kernel": n_req, "gn_kernel": n_req})
        say(phase, f"serve_clients: {SERVE_CLIENTS} threads x "
            f"{SERVE_CLIENT_REQUESTS} requests of 64 frames at once: all "
            f"bit-equal to the library call {all(ok) and done}; {calls}; "
            f"{n_req / wall:.1f} requests/s ({card})")
        if not (all(ok) and done):
            failures.append("serve_clients")

        # 16 sessions at once against the same chunks stepped in series
        sl = StreamingLocalizer.create(mics, loc.pipeline, loc.grid,
                                       loc.solver, device="cuda")
        n = SERVE_CHUNKS * STREAM_CHUNK
        src = np.array([0.8, 0.5, 1.2]) * (1.2 / np.linalg.norm([0.8, 0.5,
                                                                  1.2]))
        burst = synth.synth_scene(src, mics, noise_rms=0.0,
                                  seed=SERVE_SEED + 3)[0]
        streams = rng.integers(127, 130, (SERVE_SESSIONS, 4, n)).astype(
            np.float64)
        streams[::2, :, 3000:3000 + 1024] += 110.0 * burst
        streams = np.clip(np.round(streams), 0, 255).astype(np.float32)
        series = []
        series_t0 = time.perf_counter()
        for s in range(SERVE_SESSIONS):
            state, outs = sl.init_state(), []
            for c in range(SERVE_CHUNKS):
                state, out = sl(state, torch.from_numpy(
                    streams[s, :, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK]
                ).cuda())
                outs.append({
                    "event": bool(out["event"]),
                    "event_count": int(out["event_count"]),
                    "xy_grid": out["xy_grid"].cpu().numpy().tolist(),
                    "consistency_rms": float(out["consistency_rms"]),
                    **{k: out[k].cpu().numpy().tolist()
                       for k in ("xy", "xy_cov") if k in out}})
            series.append(outs)
        series_ms = ((time.perf_counter() - series_t0) * 1e3
                     / (SERVE_SESSIONS * SERVE_CHUNKS))
        ids = [http(srv, "/streams", b"{}", {"Content-Type":
                                              "application/json"})[1]["id"]
               for _ in range(SERVE_SESSIONS)]
        served = [[None] * SERVE_CHUNKS for _ in range(SERVE_SESSIONS)]
        step_times = []

        def session(s):
            for c in range(SERVE_CHUNKS):
                t0 = time.perf_counter()
                _, served[s][c] = http(srv, f"/streams/{ids[s]}", **octet(
                    streams[s, :, c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK]))
                step_times.append(time.perf_counter() - t0)

        def sessions():
            threads = [threading.Thread(target=session, args=(s,))
                       for s in range(SERVE_SESSIONS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            return all(not t.is_alive() for t in threads)

        t0 = time.perf_counter()
        done = counted("serve_sessions", results, sessions, phase)
        wall = time.perf_counter() - t0
        steps = SERVE_SESSIONS * SERVE_CHUNKS
        calls = count_only(phase, "serve_sessions",
                           {"detector_scan_kernel": steps})
        equal = done and served == series
        events = sum(o["event"] for outs in series for o in outs)
        say(phase, f"serve_sessions: {SERVE_SESSIONS} sessions x "
            f"{SERVE_CHUNKS} chunks of 4 x {STREAM_CHUNK} at once: outputs "
            f"equal to the same chunks stepped in series {equal} ({events} "
            f"events); {calls}; step latency p50 {pct(step_times, 50):.3f} "
            f"ms, p99 {pct(step_times, 99):.3f} ms, {steps / wall:.1f} "
            f"steps/s; the same steps in series in this process, outputs "
            f"read back: {series_ms:.3f} ms a step ({card})")
        if not equal:
            failures.append("serve_sessions")
        for sid in ids:
            http(srv, f"/streams/{sid}", method="DELETE")

        # the session limit
        codes = [http(srv, "/streams", b"{}", {"Content-Type":
                                                "application/json"})[0]
                 for _ in range(srv.max_sessions + 1)]
        say(phase, f"serve_session_limit: {codes.count(200)} sessions "
            f"created, the next answered {codes[-1]}")
        if codes != [200] * srv.max_sessions + [400]:
            failures.append("serve_session_limit")
    finally:
        srv.stop()


def serving_feeder(phase, card, results, failures):
    """32 batches of 4,096 x 4 x 1,024 (64 MiB each) through
    ``DoubleBufferedFeeder`` into the Localizer: wall times of feeder plus
    compute, copies alone and compute alone, the pinned copy's rate, every
    output equal to the unfed call, rows 1 and 5 once a batch."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.runtime.feeder import (
        DoubleBufferedFeeder)

    mics = geometry.square_array(0.3)
    loc = Localizer.create(mics, PipelineConfig(phat=True), device="cuda")
    rng = np.random.default_rng(SERVE_SEED + 4)
    host = [scene_frames(mics, 4096, rng) for _ in range(FEED_DISTINCT)]
    dev = [torch.from_numpy(h).cuda() for h in host]
    want = [{k: v for k, v in loc(d).items() if k in SERVE_KEYS}
            for d in dev]

    def batches():
        for k in range(FEED_BATCHES):
            yield host[k % FEED_DISTINCT]

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def fed():
        return [{k: v for k, v in loc(b).items() if k in SERVE_KEYS}
                for b in DoubleBufferedFeeder(batches())]

    outs, t_fed = wall(lambda: counted("serve_feeder", results, fed, phase))
    calls = count_only(phase, "serve_feeder", {
        "gcc_kernel": FEED_BATCHES, "gn_kernel": FEED_BATCHES})
    _, t_copy = wall(lambda: [b for b in DoubleBufferedFeeder(batches())])
    _, t_compute = wall(lambda: [
        {k: v for k, v in loc(dev[i % FEED_DISTINCT]).items()
         if k in SERVE_KEYS} for i in range(FEED_BATCHES)])
    equal = len(outs) == FEED_BATCHES and all(
        torch.equal(o[k], want[i % FEED_DISTINCT][k])
        for i, o in enumerate(outs) for k in SERVE_KEYS)
    # the link and the host staging copy, alone
    pinned = torch.empty(host[0].shape, pin_memory=True)
    staging_ms = time_ms(lambda: pinned.copy_(torch.from_numpy(host[0])))
    h2d_ms = cuda_ms(lambda: dev[0].copy_(pinned, non_blocking=True), 10)
    nbytes = host[0].nbytes
    say(phase, f"serve_feeder: {FEED_BATCHES} batches of 4,096 x 4 x 1,024 "
        f"({nbytes / 2**20:.0f} MiB each): {calls}; outputs equal to the "
        f"unfed calls {equal}; wall {t_fed:.1f} ms feeder + compute, "
        f"{t_copy:.1f} ms copies alone, {t_compute:.1f} ms compute alone "
        f"({t_fed / FEED_BATCHES:.3f} / {t_copy / FEED_BATCHES:.3f} / "
        f"{t_compute / FEED_BATCHES:.3f} ms a batch); reckoning: one pinned "
        f"copy {h2d_ms:.3f} ms ({nbytes / h2d_ms / 1e6:.1f} GB/s over the "
        f"host link), the host's pageable-to-pinned staging copy "
        f"{staging_ms[0]:.3f} ms a batch, compute "
        f"{t_compute / FEED_BATCHES:.3f} ms a batch ({card})")
    if not equal:
        failures.append("serve_feeder")


def serving_export(phase, card, results, failures):
    """``aot_compile`` at 4,096 frames (the replay bit-equal to the eager
    call, both timed) and ``export_localizer``'s artifact loaded and run on
    the card at two batch sizes (within the CPU path's tolerance of the
    kernel route: xy 2e-4 m, tdoa 1e-3 samples; no kernel launched)."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.utils import serving

    mics = geometry.square_array(0.3)
    loc = Localizer.create(mics, PipelineConfig(phat=True), device="cuda")
    frames = torch.from_numpy(scene_frames(
        mics, AOT_BATCH, np.random.default_rng(SERVE_SEED + 5))).cuda()
    t0 = time.perf_counter()
    g = serving.aot_compile(loc, AOT_BATCH)
    t_capture = time.perf_counter() - t0
    eager = loc(frames)
    replay = g(frames)
    bit_equal = sorted(replay) == sorted(eager) and all(
        torch.equal(replay[k], eager[k]) for k in eager)
    t_eager, t_graph = time_ms(lambda: loc(frames)), time_ms(
        lambda: g(frames))
    say(phase, f"serve_aot: capture at {AOT_BATCH} frames {t_capture:.2f} "
        f"s (kernels built, warm-up on a side stream); replay bit-equal to "
        f"the eager call on every output {bit_equal}; eager "
        f"{ms_text(t_eager)}, graph replay {ms_text(t_graph)} ({card})")
    if not bit_equal:
        failures.append("serve_aot")

    t0 = time.perf_counter()
    blob = serving.export_localizer(loc)
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn = serving.load_exported(blob)
    t_load = time.perf_counter() - t0
    ok = True
    for b in EXPORT_BATCHES:
        reset_counts()
        got = fn(frames[:b])
        torch.cuda.synchronize()
        calls = count_only(phase, f"serve_export_b{b}", {})
        want = loc(frames[:b])
        dxy = float((got["xy"] - want["xy"]).abs().max())
        dtdoa = float((got["tdoa_samples"]
                       - want["tdoa_samples"]).abs().max())
        shifts = int((got["best_shift"] != want["best_shift"]).sum())
        on_card = got["xy"].is_cuda and got["xy"].shape == (b, 2)
        say(phase, f"serve_export_b{b}: the artifact on the card "
            f"({on_card}): {calls}; vs the kernel route xy {dxy:.2e} m, "
            f"tdoa {dtdoa:.2e} samples, {shifts} best shifts differ")
        ok &= on_card and dxy <= 2e-4 and dtdoa <= 1e-3
    t_fn = time_ms(lambda: fn(frames))
    say(phase, f"serve_export: {len(blob)} B artifact, exported in "
        f"{t_export:.2f} s, loaded in {t_load:.2f} s; {AOT_BATCH} frames "
        f"on the plain-torch route {ms_text(t_fn)} ({card})")
    if not ok:
        failures.append("serve_export")


def serving_checkpoint(phase, card, results, failures):
    """A card stream state of 256 streams saved mid-stream
    (``utils.checkpoint``), restored into a fresh template and continued:
    every output of the next steps equal to the uninterrupted run's."""
    import shutil
    import tempfile

    import torch
    from audio_triangulation_tpu_torch import (PipelineConfig, StreamConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.models.streaming import (
        StreamingLocalizer, state_leaves)
    from audio_triangulation_tpu_torch.utils import checkpoint, synth

    mics = geometry.square_array(0.3)
    sl = StreamingLocalizer.create(mics, PipelineConfig(phat=True),
                                   stream=StreamConfig(chunk_size=512),
                                   device="cuda")
    rng = np.random.default_rng(SERVE_SEED + 6)
    n = CKPT_CHUNKS * STREAM_CHUNK
    x = rng.integers(127, 130, (CKPT_STREAMS, 4, n)).astype(np.float64)
    src = np.array([-0.6, 0.3, 1.2]) * (1.2 / np.linalg.norm([-0.6, 0.3,
                                                              1.2]))
    burst = synth.synth_scene(src, mics, noise_rms=0.0,
                              seed=SERVE_SEED + 7)[0]
    for at in (1000, 4000):
        x[::4, :, at:at + 1024] += 110.0 * burst
    x = torch.from_numpy(np.clip(np.round(x), 0, 255).astype(
        np.float32)).cuda()
    chunks = [x[..., c * STREAM_CHUNK:(c + 1) * STREAM_CHUNK]
              for c in range(CKPT_CHUNKS)]
    half = CKPT_CHUNKS // 2
    states = sl.init_states(CKPT_STREAMS)
    for c in chunks[:half]:
        states, _ = sl.step_many(states, c)
    tmp = tempfile.mkdtemp()
    try:
        path = checkpoint.save(os.path.join(tmp, "stream"), states)
        restored = checkpoint.restore(path, sl.init_states(CKPT_STREAMS))
    finally:
        shutil.rmtree(tmp)
    same_state = all(a.device == b.device and a.dtype == b.dtype
                     and torch.equal(a, b) for a, b in zip(
                         state_leaves(states), state_leaves(restored)))

    def run(st):
        outs = []
        for c in chunks[half:]:
            st, out = sl.step_many(st, c)
            outs.append(out)
        return st, outs

    end, want = run(states)
    end_r, got = counted("serve_checkpoint", results, lambda: run(restored),
                         phase)
    calls = count_only(phase, "serve_checkpoint", {
        "detector_scan_kernel": CKPT_CHUNKS - half})
    equal = all(sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                               for k in a)
                for a, b in zip(got, want)) and all(
        torch.equal(a, b) for a, b in zip(state_leaves(end),
                                          state_leaves(end_r)))
    events = int(sum(int(o["event"].sum()) for o in want))
    say(phase, f"serve_checkpoint: {CKPT_STREAMS} card streams saved after "
        f"{half} of {CKPT_CHUNKS} chunks, restored leaf for leaf on the card "
        f"{same_state}; the continued run equal to the uninterrupted one "
        f"{equal} ({events} events after the restore); {calls}")
    if not (same_state and equal and events > 0):
        failures.append("serve_checkpoint")


def phase_serving(card, results, refs):
    """Phase 16: the live serving path on the card: the HTTP server
    (requests, concurrent clients and sessions, the session limit), the
    feeder, graph capture and the exported artifact, a checkpointed stream
    state, and native ingest through a FIFO into ``EventPump`` and the
    Localizer (last: its references come from ``main``'s workers).
    Every part runs; the phase fails at its end if any part failed (an
    exception in a part is printed and recorded as its failure)."""
    import traceback

    import torch

    t0 = time.perf_counter()
    phase = "16 serving"
    failures = []
    parts = [serving_http, serving_feeder, serving_export,
             serving_checkpoint, lambda *a: serving_ingest(*a, refs)]
    names = ["serving_http", "serving_feeder", "serving_export",
             "serving_checkpoint", "serving_ingest"]
    for name, part in zip(names, parts):
        try:
            part(phase, card, results, failures)
        except (Exception, SystemExit):  # recorded; the phase fails below
            traceback.print_exc()
            failures.append(name)
        torch.cuda.empty_cache()
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


PAR_FRAMES = 4096  # frames (fusion: events) a call of the parallel paths
PAR_STREAMS = 1024  # streams of the sharded streaming paths
PAR_WAYS = 4  # model-axis shards run in turn on the one card
PAR_CALIB_MICS = 8
PAR_NEURAL_FRAMES = 1024
PAR_TOL_M = 2e-4  # the Localizer tests' xy tolerance (card vs CPU too)
PAR_SCORE_REL = 1e-4  # scores: of their scale (fp32 PHAT: 1.4e-4)


def par_time(card, what, sharded, plain=None):
    """Say ``what``'s sharded call time and, when given, the unsharded
    call's (median of ``TRIALS`` on the host clock around a synchronised
    card)."""
    t = time_ms(sharded)
    line = f"{what}: sharded {ms_text(t)}"
    if plain is not None:
        line += f"; unsharded {ms_text(time_ms(plain))}"
    return line + f" ({card})"


def clear_rows(scores, margin=DECISION_MARGIN):
    """Rows [B] whose best score beats the runner-up by more than
    ``margin`` of the scores' scale (their argmax is a decision no fp32
    rounding flips)."""
    import torch

    top2 = scores.topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]) > margin * float(scores.abs().max())


def parallel_grid(phase, card, results, failures, mesh):
    """Grid-parallel localize (``make_sharded_localize``, grid_parallel)
    and the explicit SPMD grid localizer on the reference array's 101 x 101
    grid at ``PAR_FRAMES`` frames, against the unsharded call."""
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.parallel import sharded, spmd

    rng = np.random.default_rng(SEED + 170)
    mics = geometry.reference_array()
    loc = Localizer.create(mics, srp_form="matmul", device="cuda")
    frames = torch.from_numpy(scene_frames(mics, PAR_FRAMES, rng)).cuda()
    fn, params = sharded.make_sharded_localize(loc, mesh, grid_parallel=True)
    out = counted("par_grid", results, lambda: fn(params, frames), phase)
    ref = loc(frames)
    clear = clear_rows(ref["scores"])
    cell_ok = torch.equal(out["best_cell"][clear],
                          ref["scores"].argmax(dim=-1)[clear])
    same_cell = out["best_cell"] == ref["scores"].argmax(dim=-1)
    d_xy = float((out["xy"] - ref["xy"]).abs().max())
    xy_equal = torch.equal(out["xy"][same_cell], ref["xy"][same_cell])
    ints = all(torch.equal(out[k], ref[k]) for k in ("best_shift",))
    ok = cell_ok and ints and xy_equal and d_xy <= PAR_TOL_M
    say(phase, f"par_grid: {PAR_FRAMES} frames of 3 x 1,024, 101 x 101 "
        f"cells, mesh 1x1 (NCCL world of one): best cell equal to the "
        f"unsharded argmax on the {int(clear.sum())} clear rows {cell_ok} "
        f"(on {int(same_cell.sum())} of {PAR_FRAMES} rows overall), shifts "
        f"equal {ints}, xy bit-equal where the cell is {xy_equal}, xy within "
        f"{d_xy:.2e} m")
    if not ok:
        failures.append("par_grid")
    say(phase, par_time(card, "par_grid", lambda: fn(params, frames),
                        lambda: loc(frames)))
    sfn = spmd.make_spmd_grid_localizer(loc, mesh)
    sout = counted("par_spmd_grid", results, lambda: sfn(frames), phase)
    ok = (torch.equal(sout["best_cell"], out["best_cell"])
          and torch.equal(sout["tdoa_samples"], ref["tdoa_samples"]))
    say(phase, f"par_spmd_grid: cell equal to the sharded localize's and "
        f"TDOAs bit-equal to the unsharded call's {ok}")
    if not ok:
        failures.append("par_spmd_grid")
    return loc, frames, out


def parallel_grid_ways(phase, card, results, failures, loc, frames):
    """The grid's model axis ``PAR_WAYS`` ways on the one card: each
    shard's SRP-argmax kernel at the shard's shape and its neighbour
    scores, then the combines; against the world of one (one shard)."""
    import torch
    from audio_triangulation_tpu_torch.models import localizer as lm
    from audio_triangulation_tpu_torch.ops import srp
    from audio_triangulation_tpu_torch.parallel import spmd

    cfg, grid, params = loc.pipeline, loc.grid, loc.params
    flat = lm._flat_frames(frames, cfg)
    corr_t = lm.gcc_peaks(flat, params, cfg)[0]
    hw = (grid.height, grid.width)

    def run(ways):
        shards = [spmd.grid_shard(params, cfg, grid.num_cells, ways, i)
                  for i in range(ways)]
        vals, cells = zip(*[spmd.grid_argmax_body(corr_t, s)
                            for s in shards])
        best, cell = spmd.argmax_combine(vals, cells)
        idx = srp.peak_neighbours(cell, hw)
        nb = spmd.sum_combine([spmd.neighbour_body(corr_t, s, idx)
                               for s in shards])
        return best, cell, spmd.refined_xy(cell, nb, grid), shards

    best4, cell4, xy4, shards = counted("par4_grid", results,
                                        lambda: run(PAR_WAYS), phase)
    best1, cell1, xy1, _ = run(1)
    scores = srp.srp_scores_matmul(corr_t, params.onehot)
    xy_plain = srp.grid_peak_xy(scores, hw, (grid.half_cells_x,
                                             grid.half_cells_y),
                                grid.cells_per_m, refine=True)
    edge = [s.start + s.onehot.shape[1] for s in shards[:-1]]
    ok = (torch.equal(cell4, cell1) and torch.equal(best4, best1)
          and torch.equal(xy4, xy1))
    d_plain = float((xy1 - xy_plain).abs().max())
    ok = ok and d_plain <= 1e-4
    say(phase, f"par4_grid: {PAR_WAYS} shards of "
        f"{shards[0].onehot.shape[1]} cells (edges at {edge}) on one card, "
        f"srp_argmax_kernel at [{PAR_FRAMES}, {corr_t[0].numel()}] x "
        f"[{corr_t[0].numel()}, {shards[0].onehot.shape[1]}] each: best "
        f"cell, score and refined peak equal to one shard's {ok}; "
        f"the refined peak within {d_plain:.2e} m of the peak fit on the "
        f"whole [B, G] scores")
    if not ok:
        failures.append("par4_grid")
    say(phase, par_time(card, "par4_grid (4 shards in turn)",
                        lambda: run(PAR_WAYS), lambda: run(1)))


def parallel_pairs(phase, card, results, failures, mesh):
    """Pair sharding of the 64-mic array (2,016 pairs) at
    ``LARGE_FRAMES`` frames of 4,096: the world of one against the
    unsharded call, then ``PAR_WAYS`` pair shards in turn on the card
    (the large-array kernel at the shard's shape each, precomputed
    steering shards) against the world of one."""
    import torch
    from audio_triangulation_tpu_torch import Localizer
    from audio_triangulation_tpu_torch.models import localizer as lm
    from audio_triangulation_tpu_torch.parallel import spmd

    mics, grid, configs = large_configs()
    cfg = configs[0][1]
    rng = np.random.default_rng(SEED + 171)
    loc = Localizer.create(mics, cfg, grid, with_solver=False, device="cuda")
    frames = torch.from_numpy(scene_frames(
        mics, LARGE_FRAMES, rng, fixed_source=(0.4, -0.3, 1.2),
        n=cfg.frame_size)).cuda()
    fn = spmd.make_spmd_pair_localizer(loc, mesh)
    out = counted("par_pairs_64mic", results, lambda: fn(frames), phase)
    ref = loc(frames)
    scale = float(ref["scores"].abs().max())
    d_ref = float((out["scores"] - ref["scores"]).abs().max()) / scale
    cell_ok = torch.equal(out["scores"].argmax(-1), ref["scores"].argmax(-1))
    d_xy = float((out["xy_grid"] - ref["xy_grid"]).abs().max())
    ok = d_ref <= PAR_SCORE_REL and cell_ok and d_xy <= 1e-5
    say(phase, f"par_pairs_64mic: {LARGE_FRAMES} frames of 64 x 4,096, "
        f"2,016 pairs, 63 x 63 cells, mesh 1x1, steering "
        f"{'precomputed' if fn.big_steering else 'pair-blocked'}: scores "
        f"within {d_ref:.2e} of scale of the unsharded call's (bound "
        f"{PAR_SCORE_REL}), grid cell equal {cell_ok}, xy_grid within "
        f"{d_xy:.2e} m")
    if not ok:
        failures.append("par_pairs_64mic")
    flat = lm._flat_frames(frames, cfg)
    p, g = loc.params.lut_flat.shape
    steer = spmd.big_steering(cfg, p, g, PAR_WAYS)
    shards = [spmd.pair_shard(loc.params, cfg, PAR_WAYS, i, steer=steer)
              for i in range(PAR_WAYS)]

    def run():
        return spmd.pair_finish(spmd.sum_combine(
            [spmd.pair_scores_body(flat, loc.window, s, cfg)
             for s in shards]), grid)

    out4 = counted("par4_pairs", results, run, phase)
    d4 = float((out4["scores"] - out["scores"]).abs().max()) / scale
    cell4 = torch.equal(out4["scores"].argmax(-1), out["scores"].argmax(-1))
    d4_xy = float((out4["xy_grid"] - out["xy_grid"]).abs().max())
    ok = d4 <= PAR_SCORE_REL and cell4 and d4_xy <= 1e-5
    say(phase, f"par4_pairs: {PAR_WAYS} shards of "
        f"{shards[0].pairs.shape[0]} pairs on one card, gcc_large_kernel at "
        f"[{LARGE_FRAMES}, 64 mics, {shards[0].pairs.shape[0]} pairs] each, "
        f"steering {'precomputed' if steer else 'pair-blocked'} "
        f"([{shards[0].pairs.shape[0] * cfg.num_lags}, {g}] a shard): "
        f"summed scores within {d4:.2e} of scale of the world of one's, "
        f"grid cell equal {cell4}, xy_grid within {d4_xy:.2e} m")
    if not ok:
        failures.append("par4_pairs")
    say(phase, par_time(card, "par_pairs_64mic", lambda: fn(frames),
                        lambda: loc(frames)))
    say(phase, par_time(card, "par4_pairs (4 shards in turn)", run))
    del shards
    torch.cuda.empty_cache()


def parallel_fusion(phase, card, results, failures, mesh):
    """``make_fusion_spmd`` on phase 13's ``fusion_2x4`` at ``PAR_FRAMES``
    events in the world of one, against the unsharded call; then four
    squares (``fusion_4x4``) with the array axis ``PAR_WAYS`` ways on the
    card (the GCC kernel without peaks at one array a shard), against the
    world of one."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.models.fusion import (
        ArrayFusionLocalizer)
    from audio_triangulation_tpu_torch.parallel import spmd
    from audio_triangulation_tpu_torch.utils import synth

    make, event, _ = estimator_paths()["fusion_2x4"]
    fus = make("cuda")
    frames = noisy(event, PAR_FRAMES, SEED + 172)
    fn = spmd.make_fusion_spmd(fus, mesh)
    out = counted("par_fusion_2x4", results, lambda: fn(frames), phase)
    ref = fus(frames)
    ok = all(torch.equal(out[k], ref[k])
             for k in ("scores", "xy_grid", "xy", "tdoa_samples"))
    say(phase, f"par_fusion_2x4: {PAR_FRAMES} events of 2 arrays x 4 x "
        f"1,024, mesh 1x1: scores, xy_grid, xy and TDOAs bit-equal to the "
        f"unsharded call's {ok}")
    if not ok:
        failures.append("par_fusion_2x4")
    say(phase, par_time(card, "par_fusion_2x4", lambda: fn(frames),
                        lambda: fus(frames)))

    sq = geometry.square_array(0.25)
    arrays = [sq + np.array(o, np.float32)
              for o in ((-1.0, 0.0), (1.0, 0.0), (0.0, -1.0), (0.0, 1.0))]
    fus4 = ArrayFusionLocalizer.create(arrays, PipelineConfig(phat=True),
                                       device="cuda")
    ev = synth.synth_scene(np.array([*FUSION_SOURCE, 1.2]),
                           np.concatenate(arrays))[0].astype(np.float32)
    frames4 = noisy(ev.reshape(4, 4, 1024), PAR_FRAMES, SEED + 173)
    one = spmd.make_fusion_spmd(fus4, mesh)(frames4)
    w = fus4._weights(None)

    def run():
        parts = [spmd.fusion_body(fus4, frames4[:, i:i + 1], (i, i + 1), w)
                 for i in range(PAR_WAYS)]
        return spmd.fusion_finish(
            fus4, spmd.sum_combine([p for p, _ in parts]),
            torch.cat([t for _, t in parts], dim=1), w)

    out4 = counted("par4_fusion", results, run, phase)
    scale = float(one["scores"].abs().max())
    d_s = float((out4["scores"] - one["scores"]).abs().max()) / scale
    d_xy = float((out4["xy"] - one["xy"]).abs().max())
    ok = (torch.equal(out4["tdoa_samples"], one["tdoa_samples"])
          and torch.equal(out4["xy_grid"], one["xy_grid"])
          and d_s <= PAR_SCORE_REL and d_xy <= PAR_TOL_M)
    say(phase, f"par4_fusion: 4 squares, {PAR_WAYS} array shards on one "
        f"card (gcc_kernel at [{PAR_FRAMES}, 4 mics] each): TDOAs and "
        f"grid peak equal to the world of one's "
        f"{ok}, scores within {d_s:.2e} of scale, xy within {d_xy:.2e} m")
    if not ok:
        failures.append("par4_fusion")
    say(phase, par_time(card, "par4_fusion (4 shards in turn)", run,
                        lambda: fus4(frames4)))


def parallel_streams(phase, card, results, failures, mesh):
    """``make_sharded_stream_step`` at ``PAR_STREAMS`` streams of the
    streaming scene, plain and tracked with health weights and the CAF
    velocity fused into the bank, against ``step_many`` on the same
    chunks."""
    import torch
    from audio_triangulation_tpu_torch import (StreamConfig,
                                               StreamingLocalizer,
                                               TrackedStreamingLocalizer,
                                               geometry)
    from audio_triangulation_tpu_torch.models.streaming import state_leaves
    from audio_triangulation_tpu_torch.parallel import sharded

    x = torch.from_numpy(stream_scene(PAR_STREAMS, seed=SEED + 174)[0]).cuda()
    mics = geometry.reference_array()
    for name, sl in (
            ("par_stream", StreamingLocalizer.create(
                mics, stream=StreamConfig(chunk_size=STREAM_CHUNK),
                device="cuda")),
            ("par_stream_tracked", TrackedStreamingLocalizer.create(
                mics, stream=StreamConfig(chunk_size=STREAM_CHUNK,
                                          health_weighting=True,
                                          solve_velocity=True),
                fuse_velocity=True, device="cuda"))):
        fn, init_states = sharded.make_sharded_stream_step(sl, mesh)
        chunks = [x[..., i:i + STREAM_CHUNK]
                  for i in range(0, x.shape[-1], STREAM_CHUNK)]

        def run(step, states):
            outs = []
            for c in chunks:
                states, out = step(states, c)
                outs.append(out)
            return states, outs

        st, outs = counted(name, results,
                           lambda: run(fn, init_states(PAR_STREAMS)), phase)
        st_ref, ref = run(sl.step_many, sl.init_states(PAR_STREAMS))
        ok = all(same(a[k], b[k]) for a, b in zip(outs, ref) for k in a)
        ok = ok and all(same(a, b) for a, b in zip(state_leaves(st),
                                                   state_leaves(st_ref)))
        events = int(sum(int(o["event"].sum()) for o in outs))
        say(phase, f"{name}: {PAR_STREAMS} streams x {len(chunks)} chunks "
            f"of 3 x {STREAM_CHUNK}, mesh 1x1: every output and the final "
            f"state bit-equal to step_many's {ok} ({events} events)")
        if not ok:
            failures.append(name)
        state = [init_states(PAR_STREAMS)]

        def one_step(step=fn):
            state[0], _ = step(state[0], chunks[0])

        say(phase, par_time(card, f"{name} step", one_step,
                            lambda: one_step(sl.step_many)))


def parallel_training(phase, card, results, failures, mesh):
    """``data_parallel_step`` around ``Calibrator.train_step`` on phase
    15's ``calib_step_8mic`` scene (4,096 events) and around
    ``NeuralLocalizer.train_step`` (``PAR_NEURAL_FRAMES`` frames), one step
    each, against the plain step from the same parameters."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.models import calibration, neural
    from audio_triangulation_tpu_torch.parallel import sharded

    mics = geometry.circular_array(PAR_CALIB_MICS, 0.2)
    frames, planes, guess = calib_scene(mics, CALIB_EVENTS, SEED + 175)
    calib = calibration.Calibrator.create(PAR_CALIB_MICS, device="cuda")
    batch = calibration.CalibBatch(torch.from_numpy(frames).cuda(),
                                   torch.from_numpy(planes).cuda())
    got = {}
    for run, step in (("dp", sharded.data_parallel_step(calib.train_step,
                                                        mesh)),
                      ("plain", calib.train_step)):
        params, opt = calib.init(guess)
        fn = (lambda: step(params, opt, batch))
        _, _, loss = (counted("par_calib_step_8mic", results, fn, phase)
                      if run == "dp" else fn())
        got[run] = (loss, params.mic_xy.detach().clone())
    ok = (torch.equal(got["dp"][0], got["plain"][0])
          and torch.equal(got["dp"][1], got["plain"][1]))
    say(phase, f"par_calib_step_8mic: data_parallel_step on {CALIB_EVENTS} "
        f"events x 8 mics, mesh 1x1: loss and mics bit-equal to the plain "
        f"step's {ok}")
    if not ok:
        failures.append("par_calib_step_8mic")
    params, opt = calib.init(guess)
    step = sharded.data_parallel_step(calib.train_step, mesh)
    say(phase, par_time(card, "par_calib_step_8mic",
                        lambda: step(params, opt, batch),
                        lambda: calib.train_step(params, opt, batch)))

    sq = geometry.square_array(0.3)
    net = neural.NeuralLocalizer.create(sq, PipelineConfig(phat=True),
                                        device="cuda")
    rng = np.random.default_rng(SEED + 176)
    xy = rng.uniform(-0.9, 0.9, (PAR_NEURAL_FRAMES, 2)).astype(np.float32)
    nf = torch.from_numpy(scene_frames(
        sq, PAR_NEURAL_FRAMES, rng)).cuda()
    nxy = torch.from_numpy(xy).cuda()
    got = {}
    for run, maker in (("dp", lambda: sharded.data_parallel_step(
            net.train_step, mesh)), ("plain", lambda: net.train_step)):
        params, opt = net.init(seed=0)
        step = maker()
        fn = (lambda: step(params, opt, nf, nxy))
        _, _, loss = (counted("par_neural_step", results, fn, phase)
                      if run == "dp" else fn())
        got[run] = (loss, [p.detach().clone() for p in params.parameters()])
    ok = torch.equal(got["dp"][0], got["plain"][0]) and all(
        torch.equal(a, b) for a, b in zip(got["dp"][1], got["plain"][1]))
    say(phase, f"par_neural_step: data_parallel_step on "
        f"{PAR_NEURAL_FRAMES} frames, mesh 1x1: loss and weights bit-equal "
        f"to the plain step's {ok}")
    if not ok:
        failures.append("par_neural_step")


def parallel_multi_gpu(phase, failures):
    """An NCCL world of min(4, cards) running the dry run's seven steps
    where there are two cards or more; otherwise one line saying so."""
    import torch
    from audio_triangulation_tpu_torch.parallel import dryrun

    n = torch.cuda.device_count()
    if n < 2:
        say(phase, f"multi-GPU NCCL world: not run ({n} card on this "
            "machine; it needs two or more): multi-GPU collectives are "
            "neither measured nor claimed here")
        return
    t0 = time.perf_counter()
    try:
        dryrun.dryrun_multichip(min(4, n), device="cuda")
    except Exception as e:  # recorded; the phase fails
        say(phase, f"multi-GPU dry run failed: {e}")
        failures.append("multi_gpu_dryrun")
        return
    say(phase, f"multi-GPU dry run: {min(4, n)} NCCL ranks, seven steps "
        f"ok in {time.perf_counter() - t0:.1f} s (not a speed claim)")


def phase_parallel(card, results):
    """Phase 17: multi-device execution on the card.  An NCCL world of one
    (a ``file://`` store in a temporary directory) runs every entry point
    of ``parallel``: grid-parallel localize and the SPMD grid localizer,
    pair sharding at 64 mics, ``fusion_2x4``, sharded streaming (plain and
    tracked with health and velocity), data-parallel calibration and
    neural steps, each held to the unsharded call; then the grid, pair and
    fusion model axes run four ways on the one card, shard by shard, and
    are held to the world of one.  Each path's wall time and launches are
    printed; every part runs and the phase fails at its end if any part
    failed."""
    import tempfile
    import traceback

    import torch
    import torch.distributed as dist
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib

    t0 = time.perf_counter()
    phase = "17 parallel"
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            mesh = mesh_lib.make_mesh((1, 1), device="cuda")
            say(phase, f"NCCL world of one: backend {dist.get_backend()}, "
                f"mesh {tuple(mesh.mesh.shape)} {mesh.mesh_dim_names}")
            grid_state = []
            parts = [
                ("par_grid", lambda: grid_state.append(parallel_grid(
                    phase, card, results, failures, mesh))),
                ("par4_grid", lambda: parallel_grid_ways(
                    phase, card, results, failures, *grid_state[0][:2])),
                ("par_pairs", lambda: parallel_pairs(
                    phase, card, results, failures, mesh)),
                ("par_fusion", lambda: parallel_fusion(
                    phase, card, results, failures, mesh)),
                ("par_streams", lambda: parallel_streams(
                    phase, card, results, failures, mesh)),
                ("par_training", lambda: parallel_training(
                    phase, card, results, failures, mesh))]
            for name, part in parts:
                try:
                    part()
                except (Exception, SystemExit):  # recorded; fails below
                    traceback.print_exc()
                    failures.append(name)
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    parallel_multi_gpu(phase, failures)
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


# ----------------------------------------------------------------------
# Phase 18: the command line
# ----------------------------------------------------------------------

# the CLI's event WAV: floor noise with bursts of the reference array's
# source at these samples (localize-wav)
CLI_WAV_EVENTS = (4000, 16000, 28000)


def cli_run(argv) -> tuple[str, dict, float]:
    """(printout, launches by kernel, wall seconds) of one in-process run
    of the port's CLI."""
    import contextlib
    import io

    import torch
    from audio_triangulation_tpu_torch.cli import main as cli

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(list(argv))
    torch.cuda.synchronize()
    return buf.getvalue(), launch_counts(), time.perf_counter() - t0


def cli_wav(path: str) -> None:
    """A 3-channel WAV of floor noise with one event burst at each of
    ``CLI_WAV_EVENTS``."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import io as audio_io
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(SEED + 180)
    mics = geometry.reference_array()
    x = rng.integers(127, 130, size=(3, 40000)).astype(np.float64)
    for i, at in enumerate(CLI_WAV_EVENTS):
        src = place(rng.uniform(-0.9, 0.9, 2))
        x[:, at:at + 1024] += 110.0 * synth.synth_scene(
            src, mics, seed=SEED + 181 + i)[0]
    audio_io.write_wav(path, np.clip(np.round(x), 0, 255).astype(np.int16),
                       50_000)


def cli_commands(tmp: str) -> list:
    """(name, argv, kernels its card run must launch, decimal tolerance,
    relative tolerance, lines left out of the comparison) of every
    subcommand at the reference's defaults, and three variants: doa's
    MUSIC and elevation, localize-wav's diagnosis."""
    wav = os.path.join(tmp, "events.wav")
    cli_wav(wav)
    manifest = os.path.join(HERE, "tests", "data", "eval", "manifest.json")
    loc_k = ("gcc_kernel", "gn_kernel")
    return [
        ("simulate", ["simulate", "--out", os.path.join(tmp, "dash.png")],
         loc_k, 0.011, 0.0, ("dashboard ->",)),
        ("evaluate", ["evaluate", manifest], loc_k, 0.03, 0.0, ()),
        ("stream", ["stream"], ("detector_scan_kernel",), 1.5e-3, 0.0, ()),
        ("doa", ["doa"], ("gcc_kernel",), 0.02, 0.0, ()),
        ("doa_music", ["doa", "--method", "music"], (), 0.02, 0.0, ()),
        ("doa_elevation", ["doa", "--elevation", "30"], ("gcc_kernel",),
         0.02, 0.0, ()),
        ("gen_window", ["gen-window"], (), 0.0, 0.0, ()),
        ("localize_wav", ["localize-wav", wav, "--diagnose"], loc_k, 0.011,
         1e-2, ()),
        ("calibrate", ["calibrate"], (), 0.011, 1e-4, ()),
        ("design", ["design"], (), 0.011, 0.0, ()),
        ("map_room", ["map-room"], loc_k, 0.011, 0.05, ()),
    ]


def cli_serve(phase, card, failures):
    """``serve`` in a subprocess on a free port (the card, its default):
    /healthz, then one /localize of 64 frames, bit-equal to ``loc(frames)``
    here on the card; every wait bounded."""
    import select
    import urllib.request

    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry

    proc = subprocess.Popen(
        [sys.executable, "-m", "audio_triangulation_tpu_torch", "serve",
         "--port", "0"], cwd=HERE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, bufsize=1)
    try:
        deadline = time.time() + 120
        line = ""
        while "serving on" not in line:
            left = deadline - time.time()
            if left <= 0 or proc.poll() is not None:
                raise RuntimeError(f"no serving line within 120 s "
                                   f"({proc.poll()})")
            ready, _, _ = select.select([proc.stdout], [], [], left)
            if ready:
                line = proc.stdout.readline()
        url = line.split()[2]
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        mics = geometry.reference_array()
        frames = scene_frames(mics, 64, np.random.default_rng(SEED + 182))
        req = urllib.request.Request(url + "/localize", **octet(frames))
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        ms = (time.perf_counter() - t0) * 1e3
        loc = Localizer.create(mics, device="cuda")
        out = loc(torch.from_numpy(frames).cuda())
        ok = health.get("backend") == "gpu" and served_equal(body, out)
        say(phase, f"cli_serve: subprocess on {url}: /healthz {health}; "
            f"/localize of 64 frames in {ms:.1f} ms (its first request), "
            f"bit-equal to loc(frames) on this card {ok} (launches in the "
            f"server's process are not counted here) ({card})")
        if not ok:
            failures.append("cli_serve")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def cli_fifo(phase, card, failures):
    """``stream --source fifo://...`` on the card and on the CPU: a FIFO
    of transported PCM (one event burst) through the native detector, each
    event localized; the printouts agree."""
    import tempfile

    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.cli.compare import compare_printouts
    from audio_triangulation_tpu_torch.runtime import transport
    from audio_triangulation_tpu_torch.utils import synth

    rng = np.random.default_rng(SEED + 183)
    x = rng.integers(127, 130, size=(3, 30000)).astype(np.float64)
    x[:, 9000:10024] += 110.0 * synth.synth_scene(
        place((0.5, 0.4)), geometry.reference_array(), noise_rms=0.0)[0]
    pcm = np.clip(np.round(x), 0, 255).astype(np.int16).T.copy()
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for dev in ("cuda", "cpu"):
            path = os.path.join(tmp, f"{dev}.fifo")
            os.mkfifo(path)
            transport.stream_pcm_to_fifo(path, pcm)
            outs[dev] = cli_run(["stream", "--source", f"fifo://{path}",
                                 "--max-seconds", "20", "--device", dev])
    text, counts, wall = outs["cuda"]
    agree, gap, why = compare_printouts(outs["cpu"][0], text,
                                        skip=("attached",))
    events = [ln for ln in text.splitlines() if ln.startswith("event @")]
    ok = (agree and len(events) == 1 and counts["gcc_kernel"] >= 1
          and counts["gn_kernel"] >= 1)
    say(phase, f"cli_stream_fifo: {len(events)} event through the FIFO, "
        f"launches {fmt_counts(counts)}; card vs CPU printouts agree "
        f"{agree} (largest gap {gap:.2e}){'' if agree else ': ' + why}; "
        f"{wall:.2f} s on the card, {outs['cpu'][2]:.2f} s on the CPU "
        f"({card})")
    if not ok:
        failures.append("cli_stream_fifo")


def fmt_counts(counts: dict) -> str:
    return ", ".join(f"{k} x{v}" for k, v in counts.items() if v) or \
        "no kernel"


def phase_cli(card, results):
    """Phase 18: the command line on the card.  Each of the eleven
    subcommands runs in this process through ``cli.main([...,
    "--device", "cuda"])`` at the reference's defaults, its launches
    counted, and is held to the same command under ``--device cpu``
    (printed positions within the tests' tolerances; shifts, trigger
    samples, cells and counts equal); ``serve`` runs in a subprocess on a
    free port and answers one /localize bit-equal to ``loc(frames)``;
    ``stream --source fifo://`` reads a FIFO; ``bench`` runs once on the
    card; one subprocess proves the module entry.  Every part runs; the
    phase fails at its end if any part failed."""
    import tempfile
    import traceback

    from audio_triangulation_tpu_torch.cli.compare import compare_printouts

    t0 = time.perf_counter()
    phase = "18 cli"
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        for name, argv, kernels, tol, rel, skip in cli_commands(tmp):
            try:
                text, counts, wall = cli_run([*argv, "--device", "cuda"])
                ref, _, cpu_wall = cli_run([*argv, "--device", "cpu"])
                agree, gap, why = compare_printouts(ref, text, tol=tol,
                                                    rel=rel, skip=skip)
                launched = all(counts[k] >= 1 for k in kernels)
                say(phase, f"cli_{name}: launches {fmt_counts(counts)}; "
                    f"card vs CPU printouts agree {agree} (largest decimal "
                    f"gap {gap:.2e}, bound {tol} + {rel} rel)"
                    f"{'' if agree else ': ' + why}; {wall:.2f} s on the "
                    f"card, {cpu_wall:.2f} s on the CPU ({card})")
                for k, v in counts.items():
                    results[k]["launches"] += v
                    if v:
                        results[k].setdefault("launches_by_path", {})[
                            f"cli_{name}"] = v
                if not (agree and launched):
                    failures.append(f"cli_{name}")
            except (Exception, SystemExit):  # recorded; fails below
                traceback.print_exc()
                failures.append(f"cli_{name}")
        for name, part in (("cli_stream_fifo", cli_fifo),
                           ("cli_serve", cli_serve)):
            try:
                part(phase, card, failures)
            except (Exception, SystemExit):
                traceback.print_exc()
                failures.append(name)
        try:
            text, counts, wall = cli_run(["bench", "--device", "cuda"])
            lines = [json.loads(ln) for ln in text.splitlines()]
            ok = len(lines) == 3 and all(
                np.isfinite(ln["value"]) and ln["value"] > 0 for ln in lines)
            say(phase, f"cli_bench: launches {fmt_counts(counts)}; "
                + "; ".join(f"{ln['metric']} {ln['value']:.1f} frames/s"
                            for ln in lines)
                + f"; {wall:.2f} s ({card})")
            if not ok:
                failures.append("cli_bench")
        except (Exception, SystemExit):
            traceback.print_exc()
            failures.append("cli_bench")
        try:
            png = os.path.join(tmp, "module.png")
            t1 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "audio_triangulation_tpu_torch",
                 "simulate", "--out", png], cwd=HERE, capture_output=True,
                text=True, timeout=300)
            inproc, _, _ = cli_run(["simulate", "--out", png])
            agree = compare_printouts(inproc, proc.stdout, tol=0.011,
                                      skip=("dashboard ->",))[0]
            ok = proc.returncode == 0 and os.path.getsize(png) > 100 and agree
            say(phase, f"cli_module_entry: python3 -m "
                f"audio_triangulation_tpu_torch simulate: rc "
                f"{proc.returncode}, the same printout as in process "
                f"{agree}, {time.perf_counter() - t1:.1f} s")
            if not ok:
                failures.append("cli_module_entry")
        except (Exception, SystemExit):
            traceback.print_exc()
            failures.append("cli_module_entry")
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


# ---- phase 19: the root tools, benches and examples -------------------------

TOOLS_CHECK_FRAMES = 256  # frames of a bench_configs record held to the CPU
TOOLS_CPU_LARGE_FRAMES = 2  # CPU frames of a replicated 64-mic record
TOOLS_TOL_M = 2e-4  # the Localizer tests' xy tolerance
TOOLS_NOISE_RTOL = 5e-4  # and of a noise frame's distance (record 3)
# tdoa of the 64-mic records (samples): of 2,016 pairs a few have a peak
# whose three values lie within rounding of each other, and their parabola
# moves by up to 3.6e-3 between the devices (the solved xy by 2e-6 m)
TOOLS_LARGE_TDOA = 1e-2
ROBUST_MEDIAN_TOL_CM = 0.05  # card vs CPU rows of bench_robustness
INT8_TOL = 1.5e-5  # one unit of the int8 line's fifth decimal
TOOLS_SOAK_MINUTES = 0.5
EVAL_FLOORS_CM = {"anechoic_hi": 1.0, "anechoic_lo": 2.0,
                  "reverb_light": 8.0, "reverb_mod": 15.0}
EXAMPLE_TOL, EXAMPLE_REL = 0.011, 0.01  # tests/test_torch_examples.py's
# lines left out of the card-vs-CPU comparison: the server's port, and block
# WPE in float32, unstable on both devices (held to its floor instead)
EXAMPLE_SKIP = {"serving_http": ("server up at",),
                "advanced": ("^dereverb:",)}
EXAMPLE_KERNELS = {
    "quickstart": ("gcc_kernel", "gn_kernel", "detector_scan_kernel"),
    "advanced": ("gcc_kernel", "gn_kernel"),
    "production": ("gcc_kernel", "gn_kernel", "detector_scan_kernel"),
    "robustness": ("gcc_kernel", "gcc_stats_kernel", "gn_kernel"),
    "serving_http": ("gcc_kernel", "gn_kernel", "detector_scan_kernel")}
REPLICATED_FRAMES = 16384  # the replicated-frames probe's batch


def tool_counted(results, failures, name, kernels, fn):
    """(result of ``fn()``, launches by kernel) with the counts from 0,
    added to the results under ``name``; ``name`` fails if a kernel of
    ``kernels`` was not launched."""
    import torch

    reset_counts()
    out = fn()
    torch.cuda.synchronize()
    counts = launch_counts()
    for k, v in counts.items():
        results[k]["launches"] += v
        if v:
            results[k].setdefault("launches_by_path", {})[name] = v
    if any(counts[k] < 1 for k in kernels):
        failures.append(f"{name}: a kernel of its path was never launched "
                        f"({fmt_counts(counts)})")
    return out, counts


def printed(fn):
    """(what ``fn()`` printed, its return value)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn()
    return buf.getvalue(), ret


def decided_rows(corr, scores, margin=DECISION_MARGIN):
    """[B] bool: the frames whose best lags are ``margin`` of scale clear of
    the runner-up in every pair, and whose best grid score is ``margin`` of
    scale clear of the best lower score.  Unlike ``bench_accuracy
    .clear_of_ties`` an exact tie of cells is kept: cells that share every
    pair's lag score alike on any device, and the first of them wins."""
    import torch

    top2 = corr.topk(2, dim=-1).values
    scale = corr.abs().amax(dim=(-1, -2))
    lag_gap = ((top2[..., 0] - top2[..., 1]) / scale[:, None]).amin(-1)
    top = scores.amax(-1, keepdim=True)
    below = torch.where(scores < top, scores,
                        torch.full_like(scores, -float("inf"))).amax(-1)
    cell_gap = (top[:, 0] - below) / scores.abs().amax(-1)
    return (lag_gap >= margin) & (cell_gap >= margin)


def tools_bench_configs(phase, card, results, failures):
    """The seven records on the card (7 trials each), then each record's
    outputs on ``TOOLS_CHECK_FRAMES`` frames of the card held to the CPU
    path: xy within ``TOOLS_TOL_M`` (tdoa 1e-3 samples), best shifts and
    grid cells equal; record 3's noise frames off near ties, xy also within
    ``TOOLS_NOISE_RTOL`` of its distance."""
    import torch
    from audio_triangulation_tpu_torch.tools import bench_configs

    _, (recs, counts) = printed(lambda: tool_counted(
        results, failures, "tool_bench_configs",
        ("gcc_kernel", "gn_kernel", "gcc_large_kernel"),
        lambda: bench_configs.main([])))
    for r in recs:
        say(phase, f"bench_configs {r['config']}: {r['frames_per_sec']:.1f} "
            f"frames/s (IQR {r['iqr'][0]:.1f}-{r['iqr'][1]:.1f}, "
            f"{r['trials']} trials of {r['batch']}); route {r['route']}"
            + (f"; single frame {r['single_frame_latency_us']:.1f} us"
               if "single_frame_latency_us" in r else "") + f" ({card})")
    if not (len(recs) == 7 and all(
            r["frames_per_sec"] > 0 and r["trials"] == 7
            and r["power_limit_w"] for r in recs)
            and [r["config"] for r in recs]
            == [n for n, _ in bench_configs.RECORDS]):
        failures.append("tool_bench_configs: malformed records")
    say(phase, f"bench_configs launches {fmt_counts(counts)}")
    for name, _ in bench_configs.RECORDS:
        n_cpu = (TOOLS_CPU_LARGE_FRAMES if name.startswith("5")
                 else TOOLS_CHECK_FRAMES)
        card_c = bench_configs.make_config(name, "cuda", TOOLS_CHECK_FRAMES)
        cpu_c = bench_configs.make_config(name, "cpu", n_cpu)
        if card_c.loc is None:  # record 1: the unfused engine's tdoa
            gap = float((card_c.call()["tdoa_samples"].cpu()
                         - cpu_c.call()["tdoa_samples"]).abs().max())
            ok = gap <= 1e-3
            say(phase, f"bench_configs {name}: card vs CPU tdoa {gap:.2e} "
                "samples")
        else:
            if name == bench_configs.RECORDS[2][0]:
                frames = [bench_configs.framing.frame_multichannel_lanes(
                    c.frames, 1024, bench_configs.HOP)[0]
                    for c in (card_c, cpu_c)]
            else:
                frames = [card_c.frames, cpu_c.frames]
            got = {k: v.cpu() for k, v in card_c.loc(frames[0]).items()}
            ref = cpu_c.loc(frames[1])
            rows = torch.arange(TOOLS_CHECK_FRAMES) % n_cpu
            ref = {k: v[rows] for k, v in ref.items()}
            clear = decided_rows(ref["correlograms"], ref["scores"])
            dxy = (got["xy"] - ref["xy"])[clear].abs()
            allowed = TOOLS_TOL_M + (TOOLS_NOISE_RTOL * ref["xy"][clear].abs()
                                     if name == bench_configs.RECORDS[2][0]
                                     else 0.0)
            shift_rows = clear[:, None].expand_as(ref["best_shift"])
            if name.startswith("5"):  # 2,016 pairs: ties of raw lags too
                shift_rows = shift_rows & large_clear_rows(
                    cpu_c.loc, cpu_c.frames)[rows]
            shifts = bool(torch.equal(got["best_shift"][shift_rows],
                                      ref["best_shift"][shift_rows]))
            dtdoa = float((got["tdoa_samples"] - ref["tdoa_samples"])[
                shift_rows].abs().max())
            # the same cells: the cell-to-meters division may differ by
            # an ulp between the devices
            cell_gap = float((got["xy_grid"] - ref["xy_grid"])[clear].abs()
                             .max())
            ok = (shifts and cell_gap <= 1e-6
                  and dtdoa <= (TOOLS_LARGE_TDOA if name.startswith("5")
                                else 1e-3)
                  and bool((dxy <= allowed).all())
                  and float(clear.float().mean()) >= 0.75)
            say(phase, f"bench_configs {name}: card vs CPU on "
                f"{int(clear.sum())} of {TOOLS_CHECK_FRAMES} frames clear of "
                f"a near tie: xy {float(dxy.max()):.2e} m, tdoa "
                f"{dtdoa:.2e} samples, best shifts equal {shifts} (off raw "
                f"near ties: {int(shift_rows.sum())} of "
                f"{shift_rows.numel()} pairs), grid peaks {cell_gap:.2e} m "
                "apart")
        if not ok:
            failures.append(f"tool_bench_configs {name}: card vs CPU")
        del card_c, cpu_c
        torch.cuda.empty_cache()


def tools_bench_latency(phase, card, results, failures):
    """Both load points on the card, the scan kernel once a step; the
    device step must be under the synchronized p50 (``realtime_ok`` is
    reported)."""
    from audio_triangulation_tpu_torch.tools import bench_latency

    _, (res, counts) = printed(lambda: tool_counted(
        results, failures, "tool_bench_latency",
        ("detector_scan_kernel",), lambda: bench_latency.main([])))
    # synchronized steps, then a warm-up, a lead-in, 29 traced steps and a
    # lead-out
    steps = sum(n + 32 for n in (220, 60))
    for tag, p in res.items():
        if not isinstance(p, dict):
            continue
        s = p["synchronized"]
        say(phase, f"bench_latency {tag}: synchronized p50 / p90 / p99 / "
            f"max {s['p50_ms']:.4f} / {s['p90_ms']:.4f} / {s['p99_ms']:.4f} "
            f"/ {s['max_ms']:.4f} ms over {s['n']} chunks, realtime_ok "
            f"{s['realtime_ok']}; device step {p['device_step_ms']} ms "
            f"(profiler; {p['scan_kernels_traced']} scan records of 29 "
            f"steps), span {p['span_step_ms']} ms a step between CUDA "
            f"events ({card})")
        if not (p["device_step_ms"] and p["scan_kernels_traced"] == 29
                and p["device_step_ms"] <= p["span_step_ms"]
                and p["device_step_ms"] < s["p50_ms"]):
            failures.append(f"tool_bench_latency {tag}: the device step is "
                            "not under the synchronized p50, or its trace "
                            "lost records")
    say(phase, f"bench_latency launches {fmt_counts(counts)} for {steps} "
        "steps")
    if counts["detector_scan_kernel"] != steps:
        failures.append("tool_bench_latency: the scan kernel did not run "
                        "once a step")


def tools_bench_robustness(phase, card, results, failures):
    """The 20 rows on the card, held to the same tool on the CPU: hit rates
    equal, medians and p90 within ``ROBUST_MEDIAN_TOL_CM``."""
    from audio_triangulation_tpu_torch.tools import bench_robustness

    _, (rows, counts) = printed(lambda: tool_counted(
        results, failures, "tool_bench_robustness",
        ("gcc_kernel", "gcc_stats_kernel", "gn_kernel"),
        lambda: bench_robustness.main([])))
    t0 = time.perf_counter()
    _, cpu = printed(lambda: bench_robustness.main(["--device", "cpu"]))
    cpu_s = time.perf_counter() - t0
    worst, hits = 0.0, True
    for r, c in zip(rows, cpu):
        hits &= r["hit_rate_lt_10cm"] == c["hit_rate_lt_10cm"]
        worst = max(worst, abs(r["xy_err_median_cm"] - c["xy_err_median_cm"]),
                    abs(r["xy_err_p90_cm"] - c["xy_err_p90_cm"]))
    for cond in ("anechoic_10db", "reverb_rt60_0.25"):
        say(phase, f"bench_robustness {cond}, median / p90 cm, hit rate: "
            + "; ".join(f"{r['method']} {r['xy_err_median_cm']:.4f} / "
                        f"{r['xy_err_p90_cm']:.4f}, {r['hit_rate_lt_10cm']}"
                        for r in rows if r["condition"] == cond))
    say(phase, f"bench_robustness: {len(rows)} rows, routes "
        + "; ".join(f"{r['method']}: {r['route']}" for r in rows[::2])
        + f"; launches {fmt_counts(counts)}; hit rates equal to the CPU run "
        f"{hits}, medians and p90 {worst:.2e} cm from it (CPU run "
        f"{cpu_s:.1f} s) ({card})")
    if not (len(rows) == len(cpu) == 20 and hits
            and worst <= ROBUST_MEDIAN_TOL_CM):
        failures.append("tool_bench_robustness: card vs CPU rows")


def tools_int8(phase, card, results, failures):
    """The int8 line on the card (row 8's int8 mode twice), its products
    bit-equal to numpy's int32 products, the line within ``INT8_TOL`` of
    the CPU run's (integers and keys equal)."""
    from audio_triangulation_tpu_torch.tools import int8_dft_accuracy

    _, (line, counts) = printed(lambda: tool_counted(
        results, failures, "tool_int8_dft_accuracy",
        ("dft_matmul_kernel_int8",), lambda: int8_dft_accuracy.main([])))
    _, prod = int8_dft_accuracy.measure("cuda")
    exact = int8_dft_accuracy.products_exact(prod)
    _, cpu = printed(lambda: int8_dft_accuracy.main(["--device", "cpu"]))
    same = list(line) == list(cpu) and all(
        abs(v - cpu[k]) <= INT8_TOL if isinstance(v, float) else v == cpu[k]
        for k, v in line.items())
    say(phase, f"int8_dft_accuracy: {json.dumps(line)}; launches "
        f"{fmt_counts(counts)}; int8 products bit-equal to numpy's int32 "
        f"{exact} ({prod['re'].shape[0]} x {prod['re'].shape[1]} each); the "
        f"CPU run's line {'equal' if line == cpu else 'within ' + str(INT8_TOL)}"
        f" {same}")
    if not (exact and same and counts["dft_matmul_kernel_int8"] == 2):
        failures.append("tool_int8_dft_accuracy")


def tools_soak_transport(phase, card, results, failures):
    """``TOOLS_SOAK_MINUTES`` of the FIFO soak on the card: every block's
    event found and within tolerance, every gate."""
    from audio_triangulation_tpu_torch.tools import soak_transport

    _, (res, counts) = printed(lambda: tool_counted(
        results, failures, "tool_soak_transport",
        ("gcc_kernel", "gn_kernel"), lambda: soak_transport.main(
            ["--minutes", str(TOOLS_SOAK_MINUTES)])))
    say(phase, f"soak_transport: {res['blocks']} blocks, {res['events']} "
        f"events, {res['spurious']} spurious, {res['reconnects']} "
        f"reconnects, error median / max {res['median_err_m']:.4f} / "
        f"{res['max_err_m']:.4f} m, peak RSS {res['rss_start_mb']:.1f} -> "
        f"{res['rss_end_mb']:.1f} MB, ok {res['ok']}; launches "
        f"{fmt_counts(counts)} ({card})")
    if not (res["ok"] and res["events"] == res["blocks"] > 0
            and counts["gcc_kernel"] == res["events"] + 1):
        failures.append("tool_soak_transport")


def tools_eval_dataset(phase, card, results, failures):
    """The dataset regenerated into a temporary directory, within one count
    of the committed WAVs, then ``evaluate`` on it on the card inside
    ``tests/test_eval_dataset.py``'s floors."""
    import tempfile

    from audio_triangulation_tpu_torch.cli import main as cli
    from audio_triangulation_tpu_torch.tools import make_eval_dataset
    from audio_triangulation_tpu_torch.utils import io as audio_io

    committed = os.path.join(HERE, "tests", "data", "eval")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "eval")
        _, entries = printed(lambda: make_eval_dataset.main(
            ["--out", out]))
        with open(os.path.join(committed, "manifest.json")) as f:
            manifest_equal = entries == json.load(f)
        worst = max(int(np.abs(
            audio_io.read_wav(os.path.join(out, e["wav"]))[0].astype(np.int64)
            - audio_io.read_wav(os.path.join(committed, e["wav"]))[0].astype(
                np.int64)).max()) for e in entries)
        report = os.path.join(tmp, "report.json")
        _, (_, counts) = printed(lambda: tool_counted(
            results, failures, "tool_make_eval_dataset",
            ("gcc_kernel", "gn_kernel"), lambda: cli.main(
                ["evaluate", os.path.join(out, "manifest.json"), "--out",
                 report, "--device", "cuda"])))
        with open(report) as f:
            rep = json.load(f)
    kinds = {e["wav"]: e["kind"] for e in entries}
    errs = {}
    for row in rep["rows"]:
        if row.get("detected"):
            errs.setdefault(kinds[row["wav"]], []).append(row["err_cm"])
    meds = {k: float(np.median(v)) for k, v in errs.items()}
    summ = rep["summary"]
    ok = (manifest_equal and worst <= 1 and summ["detection_rate"] >= 0.95
          and summ["xy_err_median_cm"] < 2.0 and summ["xy_err_p90_cm"] < 20.0
          and all(k in meds and meds[k] < f
                  for k, f in EVAL_FLOORS_CM.items()))
    say(phase, f"make_eval_dataset: {len(entries)} scenes, manifest equal "
        f"{manifest_equal}, largest sample gap {worst} count(s); evaluate on "
        f"the card: detection {summ['detection_rate']}, median / p90 "
        f"{summ['xy_err_median_cm']:.4f} / {summ['xy_err_p90_cm']:.4f} cm, "
        f"by condition {meds}; launches {fmt_counts(counts)}")
    if not ok:
        failures.append("tool_make_eval_dataset")


def example_main(name, device):
    """A call of example ``name``'s ``main`` on ``device``: (printout,
    None)."""
    import importlib

    mod = importlib.import_module(
        f"audio_triangulation_tpu_torch.examples.{name}")
    return printed(lambda: mod.main(["--device", device]))


def tools_examples(phase, card, results, failures):
    """The five examples on the card, each printout held to ``--device
    cpu`` (``cli.compare.compare_printouts`` at the examples test's
    tolerances), their launches counted; the WPE line held to the JAX
    example's 20.6 dB floor."""
    import re

    from audio_triangulation_tpu_torch.cli.compare import compare_printouts

    for name, kernels in EXAMPLE_KERNELS.items():
        try:
            t0 = time.perf_counter()
            (text, _), counts = tool_counted(
                results, failures, f"example_{name}", kernels,
                lambda: example_main(name, "cuda"))
            wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref, _ = example_main(name, "cpu")
            cpu_wall = time.perf_counter() - t0
            agree, gap, why = compare_printouts(
                ref, text, tol=EXAMPLE_TOL, rel=EXAMPLE_REL,
                skip=EXAMPLE_SKIP.get(name, ()))
            extra = ""
            if name == "advanced":
                cuts = [float(re.findall(r"by ([\d.]+) dB", t)[0])
                        for t in (text, ref)]
                agree &= cuts[0] > WPE_TAIL_FLOOR_DB
                extra = f"; WPE tail cut {cuts[0]} dB (CPU {cuts[1]})"
            say(phase, f"example {name}: launches {fmt_counts(counts)}; card "
                f"vs CPU printouts agree {agree} (largest decimal gap "
                f"{gap:.2e}){'' if agree else ': ' + why}{extra}; "
                f"{wall:.2f} s on the card, {cpu_wall:.2f} s on the CPU "
                f"({card})")
            if not agree:
                failures.append(f"example_{name}")
        except (Exception, SystemExit):
            import traceback

            traceback.print_exc()
            failures.append(f"example_{name}")


def drawn_frames(frame, n_frames, noise, seed):
    """[n_frames, M, N] on the card: the clean event ``frame`` [M, N] plus
    a white noise draw of rms ``noise`` in every frame."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.from_numpy(frame.astype(np.float32)).cuda() + noise * \
        torch.randn((n_frames, *frame.shape), device="cuda", generator=g)


def stage_fns(loc, frames) -> dict:
    """{stage: fn} of one ``loc(frames)`` call split as
    ``models.localizer.localize_frames`` runs it (no in-kernel SRP): the
    GCC kernel with its peaks, the SRP scores, the grid peak, the solver
    tail; each stage's inputs made once by the stages before it."""
    from audio_triangulation_tpu_torch.models import localizer as lm
    from audio_triangulation_tpu_torch.ops import srp

    cfg, grid, params = loc.pipeline, loc.grid, loc.params
    p_n = params.pairs.shape[0]
    flat = lm._flat_frames(frames, cfg)
    corr_t, _, tdoa, _, _ = lm.gcc_peaks(flat, params, cfg)
    scores = lm._srp_scores(corr_t, params, cfg, loc.srp_form, p_n)
    cells = ((grid.height, grid.width), (grid.half_cells_x,
                                         grid.half_cells_y),
             grid.cells_per_m)
    xy_grid = srp.grid_peak_xy(scores, *cells, refine=False)
    return {
        "gcc_peaks": lambda: lm.gcc_peaks(flat, params, cfg),
        "srp_scores": lambda: lm._srp_scores(corr_t, params, cfg,
                                             loc.srp_form, p_n),
        "grid_peak": lambda: srp.grid_peak_xy(scores, *cells, refine=False),
        "solve_tail": lambda: lm.solve_tail(
            tdoa, xy_grid, params, cfg=cfg, grid_cfg=grid,
            solver_cfg=loc.solver, gn=loc.gn),
        "whole_call": lambda: loc(frames)}


def strided_copy(frames):
    """``frames`` in the layout numpy's astype of a broadcast view gives
    (the batch axis fastest), which the tools' replicated frames had until
    ``tools.bench.bench_frames`` made them C order."""
    import torch

    one = frames[:1].cpu().numpy()
    return torch.from_numpy(np.broadcast_to(one, tuple(frames.shape)).astype(
        np.float32)).to(frames.device)


def tools_replicated(phase, card, results, failures):
    """The open fault "the bench tool's frames are not placed": record 2's
    localizer and the bench tool's three 4-mic localizers at 16,384 frames
    on one event replicated (the tools' frames, C order), on the same
    replicated frames in the layout the tools had before (``strided_copy``:
    batch axis fastest), and on the event with a noise draw in every frame.
    In this call: frames/s in turns (``TRIALS`` each), and each stage of the
    call (``stage_fns``) in device ms by CUDA events, in turns likewise
    (``REPS`` launches each)."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.tools import bench, bench_configs
    from audio_triangulation_tpu_torch.tools.bench import frames_per_s
    from audio_triangulation_tpu_torch.utils import synth

    n = REPLICATED_FRAMES
    src4 = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    clean4 = synth.synth_scene(src4, geometry.square_array(0.3),
                               noise_rms=0.0, seed=0)[0]
    cfg2 = bench_configs.make_config(bench_configs.RECORDS[1][0], "cuda", n)
    clean3 = synth.synth_scene(bench_configs.source_point(),
                               geometry.reference_array(), noise_rms=0.0,
                               seed=1)[0]
    cases = [("2_3mic_triangulation", cfg2.loc, cfg2.frames,
              drawn_frames(clean3, n, 0.01, SEED + 190))]
    rep4 = bench.bench_frames(n, "cuda")
    drawn4 = drawn_frames(clean4, n, 0.01, SEED + 191)
    for suffix, band, sub in bench.CONFIGS:
        cases.append(("bench" + (suffix or "_bandcrop"),
                      bench.make_localizer(band, sub, "cuda"), rep4, drawn4))
    kinds = ("rep", "strided", "drawn")
    order = kinds + kinds[::-1]
    for name, loc, rep, drawn in cases:
        inputs = {"rep": rep, "strided": strided_copy(rep), "drawn": drawn}
        rates = {k: [] for k in kinds}
        for kind in order:
            frames = inputs[kind]
            rates[kind].append(frames_per_s(lambda: loc(frames), n, TRIALS,
                                            "cuda")[0])
        fps = {k: float(np.mean(v)) for k, v in rates.items()}
        fns = {k: stage_fns(loc, f) for k, f in inputs.items()}
        ms = {k: {s: [] for s in fns[k]} for k in kinds}
        for kind in order:
            for stage, fn in fns[kind].items():
                ms[kind][stage].append(cuda_ms(fn, REPS))
        ms = {k: {s: float(np.mean(v)) for s, v in d.items()}
              for k, d in ms.items()}
        say(phase, f"replicated frames, {name}: frames/s replicated (C "
            f"order) / strided / drawn {fps['rep']:.1f} / "
            f"{fps['strided']:.1f} / {fps['drawn']:.1f} (drawn "
            f"{(fps['drawn'] / fps['rep'] - 1) * 100:+.2f}% and "
            f"{(fps['drawn'] / fps['strided'] - 1) * 100:+.2f}% against "
            "them); device ms a stage by CUDA events (replicated / strided "
            "/ drawn): " + "; ".join(
                f"{s} {ms['rep'][s]:.4f} / {ms['strided'][s]:.4f} / "
                f"{ms['drawn'][s]:.4f}" for s in ms["rep"]) + f" ({card})")
    del cases, rep4, drawn4, fns, inputs


def phase_root_tools(card, results):
    """Phase 19: the port's counterparts of the root benches, tools and
    examples on the card as a user runs them, launches counted, each held
    to its CPU run; then the replicated-frames probe.  Every part runs; the
    phase fails at its end if any part failed."""
    import traceback

    phase = "19 tools"
    t0 = time.perf_counter()
    failures = []
    for part in (tools_bench_configs, tools_bench_latency,
                 tools_bench_robustness, tools_int8, tools_soak_transport,
                 tools_eval_dataset, tools_examples, tools_replicated):
        t1 = time.perf_counter()
        try:
            part(phase, card, results, failures)
        except (Exception, SystemExit):
            traceback.print_exc()
            failures.append(part.__name__)
        say(phase, f"{part.__name__}: {time.perf_counter() - t1:.1f} s")
    say(phase, f"wall time {time.perf_counter() - t0:.1f} s")
    if failures:
        fail(phase, f"result checks failed: {failures}")


# further keys of an entry that has them: what the library yardstick is, the
# SRP-argmax kernel's other bound and its bf16 mode, the bf16 DFT product's
# library form with f32 outputs
EXTRA_KEYS = ("library", "bound_ms_fp32_cores", "bf16_ms", "bf16_plain_ms",
              "bf16_library_ms", "bf16_bound_ms", "library_f32_out_ms",
              "device_ms", "launches_per_call", "launches_by_path",
              "multi_8mic_no_peaks", "doa_8mic_no_peaks",
              "doa3d_tetra_no_peaks", "volume_8mic_no_peaks",
              "fusion_2x4_no_peaks")
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms")


def main():
    card = phase_device()
    import torch

    ingest_pool, ingest_refs = start_ingest_reference()

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
    phase_estimators(card, results)
    phase_reverb(card, results)
    phase_training(card, results)
    phase_serving(card, results, ingest_refs)
    ingest_pool.shutdown()
    phase_parallel(card, results)
    phase_cli(card, results)
    phase_root_tools(card, results)

    print(json.dumps({"kernels": [
        {k: results[n][k] for k in (*KERNEL_KEYS, *(
            e for e in EXTRA_KEYS if e in results[n]))}
        for n in KERNEL_INFO]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
