#!/usr/bin/env python3
"""Where one call's time goes on the GPU (torch.profiler).

For each of ``chip_smoke.py``'s Localizer paths at its full size (the three
4-mic bench configurations and the ``fused_srp`` line on 16,384 frames of
4 x 1,024 samples; the three 64-mic configurations on 256 frames of
64 x 4,096 samples), and for one ``StreamingLocalizer.step_many`` step of
its four streaming pipelines at 1,024 and 4,096 streams of 512-sample
chunks (3 mics; 4 in ``xyz_tetra``), and for one tracked step (the stream
step and the tracker bank, ``TrackedStreamingLocalizer``) eager and
replayed as one CUDA graph at the same stream counts, and for the
simultaneous and moving sources (``Localizer.localize_multi`` on
chip_smoke's 16,384 two-source frames of 8 x 1,024; ``localize_moving`` on
its 2,048 moving-source frames; the CAF stage alone on 1,024 frames of
``reference_array()`` with the time-domain operator; graphed stream steps
with ``n_sources=2`` and with ``solve_velocity`` at 1,024 streams), and
for the four frame-batch estimator paths of chip_smoke's phase 13
(``doa_8mic``, ``doa3d_tetra``, ``volume_8mic``, ``fusion_2x4``: 16,384
frames or events a call, row 2 of the kernel table once; and the SMP path,
no kernel), and for three paths of phase 14 (a ``StreamingDereverb`` step
at 1,024 streams, MVDR extraction on 4,096 frames of 8 mics, block WPE on
64 recordings of 4 x 16,384 samples; no kernel), and for two paths of
phase 15 (one ``Calibrator.train_step`` on 4,096 events of 8 x 1,024, no
kernel; one ``NeuralLocalizer.train_step`` on 1,024 frames of 4 x 1,024,
and one ``predict`` on 16,384, row 2 once each), and for one POST
/localize to phase 16's server at 64 and 4,096 frames, prints:

- the median wall time of 7 unprofiled calls and the device-busy time of
  one profiled call (the sum of its kernels' device time), hence the
  card's idle share;
- the kernels by device time, and how many were launched (a stream step's
  list names ``detector_scan_kernel``, the detector's one prefix-sum launch;
  a ``cumsum`` kernel there would mean that the float path left it);
- host-side ops that took over 0.3 ms, and the count of device-to-host
  scalar reads: a blocking copy or ``.item()`` in the middle of a call
  makes the card wait for the host.  The first op of the profiled call also
  carries the profiler's own set-up ("Activity Buffer Request"), and the
  closing ``cudaDeviceSynchronize`` is the profiler window's own.

    python3 chip_profile.py [localizer] [stream] [tracked] [sources]
                            [estimators] [reverb] [training] [serving]
                            [sessions]
                                     # one CUDA card; no argument: all

``sessions`` counts the profiler sessions that lose the record of their
one kernel launch, with and without ``chip_smoke.PROFILE_PAD_S`` of host
time inside the session around the call.

Imports no JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WALL_TRIALS = 7
TOP_KERNELS = 14
SLOW_HOST_OP_US = 300.0


SECTIONS = ("localizer", "stream", "tracked", "sources", "estimators",
            "reverb", "training", "serving", "sessions")
SESSION_TRIALS = 1200  # profiler sessions a padding, in turns


def main(argv=None):
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sections = (sys.argv[1:] if argv is None else argv) or SECTIONS
    unknown = set(sections) - set(SECTIONS)
    if unknown:
        sys.exit(f"chip_profile: unknown sections {sorted(unknown)}; "
                 f"choose from {SECTIONS}")
    sys.path.insert(0, HERE)
    import chip_smoke

    print(torch.cuda.get_device_name(0), flush=True)
    rng = np.random.default_rng(chip_smoke.SEED)
    for section in sections:
        globals()[f"profile_{section}"](chip_smoke, rng)


def profile_localizer(chip_smoke, rng):
    import torch
    from audio_triangulation_tpu_torch import Localizer, geometry

    src = (*chip_smoke.SOURCE_XY, 1.2)
    mics = geometry.square_array(0.3)
    frames = torch.from_numpy(chip_smoke.scene_frames(
        mics, chip_smoke.FRAMES, rng, fixed_source=src)).cuda()
    for name, cfg in (chip_smoke.main_configs()
                      + [chip_smoke.fused_srp_config()]):
        loc = Localizer.create(mics, cfg, device="cuda", init_grid_stride=3)
        profile_path(name, lambda: loc(frames))
    del frames
    mics64, grid64, configs64 = chip_smoke.large_configs()
    large = torch.from_numpy(chip_smoke.scene_frames(
        mics64, chip_smoke.LARGE_FRAMES, rng, fixed_source=src,
        n=chip_smoke.LARGE_SAMPLES)).cuda()
    for name, cfg in configs64:
        loc = Localizer.create(mics64, cfg, grid64, device="cuda",
                               init_grid_stride=chip_smoke.LARGE_STRIDE)
        profile_path(name, lambda: loc(large))
    del large


def profile_stream(chip_smoke, rng):
    """One streaming step: the state is carried from call to call."""
    for name, sl in chip_smoke.stream_localizers():
        for n_streams in (chip_smoke.STREAM_COUNTS[0],
                          chip_smoke.STREAM_COUNTS[-1]):
            carried = [sl.init_states(n_streams)]
            chunks = chip_smoke.quiet_chunks(
                rng, n_streams, sl.params.mic_positions.shape[0])

            def step():
                carried[0], out = sl.step_many(carried[0], chunks)
                return out

            profile_path(f"stream_{name}_{n_streams}", step,
                         watch=("detector_scan", "cumsum", "gemm"))

def profile_tracked(chip_smoke, rng):
    """The tracked step (the default bank), eager and as one CUDA graph."""
    tsl = chip_smoke.tracked_banks()["nearest"]
    for n_streams in (chip_smoke.STREAM_COUNTS[0],
                      chip_smoke.STREAM_COUNTS[-1]):
        carried = [tsl.init_states(n_streams)]
        chunks = chip_smoke.quiet_chunks(rng, n_streams)

        def step():
            carried[0], out = tsl.step_many(carried[0], chunks)
            return out

        graphed = tsl.graph_step_many(tsl.init_states(n_streams), chunks)
        for how, fn in (("eager", step), ("graphed", lambda: graphed(chunks))):
            profile_path(f"stream_tracked_{how}_{n_streams}", fn,
                         watch=("detector_scan", "gemm"))
        del graphed


def profile_sources(chip_smoke, rng):
    """Simultaneous and moving sources at chip_smoke's sizes."""
    import torch
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               StreamConfig,
                                               StreamingLocalizer, geometry)
    from audio_triangulation_tpu_torch.ops import caf

    mics = geometry.circular_array(8, 0.15)
    frames = chip_smoke.noisy(chip_smoke.two_source_frame(mics),
                              chip_smoke.MULTI_FRAMES, chip_smoke.SEED + 20)
    loc = Localizer.create(mics, PipelineConfig(phat=True), device="cuda")
    profile_path("multi_8mic", lambda: loc.localize_multi(frames),
                 watch=("gcc_kernel", "gemm"))
    del frames
    mics, cfg = chip_smoke.moving_setup()
    frames = chip_smoke.noisy(chip_smoke.moving_frame(mics),
                              chip_smoke.MOVING_FRAMES, chip_smoke.SEED + 22)
    loc = Localizer.create(mics, cfg, device="cuda")
    profile_path("moving", lambda: loc.localize_moving(
        frames, n_scales=chip_smoke.MOVING_SCALES), watch=("gemm",))
    del frames
    n = chip_smoke.VELOCITY_STREAM_COUNTS[-1]
    sl = StreamingLocalizer.create(geometry.reference_array(),
                                   stream=StreamConfig(
                                       chunk_size=chip_smoke.STREAM_CHUNK,
                                       solve_velocity=True), device="cuda")
    frames = torch.from_numpy(chip_smoke.scene_frames(
        geometry.reference_array(), n, rng)).cuda()
    profile_path(f"caf_time_domain_{n}", lambda: caf.estimate_delay_doppler(
        frames, sl.params.window, sl.params.pairs, sl.pipeline,
        n_scales=sl.stream.velocity_n_scales, resample=sl.caf_resample),
        watch=("gemm",))
    for what, stream in (
            ("n_sources2", StreamConfig(chunk_size=chip_smoke.STREAM_CHUNK,
                                        n_sources=2)),
            ("solve_velocity", sl.stream)):
        sl = StreamingLocalizer.create(geometry.reference_array(),
                                       stream=stream, device="cuda")
        n = chip_smoke.SOURCE_STREAMS
        chunks = chip_smoke.quiet_chunks(rng, n)
        graphed = sl.graph_step_many(sl.init_states(n), chunks)
        profile_path(f"stream_{what}_graphed_{n}", lambda: graphed(chunks),
                     watch=("detector_scan", "gemm"))
        del graphed


def profile_estimators(chip_smoke, rng):
    """The frame-batch estimators at chip_smoke's phase-13 sizes: the GCC
    kernel (row 2), the scoring product or gather, the solvers."""
    for seed, (name, (make, event, _)) in enumerate(
            chip_smoke.estimator_paths().items()):
        est = make("cuda")
        frames = chip_smoke.noisy(event, chip_smoke.EST_FRAMES,
                                  chip_smoke.SEED + 40 + seed)
        profile_path(name, lambda: est(frames),
                     watch=("gcc_kernel", "gemm", "gather", "reduce"))
        del frames, est


def profile_reverb(chip_smoke, rng):
    """Phase 14's heaviest paths at its sizes: one ``StreamingDereverb``
    step at 1,024 streams (the state carried from call to call), MVDR
    extraction at a given position on 4,096 frames of the 8-mic circle,
    and block WPE on 64 recordings of 4 x 16,384 samples."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.ops import beamform, dereverb

    n = chip_smoke.DVB_COUNTS[-1]
    sd = dereverb.StreamingDereverb(3, frame=1024, hop=256, device="cuda")
    chunks = chip_smoke.quiet_chunks(rng, n) - 128.0
    profile_path(f"dereverb_stream_{n}", chip_smoke.carried(
        lambda s: sd.step_many(s, chunks), sd.init_states(n)),
        watch=("gemm", "gemv", "elementwise", "fft"))
    del sd, chunks
    torch.cuda.empty_cache()
    mics8 = geometry.circular_array(8, 0.15)
    cfg = PipelineConfig(phat=True)
    frames = chip_smoke.noisy(chip_smoke.advanced_two_sources(mics8)[0],
                              chip_smoke.EXTRACT_MVDR_FRAMES,
                              chip_smoke.SEED + 63)
    delays = beamform.source_delays(
        torch.tensor([0.9, 0.3], device="cuda").expand(frames.shape[0], 2),
        mics8, cfg)
    profile_path("extract_mvdr", lambda: beamform.extract_mvdr(
        frames, delays, cfg), watch=("getrf", "getrs", "elementwise", "fft"))
    del frames
    torch.cuda.empty_cache()
    wet = torch.from_numpy(chip_smoke.wpe_example_scene().astype(
        np.float32)).cuda()
    batch = wet.expand(chip_smoke.WPE_BATCH, *wet.shape).contiguous()
    profile_path("wpe_block", lambda: dereverb.wpe(batch,
                                                   **chip_smoke.WPE_KW),
                 watch=("gemm", "getrf", "getrs", "elementwise", "fft"))


def profile_training(chip_smoke, rng):
    """Phase 15's step paths at its sizes: a calibration step (the GCC
    chain forward, its recomputation and backward under autograd, Adam),
    a neural step (row 2, the MLP forward and backward, Adam) and a
    neural prediction (row 2, the features, the MLP)."""
    import torch
    from audio_triangulation_tpu_torch import PipelineConfig, geometry
    from audio_triangulation_tpu_torch.models import calibration, neural

    mics8 = geometry.circular_array(8, 0.2)
    frames, planes, guess = chip_smoke.calib_scene(
        mics8, chip_smoke.CALIB_EVENTS, chip_smoke.SEED + 70, noise=0.01,
        guess_std=0.01)
    calib = calibration.Calibrator.create(8, device="cuda")
    params, opt = calib.init(guess)
    batch = calibration.CalibBatch(torch.from_numpy(frames).cuda(),
                                   torch.from_numpy(planes).cuda())
    profile_path("calib_step_8mic",
                 lambda: calib.train_step(params, opt, batch),
                 watch=("fft", "index", "elementwise", "reduce", "adam"))
    del batch, frames
    torch.cuda.empty_cache()
    mics = geometry.square_array(0.3)
    cfg = PipelineConfig(phat=True)
    net = neural.NeuralLocalizer.create(mics, cfg, device="cuda")
    f, xy = next(neural.synthetic_batches(
        mics, n_batches=1, batch_size=chip_smoke.NEURAL_BATCH, pipeline=cfg,
        seed=chip_smoke.SEED + 80))
    f, xy = torch.from_numpy(f).cuda(), torch.from_numpy(xy).cuda()
    mlp, nopt = net.init(seed=0)
    profile_path("neural_train",
                 lambda: net.train_step(mlp, nopt, f, xy),
                 watch=("gcc_kernel", "gemm", "adam"))
    big = f.repeat(chip_smoke.NEURAL_PREDICT_FRAMES // len(f), 1, 1)
    profile_path("neural_predict", lambda: net.predict(mlp, big),
                 watch=("gcc_kernel", "gemm", "softmax", "reduce"))


def profile_serving(chip_smoke, rng):
    """One POST /localize to a ``LocalizerServer`` on the card (the
    Localizer of the CLI's ``serve --array square --phat``) at 64 and 4,096
    frames, from a client thread of this process: the request's wall time
    against the card's busy time."""
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.runtime.server import LocalizerServer

    mics = geometry.square_array(0.3)
    loc = Localizer.create(mics, PipelineConfig(phat=True), device="cuda")
    srv = LocalizerServer(loc, port=0).start()
    try:
        for b in (64, 4096):
            req = chip_smoke.octet(chip_smoke.scene_frames(mics, b, rng))
            profile_path(f"serve_localize_b{b}",
                         lambda: chip_smoke.http(srv, "/localize", **req),
                         watch=("gcc_kernel", "gn_kernel"))
    finally:
        srv.stop()


def profile_sessions(chip_smoke, rng):
    """How often a profiler session loses the record of its one launch:
    ``SESSION_TRIALS`` sessions around one GN-kernel launch (the solver
    tail of chip_smoke's phase 5, 16,384 frames) with no host time around
    the call and with ``chip_smoke.PROFILE_PAD_S`` before and after it, in
    turns (``chip_smoke.profiled_kernels``)."""
    from audio_triangulation_tpu_torch import Localizer, geometry

    cfg = dict(chip_smoke.main_configs())["bandcrop_800_6000"]
    loc = Localizer.create(geometry.square_array(0.3), cfg, device="cuda",
                           init_grid_stride=3)
    tau, init = chip_smoke.gn_inputs(loc, chip_smoke.FRAMES)
    pad = chip_smoke.PROFILE_PAD_S
    lost = {0.0: 0, pad: 0}
    try:
        for _ in range(SESSION_TRIALS):
            for p in lost:
                chip_smoke.PROFILE_PAD_S = p
                n, _ = chip_smoke.profiled_kernels(lambda: loc.gn(tau, init))
                lost[p] += n == 0
    finally:
        chip_smoke.PROFILE_PAD_S = pad
    for p, n in lost.items():
        print(f"[sessions] {p * 1e3:.0f} ms of host time before and after "
              f"one GN-kernel launch: {n} of {SESSION_TRIALS} sessions "
              "recorded no device activity", flush=True)


def profile_path(name, fn, watch=()):
    """Profile one call of ``fn()``; ``watch`` names kernels (substrings of
    their names, any case) whose summed device time and launches get a line
    of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu = torch.autograd.DeviceType.CPU
    for _ in range(3):
        fn()
    walls = []
    for _ in range(WALL_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    stats = prof.key_averages()
    # CPU ops repeat their kernels' device time: count kernels only
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in stats if e.device_type != cpu
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    wall = float(np.median(walls))
    reads = sum(e.count for e in stats
                if e.key == "aten::_local_scalar_dense")
    print(f"[{name}] wall median {wall:.4f} ms, device busy {busy:.4f} "
          f"ms, idle share {1 - busy / wall:.4f}, "
          f"{sum(k[1] for k in kernels)} kernel launches, device-to-host "
          f"scalar reads {reads}", flush=True)
    for ms, count, key in kernels[:TOP_KERNELS]:
        print(f"    {ms:9.4f} ms  x{count:<3d} {key[:90]}", flush=True)
    for what in watch:
        hits = [k for k in kernels if what in k[2].lower()]
        print(f"    kernels named *{what}*: {sum(k[0] for k in hits):.4f} ms "
              f"in {sum(k[1] for k in hits)} launches", flush=True)
    for e in prof.events():
        if e.device_type == cpu and e.cpu_time_total > SLOW_HOST_OP_US:
            print(f"    host op {e.name}: {e.cpu_time_total:.0f} us",
                  flush=True)


if __name__ == "__main__":
    main()
