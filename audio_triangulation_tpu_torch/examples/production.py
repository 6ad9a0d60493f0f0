"""Production serving tour: live transport ingest, multi-event streaming
with the GN solver, position-space Kalman tracking, array health, the
virtual microphone and one-step tracked serving.

Counterpart of the JAX package's ``examples/production.py`` on the port.

    python -m audio_triangulation_tpu_torch.examples.production
        [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.core.config import (PipelineConfig,
                                                       StreamConfig)
from audio_triangulation_tpu_torch.models.extraction import (
    StreamingExtractor)
from audio_triangulation_tpu_torch.models.streaming import StreamingLocalizer
from audio_triangulation_tpu_torch.models.tracked import (
    TrackedStreamingLocalizer)
from audio_triangulation_tpu_torch.models.tracking import (Tracker,
                                                           TrackerConfig)
from audio_triangulation_tpu_torch.ops import consistency
from audio_triangulation_tpu_torch.runtime import native_rt, transport
from audio_triangulation_tpu_torch.tools.bench import require_device
from audio_triangulation_tpu_torch.utils import synth

INGEST_TIMEOUT_S = 30.0


def snr_db(ref, x) -> float:
    g = np.dot(x, ref) / np.dot(ref, ref)
    e = x - g * ref
    return 10 * np.log10(np.dot(x, x) / np.dot(e, e))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    mics = geometry.reference_array()
    src3 = np.array([0.5, 0.4, 1.2])
    src3 = src3 * 1.2 / np.linalg.norm(src3)

    # --- 1. live transport ingest: bytes -> native detector -> events ----
    # A FIFO here; the same URL scheme serves tcp://host:port, listen://:0
    # and alsa://device.  With the native runtime the reader thread, frame
    # assembly and triggering run in C++ (runtime/native/atrt.cpp).
    rng = np.random.default_rng(0)
    streams = rng.integers(127, 130, size=(3, 30_000)).astype(np.float64)
    frame = synth.synth_scene(src3, mics, noise_rms=0.0, seed=0)[0]
    streams[:, 9_000: 9_000 + 1024] += 110.0 * frame
    pcm = np.clip(np.round(streams), 0, 255).astype(np.int16).T.copy()

    tmp = tempfile.mkdtemp()
    try:
        fifo = os.path.join(tmp, "audio.fifo")
        os.mkfifo(fifo)
        rt = native_rt.create_ingest_runtime(mics.shape[0], 1024)
        source = transport.open_source(rt, f"fifo://{fifo}")
        transport.stream_pcm_to_fifo(fifo, pcm)

        loc = Localizer.create(mics, device=dev)
        events = []
        t0 = time.time()
        while time.time() - t0 < INGEST_TIMEOUT_S:
            ev = rt.poll()
            if ev is not None:
                events.append(ev)
            elif not source.running:
                break
            else:
                time.sleep(0.005)
        source.stop()
        eframe, stamp = events[0]
        out = loc(f32(eframe)[None])
        xy = out["xy"][0].cpu().numpy()
        print(f"transport: {source.tuples_pushed} tuples -> {len(events)} "
              f"event(s); localized xy=({xy[0]:+.3f}, {xy[1]:+.3f}) m")
        rt.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # --- 2. multi-event streaming with the solver in the loop ------------
    cfg = PipelineConfig(frame_size_bits=8, max_shift_samples=16)
    sl = StreamingLocalizer.create(
        mics, cfg,
        stream=StreamConfig(chunk_size=2048, max_events_per_chunk=4),
        device=dev, with_solver=True)
    streams2 = rng.integers(127, 130, size=(3, 4096)).astype(np.float64)
    for at in (800, 1400):  # two bursts inside ONE chunk
        fr = synth.synth_scene(src3, mics, n=256, noise_rms=0.0, seed=at)[0]
        streams2[:, at: at + 256] += 110.0 * fr
    state, outs = sl.run(np.clip(np.round(streams2), 0, 255))
    n_ev = int(state.event_count)
    xy = np.asarray(outs[-1]["xy"])
    print(f"streaming: {n_ev} events from one chunk; "
          f"solver xy=({xy[0]:+.3f}, {xy[1]:+.3f}) m")

    # --- 3. Kalman tracking over a moving source -------------------------
    # each measurement carries its own covariance (the localizer's xy_cov):
    # noisy events pull the track less
    tracker = Tracker(TrackerConfig(measurement_noise=0.02,
                                    process_noise=0.1), device=dev)
    tstate = tracker.init()
    p0, v = np.array([0.2, -0.3]), np.array([0.4, 0.25])
    t = 0.0
    for i in range(25):
        t += float(rng.uniform(0.06, 0.14))
        sigma = 0.02 if i % 4 else 0.08  # every 4th event is low-quality
        z = p0 + v * t + rng.normal(0, sigma, 2)
        tstate, tout = tracker.step(
            tstate, z, t, z_cov=np.diag([sigma ** 2, sigma ** 2]))
    k = int(torch.argmax(tout["track_confirmed"].to(torch.int32)))
    vel = tout["track_vel"][k].cpu().numpy()
    print(f"tracking: confirmed track id {int(tout['track_id'][k])}, "
          f"velocity ({vel[0]:+.2f}, {vel[1]:+.2f}) m/s (true +0.40, +0.25)")

    # --- 4. array health monitoring: TDOA cycle-consistency --------------
    # A dead channel poisons the pairs touching it; the cycle-consistency
    # residual attributes the inconsistency per mic (ops/consistency).
    mics8 = geometry.circular_array(8, 0.25)
    fr8 = np.asarray(synth.synth_scene(src3, mics8, noise_rms=0.01, seed=9))
    fr8[0, 5] = rng.normal(0, 0.3, fr8.shape[-1])  # channel 5 is dead
    loc8 = Localizer.create(mics8, PipelineConfig(phat=True), device=dev)
    out8 = loc8(f32(fr8))
    diag = consistency.diagnose_mics(
        out8["tdoa_samples"] / 50_000.0, loc8.params.pairs, 8,
        ratio_thresh=2.5)
    flags = np.nonzero(diag["faulty"][0].cpu().numpy())[0]
    print(f"health: faulty mics {flags.tolist()} "
          f"(residual rms {float(diag['residual_rms'][0]):.2e} s)")

    # --- 5. continuous source extraction: the virtual microphone ---------
    # after WHERE, recover WHAT: a chunk-rate WOLA beamformer glides with
    # the steered position (models/extraction; CLI: stream --extract)
    fs = 50_000.0
    tgt_xy = np.array([0.5, 0.4], np.float32)
    t_len = 8192
    sig = rng.standard_normal(t_len).astype(np.float32)
    spec = np.fft.rfft(sig)
    f_hz = np.fft.rfftfreq(t_len, 1 / fs)
    spec[(f_hz < 300) | (f_hz > 8000)] = 0
    sig = np.fft.irfft(spec, t_len).astype(np.float32)
    mics4 = np.asarray(geometry.square_array(0.3), np.float32)
    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = mics4
    dists = np.linalg.norm(np.array([*tgt_xy, 1.0]) - mic3, axis=-1)
    tau = (dists - dists.mean()) / 343.0 * fs
    stream4 = np.stack([
        np.fft.irfft(np.fft.rfft(sig)
                     * np.exp(-2j * np.pi * np.fft.rfftfreq(t_len) * tau[m]),
                     t_len)
        for m in range(4)]).astype(np.float32)
    clean4 = stream4.copy()
    stream4 = stream4 + 0.3 * rng.standard_normal(
        stream4.shape).astype(np.float32)

    ex = StreamingExtractor.create(mics4, height=1.0, constrain_sphere=False,
                                   device=dev)
    y = ex.run(stream4, tgt_xy, chunk_size=512)
    sl_ = slice(1024, t_len - 1024)
    in_snr = 10 * np.log10(np.var(clean4[0]) / 0.09)  # per-mic input SNR
    print(f"extraction: virtual mic SNR {snr_db(sig[sl_], y[sl_]):.1f} dB "
          f"vs {in_snr:.1f} dB per input mic (delay-and-sum gain ~6 dB at "
          "4 mics)")

    # --- 6. one-step tracked serving -------------------------------------
    # localization burst + association + Kalman update in one step per
    # chunk (models/tracked), batched across streams; on the card one CUDA
    # graph replay a chunk (graph_step_many)
    tsl = TrackedStreamingLocalizer.create(
        mics, PipelineConfig(), stream=StreamConfig(chunk_size=2048),
        device=dev)
    streams3 = rng.integers(127, 130, size=(3, 16_384)).astype(np.float64)
    for at in (3_000, 9_000):
        fr = synth.synth_scene(src3, mics, noise_rms=0.0, seed=at)[0]
        streams3[:, at: at + 1024] += 110.0 * fr
    tstate2, outs3 = tsl.run(np.clip(np.round(streams3), 0, 255))
    ev3 = [o for o in outs3 if bool(o["event"])]
    k3 = int(np.asarray(ev3[-1]["assigned"]))
    txy3 = np.asarray(ev3[-1]["track_xy"])[k3]
    print(f"fused tracking: {len(ev3)} events -> track "
          f"#{int(np.asarray(ev3[-1]['track_id'])[k3])} at "
          f"({txy3[0]:+.3f}, {txy3[1]:+.3f}) m, one dispatch per chunk")


if __name__ == "__main__":
    main()
