"""Advanced features tour: DoA, volumetric 3-D, multi-source, extraction,
MUSIC, rooms, the learned localizer, multi-array fusion, moving sources,
spherical DoA, inter-array registration, WPE and IMM tracking.

Counterpart of the JAX package's ``examples/advanced.py`` on the port.

    python -m audio_triangulation_tpu_torch.examples.advanced
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                           VolumeConfig, VolumeLocalizer,
                                           geometry)
from audio_triangulation_tpu_torch.core.config import GridConfig
from audio_triangulation_tpu_torch.models import neural
from audio_triangulation_tpu_torch.models.doa import (Doa3dEstimator,
                                                      DoaEstimator)
from audio_triangulation_tpu_torch.models.fusion import (
    ArrayFusionLocalizer, register_arrays)
from audio_triangulation_tpu_torch.models.tracking import (Tracker,
                                                           TrackerConfig)
from audio_triangulation_tpu_torch.ops import dereverb, srp, srp_freq
from audio_triangulation_tpu_torch.tools.bench import require_device
from audio_triangulation_tpu_torch.utils import room as room_mod
from audio_triangulation_tpu_torch.utils import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    def host(t):
        return t.detach().cpu().numpy()

    # --- far-field direction of arrival (8-mic circular) ----------------
    mics8 = geometry.circular_array(8, 0.15)
    doa = DoaEstimator.create(mics8, device=dev)
    az_true = 117.0
    src = 50.0 * np.array([np.cos(np.deg2rad(az_true)),
                           np.sin(np.deg2rad(az_true)), 0.0])
    frames = synth.synth_scene(src, mics8, noise_rms=0.01, seed=0)
    out = doa(f32(frames))
    print(f"DoA: true {az_true:.1f} deg -> est "
          f"{float(out['azimuth_deg'][0]):.1f}")

    # --- volumetric 3-D localization -------------------------------------
    mics_big = geometry.circular_array(8, 0.5)
    vl = VolumeLocalizer.create(
        mics_big, PipelineConfig(),
        VolumeConfig(half_cells_x=24, half_cells_y=24, cells_per_m=16.0,
                     z_min_m=0.4, z_max_m=1.2, z_cells=5), device=dev)
    src3 = np.array([0.3, 0.2, 0.8])
    frames = synth.synth_scene(src3, mics_big, noise_rms=0.005, seed=1)
    out = vl(f32(frames))
    print(f"3-D: true {src3} -> est {np.round(host(out['xyz'])[0], 3)}")

    # --- two simultaneous sources ----------------------------------------
    loc = Localizer.create(mics8, PipelineConfig(phat=True), device=dev)
    h = 1.2
    s1 = np.array([0.9, 0.3, h]) * (h / np.linalg.norm([0.9, 0.3, h]))
    s2 = np.array([-0.7, -0.6, h]) * (h / np.linalg.norm([-0.7, -0.6, h]))
    sig2 = synth.chirp_burst(1024, 50_000.0, f0=2000, f1=9000, center=0.45)
    mixed = (synth.synth_scene(s1, mics8, seed=2)
             + synth.synth_scene(s2, mics8, signal=sig2, seed=3))
    out = loc(f32(mixed))
    g = loc.grid
    xs = (np.arange(g.width) - g.half_cells_x) / g.cells_per_m
    ys = (g.half_cells_y - np.arange(g.height)) / g.cells_per_m
    gx, gy = np.meshgrid(xs, ys)
    plane_xy = f32(np.stack([gx.ravel(), gy.ravel()], -1))
    peaks, scores = srp.top_k_peaks(out["scores"], plane_xy, k=2,
                                    min_separation_m=0.4)
    print(f"multi-source: {np.round(host(peaks)[0], 2)} "
          f"(true: [0.9 0.3], [-0.7 -0.6])")
    print(f"confidence: {float(out['confidence'][0]):.2f}")

    # --- beamformed source-audio extraction ------------------------------
    # after localization says WHERE, recover WHAT: MVDR nulls source 2
    # while passing source 1 distortionless (ops/beamform)
    y = loc.extract(f32(mixed), method="mvdr")
    ref = synth.chirp_burst(1024, 50_000.0)  # source 1's emitted burst
    yv = host(y)[0] - host(y)[0].mean()
    c = np.correlate(yv, ref - ref.mean(), mode="full")
    fidelity = np.max(np.abs(c)) / (np.linalg.norm(yv)
                                    * np.linalg.norm(ref - ref.mean()))
    print(f"extraction: mvdr fidelity to source-1 waveform {fidelity:.2f}")

    # --- subspace super-resolution (MUSIC) -------------------------------
    # snapshots of two independent sources (a waveform draw a snapshot),
    # resolved on the grid beyond the delay-and-sum beamwidth
    rng = np.random.default_rng(7)
    snaps = []
    for t in range(12):
        acc = None
        for k, s in enumerate((s1, s2)):
            sig = synth.colored_burst(1024, 50_000.0, seed=100 * (k + 1) + t)
            f = synth.synth_scene(s, mics8, signal=sig, noise_rms=0.0,
                                  seed=0)[0]
            acc = f if acc is None else acc + f
        snaps.append(acc + rng.normal(0, 0.02, acc.shape))
    grid = GridConfig(half_cells_x=40, half_cells_y=40, cells_per_m=20.0)
    mus = srp_freq.localize_music(f32(np.stack(snaps)), mics8, grid,
                                  PipelineConfig(), n_sources=2)
    print(f"MUSIC peak: {np.round(host(mus['xy_grid']), 2)} "
          f"(one of the two true sources)")

    # --- physical room simulation (image-source method) ------------------
    # geometrically consistent echoes + Sabine reverberation; PHAT keeps
    # the direct-path peak sharp where plain correlation gets biased
    mics4 = geometry.square_array(0.3)
    mics4_3d = np.concatenate([mics4, np.zeros((4, 1))], axis=-1)
    shift = np.array([3.0, 2.5, 0.3])  # the array inside the room
    r = room_mod.ShoeboxRoom(size=(6.0, 5.0, 3.0), absorption=0.3,
                             max_order=6)
    print(f"room RT60 (Sabine): {room_mod.rt60_sabine(r):.2f} s")
    src_r = np.array([0.5, 0.4, 1.2])
    rev = room_mod.simulate(src_r + shift, mics4_3d + shift, r,
                            signal=synth.colored_burst(1024, 50_000.0,
                                                       seed=5),
                            noise_rms=0.005)
    loc4 = Localizer.create(mics4, PipelineConfig(phat=True), device=dev)
    out_r = loc4(f32(rev))
    print(f"reverberant localization: true [0.5 0.4] -> "
          f"{np.round(host(out_r['xy'])[0], 3)}")

    # --- learned localizer (neural model family) -------------------------
    # a small MLP on the pipeline's own GCC features, fresh synthetic data
    # a step; 40 steps here just to show the loop
    net = neural.NeuralLocalizer.create(
        mics4, PipelineConfig(frame_size_bits=9, phat=True), hidden=(64,),
        learning_rate=2e-3, device=dev)
    data = neural.synthetic_batches(
        mics4, n_batches=40, batch_size=64, pipeline=net.pipeline,
        extent_m=0.9, seed=11, device=dev)
    (params, _), losses = net.fit(data, seed=0)
    print(f"neural: loss {losses[0]:.3f} -> {losses[-1]:.3f} after 40 steps")

    # --- multi-array fusion (world grid) ----------------------------------
    # two compact arrays 2 m apart fuse one world grid; the joint GN solve
    # uses the inter-array baseline to pin range for off-axis sources
    arr_a = geometry.square_array(0.25) + np.array([-1.0, 0.0], np.float32)
    arr_b = geometry.square_array(0.25) + np.array([1.0, 0.0], np.float32)
    fus = ArrayFusionLocalizer.create([arr_a, arr_b],
                                      PipelineConfig(phat=True), device=dev)
    src_f = np.array([[0.3, 1.5, 1.2]])
    fr = synth.synth_scene(src_f, np.concatenate([arr_a, arr_b]),
                           noise_rms=0.01, seed=13)
    out_f = fus(f32(fr.reshape(1, 2, 4, -1)))
    print(f"fusion: true [0.3 1.5] -> {np.round(host(out_f['xy'])[0], 3)} "
          f"(rms {float(out_f['rms_m'][0]) * 100:.1f} cm)")

    # --- moving source: instantaneous velocity (delay-Doppler CAF) -------
    mics6 = geometry.circular_array(6, 0.35)
    cfg_m = PipelineConfig(
        phat=True, window_enabled=False, band_hz=(700.0, 9500.0),
        band_crop=True,
        max_shift_samples=geometry.max_lag_for_array(mics6,
                                                     PipelineConfig()))
    loc_m = Localizer.create(mics6, cfg_m, device=dev)
    v_true = np.array([2.5, -1.5])
    fr = synth.synth_moving_scene(
        np.array([0.3, 0.2, 1.2]), np.array([v_true[0], v_true[1], 0.0]),
        mics6, noise_rms=0.005, seed=3)
    out = loc_m.localize_moving(f32(fr), n_scales=17)
    print(f"moving source: true v {v_true} -> "
          f"est {np.round(host(out['velocity'][0]), 2)} m/s "
          f"(one frame, no tracker)")

    # --- spherical DoA: azimuth AND elevation (tetra array) --------------
    tet = geometry.tetrahedral_array(0.3)
    cfg_t = PipelineConfig(
        phat=True, window_enabled=False,
        max_shift_samples=geometry.max_lag_for_array(tet, PipelineConfig()))
    est3 = Doa3dEstimator.create(tet, cfg_t, n_dirs=1024, device=dev)
    az_t, el_t = 310.0, 40.0
    u = np.array([np.cos(np.deg2rad(el_t)) * np.cos(np.deg2rad(az_t)),
                  np.cos(np.deg2rad(el_t)) * np.sin(np.deg2rad(az_t)),
                  np.sin(np.deg2rad(el_t))])
    tau = -(np.asarray(tet, np.float64) @ u) / 343.0 * 50_000.0
    sig = synth.chirp_burst(1024, 50_000.0)
    fr = synth.fractional_delay(np.broadcast_to(sig, (4, 1024)), tau)[None]
    out = est3(f32(fr))
    print(f"spherical DoA: true az/el {az_t:.0f}/{el_t:.0f} -> "
          f"est {float(out['azimuth_deg'][0]):.1f}/"
          f"{float(out['elevation_deg'][0]):.1f} deg")

    # --- inter-array registration (unknown relative pose) ----------------
    # two arrays that don't know where they stand localize the same events
    # each in its own frame; a weighted Kabsch SVD recovers array B's pose
    ang_true, tr_true = 0.6, np.array([1.8, 0.9], np.float32)
    rot_true = np.array([[np.cos(ang_true), -np.sin(ang_true)],
                         [np.sin(ang_true), np.cos(ang_true)]], np.float32)
    shared = np.array([[0.5, 0.4], [1.2, 1.0], [1.4, 0.1], [0.3, 1.1]],
                      np.float32)  # world-frame events both arrays hear
    fixes = np.stack([shared, (shared - tr_true) @ rot_true])  # local
    reg = register_arrays(f32(fixes))
    rot = host(reg["rot"])
    ang_est = float(np.arctan2(rot[1, 1, 0], rot[1, 0, 0]))
    print(f"registration: array B pose {np.rad2deg(ang_true):.0f} deg / "
          f"{tr_true} -> est {np.rad2deg(ang_est):.1f} deg / "
          f"{np.round(host(reg['trans'])[1], 3)}")

    # --- WPE dereverberation (reverberant room) ---------------------------
    # late reflections bias 20 ms frame GCC; weighted prediction error
    # subtracts the predictable tail a STFT bin, keeping the direct path
    rm = room_mod.ShoeboxRoom(
        size=(6.0, 5.0, 3.0),
        absorption=room_mod.absorption_for_rt60((6.0, 5.0, 3.0), 0.45),
        max_order=6)
    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = np.asarray(geometry.circular_array(4, 0.25)) + [3.0, 2.5]
    mic3[:, 2] = 1.2
    sig = synth.chirp_burst(4096, 50_000.0)
    wet = room_mod.simulate(np.array([4.2, 3.4, 1.2]), mic3, rm, n=16384,
                            fs=50_000.0, signal=np.tile(sig, 4),
                            noise_rms=0.002)[0]
    dry = host(dereverb.wpe(f32(wet), frame=1024, hop=256, taps=10,
                            delay=4))
    tail = slice(6000, 16000)  # after the direct sound: reverb-dominated
    drop_db = 10 * np.log10(np.mean(dry[:, tail] ** 2)
                            / np.mean(wet[:, tail] ** 2))
    print(f"dereverb: WPE cut the reverberant tail by {-drop_db:.1f} dB "
          f"(RT60 0.45 s shoebox)")

    # --- IMM tracking (cruise/maneuver mode switching) --------------------
    # one process noise can't track both regimes; the IMM bank mixes a
    # low-q and a high-q CV filter and switches by likelihood
    imm = Tracker(TrackerConfig(imm_q=(0.05, 8.0)), device=dev)
    tstate = imm.init()
    p, v = np.array([-1.0, -0.8]), np.array([1.0, 0.0])
    rng_t = np.random.default_rng(5)
    mode_before = mode_after = 0.0
    for tt in np.arange(0.0, 6.0, 0.1):
        if abs(tt - 3.0) < 1e-9:
            v = np.array([0.0, 1.0])  # hard 90-degree turn
        tstate, tout = imm.step(tstate, f32(p + rng_t.normal(0, 0.03, 2)),
                                tt)
        p = p + v * 0.1
        k = int(torch.argmax(tout["track_active"].to(torch.int32)))
        if abs(tt - 2.9) < 1e-9:
            mode_before = float(tout["model_prob"][k, 1])
        if abs(tt - 3.4) < 1e-9:
            mode_after = float(tout["model_prob"][k, 1])
    print(f"IMM tracking: p(maneuver) {mode_before:.2f} before the turn -> "
          f"{mode_after:.2f} during it (same bank, no retuning)")


if __name__ == "__main__":
    main()
