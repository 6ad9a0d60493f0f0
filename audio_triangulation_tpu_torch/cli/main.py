"""Command-line entry point of the PyTorch port.

Counterpart of ``audio_triangulation_tpu.cli.main``: the same eleven
subcommands with the reference's flags and printed lines, each calling the
port's own modules on the card (``--device cuda``, the default) or, when
asked, on the CPU (``--device cpu``); without a card and without
``--device cpu`` a command exits non-zero with the reason.

- ``simulate``     synth scene -> batched localization -> dashboard PNG
- ``evaluate``     accuracy over a labeled WAV manifest
- ``serve``        HTTP/JSON localization server (``runtime.server``)
- ``stream``       synthetic stream -> native ingest runtime -> streaming
                   localizer -> per-event reports (+ dashboard PNGs);
                   ``--source`` reads a live transport (``runtime.transport``)
- ``bench``        the frame-batch benchmark (``tools.bench``)
- ``doa``          far-field direction of arrival
- ``gen-window``   the Q15 DPSS window table as a C array
- ``localize-wav`` detect + localize events in a WAV file
- ``calibrate``    array self-calibration on synthetic events
- ``design``       CRLB-driven mic placement
- ``map-room``     reflector mapping: echoes -> wall estimates

    python -m audio_triangulation_tpu_torch simulate --out dash.png
    python -m audio_triangulation_tpu_torch stream --device cpu
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

# stream-time clock of the synthetic demo and of live sources (Hz)
STREAM_RATE_HZ = 50_000


def _np(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _host(out: dict) -> dict:
    return {k: _np(v) for k, v in out.items()}


def _device(args) -> str:
    """The device a command runs on: the card unless ``--device cpu``;
    without a card the command stops with the reason."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device is available: this command runs on the card "
            "unless given --device cpu")
    return args.device


def _f32(a, dev):
    import torch

    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                           device=dev)


def _build_scene(args, mics):
    from ..utils import synth

    plane = np.asarray([args.x, args.y])
    p = np.array([args.x, args.y, args.height])
    source = p * (args.height / np.linalg.norm(p))
    frames = synth.synth_scene(
        source, mics, noise_rms=args.noise, seed=args.seed)
    return plane, frames


def _parse_band(spec):
    """'LO:HI' (Hz) -> (lo, hi) tuple, 'auto' -> per-event selection
    (ops/xcorr.auto_band_weight), or None."""
    if not spec:
        return None
    if spec == "auto":
        return "auto"
    lo, hi = spec.split(":")
    return (float(lo), float(hi))


def _detect_event_frames(samples, cfg, max_events, dev):
    """Shared WAV plumbing: detector triggers -> captured frames, on the
    device.  The detector runs on the samples as int64 (exact prefix sums,
    so the trigger samples equal the reference's).

    Returns (idxs [E] numpy, frames [E, M, N] tensor); idxs is empty when
    no events."""
    import torch

    from ..ops import detector

    x = torch.as_tensor(samples.astype(np.int64), device=dev)[None]
    idxs, valid = detector.all_triggers_capped(x, cfg, max_events=max_events)
    idxs = _np(idxs)[0][_np(valid)[0]]
    if len(idxs) == 0:
        return idxs, None
    frames = detector.extract_frames_at(
        _f32(samples, dev)[None].repeat(len(idxs), 1, 1),
        torch.as_tensor(idxs, device=dev), cfg.frame_size)
    return idxs, frames


def _mic_array(args):
    from ..core import geometry

    if args.array == "reference":
        return geometry.reference_array()
    if args.array == "square":
        return geometry.square_array(0.3)
    if args.array == "circular":
        return geometry.circular_array(args.mics,
                                       getattr(args, "radius", 0.15))
    if args.array == "grid":
        side = int(np.sqrt(args.mics))
        return geometry.grid_array(side, side, 0.05)
    if args.array == "tetra":
        # minimal non-coplanar array: required for volumetric (--volume)
        # height resolution (planar arrays cannot resolve elevation sign)
        return geometry.tetrahedral_array(0.3)
    raise SystemExit(f"unknown array {args.array}")


def _volume_config(args):
    from ..core.config import VolumeConfig

    lo, hi = (args.z_range.split(":") if args.z_range else ("0.2", "2.2"))
    return VolumeConfig(z_min_m=float(lo), z_max_m=float(hi),
                        z_cells=args.z_cells)


def cmd_evaluate(args):
    """Batch-evaluate localization accuracy on a labeled WAV dataset.

    Manifest: JSON list of {"wav": path, "x": meters, "y": meters}
    (plane coordinates, the grid/solver convention).  Each file is run
    through detection + localization; the first accepted event's position
    is scored against the label.  Prints one JSON line per file plus an
    aggregate summary (optionally written to --out)."""
    import json
    import os

    from .. import Localizer, PipelineConfig
    from ..utils import io as audio_io

    dev = _device(args)
    with open(args.manifest) as f:
        entries = json.load(f)
    if not entries:
        raise SystemExit("empty manifest")

    mics = _mic_array(args)
    loc = None
    rate0 = None
    rows, errs = [], []
    base = os.path.dirname(os.path.abspath(args.manifest))
    for e in entries:
        # relative wav paths resolve against the manifest's directory
        path = e["wav"] if os.path.isabs(e["wav"]) else os.path.join(
            base, e["wav"])
        samples, rate = audio_io.read_wav(path)
        if samples.shape[0] != mics.shape[0]:
            raise SystemExit(
                f"{e['wav']}: {samples.shape[0]} channels != "
                f"{mics.shape[0]} mics")
        if loc is None:
            rate0 = rate
            cfg = PipelineConfig(
                sample_rate_hz=rate, phat=args.phat,
                weighting=args.weighting, band_hz=_parse_band(args.band),
                phat_beta=args.phat_beta)
            loc = Localizer.create(mics, cfg, device=dev)
        elif rate != rate0:
            raise SystemExit(
                f"{e['wav']}: sample rate {rate} != {rate0} of the first "
                "file (one pipeline per manifest)")
        idxs, frames = _detect_event_frames(samples, cfg, 4, dev)
        row = {"wav": e["wav"], "true_xy": [e["x"], e["y"]]}
        if len(idxs) == 0:
            row["detected"] = False
        else:
            xy = _np(loc(frames[:1])["xy"])[0]
            err = float(np.linalg.norm(xy - [e["x"], e["y"]]))
            errs.append(err)
            row.update(detected=True, xy=[round(float(v), 4) for v in xy],
                       err_cm=round(err * 100, 2))
        rows.append(row)
        print(json.dumps(row))

    summary = {
        "files": len(entries),
        "detected": len(errs),
        "detection_rate": round(len(errs) / len(entries), 3),
    }
    if errs:
        summary.update(
            xy_err_median_cm=round(float(np.median(errs)) * 100, 2),
            xy_err_p90_cm=round(float(np.percentile(errs, 90)) * 100, 2),
            hit_rate_lt_10cm=round(float(np.mean(np.asarray(errs) < 0.1)),
                                   3))
    print(json.dumps({"summary": summary}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f, indent=1)


def cmd_serve(args):
    from .. import Localizer, PipelineConfig
    from ..runtime.server import LocalizerServer

    dev = _device(args)
    mics = _mic_array(args)
    loc = Localizer.create(mics, PipelineConfig(phat=args.phat), device=dev)
    srv = LocalizerServer(loc, host=args.host, port=args.port).start()
    print(f"serving on http://{args.host}:{srv.port}  "
          f"(POST /localize, /streams; GET /healthz, /config)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        srv.stop()


def cmd_map_room(args):
    """Reflector-mapping demo: simulate a shoebox room with reflective
    wall(s) (utils/room ISM), fire a few chirp events, and print the
    mapped walls vs truth (models/mapping.ReflectorMapper)."""
    from .. import Localizer, PipelineConfig, geometry
    from ..core.config import GridConfig, SolverConfig
    from ..models.mapping import ReflectorMapper
    from ..utils import room as room_mod

    dev = _device(args)
    m = 6
    mics = geometry.circular_array(m, 0.25)
    center = np.array([4.8, 1.5, 1.2])  # array placement in the room
    mics_room = np.zeros((m, 3))
    mics_room[:, :2] = mics + center[:2]
    mics_room[:, 2] = center[2]
    # wall x1 (room x = 6 -> array-frame +x at 1.2 m) always reflective;
    # --two-walls adds y0 (room y = 0 -> array-frame -y at 1.5 m)
    absorp = [0.99, 0.02, 0.02 if args.two_walls else 0.99,
              0.99, 0.99, 0.99]
    rm = room_mod.ShoeboxRoom(size=(6.0, 5.0, 3.0),
                              absorption=tuple(absorp), max_order=1)
    # full-sweep chirp inside a short window: broadband, so the source
    # autocorrelation compresses and echoes stand out
    n, length, start = 1024, 400, 50
    sweep = 800.0 + (7000.0 - 800.0) * np.arange(length) / length
    sig = np.zeros(n)
    sig[start:start + length] = (np.hanning(length)
                                 * np.sin(2 * np.pi * np.cumsum(sweep)
                                          / 50_000.0))
    rng = np.random.default_rng(args.seed)
    sources = rng.uniform((-0.5, -0.5), (0.5, 0.5), size=(args.events, 2))
    frames = np.concatenate([
        room_mod.simulate(
            np.array([sx + center[0], sy + center[1], center[2]]),
            mics_room, rm, noise_rms=args.noise, seed=args.seed + i,
            signal=sig)
        for i, (sx, sy) in enumerate(sources)], axis=0)

    grid = GridConfig(projection="plane", height_m=0.0, cells_per_m=24.0,
                      half_cells_x=40, half_cells_y=40)
    pcfg = PipelineConfig(
        phat=True, band_hz=(700.0, 7000.0), window_enabled=False,
        max_shift_samples=geometry.max_lag_for_array(mics,
                                                     PipelineConfig()))
    loc = Localizer.create(mics, pcfg, grid,
                           SolverConfig(constrain_to_sphere=False),
                           device=dev)
    mapper = ReflectorMapper(loc, n_echoes=2 if args.two_walls else 1,
                             q_max=900)
    result = mapper.map(_f32(frames, dev))
    truths = [(np.array([1.0, 0.0]), 1.2)]
    if args.two_walls:
        truths.append((np.array([0.0, -1.0]), 1.5))
    print(f"{args.events} events; true walls:")
    for tn, td in truths:
        print(f"  normal ({tn[0]:+.2f}, {tn[1]:+.2f})  distance {td:.2f} m")
    print("mapped walls (support = merged hypotheses):")
    for w in result["walls"]:
        print(f"  normal ({w.normal[0]:+.2f}, {w.normal[1]:+.2f})  "
              f"distance {w.distance:.2f} m  support {w.support}  "
              f"rms {w.rms_m * 100:.1f} cm")


def cmd_simulate(args):
    from .. import Localizer, PipelineConfig
    from ..viz import png, render

    dev = _device(args)
    mics = _mic_array(args)
    if args.volume:
        _simulate_volume(args, mics, dev)
        return
    plane, frames = _build_scene(args, mics)
    loc = Localizer.create(
        mics, PipelineConfig(phat=args.phat, weighting=args.weighting,
                             band_hz=_parse_band(args.band),
                             phat_beta=args.phat_beta),
        with_heatmap=True, device=dev)
    out = _host(loc(_f32(frames, dev)))

    xy = out["xy"][0]
    print(f"true (plane): ({plane[0]:+.3f}, {plane[1]:+.3f}) m")
    print(f"estimate    : ({xy[0]:+.3f}, {xy[1]:+.3f}) m   "
          f"err {np.linalg.norm(xy - plane) * 100:.1f} cm")
    print(f"TDOAs (samples): {np.round(out['tdoa_samples'][0], 2)}")

    if args.out:
        pair_names = [f"{chr(65 + i)}{chr(65 + j)}"
                      for i, j in _np(loc.pairs)]
        img = render.dashboard(
            frames=frames[0],
            correlograms=out["correlograms"][0],
            heat_levels_or_scores=out["heat_levels"][0],
            grid=loc.grid,
            mic_positions=mics,
            best_shifts=out["best_shift"][0],
            status=render.status_text(
                best_shifts=out["best_shift"][0],
                mic_positions=mics, pair_names=pair_names),
            xy=out["xy"][0] if "xy_cov" in out else None,
            xy_cov=out["xy_cov"][0] if "xy_cov" in out else None,
        )
        png.write_png(args.out, img)
        print(f"dashboard -> {args.out}")


def _simulate_volume(args, mics, dev):
    """simulate --volume: 3-D box SRP search + free-xyz GN refinement
    (models.volume.VolumeLocalizer) with the true source at the literal
    (x, y, height) point, no plane/sphere projection."""
    from .. import PipelineConfig, VolumeLocalizer
    from ..core import geometry
    from ..utils import synth
    from ..viz import png, render

    if mics.shape[1] < 3 or np.ptp(mics[:, 2]) < 1e-6:
        print("note: coplanar array — height estimates are ambiguous in "
              "sign and weak near the array plane (use --array tetra)")
    cfg = PipelineConfig(
        phat=args.phat, weighting=args.weighting,
        band_hz=_parse_band(args.band), phat_beta=args.phat_beta,
        max_shift_samples=geometry.max_lag_for_array(
            mics, PipelineConfig()))
    vol = _volume_config(args)
    true = np.array([args.x, args.y, args.height])
    frames = synth.synth_scene(true, mics, noise_rms=args.noise,
                               seed=args.seed)
    loc = VolumeLocalizer.create(mics, cfg, vol, device=dev)
    out = _host(loc(_f32(frames, dev)))
    xyz = out["xyz"][0]
    print(f"true    : ({true[0]:+.3f}, {true[1]:+.3f}, {true[2]:+.3f}) m")
    print(f"estimate: ({xyz[0]:+.3f}, {xyz[1]:+.3f}, {xyz[2]:+.3f}) m   "
          f"err {np.linalg.norm(xyz - true) * 100:.1f} cm")
    print(f"TDOAs (samples): {np.round(out['tdoa_samples'][0], 2)}")
    if args.out:
        img = render.volume_panels(out["scores"][0], vol,
                                   mic_positions=mics, xyz=xyz)
        png.write_png(args.out, img)
        print(f"volume view -> {args.out}")


def _track_summary_line(out, holder, k, sig=""):
    """One-line track summary shared by the host-driven (--source) and
    fused (--track) printouts: spawn detection (holder['n_active'] carries
    the previous count), gating, and the
    'track #id*: xy v sigma p(maneuver)' line.  model_prob is present in
    `out` only on the IMM path.  ``out`` holds host arrays."""
    def _fmt(v):
        return "(" + ", ".join(f"{c:+.3f}" for c in v) + ")"

    active = out["track_active"]
    ids = out["track_id"]
    n_active = int(active.sum())
    spawned = n_active > holder["n_active"]
    holder["n_active"] = n_active
    if k < 0:
        if spawned:
            sm = int(np.argmax(active & (ids == ids.max())))
            return f"track #{int(ids[sm])}: spawned"
        return "track: gated out (no free slot)"
    txy = out["track_xy"][k]
    vel = out["track_vel"][k]
    conf = bool(out["track_confirmed"][k])
    mode = ""
    if "model_prob" in out:
        mode = f" p(maneuver)={float(out['model_prob'][k, -1]):.2f}"
    return (f"track #{int(ids[k])}{'*' if conf else ''}: "
            f"{_fmt(txy)} m v={_fmt(vel)} m/s{sig}{mode}")


def _make_tracker(enabled: bool, dev, dim: int = 2, imm: bool = False):
    """update_fn(z, cov, t) -> one-line track summary for the live stream
    command's --track flag, or None.  dim=3 pairs with --solve-xyz
    (measurements are xyz; 99% chi2 gate for 3 dof).  imm=True runs the
    two-mode IMM bank (cruise/maneuver process noise) instead of a single
    CV filter."""
    if not enabled:
        return None

    from ..models.tracking import Tracker, TrackerConfig

    trk = Tracker(TrackerConfig(dim=dim,
                                imm_q=(0.05, 8.0) if imm else None,
                                gate_maha2=11.34 if dim == 3 else 9.21),
                  device=dev)
    holder = {"state": trk.init(), "n_active": 0}

    def update(z, cov, t, vel=None):
        if imm:
            vel = None  # velocity-measurement fusion is single-model only
        holder["state"], out = trk.step(
            holder["state"], np.asarray(z, np.float32), float(t), True,
            z_cov=None if cov is None else np.asarray(cov, np.float32),
            z_vel=None if vel is None else np.asarray(vel, np.float32))
        out = _host(out)
        sig = ("" if cov is None else
               f" sigma="
               f"{np.sqrt(max(np.trace(np.asarray(cov)) / dim, 0)):.3f}m")
        return _track_summary_line(out, holder, int(out["assigned"]), sig)

    return update


def _fused_track_formatter(dim: int = 2):
    """Format the fused tracked-streaming outputs (models/tracked.py, host
    arrays) into the same one-line track summaries _make_tracker prints for
    the live path.  Call only on event chunks."""
    holder = {"n_active": 0}

    def fmt(out):
        sig = ""
        if "xy_cov" in out and dim == 2:
            sig = (f" sigma="
                   f"{np.sqrt(max(np.trace(out['xy_cov']) / dim, 0)):.3f}m")
        return _track_summary_line(out, holder, int(out["assigned"]), sig)

    return fmt


def cmd_stream_live(args):
    """Live ingest: a transport source (fifo/socket/alsa) feeds the native
    detector; ``runtime.feeder.EventPump`` hands each event frame to the
    device, where it gets the full localization burst."""
    from .. import Localizer, PipelineConfig
    from ..runtime import native_rt, transport
    from ..runtime.feeder import EventPump

    dev = _device(args)
    mics = _mic_array(args)
    cfg = PipelineConfig(phat=bool(getattr(args, "phat", False)),
                         band_hz=_parse_band(getattr(args, "band", None)))
    loc = Localizer.create(mics, cfg, device=dev)
    rt = native_rt.create_ingest_runtime(mics.shape[0], cfg.frame_size)
    src = transport.open_source(rt, args.source)
    if args.source.startswith(("listen://", "socket-listen://")):
        print(f"listening on 127.0.0.1:{src.wait_port()}", flush=True)
    print(f"[{type(rt).__name__}] source {args.source} attached", flush=True)

    deadline = (time.time() + args.max_seconds
                if args.max_seconds else None)
    track = _make_tracker(getattr(args, "track", False), dev,
                          imm=getattr(args, "imm", False))
    events = 0

    def localize(frames, stamps, valid):
        # one event a batch: localized as it arrives, as the reference does
        nonlocal events
        out = _host(loc(frames))
        xy, stamp = out["xy"][0], int(stamps[0])
        events += 1
        print(f"event @ sample {stamp}: xy=({xy[0]:+.3f}, {xy[1]:+.3f}) "
              f"m  shifts={out['best_shift'][0]}", flush=True)
        if track is not None:
            cov = out["xy_cov"][0] if "xy_cov" in out else None
            print("  " + track(xy, cov, stamp / STREAM_RATE_HZ), flush=True)

    pump = EventPump(rt, batch_size=1, on_batch=localize, device=dev)
    try:
        while True:
            if pump.pump():
                continue
            if not src.running:
                if not pump.pump(flush=True):
                    break
                continue
            if deadline and time.time() > deadline:
                break
            time.sleep(0.002)
    finally:
        src.stop()
        print(f"source closed: {src.tuples_pushed} tuples in, "
              f"{rt.events_detected} events detected, {events} localized",
              flush=True)
        rt.close()


def _stream_scene(args, mics, solve_xyz: bool, solve_velocity: bool):
    """(plane [2], streams [M, T] int16) of the synthetic demo: one event
    every 12,000 samples from 3,000 on, over a quiet ADC floor."""
    from ..utils import synth

    if solve_xyz:
        # a genuinely 3-D scene: the source sits at (x, y, height) itself
        # rather than the planar demo's sphere-projected point
        source = np.array([args.x, args.y, args.height])
        plane = source[:2]
        event_frames = synth.synth_scene(
            source, mics, noise_rms=args.noise, seed=args.seed)
    elif solve_velocity:
        # moving-source demo: each event burst is synthesized at the moved
        # position with per-mic Doppler time-scaling; the CAF in the loop
        # measures it back
        plane = np.array([args.x, args.y])
        event_frames = None  # built per event below
    else:
        plane, event_frames = _build_scene(args, mics)

    rng = np.random.default_rng(args.seed)
    t_len = args.duration_samples
    streams = rng.integers(127, 130, size=(mics.shape[0], t_len)).astype(
        np.float64)
    for e in range(max(1, t_len // 12000)):
        at = 3000 + e * 12000
        if solve_velocity:
            from ..core.config import GridConfig

            vel_true = np.array([args.vx, args.vy])
            h = GridConfig().height_m
            pos = plane + vel_true * (at / 50_000.0)
            fr = synth.synth_moving_scene(
                np.array([pos[0], pos[1], h]),
                np.array([vel_true[0], vel_true[1], 0.0]),
                mics, noise_rms=args.noise, seed=args.seed + e)[0]
        else:
            fr = event_frames[0]
        streams[:, at: at + 1024] += 110.0 * fr
    return plane, np.clip(np.round(streams), 0, 255).astype(np.int16)


def _stream_pipeline(args, mics, solve_xyz: bool, solve_velocity: bool):
    from .. import PipelineConfig
    from ..core import geometry

    if solve_xyz or solve_velocity:
        # free-3-D range (and Doppler scale discrimination) ride sub-sample
        # TDOA accuracy: band-limited PHAT, window off, lag range from the
        # actual array
        band = _parse_band(getattr(args, "band", None)) or (
            (700.0, 9500.0) if solve_velocity else (700.0, 7000.0))
        return PipelineConfig(
            trigger_mode=args.trigger_mode,
            trigger_ratio=args.trigger_ratio,
            phat=True,
            band_hz=band,
            # band_crop also selects the CAF's spectral resample fold; crop
            # needs a static band, so 'auto' falls back to masking
            band_crop=solve_velocity and band != "auto",
            window_enabled=False,
            max_shift_samples=geometry.max_lag_for_array(
                mics, PipelineConfig()))
    return PipelineConfig(trigger_mode=args.trigger_mode,
                          trigger_ratio=args.trigger_ratio,
                          phat=bool(getattr(args, "phat", False)),
                          band_hz=_parse_band(getattr(args, "band", None)))


def _wola_hop(frame: int, chunk: int, flag: str) -> int:
    """The WOLA hop of a streaming stage fed ``chunk``-sample chunks: the
    largest power-of-2 common divisor of the stage's frame and the chunk,
    at most 256 (COLA holds: the hop is then frame / 2^k)."""
    import math

    hop = min(math.gcd(frame, chunk), 256)
    if hop < 8:
        raise SystemExit(
            f"{flag} needs --chunk divisible by a WOLA hop "
            f"(power of 2 >= 8); got --chunk {chunk}")
    return hop


def cmd_stream(args):
    import dataclasses
    import os

    from ..core.config import StreamConfig
    from ..models.streaming import StreamingLocalizer
    from ..ops import srp as srp_ops
    from ..runtime import native_rt
    from ..utils import profiling

    if args.source:
        if getattr(args, "extract", None):
            # live ingest is event-driven (the native runtime consumes the
            # continuous stream; Python only sees event frames), so there
            # is no chunk stream to beamform — fail loudly, don't drop it
            raise SystemExit(
                "--extract is not supported with --source (live mode is "
                "event-driven); use Localizer.extract on captured event "
                "frames, or run without --source")
        cmd_stream_live(args)
        return

    dev = _device(args)
    mics = _mic_array(args)
    solve_xyz = bool(getattr(args, "solve_xyz", False))
    solve_velocity = bool(getattr(args, "velocity", False))
    if solve_xyz and np.ptp(mics[:, 2]) < 1e-6:
        raise SystemExit(
            "--solve-xyz needs a non-coplanar array (planar arrays cannot "
            "resolve elevation sign); use --array tetra")
    _, streams = _stream_scene(args, mics, solve_xyz, solve_velocity)
    t_len = args.duration_samples

    rt = native_rt.create_ingest_runtime(mics.shape[0])
    kind = type(rt).__name__
    pcfg = _stream_pipeline(args, mics, solve_xyz, solve_velocity)
    stream_cfg = StreamConfig(
        chunk_size=args.chunk, solve_xyz=solve_xyz,
        solve_velocity=solve_velocity,
        health_weighting=bool(getattr(args, "health_weighting", False)))
    use_track = bool(getattr(args, "track", False))
    if use_track:
        # one step: localization + association + tracker update batched on
        # the device per chunk (models/tracked.py), no host loop between
        from ..models.tracked import TrackedStreamingLocalizer
        from ..models.tracking import TrackerConfig

        dim = 3 if solve_xyz else 2
        stepper = TrackedStreamingLocalizer.create(
            mics, pcfg, stream=stream_cfg,
            tracker_cfg=TrackerConfig(
                dim=dim, gate_maha2=11.34 if dim == 3 else 9.21,
                imm_q=(0.05, 8.0) if getattr(args, "imm", False) else None),
            fuse_velocity=solve_velocity and not getattr(args, "imm",
                                                         False),
            device=dev)
        sl = stepper.sl
    else:
        sl = StreamingLocalizer.create(mics, pcfg, stream=stream_cfg,
                                       device=dev)
        stepper = sl
    state = stepper.init_state()

    def _sp(st):
        # the streaming half of the carried state (tracked or plain)
        return st.stream if use_track else st

    if args.checkpoint:
        from ..utils import checkpoint as ckpt

        if os.path.exists(args.checkpoint) or os.path.exists(
                args.checkpoint + ".npz"):
            try:
                state = ckpt.restore(args.checkpoint, state)
            except ValueError as e:
                if not use_track:
                    raise
                # a plain stream checkpoint (saved without --track) resumed
                # into the tracked template: restore the streaming half,
                # start the tracker fresh
                stream_part = ckpt.restore(args.checkpoint, sl.init_state())
                state = dataclasses.replace(state, stream=stream_part)
                print(f"note: checkpoint predates --track "
                      f"({e}); tracker state starts fresh")
            print(f"resumed from {args.checkpoint} "
                  f"(events so far: {int(_sp(state).event_count)})")
    meter = profiling.ThroughputMeter()
    track_fmt = (_fused_track_formatter(dim=3 if solve_xyz else 2)
                 if use_track else None)
    extractor = None
    if getattr(args, "extract", None):
        from ..models.extraction import StreamingExtractor

        extractor = StreamingExtractor.create(
            mics, pcfg, hop=_wola_hop(512, args.chunk, "--extract"),
            method=args.extract_method, device=dev)
        ex_state = extractor.init_state()
        steer = _f32(np.zeros(2), dev)
        extracted = []
    live = None
    if args.live:
        from ..viz import terminal

        live = terminal.LiveView()
    # free-running refresh (the 60 Hz VGA analogue): redraw every
    # fs/refresh_hz stream samples, whether or not an event arrived
    refresh_every = (int(round(STREAM_RATE_HZ / args.refresh_hz))
                     if args.refresh_hz else None)
    next_refresh = 0
    frames_written = 0
    if args.frames_dir:
        os.makedirs(args.frames_dir, exist_ok=True)

    def _current_levels(state):
        if sl.srp_form == "matmul":
            scores = srp_ops.srp_scores_matmul(
                state.ema_corr[None], sl.params.onehot)[0]
        else:
            scores = srp_ops.srp_scores_gather(
                state.ema_corr[None], sl.params.lut_flat)[0]
        return _np(srp_ops.quantize_heatmap(scores[None]))[0]

    def _redraw(state, out, i):
        from ..viz import terminal

        nonlocal frames_written
        levels = _current_levels(state)
        xy = out.get("xy", out["xy_grid"])
        events_now = int(state.event_count)
        if args.frames_dir:
            from ..viz import png, render

            n = sl.pipeline.frame_size
            window_tail = _np(state.context)[:, -(n - 1):]
            wave = np.concatenate(
                [window_tail, window_tail[:, -1:]], axis=1)
            img = render.dashboard(
                frames=wave,
                correlograms=_np(state.ema_corr),
                heat_levels_or_scores=levels,
                grid=sl.grid,
                mic_positions=_np(sl.params.mic_positions),
                best_shifts=_np(state.best_shift),
                status=(f"t={i / 50000.0:6.2f}s "
                        f"events={events_now} "
                        f"xy=({xy[0]:+.2f},{xy[1]:+.2f})m"),
            )
            png.write_png(
                f"{args.frames_dir}/frame_{frames_written:05d}.png", img)
            frames_written += 1
        if live is not None:
            art = terminal.heatmap_ansi(
                levels, sl.grid.width, sl.grid.height, max_cols=48)
            live.update(
                f"t={i / 50000.0:6.2f}s  events={events_now}  "
                f"xy=({xy[0]:+.2f}, {xy[1]:+.2f}) m\n{art}")

    dereverber = None
    if getattr(args, "dereverb", False):
        from ..ops.dereverb import StreamingDereverb

        hop = _wola_hop(1024, args.chunk, "--dereverb")
        dereverber = StreamingDereverb(mics.shape[0], frame=1024, hop=hop,
                                       device=dev)
        dvb_state = dereverber.init_state()
        print(f"dereverb: WPE frame=1024 hop={hop} "
              f"(latency {dereverber.latency_samples} samples)")
    for i in range(0, t_len - t_len % args.chunk, args.chunk):
        chunk_np = streams[:, i: i + args.chunk]
        rt.push(chunk_np.T)
        chunk = _f32(chunk_np, dev)
        if dereverber is not None:
            dvb_state, chunk = dereverber.step(dvb_state, chunk)
        state, out = stepper(state, chunk)
        out = _host(out)
        meter.add(frames=args.chunk)
        if bool(out["event"]):
            # GN-refined position when the streaming solver is on, else
            # the SRP grid peak
            xy = out.get("xy", out["xy_grid"])
            xyz = out.get("xyz")
            vel = out.get("velocity")
            if live is None:
                extra = ("" if xyz is None else
                         f" xyz=({xyz[0]:+.3f}, {xyz[1]:+.3f}, "
                         f"{xyz[2]:+.3f}) m")
                if vel is not None:
                    extra += (" v=(" + ", ".join(
                        f"{c:+.2f}" for c in vel) + ") m/s")
                print(f"event @ sample {int(out['trigger_abs'])}: "
                      f"xy=({xy[0]:+.3f}, {xy[1]:+.3f}) m{extra} "
                      f"shifts={out['best_shift']}")
            if track_fmt is not None:
                # the tracker already updated on the device this chunk;
                # just format its outputs
                line = track_fmt(out)
                if live is None and line:
                    print("  " + line)
            if extractor is not None:
                steer = _f32(xy, dev)
        if extractor is not None:
            # continuous virtual microphone at the latest event position
            # (center steer = plain array average until the first fix)
            ex_state, y = extractor.step(ex_state, chunk, steer)
            extracted.append(_np(y))
        if refresh_every is not None:
            while i + args.chunk > next_refresh:
                _redraw(_sp(state), out, i)
                next_refresh += refresh_every
        elif live is not None and int(_sp(state).event_count) > 0:
            _redraw(_sp(state), out, i)  # refresh per chunk

    if args.frames_dir:
        print(f"{frames_written} dashboard frames -> {args.frames_dir}")
    if extractor is not None and extracted:
        from ..utils import io as audio_io

        y = np.concatenate(extracted)[extractor.latency_samples:]
        y = y - np.mean(y)  # drop the ADC DC offset
        peak = max(float(np.max(np.abs(y))), 1e-9)
        audio_io.write_wav(args.extract, (0.9 / peak) * y, 50_000)
        print(f"extracted {y.shape[0]} samples "
              f"({extractor.method}) -> {args.extract}")

    print(f"[{kind}] native events: {rt.events_detected}, "
          f"device events: {int(_sp(state).event_count)}, "
          f"ingest rate: {meter.frames_per_sec / 1e3:.0f}k samples/s")
    if args.checkpoint:
        from ..utils import checkpoint as ckpt

        path = ckpt.save(args.checkpoint, state, use_orbax=False)
        print(f"state -> {path}")
    rt.close()


def cmd_bench(args):
    """The frame-batch benchmark: ``tools.bench`` (the root bench.py's
    three lines, one JSON line each) on the command's device."""
    from ..tools import bench

    dev = _device(args)
    bench.main(["--batch", str(args.batch), "--trials", str(args.trials),
                "--device", dev])


def cmd_doa(args):
    """Far-field direction-of-arrival demo (azimuth SRP on a circular array)."""
    from ..core import geometry
    from ..models.doa import DoaEstimator
    from ..utils import synth

    dev = _device(args)
    if getattr(args, "elevation", None) is not None:
        # spherical DoA: plane wave from (azimuth, elevation) on a tetra
        # array, azimuth AND elevation estimated (Doa3dEstimator)
        from ..core.config import PipelineConfig
        from ..models.doa import Doa3dEstimator

        mics = geometry.tetrahedral_array(0.3)
        cfg = PipelineConfig(
            phat=True, window_enabled=False,
            max_shift_samples=geometry.max_lag_for_array(
                mics, PipelineConfig()))
        est = Doa3dEstimator.create(mics, cfg, n_dirs=2048, device=dev)
        az, el = np.deg2rad(args.azimuth), np.deg2rad(args.elevation)
        u = np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                      np.sin(el)])
        rng = np.random.default_rng(args.seed)
        tau = -(np.asarray(mics, np.float64) @ u) / 343.0 * 50_000.0
        sig = synth.chirp_burst(1024, 50_000.0)
        frames = synth.fractional_delay(
            np.broadcast_to(sig, (mics.shape[0], 1024)), tau)
        frames = frames + rng.normal(0, args.noise, frames.shape)
        out = _host(est(_f32(frames, dev)[None]))
        print(f"true bearing : az {args.azimuth:7.2f}  "
              f"el {args.elevation:6.2f} deg")
        print(f"SRP estimate : az {float(out['azimuth_deg'][0]):7.2f}  "
              f"el {float(out['elevation_deg'][0]):6.2f} deg")
        return
    mics = geometry.circular_array(args.mics, 0.15)
    ang = np.deg2rad(args.azimuth)
    src = 50.0 * np.array([np.cos(ang), np.sin(ang), 0.0])
    print(f"true azimuth : {args.azimuth:7.2f} deg")
    if args.method == "music":
        from ..core.config import PipelineConfig
        from ..models.doa import estimate_doa_music

        snaps = np.concatenate([
            synth.synth_scene(
                src, mics,
                signal=synth.colored_burst(1024, 50_000.0, seed=100 + i),
                noise_rms=args.noise, seed=args.seed + i)
            for i in range(args.snapshots)])
        out = estimate_doa_music(_f32(snaps, dev), mics, PipelineConfig(),
                                 n_sources=1)
        print(f"MUSIC estimate: {float(_np(out['azimuth_deg'])[0]):7.2f} "
              f"deg ({args.snapshots} snapshots)")
        return
    est = DoaEstimator.create(mics, device=dev)
    frames = synth.synth_scene(src, mics, noise_rms=args.noise,
                               seed=args.seed)
    out = _host(est(_f32(frames, dev)))
    got = float(out["azimuth_deg"][0])
    u = out["bearing"][0]
    print(f"SRP estimate : {got:7.2f} deg")
    print(f"LS bearing   : {np.rad2deg(np.arctan2(u[1], u[0])) % 360:7.2f} deg")


def cmd_gen_window(args):
    from ..ops import window as window_ops

    _device(args)
    w = window_ops.dpss_window(args.length, args.nw)
    q = window_ops.q15_quantize(w)
    print(f"static const int32_t WINDOW_FUNCTION[{args.length}] = {{")
    for i in range(0, args.length, 12):
        row = ", ".join(f"0x{v & 0xFFFF:04x}" for v in q[i: i + 12])
        print(f"    {row},")
    print("};")
    if args.plot:
        from ..viz import png as png_mod
        from ..viz.raster import Canvas, GREEN

        c = Canvas(480, 160)
        xs = (np.arange(args.length) * (479 / (args.length - 1))).astype(int)
        ys = (150 - w * 140).astype(int)
        c.polyline(xs, ys, GREEN)
        png_mod.write_png(args.plot, c.rgb)
        print(f"window plot -> {args.plot}")


def cmd_calibrate(args):
    from ..models import calibration
    from ..utils import synth

    dev = _device(args)
    mics = _mic_array(args)
    rng = np.random.default_rng(args.seed)
    planes = rng.uniform(-1.0, 1.0, (args.events, 2))
    sources = np.stack([
        np.array([x, y, args.height])
        * (args.height / np.linalg.norm([x, y, args.height]))
        for x, y in planes])
    frames = synth.synth_scene(sources, mics, noise_rms=args.noise,
                               seed=args.seed)
    batch = calibration.CalibBatch(frames=_f32(frames, dev),
                                   source_xy=_f32(planes, dev))

    guess = mics + rng.normal(0, args.perturb, mics.shape).astype(np.float32)
    calib = calibration.Calibrator.create(mics.shape[0], device=dev)
    params, opt_state = calib.init(guess)
    t0 = time.time()
    for step in range(args.steps):
        params, opt_state, loss = calib.train_step(params, opt_state, batch)
        if step % max(1, args.steps // 10) == 0:
            print(f"step {step:4d}  loss {float(loss):.5f}")
    err0 = np.abs(guess - mics).mean() * 1000
    err1 = np.abs(_np(params.mic_xy) - mics).mean() * 1000
    print(f"geometry error: {err0:.2f} mm -> {err1:.2f} mm "
          f"({time.time() - t0:.1f}s)")


def cmd_design(args):
    from ..core import design
    from ..core.config import GridConfig

    dev = _device(args)
    rng = np.random.default_rng(args.seed)
    k = args.cells  # coverage half-cells
    cells_per_m = k / args.extent
    xs = np.linspace(-args.extent, args.extent, 2 * k + 1)
    pts = np.stack(np.meshgrid(xs, xs), -1).reshape(-1, 2).astype(np.float32)

    init = rng.uniform(
        -args.aperture / 3, args.aperture / 3,
        (args.mics, 2)).astype(np.float32)
    t0 = time.time()
    opt, hist = design.optimize_array(
        init, pts, aperture_m=args.aperture,
        min_separation_m=args.min_sep, steps=args.steps,
        sigma_tau_s=args.sigma_tau_us * 1e-6, device=dev)
    print(f"coverage mean CRLB rms: {hist[0] * 100:.2f} cm -> "
          f"{hist[-1] * 100:.2f} cm over {args.steps} steps "
          f"({time.time() - t0:.1f}s)")
    for i, (x, y) in enumerate(opt):
        print(f"  mic {i}: ({x:+.4f}, {y:+.4f}) m")

    if args.out:
        from ..viz import png as png_mod, render

        rms = _np(design.crlb_rms_m(
            _f32(opt, dev), _f32(pts, dev),
            sigma_tau_s=args.sigma_tau_us * 1e-6, height=args.height))
        # bright = better achievable accuracy
        grid = GridConfig(half_cells_x=k, half_cells_y=k,
                          cells_per_m=cells_per_m, projection="plane")
        img = render.heatmap_rgb(
            -rms.reshape(2 * k + 1, 2 * k + 1)[::-1], grid,
            mode="continuous", mic_positions=opt)
        png_mod.write_png(args.out, img)
        print(f"CRLB map (bright = lower bound) -> {args.out}")


def _localize_wav_subspace(args, samples, mics, cfg, dev):
    """localize-wav --method srp-freq|mvdr|music|music-coherent: treat the
    WAV as a continuously emitting source, take the highest-energy frames
    as spatial-covariance snapshots, and localize on the grid."""
    from ..core.config import GridConfig
    from ..ops import srp_freq

    n = cfg.frame_size
    n_frames = samples.shape[-1] // n
    if n_frames < 1:
        raise SystemExit(f"wav shorter than one {n}-sample frame")
    chopped = samples[:, : n_frames * n].reshape(
        samples.shape[0], n_frames, n).transpose(1, 0, 2)  # [S, M, N]
    energy = np.sum(chopped.astype(np.float64) ** 2, axis=(1, 2))
    keep = np.sort(np.argsort(energy)[-max(1, args.snapshots):])
    frames = _f32(chopped[keep], dev)
    grid = GridConfig()

    n_sources = (args.n_sources if args.n_sources == "auto"
                 else int(args.n_sources))
    if args.method == "srp-freq":
        out = srp_freq.localize_freq(frames[:1], mics, grid, cfg)
        xy = _np(out["xy_grid"])[0]
    elif args.method == "mvdr":
        out = srp_freq.localize_mvdr(frames, mics, grid, cfg)
        xy = _np(out["xy_grid"])
    else:
        coherent = args.method == "music-coherent"
        if coherent and cfg.band_hz is None:
            print("warning: CSSM focusing needs a moderate fractional "
                  "bandwidth — pass --band (e.g. 800:6000)")
        out = srp_freq.localize_music(
            frames, mics, grid, cfg, n_sources=n_sources,
            coherent=coherent)
        xy = _np(out["xy_grid"])
    print(f"{args.method}: xy=({xy[0]:+.3f}, {xy[1]:+.3f}) m  "
          f"({frames.shape[0]} snapshots of {n} samples)")
    if "n_sources_estimated" in out:
        print(f"estimated sources (MDL): {out['n_sources_estimated']}")


def cmd_localize_wav(args):
    """Localize events in a multi-channel WAV file (offline ingest path)."""
    import dataclasses
    import os

    from .. import Localizer, PipelineConfig, VolumeLocalizer
    from ..core import geometry
    from ..utils import io as audio_io

    dev = _device(args)
    samples, rate = audio_io.read_wav(args.wav)
    mics = _mic_array(args)
    if samples.shape[0] != mics.shape[0]:
        raise SystemExit(
            f"wav has {samples.shape[0]} channels, array has "
            f"{mics.shape[0]} mics")
    if getattr(args, "dereverb", False):
        from ..ops import dereverb as dvb

        # ~20 ms STFT frames at the file's rate, power-of-two
        fr = 1 << max(8, int(round(np.log2(rate * 0.02))))
        samples = _np(dvb.wpe(_f32(samples, dev), frame=fr, hop=fr // 4,
                              taps=args.dereverb_taps, delay=4, iters=3))
        print(f"dereverberated: WPE frame={fr} taps={args.dereverb_taps}")
    cfg = PipelineConfig(sample_rate_hz=rate, phat=args.phat,
                         weighting=args.weighting,
                         band_hz=_parse_band(args.band),
                         phat_beta=args.phat_beta)
    if args.method != "events":
        _localize_wav_subspace(args, samples, mics, cfg, dev)
        return
    if args.volume:
        cfg = dataclasses.replace(
            cfg, max_shift_samples=geometry.max_lag_for_array(mics, cfg))
        loc = VolumeLocalizer.create(mics, cfg, _volume_config(args),
                                     device=dev)
    else:
        loc = Localizer.create(mics, cfg, device=dev)

    idxs, frames = _detect_event_frames(samples, cfg, args.max_events, dev)
    if len(idxs) == 0:
        print("no events detected")
        return
    out = loc(frames)
    shifts = _np(out["best_shift"])
    if args.volume:
        xyz = _np(out["xyz"])
        for i, t in enumerate(idxs):
            print(f"event @ {t / rate:8.3f}s (sample {t}): "
                  f"xyz=({xyz[i, 0]:+.3f}, {xyz[i, 1]:+.3f}, "
                  f"{xyz[i, 2]:+.3f}) m  shifts={shifts[i]}")
        return
    xy = _np(out["xy"])
    for i, t in enumerate(idxs):
        print(f"event @ {t / rate:8.3f}s (sample {t}): "
              f"xy=({xy[i, 0]:+.3f}, {xy[i, 1]:+.3f}) m  "
              f"shifts={shifts[i]}")
    if args.diagnose:
        from ..ops import consistency

        diag = _host(consistency.diagnose_mics(
            out["tdoa_samples"] / rate, loc.pairs, mics.shape[0]))
        scores = diag["scores"].mean(axis=0)  # over events
        faulty = np.nonzero(diag["faulty"].any(axis=0))[0]
        rms = float(diag["residual_rms"].mean())
        print(f"health: consistency rms {rms:.2e} s; "
              f"per-mic {np.round(scores * 1e6, 2).tolist()} us; "
              f"faulty mics {faulty.tolist() or 'none'}")
    if args.extract:
        waves = _np(loc.extract(frames, out["xy"],
                                method=args.extract_method))  # [E, N]
        stem, ext = os.path.splitext(args.extract)
        for i, w in enumerate(waves):
            peak = np.max(np.abs(w)) or 1.0
            path = f"{stem}_{i:03d}{ext or '.wav'}"
            audio_io.write_wav(
                path, (w / peak * 0.9).astype(np.float32), rate)
            print(f"extracted ({args.extract_method}): {path}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="audio_triangulation_tpu_torch",
        description="acoustic source localization on PyTorch and CUDA")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device(p):
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="where the command runs: the CUDA card "
                            "(default) or, when asked, the CPU")

    def common(p):
        p.add_argument("--array", default="reference",
                       choices=["reference", "square", "circular", "grid",
                                "tetra"])
        p.add_argument("--mics", type=int, default=8)
        p.add_argument("--radius", type=float, default=0.15,
                       help="circular-array radius (m); wider apertures "
                            "condition the --velocity Doppler solve")
        p.add_argument("--x", type=float, default=0.8)
        p.add_argument("--y", type=float, default=0.5)
        p.add_argument("--height", type=float, default=1.2)
        p.add_argument("--noise", type=float, default=0.01)
        p.add_argument("--seed", type=int, default=0)
        device(p)

    p = sub.add_parser("simulate", help="synthetic scene -> localization")
    common(p)
    p.add_argument("--phat", action="store_true")
    p.add_argument("--weighting", default="auto",
                   choices=("auto", "none", "phat", "scot", "roth", "ml"),
                   help="GCC frequency weighting (Knapp & Carter); "
                        "'auto' follows --phat")
    p.add_argument("--band", metavar="LO:HI|auto",
                   help="band-limit the cross-power to LO:HI Hz, or 'auto' "
                        "to select the band per event from pair coherence "
                        "(e.g. 800:6000)")
    p.add_argument("--phat-beta", type=float, default=1.0,
                   help="partial PHAT exponent (1.0 = full whitening)")
    p.add_argument("--out", default="dashboard.png")
    p.add_argument("--volume", action="store_true",
                   help="3-D box search (models.volume) instead of the "
                        "fixed-height grid; --height is then the true "
                        "source z, and --out renders top+side views")
    p.add_argument("--z-range", metavar="LO:HI",
                   help="volume z extent in meters (default 0.2:2.2)")
    p.add_argument("--z-cells", type=int, default=21,
                   help="volume z resolution (default 21)")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("evaluate",
                       help="batch accuracy evaluation on labeled WAVs")
    common(p)
    p.add_argument("manifest",
                   help='JSON list of {"wav": path, "x": m, "y": m}')
    p.add_argument("--phat", action="store_true")
    p.add_argument("--weighting", default="auto",
                   choices=("auto", "none", "phat", "scot", "roth", "ml"))
    p.add_argument("--band", metavar="LO:HI|auto")
    p.add_argument("--phat-beta", type=float, default=1.0)
    p.add_argument("--out", help="write the full JSON report here")
    p.set_defaults(fn=cmd_evaluate)

    p = sub.add_parser(
        "serve",
        help="HTTP/JSON localization server (runtime.server). The server "
             "is UNAUTHENTICATED — bind --host beyond 127.0.0.1 only on a "
             "trusted network.  Request bodies are capped (64 MiB, HTTP "
             "413 beyond) and frame shapes validated against the pipeline.")
    common(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--phat", action="store_true")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("stream", help="streaming demo with native ingest")
    common(p)
    p.add_argument("--chunk", type=int, default=512)
    p.add_argument("--phat", action="store_true",
                   help="PHAT-whiten the cross-power (pair with --band)")
    p.add_argument("--band", metavar="LO:HI|auto",
                   help="band-limit the cross-power to LO:HI Hz, or 'auto' "
                        "to select the band per event from pair coherence "
                        "(ops/xcorr.auto_band_weight); overrides the tuned "
                        "defaults of --solve-xyz/--velocity")
    p.add_argument("--duration-samples", type=int, default=50_000)
    p.add_argument("--trigger-mode", choices=("absolute", "relative"),
                   default="absolute",
                   help="'absolute' = the reference's fixed threshold; "
                        "'relative' = CFAR-style floor-tracking "
                        "(out > threshold + ratio * incoming power)")
    p.add_argument("--trigger-ratio", type=float, default=4.0)
    p.add_argument("--extract", default=None, metavar="OUT_WAV",
                   help="beamform a continuous 'virtual microphone' at "
                        "the latest event position and write it as a WAV "
                        "(models/extraction.StreamingExtractor)")
    p.add_argument("--extract-method", choices=("das", "mvdr"),
                   default="das")
    p.add_argument("--health-weighting", action="store_true",
                   help="fault-tolerant solve: leave-one-mic-out "
                        "cycle-consistency weights auto-suppress a "
                        "failing channel's pairs in the SRP init and GN "
                        "solve (StreamConfig.health_weighting; adds "
                        "mic_weight/pair_weight outputs)")
    p.add_argument("--track", action="store_true",
                   help="run the Kalman tracker over events (uses each "
                        "event's xy_cov as measurement noise); prints "
                        "track id/position/velocity per event; with "
                        "--solve-xyz the tracker runs in 3-D")
    p.add_argument("--imm", action="store_true",
                   help="with --track: IMM cruise/maneuver mode bank "
                        "(TrackerConfig.imm_q=(0.05, 8.0)) instead of a "
                        "single CV filter; prints p(maneuver) per event")
    p.add_argument("--velocity", action="store_true",
                   help="per-event instantaneous velocity via the "
                        "delay-Doppler cross-ambiguity (ops.caf) on the "
                        "captured frame; the demo scene then MOVES the "
                        "source at (--vx, --vy) with per-mic Doppler "
                        "time-scaling, and --track fuses the measured "
                        "velocity (z_vel)")
    p.add_argument("--vx", type=float, default=2.0,
                   help="demo source x-velocity for --velocity (m/s)")
    p.add_argument("--vy", type=float, default=-1.0,
                   help="demo source y-velocity for --velocity (m/s)")
    p.add_argument("--solve-xyz", action="store_true",
                   help="also solve each event's free 3-D position from "
                        "the smoothed TDOAs (multi-start GN over "
                        "StreamConfig.xyz_z_inits; needs a non-coplanar "
                        "array, e.g. --array tetra); the demo scene then "
                        "places the source at (--x, --y, --height)")
    p.add_argument("--dereverb", action="store_true",
                   help="insert a streaming WPE dereverberation stage "
                        "(ops.dereverb.StreamingDereverb) in front of the "
                        "detector; chunks are dereverbed continuously "
                        "(adaptive RLS per STFT bin), event timestamps "
                        "shift by the WOLA latency (frame - hop samples)")
    p.add_argument("--live", action="store_true",
                   help="in-place ANSI heatmap (the live VGA analogue)")
    p.add_argument("--refresh-hz", type=float, default=None,
                   help="free-running dashboard refresh rate in stream time "
                        "(the reference display free-runs at 60 Hz); redraws "
                        "whether or not an event arrived")
    p.add_argument("--frames-dir", default=None,
                   help="write the refreshed dashboard as a PNG sequence "
                        "into this directory")
    p.add_argument("--checkpoint", default=None,
                   help="save/resume the stream state (EMA correlograms etc.)")
    p.add_argument("--source", default=None,
                   help="live transport source: fifo:///path, "
                        "socket://host:port, listen://:port, alsa://device "
                        "(interleaved int16 tuples); omit for the synthetic "
                        "demo stream")
    p.add_argument("--max-seconds", type=float, default=None,
                   help="stop a live source after this many idle seconds")
    p.set_defaults(fn=cmd_stream)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.add_argument("--verbose", action="store_true",
                   help="accepted for the reference's command line; the "
                        "tool prints its JSON lines either way")
    p.add_argument("--batch", type=int, default=16384,
                   help="frames a call (tools.bench)")
    p.add_argument("--trials", type=int, default=7,
                   help="timed calls per configuration (tools.bench)")
    device(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("doa", help="far-field direction-of-arrival demo")
    p.add_argument("--mics", type=int, default=8)
    p.add_argument("--azimuth", type=float, default=222.5)
    p.add_argument("--noise", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--method", choices=("srp", "music"), default="srp",
                   help="'music' runs wideband subspace DoA over "
                        "--snapshots independent bursts")
    p.add_argument("--snapshots", type=int, default=12)
    p.add_argument("--elevation", type=float, default=None,
                   help="also estimate elevation: spherical SRP on a "
                        "tetrahedral array with the plane wave arriving "
                        "from (--azimuth, --elevation) degrees")
    device(p)
    p.set_defaults(fn=cmd_doa)

    p = sub.add_parser("gen-window", help="emit the Q15 DPSS window C table")
    p.add_argument("--length", type=int, default=1024)
    p.add_argument("--nw", type=float, default=2.0)
    p.add_argument("--plot", default=None,
                   help="also render the window curve to this PNG "
                        "(the window.ipynb plot)")
    device(p)
    p.set_defaults(fn=cmd_gen_window)

    p = sub.add_parser("localize-wav",
                       help="detect + localize events in a WAV file")
    common(p)
    p.add_argument("wav")
    p.add_argument("--phat", action="store_true")
    p.add_argument("--weighting", default="auto",
                   choices=("auto", "none", "phat", "scot", "roth", "ml"),
                   help="GCC frequency weighting (Knapp & Carter); "
                        "'auto' follows --phat")
    p.add_argument("--band", metavar="LO:HI|auto",
                   help="band-limit the cross-power to LO:HI Hz, or 'auto' "
                        "to select the band per event from pair coherence "
                        "(e.g. 800:6000)")
    p.add_argument("--phat-beta", type=float, default=1.0,
                   help="partial PHAT exponent (1.0 = full whitening)")
    p.add_argument("--max-events", type=int, default=16)
    p.add_argument("--method", default="events",
                   choices=("events", "srp-freq", "mvdr", "music",
                            "music-coherent"),
                   help="'events' (default) detects transient events and "
                        "runs the GCC+SRP+GN pipeline on each; the others "
                        "treat the WAV as ONE continuously emitting source "
                        "and localize it from snapshot frames: 'srp-freq' "
                        "(frequency-steered SRP), 'mvdr' (Capon), 'music' "
                        "(wideband incoherent subspace), 'music-coherent' "
                        "(CSSM focusing — resolves a source plus its "
                        "reflection; set --band, e.g. 800:6000)")
    p.add_argument("--snapshots", type=int, default=16,
                   help="snapshot frames for the subspace methods "
                        "(highest-energy frames of the file)")
    p.add_argument("--n-sources", default="1",
                   help="subspace model order: an int or 'auto' "
                        "(MDL selection; music methods only)")
    p.add_argument("--diagnose", action="store_true",
                   help="print array health (TDOA cycle-consistency "
                        "per-mic scores + faulty-mic flags)")
    p.add_argument("--dereverb", action="store_true",
                   help="WPE multi-channel dereverberation of the whole "
                        "file before detection (ops.dereverb; late "
                        "reflections are subtracted per STFT bin, the "
                        "direct path and early reflections survive — "
                        "sharper GCC peaks in reverberant rooms)")
    p.add_argument("--dereverb-taps", type=int, default=10,
                   help="WPE prediction taps per channel (default 10)")
    p.add_argument("--extract", metavar="OUT_WAV",
                   help="also write a beamformed mono waveform of each "
                        "event at its localized position (files get a "
                        "_NNN suffix)")
    p.add_argument("--extract-method", choices=("das", "mvdr"),
                   default="das")
    p.add_argument("--volume", action="store_true",
                   help="solve (x, y, z) per event via the 3-D box search "
                        "(models.volume; wants a non-coplanar array, "
                        "e.g. --array tetra)")
    p.add_argument("--z-range", metavar="LO:HI",
                   help="volume z extent in meters (default 0.2:2.2)")
    p.add_argument("--z-cells", type=int, default=21,
                   help="volume z resolution (default 21)")
    p.set_defaults(fn=cmd_localize_wav)

    p = sub.add_parser(
        "design", help="CRLB-driven mic placement over a coverage region")
    p.add_argument("--mics", type=int, default=4)
    p.add_argument("--aperture", type=float, default=0.15,
                   help="max mic radius from array center (m)")
    p.add_argument("--min-sep", type=float, default=0.05)
    p.add_argument("--extent", type=float, default=1.5,
                   help="coverage half-extent (m)")
    p.add_argument("--cells", type=int, default=16)
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--sigma-tau-us", type=float, default=2.0,
                   help="per-pair TDOA noise (microseconds RMS)")
    p.add_argument("--height", type=float, default=1.2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="",
                   help="optional CRLB-map PNG path")
    device(p)
    p.set_defaults(fn=cmd_design)

    p = sub.add_parser("calibrate", help="array self-calibration demo")
    common(p)
    p.add_argument("--events", type=int, default=48)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--perturb", type=float, default=0.01)
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser(
        "map-room",
        help="acoustic reflector mapping demo: echoes -> wall estimates")
    p.add_argument("--events", type=int, default=3)
    p.add_argument("--two-walls", action="store_true",
                   help="make two walls reflective instead of one")
    p.add_argument("--noise", type=float, default=0.003)
    p.add_argument("--seed", type=int, default=0)
    device(p)
    p.set_defaults(fn=cmd_map_room)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
