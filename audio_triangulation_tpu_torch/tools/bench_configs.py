"""Benchmark matrix: the five ``BASELINE.json`` configurations on one card.

Counterpart of the JAX package's ``bench_configs.py``, with its seven
records by its names, settings and batches:

  1. ``1_2mic_gcc_phat_1024``: 2-mic GCC-PHAT, 16,384 frames of 1,024
     samples (TDOA only, the unfused matmul engine ``mxu_fft.xcorr_mxu``
     and ``xcorr.subsample_peak``: plain torch, no kernel);
  2. ``2_3mic_triangulation``: ``reference_array()``, 16,384 frames, and
     ``single_frame_latency_us``, the median of 50 single-frame calls;
  3. ``3_4mic_streaming_overlap_lanes_s3``: a 4 x 2,098,176 stream framed
     into 4,097 half-overlapped frames in lane order
     (``framing.frame_multichannel_lanes``), bf16 scoring, init grid
     stride 3, time order restored on ``xy``;
  4. ``4_8mic_circular_srp_phat_65x65_s2bf16``: ``circular_array(8,
     0.15)``, 65 x 65 cells, bf16 scoring, stride 2, 8,192 frames;
  5. ``5_64mic_4096pt_batched``, ``5b_64mic_4096pt_band_crop`` (800-6,000
     Hz) and ``5c_64mic_4096pt_band_auto``: 256 frames of 64 x 4,096
     (2,016 pairs, 268 MB), stride 2.

Each record holds the median frames/s of ``--trials`` calls (7 by default)
and its quartiles, timed by :func:`.bench.frames_per_s` (one call a trial
on the host clock around ``torch.cuda.synchronize()``, as
``chip_smoke.py`` times its paths), the kernels the configuration reaches
(``route``), and the card's name and power limit.  The reference's
``resident_batches`` is left out: it stacked 4-12 resident batches in one
jit to hide the TPU's dispatch latency, which a card called from its own
host does not have.  There is no ``vs_baseline``.  Like the reference, the
frames of records 1, 2, 4 and 5 are one event replicated over the batch.

    python -m audio_triangulation_tpu_torch.tools.bench_configs
        [--trials 7] [--max-frames N] [--device cuda] [--out PATH]

``--max-frames`` cuts every record's batch to at most N frames (a quick
look on the CPU; the records then say so in ``batch``).

It writes a file only when given ``--out``; the last line is the summary.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Callable

import numpy as np
import torch

from ..core import geometry
from ..core.config import GridConfig, PipelineConfig
from ..models import localizer as localizer_mod
from ..models.localizer import Localizer
from ..ops import framing, mxu_fft, xcorr
from ..ops.cuda import gcc_kernel
from ..utils import synth
from .bench import card_fields, frames_per_s, require_device

# (record name, frames a call) in the reference's order
RECORDS = (("1_2mic_gcc_phat_1024", 16384),
           ("2_3mic_triangulation", 16384),
           ("3_4mic_streaming_overlap_lanes_s3", 4097),
           ("4_8mic_circular_srp_phat_65x65_s2bf16", 8192),
           ("5_64mic_4096pt_batched", 256),
           ("5b_64mic_4096pt_band_crop", 256),
           ("5c_64mic_4096pt_band_auto", 256))
LATENCY_CALLS = 50  # single-frame calls of record 2
HOP = 512  # record 3's framing: 1,024-sample frames at half overlap


@dataclasses.dataclass
class Config:
    """One record's workload on a device: ``call()`` runs the timed call on
    ``frames`` ([B, M, N], or record 3's [M, T] stream) and returns its
    outputs (``xy`` in time order, or record 1's ``tdoa_samples``)."""

    name: str
    n_frames: int
    call: Callable[[], dict]
    frames: torch.Tensor
    route: str
    extra: dict
    loc: Localizer | None = None


def source_point(xyz=(0.7, 0.4, 1.2)) -> np.ndarray:
    """The reference's source: (0.7, 0.4, 1.2) put on the 1.2 m sphere."""
    src = np.array(xyz, np.float64)
    return src * 1.2 / np.linalg.norm(src)


def replicated(frame: np.ndarray, n_frames: int, device) -> torch.Tensor:
    """One event [1, M, N] replicated over ``n_frames`` frames on
    ``device``, in C order as the reference's arrays are on its device
    (numpy's astype of the broadcast view would keep the batch axis
    fastest, and each call would pay a transposing copy)."""
    return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        frame, (n_frames, *frame.shape[1:])), dtype=np.float32)).to(device)


def route_of(loc: Localizer, frames: torch.Tensor) -> str:
    """The kernels (or plain torch stages) ``loc(frames)`` runs, as
    ``models.localizer.localize_frames`` decides them for this shape on
    this device (``gcc_routes``, ``in_kernel_srp``, the GN route)."""
    cfg, grid = loc.pipeline, loc.grid
    n_pairs = loc.pairs.shape[0]
    flat = frames.reshape(-1, *frames.shape[-2:])
    peaks = cfg.taper_enabled and cfg.subsample_peak
    on_kernel, on_large = localizer_mod.gcc_routes(flat, cfg, n_pairs, peaks)
    refine = (grid.refine_peak == "on"
              or (grid.refine_peak == "auto" and not loc.with_solver))
    if (on_kernel and peaks and localizer_mod.in_kernel_srp(
            cfg, loc.srp_form, refine, loc.score_bias is not None)
            and gcc_kernel.srp_mode_fits(flat, cfg, n_pairs)):
        gcc = "gcc_srp_kernel (scores and grid argmax in it)"
    elif on_kernel:
        gcc = ("gcc_stats_kernel" if gcc_kernel.needs_stats(cfg, peaks)
               else "gcc_kernel")
    elif on_large:
        gcc = "gcc_large_kernel"
    else:
        gcc = "unfused GCC (torch)"
    solve = "gn_kernel" if loc.gn is not None else "batched solver (torch)"
    return f"{gcc} + {solve}"


def _localizer_config(name, n_frames, loc, frames) -> Config:
    return Config(name, n_frames, lambda: {"xy": loc(frames)["xy"]}, frames,
                  route_of(loc, frames), {}, loc)


def config_2mic(n_frames: int, device) -> Config:
    cfg = PipelineConfig(phat=True, fft_pad_mode="circular")
    sig = synth.chirp_burst(1024, 48_000.0)
    f2 = np.stack([sig, synth.fractional_delay(sig, 7.3)])[None]
    frames = replicated(f2, n_frames, device)
    pair = torch.tensor([[0, 1]], device=device)

    def call():
        corr = mxu_fft.xcorr_mxu(frames, pair, cfg)
        return {"tdoa_samples": xcorr.subsample_peak(corr, cfg.max_shift)[0]}

    return Config(RECORDS[0][0], n_frames, call, frames,
                  "unfused matmul GCC (torch): xcorr_mxu + subsample_peak",
                  {})


def config_3mic(n_frames: int, device) -> Config:
    mics = geometry.reference_array()
    loc = Localizer.create(mics, PipelineConfig(fft_pad_mode="circular"),
                           device=device)
    one = synth.synth_scene(source_point(), mics, noise_rms=0.01, seed=1)
    return _localizer_config(RECORDS[1][0], n_frames, loc,
                             replicated(one, n_frames, device))


def config_4mic_lanes(n_frames: int, device) -> Config:
    """Record 3: ``n_frames`` half-overlapped frames of a 4-mic noise
    stream (the reference's 4,097 come from 2,049 x 1,024 samples)."""
    mics = geometry.square_array(0.3)
    loc = Localizer.create(
        mics, PipelineConfig(phat=True, fft_pad_mode="circular",
                             srp_dtype="bfloat16"),
        device=device, init_grid_stride=3)
    t_len = 1024 + (n_frames - 1) * HOP
    stream = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.05, (4, t_len)).astype(np.float32)).to(device)

    def frame():
        return framing.frame_multichannel_lanes(stream, 1024, HOP)

    frames, order = frame()
    order_t = torch.as_tensor(order, device=device)

    def call():
        lanes, _ = frame()
        # time order restored on the small output, not on the frames
        return {"xy": loc(lanes)["xy"][order_t]}

    return Config(RECORDS[2][0], n_frames, call, stream,
                  route_of(loc, frames),
                  {"framing": "lanes", "init_grid_stride": 3}, loc)


def config_8mic(n_frames: int, device) -> Config:
    mics = geometry.circular_array(8, 0.15)
    grid = GridConfig(half_cells_x=32, half_cells_y=32, cells_per_m=24.0)
    loc = Localizer.create(
        mics, PipelineConfig(phat=True, fft_pad_mode="circular",
                             srp_dtype="bfloat16"), grid,
        device=device, init_grid_stride=2)
    one = synth.synth_scene(source_point(), mics, noise_rms=0.01, seed=2)
    c = _localizer_config(RECORDS[3][0], n_frames, loc,
                          replicated(one, n_frames, device))
    c.extra = {"srp_form": loc.srp_form, "init_grid_stride": 2}
    return c


def config_64mic(name: str, n_frames: int, device) -> Config:
    """Records 5, 5b and 5c: full band, 800-6,000 Hz crop, auto band."""
    mics = geometry.grid_array(8, 8, 0.05)
    band = {RECORDS[4][0]: {}, RECORDS[5][0]: {
        "band_hz": (800.0, 6000.0), "band_crop": True},
        RECORDS[6][0]: {"band_hz": "auto"}}[name]
    cfg = PipelineConfig(
        frame_size_bits=12,
        max_shift_samples=geometry.max_lag_for_array(mics, PipelineConfig()),
        phat=True, fft_pad_mode="circular", srp_dtype="bfloat16", **band)
    grid = GridConfig(half_cells_x=31, half_cells_y=31, cells_per_m=16.0)
    loc = Localizer.create(mics, cfg, grid, device=device, init_grid_stride=2)
    one = synth.synth_scene(source_point(), mics, n=4096, seed=3)
    c = _localizer_config(name, n_frames, loc,
                          replicated(one, n_frames, device))
    c.extra = {"pairs": 2016}
    if name == RECORDS[4][0]:
        c.extra["srp_form"] = loc.srp_form
    else:
        c.extra["band_hz"] = list(band["band_hz"]) if isinstance(
            band["band_hz"], tuple) else band["band_hz"]
    return c


def make_config(name: str, device, n_frames: int | None = None) -> Config:
    """Record ``name``'s workload on ``device`` at its batch, or at
    ``n_frames`` frames."""
    n = n_frames or dict(RECORDS)[name]
    if name == RECORDS[0][0]:
        return config_2mic(n, device)
    if name == RECORDS[1][0]:
        return config_3mic(n, device)
    if name == RECORDS[2][0]:
        return config_4mic_lanes(n, device)
    if name == RECORDS[3][0]:
        return config_8mic(n, device)
    if name in dict(RECORDS[4:]):
        return config_64mic(name, n, device)
    raise ValueError(f"unknown record {name!r}")


def single_frame_latency_us(device, calls: int = LATENCY_CALLS) -> float:
    """Median microseconds of one synchronised single-frame call of record
    2's localizer."""
    c = make_config(RECORDS[1][0], device, 1)
    med, _, _ = frames_per_s(c.call, 1, calls, device, warmup=3)
    return 1e6 / med


def record(c: Config, trials: int, device, card: dict) -> dict:
    """One record: ``c``'s frames/s and its fields."""
    med, q1, q3 = frames_per_s(c.call, c.n_frames, trials, device)
    rec = {"config": c.name, "frames_per_sec": med, "iqr": [q1, q3],
           "trials": trials, "batch": c.n_frames, "route": c.route, **card,
           **c.extra}
    if c.name.startswith("5"):
        rec["time_for_10k_frames_s"] = 10_000 / med
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.trials < 1:
        raise ValueError("--trials must be at least 1")
    dev = require_device(args.device)
    card = card_fields(dev)
    results = []
    for name, batch in RECORDS:
        n = min(batch, args.max_frames or batch)
        rec = record(make_config(name, dev, n), args.trials, dev, card)
        if name == RECORDS[1][0]:
            rec["single_frame_latency_us"] = single_frame_latency_us(dev)
        results.append(rec)
        print(json.dumps(rec), flush=True)
        if dev != "cpu":
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps({"summary": "ok", "configs": len(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
