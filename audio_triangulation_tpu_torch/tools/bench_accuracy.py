"""Accuracy of the port against geometric truth: TDOA and position error
versus SNR, on one device.

Counterpart of the JAX package's ``bench_accuracy.py``, with its scenes
and seeds: 256 sources on the 1.2 m sphere over ``square_array(0.3)``
(``default_rng(7)``), chirp frames at SNR 40 / 30 / 20 / 10 / 6 / 0 dB
(noise ``seed=snr_db``), the five methods (``plain``, ``phat``,
``band_crop``, ``band_auto``, ``auto_hybrid``) at init-grid strides 1 and
3, then the 8-bit ADC row (``seed=99``).  The true TDOAs come from
``solver.predicted_tdoas``.  One JSON line a point, with the rows' keys of
the reference's ``BENCH_ACCURACY.json`` plus ``device`` and
``power_limit_w``.

    python -m audio_triangulation_tpu_torch.tools.bench_accuracy
        [--device cuda] [--scenes 256] [--snrs 40 30 20 10 6 0]
        [--strides 1 3] [--out PATH]

It writes a file (the list of rows as JSON) only when given ``--out``.
``bench_accuracy_reference.json`` beside it holds the JAX package's rows
of the same sweep from a CPU run; :func:`off_reference` holds a run's
medians to them.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..models.localizer import Localizer
from ..ops import solver as solver_ops
from ..utils import synth
from .bench import card_fields

HEIGHT_M = 1.2
SNRS = (40, 30, 20, 10, 6, 0)
STRIDES = (1, 3)
# 'band_crop' is the bench's headline configuration (PHAT band-limited to
# the chirp's 800-6,000 Hz, cropped spectra), 'band_auto' its hands-free
# form, 'auto_hybrid' adds the coherence-gated phase-slope sub-sample
METHODS = {
    "plain": {},
    "phat": dict(phat=True),
    "band_crop": dict(phat=True, band_hz=(800.0, 6000.0), band_crop=True),
    "band_auto": dict(phat=True, band_hz="auto"),
    "auto_hybrid": dict(phat=True, band_hz="auto", subsample_method="hybrid"),
}

REFERENCE_ROWS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "bench_accuracy_reference.json")
# how far a row's medians may lie from the reference row: the parity rule
# holds each scene within 1e-3 samples and 2e-4 m of the other path, so a
# median moves by no more, plus each side's rounding (1e-4 samples,
# 0.01 cm); twice that
MEDIAN_TOLERANCE = {"tdoa_err_median_samples": 2e-3, "xy_err_median_cm": 0.05}


def row_key(row: dict) -> tuple:
    return row["snr_db"], row.get("method"), row.get("init_grid_stride")


def off_reference(rows: list) -> list:
    """(point, key, value, reference value) of every median of ``rows``
    further from the reference row of its point than
    ``MEDIAN_TOLERANCE``; rows of points the reference lacks, or of
    another scene count, are an error."""
    with open(REFERENCE_ROWS) as f:
        ref = {row_key(r): r for r in json.load(f)}
    off = []
    for row in rows:
        r = ref[row_key(row)]
        if r["scenes"] != row["scenes"]:
            raise ValueError(f"{row_key(row)}: {row['scenes']} scenes, the "
                             f"reference row has {r['scenes']}")
        off += [(row_key(row), k, row[k], r[k])
                for k, tol in MEDIAN_TOLERANCE.items()
                if abs(row[k] - r[k]) > tol]
    return off


def clear_of_ties(correlograms: torch.Tensor, scores: torch.Tensor,
                  margin: float = 1e-3) -> torch.Tensor:
    """[B] bool: the frames whose decisions are ``margin`` of scale clear of
    the runner-up, where two paths that differ in rounding must agree: in
    every pair the best lag's value over the second's (correlograms
    [B, P, L], scale the frame's largest |value|), and the best grid cell's
    score over the second's (scores [B, G], scale the largest |score|)."""
    top2 = correlograms.topk(2, dim=-1).values
    scale = correlograms.abs().amax(dim=(-1, -2))
    lag_gap = ((top2[..., 0] - top2[..., 1]) / scale[:, None]).amin(-1)
    s2 = scores.topk(2, dim=-1).values
    cell_gap = (s2[:, 0] - s2[:, 1]) / scores.abs().amax(-1)
    return (lag_gap >= margin) & (cell_gap >= margin)


def method_config(method: str) -> PipelineConfig:
    return PipelineConfig(fft_pad_mode="circular", **METHODS[method])


def scenes(n_scenes: int):
    """(plane points [S, 2], sources [S, 3], true TDOAs [S, P] in samples)
    of the reference's scenes: the first ``n_scenes`` of its draw."""
    mics = geometry.square_array(0.3)
    planes = np.random.default_rng(7).uniform(-1.2, 1.2, (n_scenes, 2))
    v = np.concatenate([planes, np.full((n_scenes, 1), HEIGHT_M)], axis=1)
    sources = v * (HEIGHT_M / np.linalg.norm(v, axis=1, keepdims=True))
    mic3 = torch.zeros((4, 3))
    mic3[:, :2] = torch.from_numpy(mics)
    tau = solver_ops.predicted_tdoas(
        torch.from_numpy(planes.astype(np.float32)), mic3,
        torch.from_numpy(geometry.mic_pairs(4)), 343.0, HEIGHT_M, True)
    return planes, sources, tau.numpy() * 50_000.0


def errors(out: dict, planes: np.ndarray, true_tau: np.ndarray) -> dict:
    """The row's error statistics of one point's outputs."""
    tdoa_err = np.abs(out["tdoa_samples"].cpu().numpy() - true_tau)
    xy_err = np.linalg.norm(out["xy"].cpu().numpy() - planes, axis=-1)
    return {
        "tdoa_err_median_samples": round(float(np.median(tdoa_err)), 4),
        "tdoa_err_p90_samples": round(float(np.percentile(tdoa_err, 90)), 4),
        "xy_err_median_cm": round(float(np.median(xy_err)) * 100, 2),
        "xy_err_p90_cm": round(float(np.percentile(xy_err, 90)) * 100, 2),
        "scenes": len(planes),
    }


def points(n_scenes: int = 256, snrs=SNRS, strides=STRIDES,
           device="cuda"):
    """Each point of the sweep in turn: (row, outputs, frames [S, 4, N]
    f32 numpy, its localizer, its init-grid stride).  The signal's
    amplitude is 0.8; the noise sets the SNR."""
    mics = geometry.square_array(0.3)
    planes, sources, true_tau = scenes(n_scenes)
    for snr_db in snrs:
        noise = 0.8 / (10 ** (snr_db / 20.0)) / np.sqrt(2)
        frames = synth.synth_scene(sources, mics, noise_rms=noise,
                                   seed=snr_db).astype(np.float32)
        x = torch.from_numpy(frames).to(device)
        for method in METHODS:
            for stride in strides:
                loc = Localizer.create(mics, method_config(method),
                                       device=device, init_grid_stride=stride)
                out = loc(x)
                row = {"snr_db": snr_db, "method": method,
                       "init_grid_stride": stride,
                       **errors(out, planes, true_tau)}
                yield row, out, frames, loc, stride
    # the 8-bit ADC front end (the firmware's input format)
    frames = synth.to_adc_u8(synth.synth_scene(
        sources, mics, noise_rms=0.01, seed=99)).astype(np.float32)
    loc = Localizer.create(mics, PipelineConfig(fft_pad_mode="circular"),
                           device=device)
    out = loc(torch.from_numpy(frames).to(device))
    yield ({"snr_db": "8bit_adc", "phat": False,
            **errors(out, planes, true_tau)}, out, frames, loc, 1)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scenes", type=int, default=256)
    ap.add_argument("--snrs", type=int, nargs="+", default=list(SNRS))
    ap.add_argument("--strides", type=int, nargs="+", default=list(STRIDES))
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    card = card_fields(args.device)
    rows = []
    for row, *_ in points(args.scenes, args.snrs, args.strides, args.device):
        row.update(card)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
