"""Robustness benchmark: the localization error of each estimator variant
on adverse scenes, reverberant and noisy.

Counterpart of the JAX package's ``bench_robustness.py``: its ten
``METHODS`` (the GCC weighting family, band-limited and partial PHAT,
phase-slope TDOA, the hands-free auto band and its hybrid) on
``square_array(0.3)`` by two conditions of 64 scenes each (sources on the
1.2 m sphere over a +-1 m plane, ``default_rng(11)``):

- ``anechoic_10db``: ``synth_scene`` at 10 dB SNR;
- ``reverb_rt60_0.25``: a 6 x 5 x 3 m shoebox at RT60 0.25 s,
  ``max_order=5``, the array at the room's centre, through
  ``utils.room.simulate_batch`` on the device, plus 0.01 rms noise.

It prints one JSON line a (condition, method) with the reference's keys
(``xy_err_median_cm``, ``xy_err_p90_cm``, ``hit_rate_lt_10cm``,
``scenes``), the kernels the method reaches (``route``), and the card's
name and power limit.

    python -m audio_triangulation_tpu_torch.tools.bench_robustness
        [--scenes 64] [--device cuda] [--out PATH]

It writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..models.localizer import Localizer
from ..utils import room as room_mod
from ..utils import synth
from .bench import card_fields, require_device
from .bench_configs import route_of

METHODS = {
    "plain": {},
    "phat": {"phat": True},
    "phat_band": {"phat": True, "band_hz": (800.0, 6000.0)},
    "phat_beta05": {"phat": True, "phat_beta": 0.5},
    "scot": {"weighting": "scot"},
    "roth": {"weighting": "roth"},
    "ml": {"weighting": "ml"},
    "phase": {"subsample_method": "phase"},
    "band_auto": {"phat": True, "band_hz": "auto"},
    "auto_hybrid": {"phat": True, "band_hz": "auto",
                    "subsample_method": "hybrid"},
}
HEIGHT_M = 1.2
ROOM_SIZE = (6.0, 5.0, 3.0)
ROOM_RT60_S = 0.25
ROOM_MAX_ORDER = 5
ROOM_SHIFT = (3.0, 2.5, 0.8)  # the array's place in the room
SNR_DB = 10.0


def conditions(n_scenes: int, device):
    """(plane points [S, 2], {condition: frames [S, 4, 1,024] on
    ``device``}) of the reference's scenes."""
    mics = geometry.square_array(0.3)
    rng = np.random.default_rng(11)
    planes = rng.uniform(-1.0, 1.0, (n_scenes, 2))
    sources = np.stack([
        np.array([x, y, HEIGHT_M]) * (HEIGHT_M / np.linalg.norm(
            [x, y, HEIGHT_M])) for x, y in planes])
    noise = 0.8 / (10 ** (SNR_DB / 20.0)) / np.sqrt(2)
    anechoic = synth.synth_scene(sources, mics, noise_rms=noise,
                                 seed=1).astype(np.float32)
    alpha = room_mod.absorption_for_rt60(ROOM_SIZE, ROOM_RT60_S)
    room = room_mod.ShoeboxRoom(size=ROOM_SIZE, absorption=alpha,
                                max_order=ROOM_MAX_ORDER)
    shift = np.array(ROOM_SHIFT)
    mics3 = np.concatenate([mics, np.zeros((mics.shape[0], 1))], -1) + shift
    rev = room_mod.simulate_batch(
        np.asarray(sources + shift, np.float32), mics3, room, device=device)
    rev = rev + torch.from_numpy(
        rng.normal(0, 0.01, tuple(rev.shape)).astype(np.float32)).to(device)
    return planes, {"anechoic_10db": torch.from_numpy(anechoic).to(device),
                    "reverb_rt60_0.25": rev}


def row(cond: str, method: str, xy: np.ndarray, planes: np.ndarray) -> dict:
    err_cm = 100 * np.linalg.norm(xy - planes, axis=-1)
    return {"condition": cond, "method": method,
            "xy_err_median_cm": float(np.median(err_cm)),
            "xy_err_p90_cm": float(np.percentile(err_cm, 90)),
            "hit_rate_lt_10cm": float((err_cm < 10).mean()),
            "scenes": int(len(planes))}


def points(n_scenes: int, device, methods=tuple(METHODS)):
    """Yield (row, xy [S, 2] numpy, route) a (method, condition)."""
    planes, conds = conditions(n_scenes, device)
    mics = geometry.square_array(0.3)
    for method in methods:
        loc = Localizer.create(mics, PipelineConfig(**METHODS[method]),
                               device=device)
        for cond, frames in conds.items():
            xy = loc(frames)["xy"].cpu().numpy()
            yield row(cond, method, xy, planes), xy, route_of(loc, frames)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenes", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    card = card_fields(dev)
    rows = []
    for r, _, route in points(args.scenes, dev):
        r = {**r, "route": route, **card}
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
