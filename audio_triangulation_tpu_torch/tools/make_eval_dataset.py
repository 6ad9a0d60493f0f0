"""Generate the labelled evaluation dataset into a directory of the
caller's.

Counterpart of the JAX package's ``tools/make_eval_dataset.py``, which
made the committed ``tests/data/eval/``: the same 20 three-channel WAV
scenes of ``reference_array()`` (five source positions by four
conditions: anechoic at high and low gain, a lightly and a moderately
reverberant 6 x 5 x 3 m shoebox), at the reference's seeds, gains and burst
position (sample 4,000 of 12,000 at 50 kHz), 8-bit ADC counts in 16-bit
WAVs, and ``manifest.json``.  Everything is numpy (``synth_scene``,
``utils.room.simulate``), so the scenes need no device; a regeneration
matches the committed files to within one ADC count.  ``--device`` is
taken as by the other tools (the card by default, and without one the tool
stops with the reason), though nothing here runs on it.

    python -m audio_triangulation_tpu_torch.tools.make_eval_dataset
        --out DIR [--device cuda]

``--out`` is required: the tool never writes over the committed dataset.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..core import geometry
from ..utils import io as audio_io
from ..utils import room as room_mod
from ..utils import synth
from .bench import require_device

FS = 50_000
STREAM_LEN = 12_000
BURST_AT = 4_000
# (x, y) plane labels; the source sits on the 1.2 m sphere through (x, y, 1.2)
POSITIONS = ((0.6, 0.5), (-0.4, 0.7), (0.8, -0.3), (-0.7, -0.6), (0.2, 0.9))
# (kind, burst gain, absorption or None for anechoic, image order)
CONDITIONS = (("anechoic_hi", 110.0, None, 0),
              ("anechoic_lo", 30.0, None, 0),
              ("reverb_light", 90.0, 0.6, 6),
              ("reverb_mod", 90.0, 0.35, 8))
ROOM_SIZE = (6.0, 5.0, 3.0)
ROOM_SHIFT = (3.0, 2.5, 1.0)  # the array's place in the room


def scene_streams(i: int, xy, gain: float, absorption, max_order: int,
                  mics: np.ndarray) -> np.ndarray:
    """Scene ``i``'s [3, 12,000] int16 ADC stream."""
    rng = np.random.default_rng(1000 + i)
    p = np.array([xy[0], xy[1], 1.2])
    src = p * (1.2 / np.linalg.norm(p))
    if absorption is None:
        fr = synth.synth_scene(src, mics, noise_rms=0.0, seed=1000 + i)[0]
    else:
        room = room_mod.ShoeboxRoom(size=ROOM_SIZE, absorption=absorption,
                                    max_order=max_order)
        shift = np.array(ROOM_SHIFT)
        mics3 = np.zeros((mics.shape[0], 3))
        mics3[:, :2] = mics
        # n = the frame: the tail past 20.5 ms wraps circularly
        fr = room_mod.simulate(src + shift, mics3 + shift, room, n=1024,
                               fs=FS, noise_rms=0.0, seed=1000 + i)[0]
        peak = np.max(np.abs(fr)) or 1.0
        fr = fr / peak * 0.9
    # ~128 DC + ~1.5 LSB idle noise + gain * burst
    streams = rng.integers(127, 130, size=(3, STREAM_LEN)).astype(np.float64)
    streams[:, BURST_AT:BURST_AT + 1024] += gain * fr
    return np.clip(np.round(streams), 0, 255).astype(np.int16)


def write_dataset(out_dir: str) -> list:
    """Write the 20 WAVs and ``manifest.json`` into ``out_dir``; returns
    the manifest's entries."""
    mics = geometry.reference_array()
    os.makedirs(out_dir, exist_ok=True)
    entries = []
    i = 0
    for kind, gain, absorption, max_order in CONDITIONS:
        for x, y in POSITIONS:
            wav = f"scene_{i:02d}_{kind}.wav"
            audio_io.write_wav(
                os.path.join(out_dir, wav),
                scene_streams(i, (x, y), gain, absorption, max_order, mics),
                FS)
            entries.append({"wav": wav, "x": x, "y": y, "kind": kind})
            i += 1
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(entries, f, indent=1)
    return entries


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="directory to write the WAVs and manifest.json to")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    require_device(args.device)
    entries = write_dataset(args.out)
    total = sum(os.path.getsize(os.path.join(args.out, e["wav"]))
                for e in entries)
    print(f"wrote {len(entries)} scenes, {total / 1e6:.2f} MB -> {args.out}")
    return entries


if __name__ == "__main__":
    main()
