#!/usr/bin/env python3
"""Time variants of the large-array GCC kernel against each other on the GPU.

Each variant is a copy of ``audio_triangulation_tpu_torch/csrc`` with one
constant of ``gcc_large.cu`` edited (bins staged per step, blocks per SM),
built into its own library; the variants are launched in turns, twice round,
within one process and on one card, on the operands of the 64-mic full-band
and band-crop configurations of ``chip_smoke.py`` (256 frames), and each
output is compared with the unedited kernel's.

    python3 chip_variants.py         # one CUDA card

Imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
REPS = 5
# name -> (text in gcc_large.cu, its replacement)
VARIANTS = {
    "as_committed": None,
    "8_bins_a_step": ("constexpr int kFChunk = 16; ",
                      "constexpr int kFChunk = 8;  "),
    "32_bins_a_step": ("constexpr int kFChunk = 16; ",
                       "constexpr int kFChunk = 32; "),
    "3_blocks_an_sm": ("__launch_bounds__(kThreads, 2)",
                       "__launch_bounds__(kThreads, 3)"),
    "1_block_an_sm": ("__launch_bounds__(kThreads, 2)",
                      "__launch_bounds__(kThreads, 1)"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import chip_smoke
    from audio_triangulation_tpu_torch import Localizer
    from audio_triangulation_tpu_torch.ops.cuda import _build, gcc_large

    committed = _build.CSRC_DIR
    libs = {}
    with tempfile.TemporaryDirectory() as root:
        for name, edit in VARIANTS.items():
            src = Path(root) / name / "csrc"
            shutil.copytree(committed, src)
            if edit is not None:
                text = (src / "gcc_large.cu").read_text()
                if edit[0] not in text:
                    raise RuntimeError(f"{name}: {edit[0]!r} not in the source")
                (src / "gcc_large.cu").write_text(text.replace(*edit))
            _build.CSRC_DIR = src
            libs[name] = _build.load_library(Path(root) / name / "build")
        _build.CSRC_DIR = committed

        rng = np.random.default_rng(chip_smoke.SEED)
        mics, grid, configs = chip_smoke.large_configs()
        frames = torch.from_numpy(chip_smoke.scene_frames(
            mics, chip_smoke.LARGE_FRAMES, rng,
            fixed_source=(*chip_smoke.SOURCE_XY, 1.2),
            n=chip_smoke.LARGE_SAMPLES)).cuda()
        cases = {}
        for cname, cfg in configs[:2]:
            loc = Localizer.create(mics, cfg, grid, device="cuda",
                                   init_grid_stride=chip_smoke.LARGE_STRIDE)
            cases[cname] = (loc.pairs, chip_smoke.large_operands(
                frames, loc.window, loc.pairs, cfg))
        print(torch.cuda.get_device_name(0), flush=True)
        first = {}
        for rnd in range(ROUNDS):
            for name, lib in libs.items():
                # the wrappers take whichever library is loaded
                _build._loaded[str(_build.BUILD_DIR)] = lib
                row = {}
                for cname, (pairs, (re, im, sync, syns, kw)) in cases.items():
                    def run():
                        return gcc_large.launch(re, im, pairs, sync, syns,
                                                **kw, with_peaks=True)
                    got = run()
                    torch.cuda.synchronize()
                    ref = first.setdefault(cname, got)
                    row[cname] = {
                        "ms": round(chip_smoke.cuda_ms(run, REPS), 4),
                        "corr_err_of_scale": float(
                            (ref[0] - got[0]).abs().max()
                            / ref[0].abs().max()),
                        "shifts_equal": bool(torch.equal(ref[1], got[1]))}
                print(rnd, name, json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
