#!/usr/bin/env python3
"""Time variants of three kernels against each other on the GPU.

Each variant is a copy of ``audio_triangulation_tpu_torch/csrc`` with one
line edited, built into its own library; the variants are launched in
turns, twice round, within one process and on one card, and each output is
compared with the unedited kernel's.  The large-array GCC kernel
(``gcc_large.cu``: rows a block, how often the accumulators are flushed)
runs on the operands of the 64-mic full-band and band-crop configurations
of ``chip_smoke.py`` (256 frames) and in the bf16 mode; the SRP-argmax
kernel (``srp_kernel.cu``, ``hopper.cuh``: how a value is rounded to TF32,
stages of the copy ring) on 16,384 random correlograms against the
101 x 101 steering matrix, in f32 and bf16 mode; the GCC kernel's stats
mode (``gcc_kernel.cu``) on the 16,384 frames of the hands-free line, with
the window sums from shared memory, and with one stage at a time cut to a
fraction of its work, which gives that stage's time (those outputs are
wrong and say so).

    python3 chip_variants.py         # one CUDA card

Imports no JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROUNDS = 2
REPS = 5
SRP_REPS = 10
# name -> (file, text in it, its replacement)
LARGE_VARIANTS = {
    "as_committed": None,
    "64_rows_a_block": ("gcc_large.cu", "for (int wg = 3; wg >= 1; wg -= 2)",
                        "for (int wg = 1; wg >= 1; wg -= 2)"),
    "flush_every_128_steps": ("gcc_large.cu",
                              "constexpr int kFlushChunks = 16; ",
                              "constexpr int kFlushChunks = 32; "),
    "one_flush_at_the_end": ("gcc_large.cu",
                             "constexpr int kFlushChunks = 16; ",
                             "constexpr int kFlushChunks = 1 << 20; "),
}
# the stats mode: a stage's time is the committed kernel's less the time
# with that stage cut short
STATS_VARIANTS = {
    "as_committed": None,
    "window_sums_from_shared_memory": (
        "gcc_kernel.cu", "constexpr int kRegHw = 16;",
        "constexpr int kRegHw = 0;"),
    "timing_only_no_window_sums": (
        "gcc_kernel.cu", "const int runs = (F + kRun - 1) / kRun;",
        "const int runs = 1;"),
    "timing_only_dft_first_chunk_of_8": (
        "gcc_kernel.cu", "for (int c = 0; c < n_chunks; ++c) {",
        "for (int c = 0; c < 1; ++c) {"),
    "timing_only_synthesis_first_chunk_of_33": (
        "gcc_kernel.cu",
        "for (int fb = 0; fb < F; fb += kFChunk) {\n"
        "          const float4* src",
        "for (int fb = 0; fb < kFChunk; fb += kFChunk) {\n"
        "          const float4* src"),
    "timing_only_no_phase_steps": (
        "gcc_kernel.cu", "if (st.phase && with_peaks) {",
        "if (false) {"),
}
SRP_VARIANTS = {
    "as_committed": None,
    "round_by_cvt": (
        "hopper.cuh",
        "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
        "  uint32_t r;\n"
        "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : \"f\"(x));\n"
        "  return r;"),
    "2_stages": ("srp_kernel.cu", "constexpr int kStages = 3;",
                 "constexpr int kStages = 2;"),
    "4_stages": ("srp_kernel.cu", "constexpr int kStages = 3;",
                 "constexpr int kStages = 4;"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import chip_smoke
    import dataclasses

    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.ops.cuda import (_build, gcc_kernel,
                                                        gcc_large, srp_kernel)

    committed = _build.CSRC_DIR
    libs = {}
    with tempfile.TemporaryDirectory() as root:
        for name, edit in {**SRP_VARIANTS, **LARGE_VARIANTS,
                           **STATS_VARIANTS}.items():
            src = Path(root) / name / "csrc"
            shutil.copytree(committed, src)
            if edit is not None:
                file, old, new = edit
                text = (src / file).read_text()
                if old not in text:
                    raise RuntimeError(f"{name}: {old!r} not in {file}")
                (src / file).write_text(text.replace(old, new))
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
        for cname, cfg in configs[:2] + [
                ("large64_fullband_bf16", dataclasses.replace(
                    configs[0][1], matmul_dtype="bfloat16"))]:
            loc = Localizer.create(mics, cfg, grid, device="cuda",
                                   init_grid_stride=chip_smoke.LARGE_STRIDE)
            cases[cname] = (loc.pairs, chip_smoke.large_operands(
                frames, loc.window, loc.pairs, cfg))
        # the hands-free line's stats-mode launch
        mics4 = geometry.square_array(0.3)
        frames4 = torch.from_numpy(chip_smoke.scene_frames(
            mics4, chip_smoke.FRAMES, rng,
            fixed_source=(*chip_smoke.SOURCE_XY, 1.2))).cuda()
        sname, scfg = chip_smoke.main_configs()[2]
        sloc = Localizer.create(mics4, scfg, device="cuda",
                                init_grid_stride=3)
        s_ops = gcc_kernel.operands(frames4, sloc.window, scfg)
        s_sp = gcc_kernel.stats_params(scfg, True)
        s_kw = dict(phat=scfg.phat, phat_eps=scfg.phat_eps,
                    max_shift=scfg.max_shift, taper_denom=scfg.taper_denom)
        corr = torch.from_numpy(rng.standard_normal(
            (chip_smoke.FRAMES, 6, 93), dtype=np.float32)).cuda()
        onehot, cells = chip_smoke.srp_inputs(corr)
        flat = corr.reshape(chip_smoke.FRAMES, -1)
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        first = {}

        def use(lib):  # the wrappers take whichever library is loaded
            _build._loaded[str(_build.BUILD_DIR)] = lib

        for rnd in range(ROUNDS):
            for name in SRP_VARIANTS:
                use(libs[name])
                row = {}
                for mode, bf16 in (("f32", False), ("bf16", True)):
                    def run():
                        return srp_kernel.launch(flat, onehot, cells,
                                                 bf16=bf16)
                    got = run()
                    torch.cuda.synchronize()
                    ref = first.setdefault(mode, got)
                    row[mode] = {
                        "ms": round(chip_smoke.cuda_ms(run, SRP_REPS), 4),
                        "outputs_equal": bool(
                            torch.equal(ref[0], got[0])
                            and torch.equal(ref[1], got[1]))}
                print(rnd, "srp_argmax_kernel", name, json.dumps(row),
                      flush=True)
            for name in LARGE_VARIANTS:
                use(libs[name])
                row = {}
                for cname, (pairs, (re, im, sync, syns, kw,
                                    packed)) in cases.items():
                    def run():
                        return gcc_large.launch(re, im, pairs, sync, syns,
                                                **kw, packed=packed,
                                                with_peaks=True)
                    got = run()
                    torch.cuda.synchronize()
                    ref = first.setdefault(cname, got)
                    # a shift that flips on a near tie moves the taper:
                    # compare the rows whose shifts agree, count the others
                    same = ref[1] == got[1]
                    row[cname] = {
                        "ms": round(chip_smoke.cuda_ms(run, REPS), 4),
                        "corr_err_of_scale": float(
                            ((ref[0] - got[0]).abs().amax(dim=-1)
                             * same).max() / ref[0].abs().max()),
                        "rows_with_another_shift": int((~same).sum())}
                print(rnd, "gcc_large_kernel", name, json.dumps(row),
                      flush=True)
            for name in STATS_VARIANTS:
                use(libs[name])

                def run():
                    return gcc_kernel.launch_stats(
                        frames4, *s_ops, sloc.pairs, s_sp, **s_kw,
                        with_peaks=True)
                got = run()
                torch.cuda.synchronize()
                ref = first.setdefault(sname, got)
                print(rnd, "gcc_stats_kernel", name, json.dumps({sname: {
                    "ms": round(chip_smoke.cuda_ms(run, chip_smoke.REPS), 4),
                    "outputs_equal": all(torch.equal(a, b)
                                         for a, b in zip(ref, got))}}),
                      flush=True)


if __name__ == "__main__":
    main()
