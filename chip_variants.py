#!/usr/bin/env python3
"""Time variants of six kernels against each other on the GPU.

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
wrong and say so); the GCC kernel's base mode (``gcc_kernel.cu``) on the
16,384 frames of the full-band and band-crop lines and its SRP mode on the
band-crop line, at one block an SM, with bin chunks of 128 (four column
tiles a warp; the outputs stay bit-equal), with the coefficient loads left
to the compiler's placement, and with its DFT cut to the first 32 samples,
its samples loaded for the first chunk only, or its synthesis cut out (DFT,
means and peaks only).  The base mode without peaks (``rowtwo``: row 2 of
the kernel table) runs on the 16,384 frames of each frame-batch estimator
path of ``chip_smoke.py``'s phase 13 as it is, with its DFT cut to the
first 32 samples, with the fused body's synthesis cut out and with the
pair phase cut to its first 16 bins, which splits its time between the
DFT and the lag synthesis at each shape (the pair phase takes the shapes
whose correlograms would crowd a block's tile, the fused body the rest).

    python3 chip_variants.py [srp] [large] [stats] [base] [dft] [scan] [gn]
                             [rowtwo]

(one CUDA card).  The DFT-product kernel's f32 mode (``dft_matmul.cu``)
runs at the tool's 65,536 x 1,024 x 512 with its sums flushed into fp32
registers every 8, 16 (committed) or 32 steps of 8 or once at the end,
each output held to float64; the detector's scan kernel
(``detector_scan.cu``) on the [S, 3, 1,535] window at 1,024 and 4,096
streams with three slots, or with units of 32 blocks.

The GN kernel (``gn``): the Localizer's solver tail on the band-crop
line's 16,384 frames, one call of the GN kernel that writes the covariance
too, against the split tail, the GN kernel as it was before its covariance
epilogue (kept below as ``SOLVE_ONLY_GN_SOURCE``, built into a library of
its own) followed by
``solution_covariance`` in torch: each timed by CUDA events, and its
kernels launched and device time read by torch.profiler, in turns;
``chip_smoke.py`` times the same pair in its phase 5.

With no argument every group runs; else the groups named.

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
# the base and SRP modes: the DFT's time is the committed kernel's less the
# time with the DFT cut short; the synthesis's, less the time without it
BASE_VARIANTS = {
    "as_committed": None,
    "one_block_an_sm": ("gcc_kernel.cu", "__launch_bounds__(kThreads, 2)\ngcc_kernel",
                        "__launch_bounds__(kThreads, 1)\ngcc_kernel"),
    "chunks_of_128_bins": ("gcc_kernel.cu", "constexpr int kWarpTiles = 2;",
                           "constexpr int kWarpTiles = 4;"),
    "timing_only_dft_first_32_samples": (
        "gcc_kernel.cu", "for (int sc = 0; sc < n_samp; ++sc) {",
        "for (int sc = 0; sc < 1; ++sc) {"),
    "coefficient_loads_not_pinned": (
        "gcc_kernel.cu",
        'asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];\\n" : "=f"(v.x), "=f"(v.y) : "l"(p));',
        "v = __ldg(p);"),
    "timing_only_samples_loaded_once": (
        "gcc_kernel.cu", "if (sc + 1 < n_samp) fetch(sc + 1);",
        "if (false) fetch(sc + 1);"),
    "timing_only_no_synthesis": (
        "gcc_kernel.cu", "for (int fb = 0; fb < nbs; fb += kSub) {",
        "for (int fb = 0; fb < 0; fb += kSub) {"),
}
# row 2 (the base mode without peaks) at the estimators' shapes: the whole
# kernel, its DFT cut to the first 32 samples (two ring stages a bin chunk),
# the fused body's synthesis cut out, the pair phase cut to two ring stages
# of 8 bins
ROW_TWO_VARIANTS = {
    "as_committed": None,
    "timing_only_dft_first_32_samples": (
        "gcc_kernel.cu",
        "const int nkb = (N + kKStage - 1) / kKStage;   // ring stages a chunk",
        "const int nkb = 2;"),
    "timing_only_no_synthesis": BASE_VARIANTS["timing_only_no_synthesis"],
    "timing_only_pair_phase_first_2_stages": (
        "gcc_kernel.cu",
        "const int nks = (F + kStageBins - 1) / kStageBins;   // ring stages a lag block",
        "const int nks = 2;"),
}
# the DFT-product kernel's f32 mode: how often the tensor cores' sums go
# into fp32 registers (outputs compared with float64, not with each other)
DFT_VARIANTS = {
    "as_committed": None,
    "flush_every_8_steps": ("dft_matmul.cu", "constexpr int kSpFlushStages = 4; ",
                            "constexpr int kSpFlushStages = 2; "),
    "flush_every_32_steps": ("dft_matmul.cu", "constexpr int kSpFlushStages = 4; ",
                             "constexpr int kSpFlushStages = 8; "),
    "one_flush_at_the_end": ("dft_matmul.cu", "constexpr int kSpFlushStages = 4; ",
                             "constexpr int kSpFlushStages = 1 << 20; "),
}
# the detector's scan kernel: depth of the slot ring, blocks a unit
SCAN_VARIANTS = {
    "as_committed": None,
    "3_stages": ("detector_scan.cu", "constexpr int kStages = 2; ",
                 "constexpr int kStages = 3; "),
    "units_of_32_blocks": ("detector_scan.cu", "constexpr int kChains = 64; ",
                           "constexpr int kChains = 32; "),
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


# The GN kernel before its covariance epilogue: the damped Gauss-Newton
# solve alone, one thread a frame in 256-thread blocks, each mic's terms
# formed once per pair it is in
SOLVE_ONLY_GN_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

struct Lift {
  float sx, sy, sz;               // source point
  float j11, j21, j31, j12, j22, j32;  // d(source) / d(x, y)
};

__device__ __forceinline__ Lift lift(float x, float y, float h, float hh,
                                     int sphere) {
  Lift o;
  if (sphere) {
    const float nv = sqrtf(x * x + y * y + hh);
    const float inv = 1.f / nv;
    const float s = h * inv;
    o.sx = x * s;
    o.sy = y * s;
    o.sz = h * s;
    const float vx = x * inv, vy = y * inv, vz = h * inv;
    o.j11 = s * (1.f - vx * vx);
    o.j21 = s * (-vy * vx);
    o.j31 = s * (-vz * vx);
    o.j12 = s * (-vx * vy);
    o.j22 = s * (1.f - vy * vy);
    o.j32 = s * (-vz * vy);
  } else {
    o.sx = x;
    o.sy = y;
    o.sz = h;
    o.j11 = 1.f; o.j21 = 0.f; o.j31 = 0.f;
    o.j12 = 0.f; o.j22 = 1.f; o.j32 = 0.f;
  }
  return o;
}

// Distance from the source to mic (mx, my, 0) and its gradient in (x, y).
__device__ __forceinline__ void mic_term(const Lift& s, float mx, float my,
                                         float& d, float& g1, float& g2) {
  const float dx = s.sx - mx, dy = s.sy - my, dz = s.sz;
  d = sqrtf(dx * dx + dy * dy + dz * dz);
  const float ud = 1.f / d;
  const float ux = dx * ud, uy = dy * ud, uz = dz * ud;
  g1 = ux * s.j11 + uy * s.j21 + uz * s.j31;
  g2 = ux * s.j12 + uy * s.j22 + uz * s.j32;
}

__global__ void __launch_bounds__(kThreads)
gn_kernel(const float* __restrict__ tau,    // [B, P] seconds
          const float* __restrict__ init,   // [B, 2]
          const float* __restrict__ mics,   // [M, 2]
          const int* __restrict__ pairs,    // [P, 2]
          float* __restrict__ xy_out,       // [B, 2]
          float* __restrict__ rms_out,      // [B]
          int B, int M, int P, float c, float h, float hh, int iters,
          float damping, int sphere) {
  extern __shared__ float smem[];
  float* mic_s = smem;                      // [M, 2]
  int* pair_s = (int*)(smem + 2 * M);       // [P, 2]
  for (int e = threadIdx.x; e < 2 * M; e += blockDim.x) mic_s[e] = mics[e];
  for (int e = threadIdx.x; e < 2 * P; e += blockDim.x) pair_s[e] = pairs[e];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* t = tau + (size_t)b * P;
  float x = init[2 * b], y = init[2 * b + 1];

  for (int it = 0; it < iters; ++it) {
    const Lift s = lift(x, y, h, hh, sphere);
    float a00 = 0.f, a11 = 0.f, a01 = 0.f, b0 = 0.f, b1 = 0.f;
    for (int p = 0; p < P; ++p) {
      const int i = pair_s[2 * p], j = pair_s[2 * p + 1];
      float di, g1i, g2i, dj, g1j, g2j;
      mic_term(s, mic_s[2 * i], mic_s[2 * i + 1], di, g1i, g2i);
      mic_term(s, mic_s[2 * j], mic_s[2 * j + 1], dj, g1j, g2j);
      const float r = dj - di - t[p] * c;
      const float ja = g1j - g1i, jb = g2j - g2i;
      a00 += ja * ja;
      a11 += jb * jb;
      a01 += ja * jb;
      b0 += ja * r;
      b1 += jb * r;
    }
    a00 += damping;
    a11 += damping;
    const float det = a00 * a11 - a01 * a01;
    const float inv_det = 1.f / (fabsf(det) > 1e-20f ? det : 1e-20f);
    const float nx = x - (a11 * b0 - a01 * b1) * inv_det;
    const float ny = y - (a00 * b1 - a01 * b0) * inv_det;
    x = nx;
    y = ny;
  }

  const Lift s = lift(x, y, h, hh, sphere);
  float ss = 0.f;
  for (int p = 0; p < P; ++p) {
    const int i = pair_s[2 * p], j = pair_s[2 * p + 1];
    float di, dj, g1, g2;
    mic_term(s, mic_s[2 * i], mic_s[2 * i + 1], di, g1, g2);
    mic_term(s, mic_s[2 * j], mic_s[2 * j + 1], dj, g1, g2);
    const float r = dj - di - t[p] * c;
    ss += r * r;
  }
  xy_out[2 * b] = x;
  xy_out[2 * b + 1] = y;
  rms_out[b] = sqrtf(ss / (float)P);
}

}  // namespace

extern "C" int att_gn(const void* tau, const void* init, const void* mics,
                      const void* pairs, void* xy_out, void* rms_out, int B,
                      int M, int P, float c, float h, float hh, int iters,
                      float damping, int sphere, void* stream) {
  const size_t smem = (size_t)(2 * M + 2 * P) * sizeof(float);
  const int grid = (B + kThreads - 1) / kThreads;
  gn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)tau, (const float*)init, (const float*)mics,
      (const int*)pairs, (float*)xy_out, (float*)rms_out, B, M, P, c, h, hh,
      iters, damping, sphere);
  return (int)cudaGetLastError();
}
"""


def solve_only_gn_tail(loc):
    """The split solver tail for ``loc`` (a CUDA Localizer on a coplanar
    array), as (solve, tail): ``solve(tau, init) -> (xy, rms)`` is the
    solve-only kernel through its wrapper as it stood (the casts, the device
    context and the mic-z check of every call); ``tail(tau, init) -> (xy,
    rms, cov)`` adds torch's ``solution_covariance``."""
    import ctypes

    import torch
    from audio_triangulation_tpu_torch.ops import solver as solver_ops
    from audio_triangulation_tpu_torch.ops.cuda import _build

    root = _build.BUILD_DIR / "gn_solve_only"  # beside the package's build
    root.mkdir(parents=True, exist_ok=True)
    (root / "gn_solve_only.cu").write_text(SOLVE_ONLY_GN_SOURCE)
    lib_path = root / "libgn_solve_only.so"
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(lib_path), str(root / "gn_solve_only.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.att_gn.argtypes = [vp] * 6 + [ci] * 3 + [cf] * 3 + [ci, cf, ci, vp]
    lib.att_gn.restype = ci
    mics, pairs, cfg = loc.mic_positions, loc.pairs, loc.solver
    c, h = loc.pipeline.speed_of_sound_mps, loc.grid.height_m

    def solve(tau, init):
        if mics.shape[-1] > 2 and bool((mics[:, 2:] != 0).any()):
            raise ValueError("the GN kernel assumes mics at z = 0")
        dev = tau.device
        b, p = tau.shape
        tau32 = tau.to(dtype=torch.float32).contiguous()
        init32 = init.to(device=dev, dtype=torch.float32).contiguous()
        mics2 = mics[:, :2].to(device=dev, dtype=torch.float32).contiguous()
        pairs32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
        xy = torch.empty((b, 2), dtype=torch.float32, device=dev)
        rms = torch.empty((b,), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            err = lib.att_gn(
                tau32.data_ptr(), init32.data_ptr(), mics2.data_ptr(),
                pairs32.data_ptr(), xy.data_ptr(), rms.data_ptr(), b,
                mics.shape[0], p, c, h, h * h, cfg.iterations, cfg.damping,
                int(cfg.constrain_to_sphere),
                torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"solve-only gn_kernel launch: CUDA error {err}")
        return xy, rms

    def tail(tau, init):
        xy, rms = solve(tau, init)
        cov = solver_ops.solution_covariance(xy, rms, mics, pairs, height=h,
                                             cfg=cfg)
        return xy, rms, cov

    return solve, tail


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import chip_smoke
    import dataclasses

    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.models import (
        localizer as localizer_mod)
    from audio_triangulation_tpu_torch.ops.cuda import (
        _build, detector_scan, dft_matmul, gcc_kernel, gcc_large, srp_kernel)
    from audio_triangulation_tpu_torch.tools import int8_microbench

    groups = {"srp": SRP_VARIANTS, "large": LARGE_VARIANTS,
              "stats": STATS_VARIANTS, "base": BASE_VARIANTS,
              "dft": DFT_VARIANTS, "scan": SCAN_VARIANTS,
              "rowtwo": ROW_TWO_VARIANTS}
    asked = sys.argv[1:] or [*groups, "gn"]
    if not set(asked) <= {*groups, "gn"}:
        sys.exit(f"chip_variants: groups are {sorted(groups) + ['gn']}; "
                 f"got {asked}")
    if "gn" in asked:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip(), flush=True)
        time_gn_tails()
        if asked == ["gn"]:
            return
    chosen = {g: groups[g] if g in asked else {} for g in groups}
    srp_variants, large_variants = chosen["srp"], chosen["large"]
    stats_variants, base_variants = chosen["stats"], chosen["base"]
    dft_variants, scan_variants = chosen["dft"], chosen["scan"]
    row_two_variants = chosen["rowtwo"]
    committed = _build.CSRC_DIR
    libs = {}
    with tempfile.TemporaryDirectory() as root:
        for group, variants in chosen.items():
            for name, edit in variants.items():
                key = f"{group}_{name}"
                src = Path(root) / key / "csrc"
                shutil.copytree(committed, src)
                if edit is not None:
                    file, old, new = edit
                    text = (src / file).read_text()
                    if old not in text:
                        raise RuntimeError(f"{key}: {old!r} not in {file}")
                    (src / file).write_text(text.replace(old, new))
                _build.CSRC_DIR = src
                libs[key] = _build.load_library(Path(root) / key / "build")
        _build.CSRC_DIR = committed

        rng = np.random.default_rng(chip_smoke.SEED)
        # the DFT product at the tool's size, and the detector's window
        dft_x, dft_w, _ = int8_microbench.make_inputs(
            "f32", chip_smoke.DFT_ROWS, chip_smoke.DFT_N, chip_smoke.DFT_F,
            chip_smoke.DFT_GRID, "cuda", seed=chip_smoke.SEED)
        dft_w2 = dft_w.flip(0).contiguous()
        dft_s = torch.ones((1,), device="cuda")
        dft_xs = (dft_x + dft_s).double()
        dft_r64 = dft_xs @ dft_w.double() + dft_xs @ dft_w2.double()
        del dft_xs
        windows = {n: torch.from_numpy(rng.integers(
            0, 256, (n, 3, chip_smoke.SCAN_WINDOW)).astype(np.float32)).cuda()
            for n in (chip_smoke.STREAM_COUNTS[0], chip_smoke.STREAM_COUNTS[-1])}
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
        # the base mode's lines, and the SRP mode's
        base_cases = {}
        for bname, bcfg in chip_smoke.main_configs()[:2]:
            bloc = Localizer.create(mics4, bcfg, device="cuda",
                                    init_grid_stride=3)
            base_cases[bname] = (bloc, gcc_kernel.operands(
                frames4, bloc.window, bcfg), dict(
                    phat=bcfg.phat, phat_eps=bcfg.phat_eps,
                    max_shift=bcfg.max_shift, taper_denom=bcfg.taper_denom))
        # row 2 as the estimators launch it, on their frames
        row_two_cases = {}
        for seed, (ename, (make, event, kernels)) in enumerate(
                chip_smoke.estimator_paths().items()):
            if not row_two_variants or not kernels:
                continue
            est = make("cuda")
            ecfg = est.pipeline
            eflat = localizer_mod._flat_frames(chip_smoke.noisy(
                event, chip_smoke.EST_FRAMES, chip_smoke.SEED + 40 + seed),
                ecfg)
            row_two_cases[ename] = (eflat, gcc_kernel.operands(
                eflat, est.window, ecfg), est.pairs, dict(
                    phat=ecfg.phat, phat_eps=ecfg.phat_eps,
                    max_shift=ecfg.max_shift, taper_denom=ecfg.taper_denom))
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
            for name in dft_variants:
                use(libs["dft_" + name])

                def run():
                    return dft_matmul.launch(dft_x, dft_w, dft_w2, dft_s)
                got = run()
                torch.cuda.synchronize()
                print(rnd, "dft_matmul_kernel_f32", name, json.dumps({
                    "ms": round(chip_smoke.cuda_ms(run, chip_smoke.DFT_REPS),
                                4),
                    "err_of_scale_vs_float64": float(
                        (got.double() - dft_r64).abs().max()
                        / dft_r64.abs().max())}), flush=True)
                del got
            for name in scan_variants:
                use(libs["scan_" + name])
                row = {}
                for n_streams, win in windows.items():
                    got = detector_scan.launch(win)
                    torch.cuda.synchronize()
                    ref = first.setdefault(f"scan_{n_streams}", got)
                    row[n_streams] = {
                        "ms": round(chip_smoke.cuda_ms(
                            lambda: detector_scan.launch(win),
                            chip_smoke.REPS), 4),
                        "outputs_equal": all(torch.equal(a, b)
                                             for a, b in zip(ref, got))}
                print(rnd, "detector_scan_kernel", name, json.dumps(row),
                      flush=True)
            for name in srp_variants:
                use(libs["srp_" + name])
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
            for name in large_variants:
                use(libs["large_" + name])
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
            for name in base_variants:
                use(libs["base_" + name])
                row = {}
                for bname, (bloc, bops, bkw) in base_cases.items():
                    runs = {bname: lambda: gcc_kernel.launch(
                        frames4, *bops, bloc.pairs, **bkw, with_peaks=True)}
                    if bloc.pipeline.band_crop:
                        runs[bname + "_srp"] = lambda: gcc_kernel.launch_srp(
                            frames4, *bops, bloc.pairs, bloc.lut_flat, **bkw)
                    for key, run in runs.items():
                        got = run()
                        torch.cuda.synchronize()
                        ref = first.setdefault(key, got)
                        row[key] = {
                            "ms": round(chip_smoke.cuda_ms(run,
                                                           chip_smoke.REPS), 4),
                            "outputs_equal": all(torch.equal(a, b)
                                                 for a, b in zip(ref, got))}
                print(rnd, "gcc_kernel base / SRP mode", name,
                      json.dumps(row), flush=True)
            for name in row_two_variants:
                use(libs["rowtwo_" + name])
                row = {}
                for ename, (eflat, eops, epairs, ekw) in row_two_cases.items():
                    def run():
                        return gcc_kernel.launch(eflat, *eops, epairs, **ekw,
                                                 with_peaks=False)
                    got = run()
                    torch.cuda.synchronize()
                    ref = first.setdefault("rowtwo_" + ename, got)
                    b, m, _ = eflat.shape
                    row[ename] = {
                        "ms": round(chip_smoke.cuda_ms(run,
                                                       chip_smoke.REPS), 4),
                        "frames": b, "mics": m, "pairs": int(epairs.shape[0]),
                        "lags": int(got.shape[-1]),
                        "frames_a_block": gcc_kernel._lib()
                        .att_gcc_frames_per_block(m, int(epairs.shape[0]),
                                                  int(got.shape[-1])),
                        "outputs_equal": bool(torch.equal(ref, got))}
                    del got
                print(rnd, "gcc_kernel row 2", name, json.dumps(row),
                      flush=True)
            for name in stats_variants:
                use(libs["stats_" + name])

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


def time_gn_tails():
    """The ``gn`` group: the solver tail against the split tail, in turns,
    two rounds."""
    import torch

    import chip_smoke
    from audio_triangulation_tpu_torch import Localizer, geometry

    name, cfg = chip_smoke.main_configs()[0]
    loc = Localizer.create(geometry.square_array(0.3), cfg, device="cuda",
                           init_grid_stride=3)
    tau, init = chip_smoke.gn_inputs(loc, chip_smoke.FRAMES)
    _, split = solve_only_gn_tail(loc)
    forms = {"tail": lambda: loc.gn(tau, init),
             "split_tail": lambda: split(tau, init)}
    new, old = forms["tail"](), forms["split_tail"]()
    torch.cuda.synchronize()
    diff = {k: float((a - b).abs().max()) for k, a, b in
            zip(("xy", "rms", "cov"), new, old)}
    for rnd in range(ROUNDS):
        for k in ("split_tail", "tail", "tail", "split_tail"):
            n, dev_ms, _ = chip_smoke.device_kernels(forms[k])
            print(rnd, "gn", name, k, json.dumps({
                "ms": round(chip_smoke.cuda_ms(forms[k], chip_smoke.REPS), 4),
                "launches_a_call": n, "device_ms": round(dev_ms, 4),
                "max_abs_diff_to_split_tail": diff}), flush=True)


if __name__ == "__main__":
    main()
