"""Fused GCC kernel: raw frames -> (tapered) correlograms and per-pair peaks.

Counterpart of ``audio_triangulation_tpu.ops.pallas.gcc_kernel``
(``fused_gcc`` / ``fused_gcc_peaks``) in both of its modes on this path:

- the base mode: conditioning, DFT, PHAT, cross-power, lag synthesis and
  the peak stage;
- the spectral-stats mode, taken when ``band_hz='auto'`` or (with peaks)
  ``subsample_method`` is 'phase' or 'hybrid': smoothed periodograms and
  cross-spectra, coherence, the per-event auto band weighting the
  cross-power, and the phase-slope sub-sample TDOA with its hybrid gate;
- the in-kernel SRP mode (:func:`fused_gcc_srp`, the reference's compact
  "Mode B", ``fused_gcc_peaks(..., srp_onehot=...)``): the base mode with
  peaks, then every grid cell scored from the bf16-rounded tapered
  correlograms, the scores [B, G] written out and the first best cell and
  its score per frame.

The base and SRP modes compute the DFT as a split-fp32 product on the
tensor cores (:func:`split_rdft`; ``wgmma`` with the coefficients split once
by :func:`pack_dft_split`) a chunk of ``CHUNK_BINS`` bins at a time;
:func:`gcc_reference` with ``split=True`` repeats that arithmetic.

On a CUDA tensor :func:`fused_gcc` and :func:`fused_gcc_srp` launch
``csrc/gcc_kernel.cu`` or raise; on a CPU tensor they run the plain PyTorch
version of the mode (:func:`gcc_reference`, :func:`gcc_stats_reference`,
:func:`gcc_srp_reference`).  ``launches`` counts base-mode launches,
``stats_launches`` stats-mode launches and ``srp_launches`` SRP-mode
launches.  No mode picks between DFT stages: the base, SRP and pipelined
launches take the ``wgmma`` one fed by TMA, the stats mode the ``mma.sync``
one, and :func:`dft_path_launches` counts the launches so by DFT stage.

Without peaks, where the correlograms of a block's frames would crowd its
tile (fewer than ``128 // M`` frames a block fit, as at 8 mics and 28
pairs), :func:`launch` takes the pair phase instead: one persistent launch
of the same kernel that writes the whitened spectra of full tiles to a
scratch buffer and synthesises each tile of 128 (frame, pair) rows on
split-fp32 ``wgmma`` (:func:`pack_synthesis_split`);
:func:`gcc_reference` with ``split=True, pair_phase=True`` repeats its
arithmetic, and ``pair_launches`` counts it (those launches count in
``launches`` too), as does the span system's ``gcc.route.pairs``.

:func:`fused_gcc_pipelined` is the base mode with peaks as a persistent
kernel that walks the batch tiles itself, each tile's frames staged one
tile ahead (counterpart of ``tools/emit_pipeline_probe.py``'s ``outer`` in
the JAX package); its outputs are bit-equal to :func:`fused_gcc`'s, its
plain version is :func:`gcc_reference`, and ``pipelined_launches`` counts
it.  The ``Localizer`` does not route to it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ...core.config import PipelineConfig
from ...utils import profiling
from .. import mxu_fft, xcorr
from . import _build
from .split_fp32 import split_product, tf32_split

# the SRP mode stages the lag LUT as int16
SRP_MAX_LAGS = 32767

launches = 0
pair_launches = 0
stats_launches = 0
srp_launches = 0
pipelined_launches = 0


def dft_path_launches() -> dict:
    """Launches by the DFT stage they ran: ``wgmma`` (base, SRP and
    pipelined) and ``mma_sync`` (stats)."""
    return {"wgmma": launches + srp_launches + pipelined_launches,
            "mma_sync": stats_launches}


# The split, packed synthesis matrix that the stats mode's synthesis stage
# reads: bins are padded to whole chunks of SPLIT_CHUNK_BINS (the
# large-array kernel stages the same chunks), lags to whole lag blocks of at
# most STATS_LAG_TILES tiles of 8 (``kLagBlock / 8`` of
# ``csrc/gcc_kernel.cu``).
SPLIT_CHUNK_BINS = 16
STATS_LAG_TILES = 16


def split_dims(f: int, l: int, max_tiles: int):
    """(lag tiles a lag block, lag blocks, padded bins) of the packed matrix
    for F bins and L lags with at most ``max_tiles`` lag tiles a block."""
    nt = -(-l // 8)
    ntb = min(nt, max_tiles)
    return ntb, -(-nt // ntb), -(-f // SPLIT_CHUNK_BINS) * SPLIT_CHUNK_BINS


def pack_split_synthesis(sync: torch.Tensor, syns: torch.Tensor,
                         max_tiles: int) -> torch.Tensor:
    """(sync, syns) [F, L] f32 -> the B operand of a tensor-core synthesis,
    split and in mma fragment order: [lag blocks, steps, lag tiles, 32
    lanes, 4] f32, where a step is 8 values of K (the cos rows of 4 bins,
    then their sin rows), a lag tile 8 lags, and lane = 4 g + t holds, for
    lag 8 j + g of the tile, (hi[k = t], hi[k = t + 4], lo[k = t],
    lo[k = t + 4]), each matrix split by :func:`tf32_split`.  Bins are
    padded with zero rows to whole chunks, lags with zero columns to whole
    lag blocks of at most ``max_tiles`` tiles."""
    f, l = sync.shape
    ntb, n_lb, fp = split_dims(f, l, max_tiles)
    lp = n_lb * ntb * 8
    parts = []
    for mat in (sync, syns):
        padded = torch.zeros((fp, lp), dtype=torch.float32,
                             device=sync.device)
        padded[:f, :l] = mat
        parts.append(tf32_split(padded))
    comp = torch.stack([parts[0][0], parts[1][0], parts[0][1], parts[1][1]])
    # (comp, step, t, lag block, j, g) -> (lag block, step, j, g, t, comp)
    comp = comp.reshape(4, fp // 4, 4, n_lb, ntb, 8).permute(3, 1, 4, 5, 2, 0)
    return comp.reshape(n_lb, fp // 4, ntb, 32, 4).contiguous()


def unpack_split_synthesis(packed: torch.Tensor, f: int, l: int):
    """The inverse of :func:`pack_split_synthesis`: (sync hi, syns hi,
    sync lo, syns lo), each [F, L]."""
    n_lb, steps, ntb = packed.shape[:3]
    comp = packed.reshape(n_lb, steps, ntb, 8, 4, 4).permute(5, 1, 4, 0, 2, 3)
    comp = comp.reshape(4, steps * 4, n_lb * ntb * 8)
    return tuple(comp[i, :f, :l] for i in range(4))


DFT_FLUSH_STEPS = 16  # mma steps (of 8 samples) summed before the flush
# steps the base mode's tensor cores sum from zero before the CUDA cores add
# them (``kTcSteps`` of ``csrc/gcc_kernel.cu``); the stats mode sums one
DFT_TC_STEPS = 2
# bins of a chunk of the base and SRP modes (``kChunkBins`` of
# ``csrc/gcc_kernel.cu``): each chunk's spectra are computed, whitened and
# added into the correlograms before the next
CHUNK_BINS = 64


def pack_dft(cos: torch.Tensor, msin: torch.Tensor) -> torch.Tensor:
    """(cos, -sin) [N, F] f32 -> the DFT's B operand in mma fragment order:
    [steps, column tiles, 32 lanes, 2] f32.  A step is 8 samples, a column
    tile 4 bins as (re, im) column pairs; lane = 4 g + t holds, for column
    g of the tile (bin 4 j + g // 2, cos for even g and -sin for odd), the
    coefficients of samples 8 s + t and 8 s + t + 4.  Samples are padded
    with zero rows to whole steps, bins with zero columns to whole tiles.
    The kernel splits the coefficients in registers, so they are stored
    once, unsplit."""
    n, f = cos.shape
    steps, tiles = -(-n // 8), -(-f // 4)
    full = torch.zeros((steps * 8, tiles * 4, 2), dtype=torch.float32,
                       device=cos.device)
    full[:n, :f, 0] = cos
    full[:n, :f, 1] = msin
    # (step, half, t, tile, g) -> (step, tile, g, t, half)
    full = full.reshape(steps, 2, 4, tiles, 8).permute(0, 3, 4, 2, 1)
    return full.reshape(steps, tiles, 32, 2).contiguous()


def unpack_dft(packed: torch.Tensor, n: int, f: int):
    """The inverse of :func:`pack_dft`: (cos, -sin), each [N, F]."""
    steps, tiles = packed.shape[:2]
    full = packed.reshape(steps, tiles, 8, 4, 2).permute(0, 4, 3, 1, 2)
    full = full.reshape(steps * 8, tiles * 4, 2)
    return full[:n, :f, 0], full[:n, :f, 1]


# The base mode's DFT operand (:func:`pack_dft_split`): its columns are the
# wgmma's, CHUNK_COLS a chunk, its K padded to whole ring stages of
# SPLIT_STAGE_SAMPLES samples (``kKStage`` of ``csrc/gcc_kernel.cu``); K slot
# k of a step of 8 samples holds sample 8 s + DFT_SLOT_SAMPLE[k], so that a
# lane's two slots t and t + 4 are the neighbouring samples 2 t and 2 t + 1.
CHUNK_COLS = 2 * CHUNK_BINS
SPLIT_STAGE_SAMPLES = 16
DFT_SLOT_SAMPLE = (0, 2, 4, 6, 1, 3, 5, 7)


def split_shape(n: int, f: int):
    """(columns a part, K) of :func:`pack_dft_split` for N samples, F bins."""
    return (-(-2 * f // CHUNK_COLS) * CHUNK_COLS,
            -(-n // SPLIT_STAGE_SAMPLES) * SPLIT_STAGE_SAMPLES)


def pack_dft_split(cos: torch.Tensor, msin: torch.Tensor) -> torch.Tensor:
    """(cos, -sin) [N, F] f32 -> the base mode's DFT operand [2, C, K] f32:
    the coefficients split once by :func:`tf32_split`, the hi parts then the
    lo parts, K-major (each row one column of the product, K running
    fastest).  Column 2 f of a part is bin f's cos, column 2 f + 1 its -sin;
    C = 2 F padded with zero columns to whole chunks, K = N padded with zero
    samples to whole ring stages (:func:`split_shape`), and the samples of
    each step of 8 in the K slots of ``DFT_SLOT_SAMPLE``."""
    n, f = cos.shape
    c, k = split_shape(n, f)
    full = torch.zeros((k, c), dtype=torch.float32, device=cos.device)
    full[:n, 0:2 * f:2] = cos
    full[:n, 1:2 * f:2] = msin
    slots = torch.tensor(DFT_SLOT_SAMPLE, device=cos.device)
    full = full.reshape(k // 8, 8, c).index_select(1, slots).reshape(k, c)
    hi, lo = tf32_split(full)
    return torch.stack((hi.t(), lo.t())).contiguous()


def unpack_dft_split(packed: torch.Tensor, n: int, f: int):
    """The inverse of :func:`pack_dft_split`: ((cos hi, -sin hi), (cos lo,
    -sin lo)), each [N, F]."""
    k = packed.shape[-1]
    order = torch.tensor(DFT_SLOT_SAMPLE).argsort().to(packed.device)
    parts = []
    for part in packed:
        full = part.t().reshape(k // 8, 8, -1).index_select(1, order)
        full = full.reshape(k, -1)[:n, :2 * f]
        parts.append((full[:, 0::2], full[:, 1::2]))
    return tuple(parts)


def split_rdft(x: torch.Tensor, cos: torch.Tensor, msin: torch.Tensor,
               tc_steps: int = 1):
    """:func:`mxu_fft.rdft` in the arithmetic of the DFT stages of every
    mode, in plain PyTorch, on f32 operands: samples and coefficients split by
    :func:`tf32_split`; each group of ``tc_steps`` steps of 8 samples sums,
    step by step, ``x_lo w_hi``, then ``x_hi w_lo``, then ``x_hi w_hi`` from
    zero (the tensor cores' sum) and is added to one f32 accumulator, which
    is added into the spectrum and cleared every ``DFT_FLUSH_STEPS`` steps.
    (The base mode's ``wgmma`` puts a step's samples in other K slots,
    ``DFT_SLOT_SAMPLE``: the same sums.)"""
    return [split_product(x, w, tc_steps=tc_steps,
                          flush_steps=DFT_FLUSH_STEPS) for w in (cos, msin)]


def chunked_lag_correlogram(rr: torch.Tensor, jj: torch.Tensor,
                            sync: torch.Tensor,
                            syns: torch.Tensor) -> torch.Tensor:
    """:func:`mxu_fft.lag_correlogram` summed ``CHUNK_BINS`` bins at a
    time, the chunks in ascending order, as the base mode adds each bin
    chunk's synthesis into the correlograms it holds."""
    corr = None
    for f0 in range(0, rr.shape[-1], CHUNK_BINS):
        ks = slice(f0, f0 + CHUNK_BINS)
        part = mxu_fft.lag_correlogram(rr[..., ks], jj[..., ks], sync[ks],
                                       syns[ks])
        corr = part if corr is None else corr + part
    return corr


def split_lag_correlogram(rr: torch.Tensor, jj: torch.Tensor,
                          sync: torch.Tensor, syns: torch.Tensor, *,
                          flush_steps: int = 0, tc_steps: int = 0,
                          hi_only: bool = False) -> torch.Tensor:
    """:func:`mxu_fft.lag_correlogram` in the arithmetic of the tensor-core
    synthesis stages, in plain PyTorch: cross-power [..., P, F] and matrices
    [F, L] split by :func:`tf32_split`; every step of 4 bins (8 values of K:
    their rr, then their jj) adds ``a_lo b_hi``, then ``a_hi b_lo``, then
    ``a_hi b_hi`` to one f32 accumulator (``a_hi b_hi`` alone with
    ``hi_only``, for operands that have no low part); with ``tc_steps``
    each group of that many steps is summed from zero first (the tensor
    cores' sum) and then added to the accumulator; with ``flush_steps``
    the accumulator is added into a total and cleared every that many
    steps."""
    f, l = sync.shape
    fp = -(-f // SPLIT_CHUNK_BINS) * SPLIT_CHUNK_BINS
    steps = fp // 4

    def k_steps(c, s):  # two [..., F] -> [..., K]
        pad = (0, fp - f)
        return torch.cat(
            [torch.nn.functional.pad(t.float(), pad).unflatten(-1, (steps, 4))
             for t in (c, s)], dim=-1).flatten(-2)

    # b [K, L] is a view of [L, K], K running fastest
    return split_product(k_steps(rr, jj), k_steps(sync.t(), syns.t()).t(),
                         tc_steps=tc_steps, flush_steps=flush_steps,
                         hi_only=hi_only)


# The pair phase's synthesis operand (:func:`pack_synthesis_split`): lag
# blocks of PAIR_LAG_COLS lags (``kPairCols`` of ``csrc/gcc_kernel.cu``),
# K padded to whole ring stages of PAIR_STAGE_BINS bins; its tensor cores
# sum PAIR_TC_STEPS steps from zero, its registers flush every
# PAIR_FLUSH_STEPS (the DFT's ``kTcSteps`` and ``kFlushSteps``).
PAIR_LAG_COLS = 96
PAIR_STAGE_BINS = 8
PAIR_TC_STEPS = DFT_TC_STEPS
PAIR_FLUSH_STEPS = DFT_FLUSH_STEPS


def pair_bins(f: int) -> int:
    """F padded to whole pair-phase ring stages: the bins of a row of the
    pair phase's spectra and of its synthesis operand's K / 2."""
    return -(-f // PAIR_STAGE_BINS) * PAIR_STAGE_BINS


def pack_synthesis_split(sync: torch.Tensor,
                         syns: torch.Tensor) -> torch.Tensor:
    """(sync, syns) [F, L] f32 -> the pair phase's B operand [2, Lp, K] f32:
    the matrices split once by :func:`tf32_split`, the hi parts then the lo
    parts, K-major (each row one lag).  K slot 8 s + t of step s holds bin
    4 s + t's cos row, slot 8 s + 4 + t its sin row (as
    :func:`split_lag_correlogram` orders K); K = 2 :func:`pair_bins`, Lp =
    L padded to whole lag blocks of PAIR_LAG_COLS, both with zeros."""
    f, l = sync.shape
    fp = pair_bins(f)
    lp = -(-l // PAIR_LAG_COLS) * PAIR_LAG_COLS
    parts = []
    for mat in (sync, syns):
        padded = torch.zeros((fp, lp), dtype=torch.float32, device=sync.device)
        padded[:f, :l] = mat
        parts.append(padded.reshape(fp // 4, 4, lp))
    hi, lo = tf32_split(torch.stack(parts, dim=1).reshape(2 * fp, lp))
    return torch.stack((hi.t(), lo.t())).contiguous()


def unpack_synthesis_split(packed: torch.Tensor, f: int, l: int):
    """The inverse of :func:`pack_synthesis_split`: ((sync hi, syns hi),
    (sync lo, syns lo)), each [F, L]."""
    lp, k = packed.shape[1:]
    out = []
    for part in packed:
        full = part.t().reshape(k // 8, 2, 4, lp)
        out.append(tuple(full[:, i].reshape(k // 2, lp)[:f, :l]
                         for i in range(2)))
    return tuple(out)


class GccMatrices(NamedTuple):
    """The GCC operands fixed by the configuration (f32, one device)."""

    cos: torch.Tensor  # [N, F] DFT, real part
    msin: torch.Tensor  # [N, F] DFT, imaginary part (-sin)
    sync: torch.Tensor  # [F, L] lag synthesis, cos rows
    syns: torch.Tensor  # [F, L] lag synthesis, sin rows
    # the kernel's DFT operand in mma fragment order (:func:`pack_dft`):
    # [N / 8, F / 4, 32, 2], samples and bins padded with zeros
    dft: torch.Tensor
    # sync / syns split and in mma fragment order, for the stats mode's
    # synthesis on the tensor cores (:func:`pack_split_synthesis`); f32 always
    synp: torch.Tensor
    # (cos, -sin) split and K-major for the base mode's wgmma DFT
    # (:func:`pack_dft_split`): [2, C, K], f32 always
    dft_split: torch.Tensor
    # (cos, -sin) of the last bin [N, 2], which the base mode sums apart
    # when F % 4 == 1; f32 always
    dft_tail: torch.Tensor
    # (sync, syns) split and K-major for the pair phase's wgmma synthesis
    # (:func:`pack_synthesis_split`): [2, Lp, K], f32 always
    syn_split: torch.Tensor

    def to(self, dtype: torch.dtype) -> "GccMatrices":
        """The plain versions' matrices in ``dtype``; the kernel's own
        packed operands stay f32."""
        return GccMatrices(*(t.to(dtype) for t in self[:4]), *self[4:])


@functools.lru_cache(maxsize=32)
def _matrices(cfg: PipelineConfig, n: int, device: str) -> GccMatrices:
    cos, msin, sync, syns = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in mxu_fft.gcc_matrices(cfg, n))
    return GccMatrices(cos, msin, sync, syns, pack_dft(cos, msin),
                       pack_split_synthesis(sync, syns, STATS_LAG_TILES),
                       pack_dft_split(cos, msin),
                       torch.stack((cos[:, -1], msin[:, -1]), dim=-1).contiguous(),
                       pack_synthesis_split(sync, syns))


def window_gain(window: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """The window with the shift8 gain folded in (ones when windowing is
    off), the one conditioning vector the kernel applies after removing
    the mean."""
    win = window.float() if cfg.window_enabled else torch.ones_like(
        window, dtype=torch.float32)
    return win * (256.0 if cfg.normalize_mode == "shift8" else 1.0)


def _peaks(corr, max_shift: int, taper_denom: float):
    """The peak stage on raw correlograms: (tapered correlograms, shift,
    parabolic tdoa, peak, psr)."""
    shifts = xcorr.best_lag(corr, max_shift)
    tdoa, peak = xcorr.subsample_peak(corr, max_shift)
    psr = xcorr.peak_confidence(corr, max_shift)
    corr_t = xcorr.peak_taper(corr, max_shift, taper_denom, shifts)
    return corr_t, shifts, tdoa, peak, psr


def gcc_reference(frames, win_gain, mats: GccMatrices, pairs, *,
                  phat: bool, phat_eps: float, max_shift: int,
                  taper_denom: float, with_peaks: bool, split: bool = False,
                  pair_phase: bool = False):
    """Plain PyTorch version of the base mode, on the kernel's operands.

    frames [B, M, N] -> correlograms [B, P, L]; with ``with_peaks`` ->
    (tapered correlograms, best shift int32 [B, P], sub-sample tdoa [B, P]
    in lags, peak value [B, P], psr [B, P]), peaks taken on the raw
    correlogram.  ``split`` repeats the kernel's arithmetic on f32 frames:
    the DFT as a split-fp32 product (:func:`split_rdft`, ``DFT_TC_STEPS``
    steps to a tensor-core sum) and the synthesis added a bin chunk at a time
    (:func:`chunked_lag_correlogram`), or with ``pair_phase`` as the pair
    phase's split-fp32 product (:func:`split_lag_correlogram`,
    ``PAIR_TC_STEPS`` steps to a tensor-core sum, flushed every
    ``PAIR_FLUSH_STEPS``)."""
    split = split and frames.dtype == torch.float32
    x = (frames - frames.mean(dim=-1, keepdim=True)) * win_gain
    if split:
        re, im = split_rdft(x, mats.cos, mats.msin, DFT_TC_STEPS)
    else:
        re, im = mxu_fft.rdft(x, mats.cos, mats.msin)
    rr, jj = mxu_fft.cross_power_reim(re, im, pairs, phat=phat,
                                      phat_eps=phat_eps)
    if split and pair_phase:
        corr = split_lag_correlogram(rr, jj, mats.sync, mats.syns,
                                     flush_steps=PAIR_FLUSH_STEPS,
                                     tc_steps=PAIR_TC_STEPS)
    else:
        synth = chunked_lag_correlogram if split else mxu_fft.lag_correlogram
        corr = synth(rr, jj, mats.sync, mats.syns)
    if not with_peaks:
        return corr
    return _peaks(corr, max_shift, taper_denom)


def srp_first_max(corr_t: torch.Tensor, lut_flat: torch.Tensor):
    """The SRP mode's scoring on tapered correlograms [B, P, L]: (first best
    cell int32 [B], its score [B], every cell's score [B, G]).  Each value
    is rounded to bf16, and the pairs' values at ``lut_flat`` [P, G] are
    added in the order p = 0..P-1 in the correlograms' dtype, as the kernel
    adds them."""
    tap = corr_t.to(torch.bfloat16).to(corr_t.dtype)
    idx = lut_flat.long()
    scores = torch.zeros((corr_t.shape[0], idx.shape[1]),
                         dtype=corr_t.dtype, device=corr_t.device)
    for p in range(idx.shape[0]):
        scores = scores + tap[:, p, :].index_select(-1, idx[p])
    cell = scores.argmax(dim=-1)  # the first maximum
    return (cell.to(torch.int32), scores.gather(-1, cell[:, None])[:, 0],
            scores)


def gcc_srp_reference(frames, win_gain, mats: GccMatrices, pairs, lut_flat,
                      *, phat: bool, phat_eps: float, max_shift: int,
                      taper_denom: float):
    """Plain PyTorch version of the SRP mode, on the kernel's operands:
    :func:`gcc_reference` with peaks, then (cell int32 [B], score [B],
    scores [B, G]) from :func:`srp_first_max`."""
    outs = gcc_reference(frames, win_gain, mats, pairs, phat=phat,
                         phat_eps=phat_eps, max_shift=max_shift,
                         taper_denom=taper_denom, with_peaks=True)
    return (*outs, *srp_first_max(outs[0], lut_flat))


class StatsParams(NamedTuple):
    """The stats mode's settings (see :func:`stats_params`)."""

    band_auto: bool  # weight the cross-power by the per-event auto band
    phase: bool  # phase-slope sub-sample TDOA (needs peaks)
    hybrid: bool  # keep it only where the row's band coherence clears
    hybrid_min: float
    half_width: int  # coherence smoothing, +- bins
    rel: float  # auto band: threshold = max(rel * max, floor)
    floor: float
    min_bins: int  # fewer selected bins fall back to the interior
    lo: int  # without the auto band, bins [lo, hi) weight the phase
    hi: int  # slope and the hybrid gate (Nyquist always out)
    fft_length: int


def _phase(cfg: PipelineConfig, with_peaks: bool) -> bool:
    """Whether the peak stage refines by phase slope (phase / hybrid)."""
    return (with_peaks and cfg.subsample_peak
            and cfg.subsample_method in ("phase", "hybrid"))


def needs_stats(cfg: PipelineConfig, with_peaks: bool = True) -> bool:
    """Whether ``cfg`` takes the stats mode: the per-event auto band, or
    (with the peak stage) a phase-slope / hybrid sub-sample TDOA."""
    return cfg.band_auto or _phase(cfg, with_peaks)


def stats_params(cfg: PipelineConfig, with_peaks: bool):
    """StatsParams when ``cfg`` needs the stats mode, else None.  The mode
    runs on all F = L/2 + 1 bins of an even-length DFT; band-crop and odd
    lengths are routed to the unfused path by the Localizer and refused
    here."""
    if not needs_stats(cfg, with_peaks):
        return None
    phase = _phase(cfg, with_peaks)
    if cfg.band_crop or cfg.fft_length % 2:
        raise ValueError("the GCC kernel's stats mode needs the full band "
                         "of an even fft_length (no band_crop)")
    nyq = cfg.fft_length // 2
    lo, hi = 0, nyq
    if cfg.band_hz is not None and not cfg.band_auto:
        lo, hi = mxu_fft.band_bins(cfg.fft_length, cfg.sample_rate_hz,
                                   *cfg.band_hz)
        hi = min(hi, nyq)
    return StatsParams(
        band_auto=cfg.band_auto, phase=phase,
        hybrid=cfg.subsample_method == "hybrid",
        hybrid_min=cfg.hybrid_coherence_min, half_width=cfg.coherence_bins,
        rel=cfg.auto_band_rel, floor=cfg.auto_band_floor,
        min_bins=cfg.auto_band_min_bins, lo=lo, hi=hi,
        fft_length=cfg.fft_length)


def stats_terms(frames, win_gain, mats: GccMatrices, pairs,
                sp: StatsParams, *, phat_eps: float,
                split: bool = False) -> dict:
    """The stats mode's spectral statistics, in the frames' dtype:
    raw spectra ``re``/``im`` [B, M, F], raw cross-power ``rr``/``jj``
    [B, P, F], coherence ``g2`` [B, P, F], the pair-mean coherence ``g2m``
    and the auto band's threshold ``thr`` [B, 1] (auto band only), and the
    bin weights ``wb`` of the phase slope and the hybrid gate ([B, 1, F] or
    [F]; 0 at Nyquist, which the auto band also always leaves out)."""
    x = (frames - frames.mean(dim=-1, keepdim=True)) * win_gain
    if split:  # the kernel's DFT arithmetic, on f32 operands
        re, im = split_rdft(x, mats.cos, mats.msin)
    else:
        re, im = mxu_fft.rdft(x, mats.cos, mats.msin)
    f = re.shape[-1]
    hw = sp.half_width
    auto_s = xcorr.freq_smooth(re * re + im * im, hw)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ri, ii = re.index_select(-2, i), im.index_select(-2, i)
    rj, ij = re.index_select(-2, j), im.index_select(-2, j)
    rr = ri * rj + ii * ij
    jj = ri * ij - ii * rj
    rr_s, jj_s = xcorr.freq_smooth(rr, hw), xcorr.freq_smooth(jj, hw)
    gaa, gbb = auto_s.index_select(-2, i), auto_s.index_select(-2, j)
    g2 = ((rr_s * rr_s + jj_s * jj_s)
          / (gaa * gbb + phat_eps * phat_eps)).clamp(0.0, 1.0)
    out = dict(re=re, im=im, rr=rr, jj=jj, g2=g2)
    k = torch.arange(f, device=re.device)
    if sp.band_auto:
        # pair-mean coherence over the interior (DC and Nyquist out)
        g2m = g2.mean(dim=-2)
        interior = (k > 0) & (k < f - 1)
        g2i = torch.where(interior, g2m, torch.zeros_like(g2m))
        thr = (sp.rel * g2i.amax(dim=-1, keepdim=True)).clamp_min(sp.floor)
        sel = (g2i >= thr) & (k < f - 1)
        enough = sel.sum(dim=-1, keepdim=True) >= sp.min_bins
        band = torch.where(enough, sel, interior).to(re.dtype)
        out.update(g2m=g2m, thr=thr, band=band, wb=band[..., None, :])
    else:
        out["wb"] = ((k >= sp.lo) & (k < sp.hi)).to(re.dtype)
    return out


def hybrid_coherence(terms: dict) -> torch.Tensor:
    """The hybrid gate's in-band mean coherence per row [B, P]."""
    wb = terms["wb"]
    return ((terms["g2"] * wb).sum(dim=-1)
            / wb.sum(dim=-1).clamp_min(1e-12))


def _phase_slope(terms: dict, shifts, tdoa_par, sp: StatsParams):
    """Phase-slope TDOA [B, P] from the integer peaks: weights |R|^2 g2 wb
    normalised by the row maximum, two Gauss-Newton steps on the wrapped
    phase of the derotated raw cross-power; with ``hybrid`` the parabolic
    ``tdoa_par`` stays where the row's band coherence is under the gate."""
    rr, jj = terms["rr"], terms["jj"]
    k = torch.arange(rr.shape[-1], dtype=rr.dtype, device=rr.device)
    w = (rr * rr + jj * jj) * terms["g2"] * terms["wb"]
    w = w / w.amax(dim=-1, keepdim=True).clamp_min(1e-30)
    den = (w * k * k).sum(dim=-1)
    omega = 2.0 * np.pi / sp.fft_length
    gain_d = -sp.fft_length / (2.0 * np.pi)
    d = shifts.to(rr.dtype)
    for _ in range(2):
        ang = omega * k * d[..., None]
        c, s = torch.cos(ang), torch.sin(ang)
        phi = torch.atan2(rr * s + jj * c, rr * c - jj * s)
        num = (w * k * phi).sum(dim=-1)
        d = d + (gain_d * num / den.clamp_min(1e-20)).clamp(-1.0, 1.0)
    if not sp.hybrid:
        return d
    return torch.where(hybrid_coherence(terms) >= sp.hybrid_min, d,
                       tdoa_par)


def gcc_stats_reference(frames, win_gain, mats: GccMatrices, pairs,
                        sp: StatsParams, *, phat: bool, phat_eps: float,
                        max_shift: int, taper_denom: float, with_peaks: bool,
                        with_band: bool = False, split: bool = False):
    """Plain PyTorch version of the stats mode, on the kernel's operands and
    with the outputs of :func:`gcc_reference`; ``with_band`` appends the
    per-frame auto band weights [B, F] (None without the auto band).
    ``split`` repeats the arithmetic of the kernel's synthesis stage (a
    split-fp32 product, :func:`split_lag_correlogram`) where the plain
    version multiplies in the operands' dtype, and on f32 frames also that
    of its DFT stage (:func:`split_rdft`); float64 frames keep the float64
    DFT and statistics in front of the split synthesis.

    It follows the TPU kernel's stats mode, which the hands-free
    configuration ran on: the raw cross-power is whitened by the product of
    per-mic factors (M >= 3), the auto band's pair mean takes all pairs,
    and Nyquist is out of the phase weights and of the hybrid gate."""
    t = stats_terms(frames, win_gain, mats, pairs, sp, phat_eps=phat_eps,
                    split=split and frames.dtype == torch.float32)
    rr, jj = t["rr"], t["jj"]
    if phat and xcorr.phat_per_mic(frames.shape[-2]):
        inv = torch.rsqrt(t["re"] ** 2 + t["im"] ** 2 + phat_eps * phat_eps)
        invij = (inv.index_select(-2, pairs[:, 0].long())
                 * inv.index_select(-2, pairs[:, 1].long()))
        rr_w, jj_w = rr * invij, jj * invij
    elif phat:
        inv = torch.rsqrt(rr * rr + jj * jj + phat_eps * phat_eps)
        rr_w, jj_w = rr * inv, jj * inv
    else:
        rr_w, jj_w = rr, jj
    if sp.band_auto:
        rr_w, jj_w = rr_w * t["wb"], jj_w * t["wb"]
    if split:
        corr = split_lag_correlogram(rr_w, jj_w, mats.sync, mats.syns)
    else:
        corr = mxu_fft.lag_correlogram(rr_w, jj_w, mats.sync, mats.syns)
    band = (t.get("band"),) if with_band else ()
    if not with_peaks:
        return (corr, *band) if with_band else corr
    corr_t, shifts, tdoa, peak, psr = _peaks(corr, max_shift, taper_denom)
    if sp.phase:
        tdoa = _phase_slope(t, shifts, tdoa, sp)
    return (corr_t, shifts, tdoa, peak, psr, *band)


def operands(frames: torch.Tensor, window: torch.Tensor,
             cfg: PipelineConfig):
    """(win_gain, GccMatrices) for ``frames``' device; the matrices are
    built once per configuration and device."""
    return (window_gain(window.to(frames.device), cfg),
            _matrices(cfg, frames.shape[-1], str(frames.device)))


def fused_gcc(frames: torch.Tensor, window: torch.Tensor,
              pairs: torch.Tensor, cfg: PipelineConfig, *,
              with_peaks: bool):
    """Raw frames [B, M, N] f32 -> correlograms [B, P, L] (conditioning,
    DFT, PHAT per ``cfg``, cross-power, lag synthesis), or with
    ``with_peaks`` the tapered correlograms plus per-pair peaks (see
    :func:`gcc_reference`); in the stats mode when ``cfg`` needs it (see
    :func:`stats_params`)."""
    if frames.ndim != 3 or frames.dtype != torch.float32:
        raise ValueError(f"frames must be f32 [B, M, N]; got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    ops = operands(frames, window, cfg)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, with_peaks=with_peaks)
    sp = stats_params(cfg, with_peaks)
    on_cpu = frames.device.type == "cpu"
    if sp is not None:
        if on_cpu:
            return gcc_stats_reference(frames, *ops, pairs.to(frames.device),
                                       sp, **kw)
        return launch_stats(frames, *ops, pairs, sp, **kw)
    if on_cpu:
        return gcc_reference(frames, *ops, pairs.to(frames.device), **kw)
    return launch(frames, *ops, pairs, **kw)


def fused_gcc_srp(frames: torch.Tensor, window: torch.Tensor,
                  pairs: torch.Tensor, lut_flat: torch.Tensor,
                  cfg: PipelineConfig):
    """:func:`fused_gcc` with peaks in the base mode, plus SRP scoring and
    the grid argmax in the same kernel: (tapered correlograms, shift, tdoa,
    peak, psr, best cell int32 [B], best score [B], scores [B, G]) for the
    lag LUT ``lut_flat`` int32 [P, G].  ``cfg`` must not need the stats
    mode."""
    if frames.ndim != 3 or frames.dtype != torch.float32:
        raise ValueError(f"frames must be f32 [B, M, N]; got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if needs_stats(cfg):
        raise ValueError("the in-kernel SRP mode does not take the stats "
                         "mode (band_hz='auto', phase / hybrid sub-sample)")
    ops = operands(frames, window, cfg)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom)
    if frames.device.type == "cpu":
        return gcc_srp_reference(frames, *ops, pairs.to(frames.device),
                                 lut_flat.to(frames.device), **kw)
    return launch_srp(frames, *ops, pairs, lut_flat, **kw)


def fused_gcc_pipelined(frames: torch.Tensor, window: torch.Tensor,
                        pairs: torch.Tensor, cfg: PipelineConfig):
    """:func:`fused_gcc` with peaks in the base mode through the persistent,
    self-pipelined kernel: (tapered correlograms, shift, tdoa, peak, psr),
    bit-equal to :func:`fused_gcc`'s on the same frames.  ``cfg`` must not
    need the stats mode."""
    if frames.ndim != 3 or frames.dtype != torch.float32:
        raise ValueError(f"frames must be f32 [B, M, N]; got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    if needs_stats(cfg):
        raise ValueError("the pipelined kernel is the base mode only (no "
                         "band_hz='auto', no phase / hybrid sub-sample)")
    ops = operands(frames, window, cfg)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom)
    if frames.device.type == "cpu":
        return gcc_reference(frames, *ops, pairs.to(frames.device), **kw,
                             with_peaks=True)
    return launch_pipelined(frames, *ops, pairs, **kw)


def fits(frames: torch.Tensor, cfg: PipelineConfig, n_pairs: int,
         with_peaks: bool) -> bool:
    """Whether :func:`fused_gcc` takes these frames [B, M, N] of
    ``n_pairs`` pairs in the mode ``cfg`` needs: on a CUDA device one
    frame must fit a block's shared memory (in the base mode 8 mics x 28
    pairs fit up to 1,363 lags); the plain version on the CPU has no
    limit.  The routes ask it from the shape
    (``models.localizer.gcc_routes``), never from a launch error."""
    if frames.device.type != "cuda":
        return True
    m = frames.shape[-2]
    f, l = _matrices(cfg, frames.shape[-1], str(frames.device)).sync.shape
    if needs_stats(cfg, with_peaks):
        return _lib().att_gcc_stats_frames_per_block(m, f, l, n_pairs) >= 1
    return _lib().att_gcc_frames_per_block(m, n_pairs, l) >= 1


def srp_mode_fits(frames: torch.Tensor, cfg: PipelineConfig,
                  n_pairs: int) -> bool:
    """Whether the SRP mode takes these frames [B, M, N]: on a CUDA device
    one frame's correlograms must fit a block's shared memory, and the lag
    axis the LUT's int16 copy; the plain version on the CPU has no limit."""
    if frames.device.type != "cuda":
        return True
    l = mxu_fft.gcc_matrices(cfg, frames.shape[-1])[2].shape[1]
    return (l <= SRP_MAX_LAGS and _lib().att_gcc_frames_per_block(
        frames.shape[-2], n_pairs, l) >= 1)


def _checked(frames, win_gain, mats: GccMatrices, pairs, kernel: str,
             dft: tuple):
    """The launch operands on ``frames``' CUDA device, checked against the
    frames: (dims (b, m, n, f, p, l), frames, [win_gain, sync, syns], pairs
    int32).  Refuses inputs that require grad (``_build.refuse_grad``),
    ``dft`` the mode's DFT operands among them."""
    _build.refuse_grad(kernel, frames, win_gain, mats.sync, mats.syns, *dft)
    if frames.device.type != "cuda":
        raise ValueError(f"the GCC kernel needs CUDA tensors; frames are on "
                         f"{frames.device}")
    b, m, n = frames.shape
    f, l = mats.sync.shape
    p = pairs.shape[0]
    dev = frames.device
    pairs32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
    ins = [t.to(device=dev, dtype=torch.float32).contiguous()
           for t in (win_gain, mats.sync, mats.syns)]
    if ins[0].shape != (n,) or ins[2].shape != (f, l):
        raise ValueError("GCC operand shapes do not match the frames")
    if p < 1 or pairs32.shape != (p, 2) or l % 2 == 0:
        raise ValueError("bad pair list or lag count for the GCC kernel")
    return (b, m, n, f, p, l), frames.contiguous(), ins, pairs32


def _tma_frames(frames: torch.Tensor):
    """(frames, row stride in floats) as the base mode's TMA reads them:
    rows of a multiple of 16 bytes from a 16-byte boundary, the frames
    themselves when they are so, else a copy with zero-padded rows."""
    n = frames.shape[-1]
    if n % 4 == 0 and frames.data_ptr() % 16 == 0:
        return frames, n
    ld = -(-n // 4) * 4
    padded = torch.zeros((*frames.shape[:-1], ld), dtype=frames.dtype,
                         device=frames.device)
    padded[..., :n] = frames
    return padded, ld


def _split_dft(mats: GccMatrices):
    """The base, SRP and pipelined instances' DFT operands."""
    return mats.dft_tail, mats.dft_split


def _split_operands(mats: GccMatrices, n: int, f: int, dev):
    """The base mode's DFT operands on ``dev``, checked: (the last bin's
    coefficients [N, 2], the split matrix [2, C, K])."""
    tail, wk = (t.to(device=dev, dtype=torch.float32).contiguous()
                for t in (mats.dft_tail, mats.dft_split))
    if tail.shape != (n, 2) or wk.shape != (2, *split_shape(n, f)):
        raise ValueError("the split DFT operands do not match the frames")
    return tail, wk


def _outputs(b, p, l, dev, with_peaks):
    corr = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    if not with_peaks:
        return (corr,)
    shift = torch.empty((b, p), dtype=torch.int32, device=dev)
    return (corr, shift, *(torch.empty((b, p), dtype=torch.float32,
                                       device=dev) for _ in range(3)))


# (frame, mic) rows of a block's tile (``kBlockRows`` of
# ``csrc/gcc_kernel.cu``)
BLOCK_ROWS = 128


def takes_pair_phase(m: int, p: int, l: int) -> bool:
    """Whether :func:`launch` without peaks takes the pair phase for frames
    of ``m`` mics and ``p`` pairs x ``l`` lags: where fewer than
    ``BLOCK_ROWS // m`` frames a block fit the fused body beside their
    correlograms, and the pair phase's ring fits.  Asks the kernel library
    (CUDA only)."""
    lib = _lib()
    tb = lib.att_gcc_frames_per_block(m, p, l)
    return 1 <= tb < BLOCK_ROWS // m and bool(lib.att_gcc_pairs_fit(m, p))


def launch(frames, win_gain, mats: GccMatrices, pairs, *, phat: bool,
           phat_eps: float, max_shift: int, taper_denom: float,
           with_peaks: bool):
    """Run ``csrc/gcc_kernel.cu``'s base mode on CUDA tensors (same
    contract as :func:`gcc_reference`); raises on anything it does not
    take.  Without peaks at shapes where the correlograms would crowd the
    tile (:func:`takes_pair_phase`) it takes the pair phase, else the
    fused body.  The pair indices are not range-checked here (that would
    sync with the device): they must index the M mics, as
    ``Localizer.create`` and ``params_from_reference`` ensure."""
    if (not with_peaks and frames.is_cuda and frames.ndim == 3
            and takes_pair_phase(frames.shape[1], pairs.shape[0],
                                 mats.sync.shape[1])):
        return _launch_pairs(frames, win_gain, mats, pairs, phat=phat,
                             phat_eps=phat_eps)
    return _launch_fused(frames, win_gain, mats, pairs, phat=phat,
                         phat_eps=phat_eps, max_shift=max_shift,
                         taper_denom=taper_denom, with_peaks=with_peaks)


def _launch_fused(frames, win_gain, mats: GccMatrices, pairs, *, phat: bool,
                  phat_eps: float, max_shift: int, taper_denom: float,
                  with_peaks: bool):
    """The base mode's fused body (each block's correlograms in its shared
    memory) at any shape it fits, as :func:`launch`."""
    global launches
    (b, m, n, f, p, l), frames, ins, pairs32 = _checked(
        frames, win_gain, mats, pairs, "gcc_kernel", _split_dft(mats))
    lib = _lib()
    if lib.att_gcc_frames_per_block(m, p, l) < 1:
        raise ValueError(f"one frame of {m} mics, {p} pairs x {l} lags does "
                         "not fit the kernel's shared memory")
    tail, wk = _split_operands(mats, n, f, frames.device)
    outs = _outputs(b, p, l, frames.device, with_peaks)
    if b > 0:
        # Temporaries may be freed once launched: the caching allocator
        # reuses memory in the order of the stream the kernel runs on.
        x, ld = _tma_frames(frames)
        ptr = [t.data_ptr() for t in (ins[0], tail, wk, *ins[1:], pairs32)]
        optr = [t.data_ptr() for t in outs] + [None] * (5 - len(outs))
        per_mic = phat and xcorr.phat_per_mic(m)
        with torch.cuda.device(frames.device):
            err = lib.att_gcc(
                x.data_ptr(), ld, *ptr, *optr, b, m, n, f, p, l, int(phat),
                int(per_mic), phat_eps, taper_denom, int(with_peaks),
                torch.cuda.current_stream(frames.device).cuda_stream)
        with _build.count_lock:
            launches += 1
        _build.check(err, "gcc_kernel launch", lib)
    return outs if with_peaks else outs[0]


def _launch_pairs(frames, win_gain, mats: GccMatrices, pairs, *, phat: bool,
                  phat_eps: float):
    """The base mode without peaks through its pair phase, as
    :func:`launch`: the whitened spectra of full tiles go to a scratch
    buffer [B M, pair_bins(F)] complex, then tiles of 128 (frame, pair)
    rows are synthesised against :func:`pack_synthesis_split`'s operand,
    in one launch."""
    global launches, pair_launches
    (b, m, n, f, p, l), frames, ins, pairs32 = _checked(
        frames, win_gain, mats, pairs, "gcc_kernel",
        (*_split_dft(mats), mats.syn_split))
    lib = _lib()
    dev = frames.device
    tail, wk = _split_operands(mats, n, f, dev)
    wsyn = mats.syn_split.to(device=dev, dtype=torch.float32).contiguous()
    fs = pair_bins(f)
    if wsyn.shape != (2, -(-l // PAIR_LAG_COLS) * PAIR_LAG_COLS, 2 * fs):
        raise ValueError("the split synthesis operand does not match the "
                         "frames")
    corr = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    if b > 0:
        x, ld = _tma_frames(frames)
        spectra = torch.empty((b * m, 2 * fs), dtype=torch.float32, device=dev)
        # [0] the next work item, [1 + s] spectra tile s written
        work = torch.zeros(1 + -(-b // (BLOCK_ROWS // m)), dtype=torch.int32,
                           device=dev)
        ptr = [t.data_ptr() for t in (ins[0], tail, wk, wsyn, pairs32, corr,
                                      spectra, work)]
        per_mic = phat and xcorr.phat_per_mic(m)
        with torch.cuda.device(dev):
            err = lib.att_gcc_pairs(
                x.data_ptr(), ld, *ptr, work.numel(), b, m, n, f, p, l,
                int(phat), int(per_mic), phat_eps,
                torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            launches += 1
            pair_launches += 1
        profiling.count("gcc.route.pairs")
        _build.check(err, "gcc_kernel pair-phase launch", lib)
    return corr


def launch_pipelined(frames, win_gain, mats: GccMatrices, pairs, *,
                     phat: bool, phat_eps: float, max_shift: int,
                     taper_denom: float):
    """Run ``csrc/gcc_kernel.cu``'s persistent, self-pipelined instance of
    the base mode with peaks on CUDA tensors (same contract as
    :func:`gcc_reference` with peaks); raises on anything it does not take.
    Its size limit: one frame's correlograms and its staged samples (M
    rows of N floats, a multiple of 16 bytes) must fit a block's shared
    memory."""
    global pipelined_launches
    (b, m, n, f, p, l), frames, ins, pairs32 = _checked(
        frames, win_gain, mats, pairs, "gcc_pipelined_kernel",
        _split_dft(mats))
    lib = _lib()
    if n % 4 or lib.att_gcc_pipelined_frames_per_block(m, n, p, l) < 1:
        raise ValueError(f"one frame of {m} mics x {n} samples, {p} pairs "
                         "does not fit the pipelined kernel's shared memory "
                         "(or its rows are no multiple of 16 bytes)")
    tail, wk = _split_operands(mats, n, f, frames.device)
    outs = _outputs(b, p, l, frames.device, True)
    if b > 0:
        ptr = [t.data_ptr() for t in (frames, ins[0], tail, wk, *ins[1:],
                                      pairs32, *outs)]
        per_mic = phat and xcorr.phat_per_mic(m)
        with torch.cuda.device(frames.device):
            err = lib.att_gcc_pipelined(
                *ptr, b, m, n, f, p, l, int(phat), int(per_mic),
                phat_eps, taper_denom, 1, None,
                torch.cuda.current_stream(frames.device).cuda_stream)
        with _build.count_lock:
            pipelined_launches += 1
        _build.check(err, "gcc_kernel pipelined launch", lib)
    return outs


def launch_srp(frames, win_gain, mats: GccMatrices, pairs, lut_flat, *,
               phat: bool, phat_eps: float, max_shift: int,
               taper_denom: float):
    """Run ``csrc/gcc_kernel.cu``'s SRP mode on CUDA tensors (same contract
    as :func:`gcc_srp_reference`); raises on anything it does not take.
    Its size limit: the correlograms of one frame (P x L floats) must fit a
    block's shared memory, and L at most ``SRP_MAX_LAGS`` (the LUT is staged
    as int16); the grid size G has no limit (the LUT is staged a chunk of
    cells at a time).  LUT entries are clamped to the lag axis, not
    range-checked."""
    global srp_launches
    (b, m, n, f, p, l), frames, ins, pairs32 = _checked(
        frames, win_gain, mats, pairs, "gcc_srp_kernel", _split_dft(mats))
    dev = frames.device
    tail, wk = _split_operands(mats, n, f, dev)
    lut32 = lut_flat.to(device=dev, dtype=torch.int32).contiguous()
    if lut32.ndim != 2 or lut32.shape[0] != p or lut32.shape[1] < 1:
        raise ValueError(f"lut_flat must be [P={p}, G]; got "
                         f"{tuple(lut32.shape)}")
    lib = _lib()
    if l > SRP_MAX_LAGS or lib.att_gcc_frames_per_block(m, p, l) < 1:
        raise ValueError(f"one frame of {m} mics with {p} pairs x {l} lags "
                         "does not fit the SRP mode's shared memory (or "
                         "its int16 LUT)")
    outs = _outputs(b, p, l, dev, True)
    cell = torch.empty((b,), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    scores = torch.empty((b, lut32.shape[1]), dtype=torch.float32,
                         device=dev)
    if b > 0:
        x, ld = _tma_frames(frames)
        ptr = [t.data_ptr() for t in (ins[0], tail, wk, *ins[1:], pairs32,
                                      lut32)]
        optr = [t.data_ptr() for t in (*outs, cell, score, scores)]
        per_mic = phat and xcorr.phat_per_mic(m)
        with torch.cuda.device(dev):
            err = lib.att_gcc_srp(
                x.data_ptr(), ld, *ptr, *optr, b, m, n, f, p, l,
                lut32.shape[1], int(phat),
                int(per_mic), phat_eps, taper_denom,
                torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            srp_launches += 1
        _build.check(err, "gcc_kernel SRP launch", lib)
    return (*outs, cell, score, scores)


def launch_stats(frames, win_gain, mats: GccMatrices, pairs,
                 sp: StatsParams, *, phat: bool, phat_eps: float,
                 max_shift: int, taper_denom: float, with_peaks: bool,
                 with_band: bool = False):
    """Run ``csrc/gcc_kernel.cu``'s stats mode on CUDA tensors (same
    contract as :func:`gcc_stats_reference`); raises on anything it does
    not take, a frame too large for its shared memory included."""
    global stats_launches
    (b, m, n, f, p, l), frames, ins, pairs32 = _checked(
        frames, win_gain, mats, pairs, "gcc_stats_kernel",
        (mats.dft, mats.synp))
    if sp.phase and not with_peaks:
        raise ValueError("the phase-slope TDOA needs the peak stage")
    if f != sp.fft_length // 2 + 1:
        raise ValueError("the stats mode needs all F = L/2 + 1 bins")
    lib = _lib()
    if lib.att_gcc_stats_frames_per_block(m, f, l, p) < 1:
        raise ValueError(f"one frame of {m} mics, {p} pairs x {f} bins does "
                         "not fit the stats mode's shared memory")
    dev = frames.device
    fp = -(-f // 4) * 4  # bins padded to whole column tiles
    dft, synp = (t.to(device=dev, dtype=torch.float32).contiguous()
                 for t in (mats.dft, mats.synp))
    if dft.shape != (-(-n // 8), fp // 4, 32, 2):
        raise ValueError("the packed DFT matrix does not match the frames")
    ntb, n_lb, fpad = split_dims(f, l, STATS_LAG_TILES)
    if synp.shape != (n_lb, fpad // 4, ntb, 32, 4):
        raise ValueError("the packed synthesis matrix does not match the "
                         "operands")
    outs = _outputs(b, p, l, dev, with_peaks)
    band = (torch.empty((b, f), dtype=torch.float32, device=dev)
            if with_band and sp.band_auto else None)
    if b > 0:
        ptr = [t.data_ptr() for t in (frames, ins[0], dft, *ins[1:], synp,
                                      pairs32)]
        optr = [t.data_ptr() for t in outs] + [None] * (5 - len(outs))
        per_mic = phat and xcorr.phat_per_mic(m)
        with torch.cuda.device(dev):
            err = lib.att_gcc_stats(
                *ptr, *optr, None if band is None else band.data_ptr(),
                b, m, n, f, fp, p, l, int(phat), int(per_mic), phat_eps,
                taper_denom, int(with_peaks), int(sp.band_auto),
                int(sp.phase), int(sp.hybrid), sp.half_width, sp.min_bins,
                sp.lo, sp.hi, sp.fft_length, sp.rel, sp.floor, sp.hybrid_min,
                torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            stats_launches += 1
        _build.check(err, "gcc_kernel stats launch", lib)
    extra = (band,) if with_band else ()
    if not with_peaks:
        return (outs[0], *extra) if with_band else outs[0]
    return (*outs, *extra)


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_gcc.argtypes is None:
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.att_gcc.argtypes = ([vp, ci] + [vp] * 11 + [ci] * 8
                                    + [cf, cf, ci, vp])
            lib.att_gcc.restype = ci
            lib.att_gcc_stats.argtypes = ([vp] * 13 + [ci] * 9 + [cf, cf]
                                          + [ci] * 9 + [cf] * 3 + [vp])
            lib.att_gcc_stats.restype = ci
            lib.att_gcc_frames_per_block.argtypes = [ci, ci, ci]
            lib.att_gcc_frames_per_block.restype = ci
            lib.att_gcc_stats_frames_per_block.argtypes = [ci] * 4
            lib.att_gcc_stats_frames_per_block.restype = ci
            lib.att_gcc_srp.argtypes = ([vp, ci] + [vp] * 15 + [ci] * 9
                                        + [cf, cf, vp])
            lib.att_gcc_srp.restype = ci
            lib.att_gcc_pipelined.argtypes = ([vp] * 12 + [ci] * 8
                                              + [cf, cf, ci, vp, vp])
            lib.att_gcc_pipelined.restype = ci
            lib.att_gcc_pipelined_frames_per_block.argtypes = [ci] * 4
            lib.att_gcc_pipelined_frames_per_block.restype = ci
            lib.att_gcc_pairs.argtypes = ([vp, ci] + [vp] * 8 + [ci] * 9
                                          + [cf, vp])
            lib.att_gcc_pairs.restype = ci
            lib.att_gcc_pairs_fit.argtypes = [ci, ci]
            lib.att_gcc_pairs_fit.restype = ci
    return lib
