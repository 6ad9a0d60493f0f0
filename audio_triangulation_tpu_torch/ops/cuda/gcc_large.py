"""Large-array GCC kernel: whitened spectra -> correlograms of every pair.

Counterpart of ``audio_triangulation_tpu.ops.pallas.gcc_large``
(``xcorr_large`` / ``xcorr_large_peaks``), for arrays with more pairs than
the fused GCC kernel holds (64 mics -> 2,016 pairs).  The spectra are made
once per frame in plain torch (:func:`_prep_spectra`: the DFT as a matmul,
the per-event auto band scaled in as sqrt(w), per-mic PHAT), as the
reference makes them outside its kernel; the kernel computes each pair's
cross-power and its +-K lag synthesis, and with ``with_peaks`` the peak
stage and the taper.

On CUDA tensors :func:`launch` runs ``csrc/gcc_large.cu`` or raises; on CPU
tensors the entry points run :func:`gcc_large_reference`, the plain PyTorch
version.  The kernel multiplies on the tensor cores as a split-fp32 product
(three TF32 products of operands split into a high and a low part; one in
the bf16 mode) against synthesis matrices split and packed once per
configuration (:func:`pack_synthesis`, :func:`packed_synthesis`);
:func:`gcc_large_split_reference` repeats that arithmetic in plain PyTorch.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ...core.config import PipelineConfig
from .. import mxu_fft, xcorr
from . import _build
from .gcc_kernel import SPLIT_CHUNK_BINS, _peaks, split_lag_correlogram
from .srp_kernel import tf32_split

launches = 0

# the packed synthesis matrix's layout, as ``csrc/gcc_large.cu`` reads it
LAG_BLOCK = 152  # lags a lag block: the N of the kernel's wgmma (8 kNT)
CHUNK_BINS = SPLIT_CHUNK_BINS  # bins staged per step (kChunkBins)
TENSOR_MAP_ERROR = -1  # att_gcc_large could not encode its TMA tensor map
FLUSH_STEPS = 64  # steps (of 4 bins) between flushes of the accumulators


def _prep_spectra(frames: torch.Tensor, pairs: torch.Tensor,
                  cfg: PipelineConfig):
    """Conditioned frames [B, M, N] -> (re, im) [B, M, F] f32: forward (or
    band-cropped) spectra, then per-mic PHAT, then the auto band.  The 0/1
    band weight w of ``band_hz='auto'`` is estimated on the raw spectra from
    an evenly strided subset of the pairs and scaled in as sqrt(w), which
    weights every cross-power by w without a band operand in the kernel."""
    crop = mxu_fft.crop_bins(cfg)
    if crop is not None:
        re, im = mxu_fft.forward_spectra_band(frames, cfg.fft_length, *crop)
    else:
        re, im = mxu_fft.forward_spectra(frames, cfg.fft_length)
    w_sqrt = None
    if cfg.band_auto:
        w = xcorr.auto_band_weight_reim(
            re, im, xcorr.band_pair_subset(pairs), cfg)
        w_sqrt = torch.sqrt(w)[..., None, :]
    if cfg.phat:
        re, im = mxu_fft.whiten_reim(re, im, cfg.phat_eps, cfg.phat_beta)
    if w_sqrt is not None:
        re, im = re * w_sqrt, im * w_sqrt
    return re, im


@functools.lru_cache(maxsize=16)
def synthesis(cfg: PipelineConfig, device: str):
    """(sync, syns) [F, L] f32 on ``device`` for ``cfg``: band-cropped rows,
    or all bins with out-of-band rows zeroed; rounded to bf16 (carried as
    f32) under ``matmul_dtype='bfloat16'``."""
    crop = mxu_fft.crop_bins(cfg)
    if crop is not None:
        mats = mxu_fft.lag_synthesis_matrices_band(
            cfg.fft_length, cfg.max_shift, *crop)
    else:
        mats = mxu_fft.masked_synthesis(cfg)
    mats = [torch.as_tensor(a, dtype=torch.float32, device=device)
            for a in mats]
    if cfg.matmul_dtype == "bfloat16":
        mats = [mxu_fft._bf16(a) for a in mats]
    return tuple(mats)


def _packed_dims(f: int, l: int):
    """(lag blocks, padded bins) of the packed matrix for F bins and L
    lags."""
    return (-(-l // LAG_BLOCK),
            -(-f // CHUNK_BINS) * CHUNK_BINS)


def pack_synthesis(sync: torch.Tensor, syns: torch.Tensor) -> torch.Tensor:
    """(sync, syns) [F, L] f32 -> the kernel's B operand, split and K-major:
    [2, lag blocks x 152, K] f32, the hi parts' rows first, then the lo
    parts' (:func:`tf32_split` of each matrix), one row a lag.  Along K a
    step of 8 values is the cos rows of 4 bins, then their sin rows (K = 2 x
    F padded with zero bins to whole chunks of ``CHUNK_BINS``); lags are
    padded with zero rows to whole lag blocks of ``LAG_BLOCK``."""
    f, l = sync.shape
    n_lb, fp = _packed_dims(f, l)
    lp = n_lb * LAG_BLOCK
    both = torch.zeros((2, fp, lp), dtype=torch.float32, device=sync.device)
    both[0, :f, :l] = sync
    both[1, :f, :l] = syns
    # (cos | sin, step, bin of the step, lag) -> (lag, step, cos | sin, bin)
    km = both.reshape(2, fp // 4, 4, lp).permute(3, 1, 0, 2).reshape(lp, 2 * fp)
    return torch.stack(tf32_split(km.contiguous())).contiguous()


def unpack_synthesis(packed: torch.Tensor, f: int, l: int):
    """The inverse of :func:`pack_synthesis`: (sync hi, syns hi, sync lo,
    syns lo), each [F, L]."""
    _, lp, k2 = packed.shape
    parts = packed.reshape(2, lp, k2 // 8, 2, 4).permute(0, 3, 2, 4, 1)
    parts = parts.reshape(2, 2, k2 // 2, lp)[..., :f, :l]
    return parts[0, 0], parts[0, 1], parts[1, 0], parts[1, 1]


@functools.lru_cache(maxsize=16)
def packed_synthesis(cfg: PipelineConfig, device: str) -> torch.Tensor:
    """:func:`pack_synthesis` of :func:`synthesis`, made once per
    configuration and device (under ``matmul_dtype='bfloat16'`` the low
    parts are zero: a bf16 value is a TF32 value)."""
    return pack_synthesis(*synthesis(cfg, device))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(x.dtype)


def gcc_large_reference(re, im, pairs, sync, syns, *, bf16: bool,
                        with_peaks: bool, max_shift: int, taper_denom: float,
                        taper_enabled: bool = True, pair_chunk: int = 64):
    """Plain PyTorch version of the kernel, on its operands and in their
    dtype.  (re, im) [B, M, F] -> correlograms [B, P, L]; with
    ``with_peaks`` -> (correlograms, tapered unless ``taper_enabled`` is
    off, best shift int32 [B, P], sub-sample tdoa [B, P] in lags, peak
    value [B, P], psr [B, P]), peaks taken on the raw correlogram.  The
    pair axis goes ``pair_chunk`` pairs at a time, so the [B, P, F]
    cross-power is never whole in memory; ``bf16`` rounds it as the kernel
    does (the spectra and matrices arrive rounded)."""
    out = []
    for p0 in range(0, pairs.shape[0], pair_chunk):
        rr, jj = mxu_fft.cross_power_reim(re, im, pairs[p0:p0 + pair_chunk])
        if bf16:
            rr, jj = _round_bf16(rr), _round_bf16(jj)
        out.append(torch.matmul(rr, sync) + torch.matmul(jj, syns))
    corr = torch.cat(out, dim=-2)
    if not with_peaks:
        return corr
    corr_t, shifts, tdoa, peak, psr = _peaks(corr, max_shift, taper_denom)
    return (corr_t if taper_enabled else corr), shifts, tdoa, peak, psr


def gcc_large_split_reference(re, im, pairs, sync, syns, *, bf16: bool,
                              with_peaks: bool, max_shift: int,
                              taper_denom: float, taper_enabled: bool = True,
                              pair_chunk: int = 64):
    """Plain PyTorch version that repeats the kernel's arithmetic on f32
    operands (same contract as :func:`gcc_large_reference`): the
    cross-power and the matrices split by :func:`tf32_split`, every step of
    4 bins (8 values of K) adds ``a_lo b_hi``, then ``a_hi b_lo``, then
    ``a_hi b_hi`` to one f32 accumulator (``a_hi b_hi`` alone under
    ``bf16``, whose operands have no low part), and every ``FLUSH_STEPS``
    steps the accumulator is added into the total and cleared."""
    out = []
    for p0 in range(0, pairs.shape[0], pair_chunk):
        rr, jj = mxu_fft.cross_power_reim(re.float(), im.float(),
                                          pairs[p0:p0 + pair_chunk])
        if bf16:
            rr, jj = _round_bf16(rr), _round_bf16(jj)
        out.append(split_lag_correlogram(rr, jj, sync, syns,
                                         flush_steps=FLUSH_STEPS,
                                         hi_only=bf16))
    corr = torch.cat(out, dim=-2)
    if not with_peaks:
        return corr
    corr_t, shifts, tdoa, peak, psr = _peaks(corr, max_shift, taper_denom)
    return (corr_t if taper_enabled else corr), shifts, tdoa, peak, psr


def launch(re, im, pairs, sync, syns, *, packed: torch.Tensor, bf16: bool,
           with_peaks: bool, max_shift: int, taper_denom: float,
           taper_enabled: bool = True):
    """Run ``csrc/gcc_large.cu`` on CUDA tensors (same contract as
    :func:`gcc_large_reference`); raises on anything it does not take.
    ``packed`` is :func:`pack_synthesis` of (sync, syns), the matrices as
    the kernel reads them (:func:`packed_synthesis` keeps one a
    configuration); (sync, syns) themselves give the shapes only.  The pair
    indices are not range-checked here (that would sync with the device):
    they must index the M mics."""
    global launches
    _build.refuse_grad("gcc_large_kernel", re, im, sync, syns, packed)
    if re.device.type != "cuda":
        raise ValueError(f"the large-array GCC kernel needs CUDA tensors; "
                         f"the spectra are on {re.device}")
    if re.ndim != 3 or re.shape != im.shape or re.dtype != torch.float32:
        raise ValueError(f"spectra must be two f32 [B, M, F] tensors; got "
                         f"{tuple(re.shape)} {re.dtype}")
    dev = re.device
    b, m, f = re.shape
    p, l = pairs.shape[0], sync.shape[1]
    if (sync.shape != (f, l) or syns.shape != (f, l) or l != 2 * max_shift + 1
            or p < 1 or pairs.shape != (p, 2)):
        raise ValueError("large-array GCC operand shapes do not match")
    lib = _lib()
    if not lib.att_gcc_large_fits(m, l):
        raise ValueError(f"the staged spectra of {m} mics and a block's rows "
                         f"of {l} lags do not fit the kernel's shared memory")
    re, im = re.contiguous(), im.contiguous()
    pairs32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
    n_lb, fp = _packed_dims(f, l)
    if (packed.shape != (2, n_lb * LAG_BLOCK, 2 * fp) or packed.device != dev
            or packed.dtype != torch.float32 or not packed.is_contiguous()):
        raise ValueError("the packed synthesis matrix does not match the "
                         "operands")
    corr = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    outs = (corr,)
    if with_peaks:
        outs = (corr, torch.empty((b, p), dtype=torch.int32, device=dev),
                *(torch.empty((b, p), dtype=torch.float32, device=dev)
                  for _ in range(3)))
    if b > 0:
        optr = [t.data_ptr() for t in outs] + [None] * (5 - len(outs))
        with torch.cuda.device(dev):
            err = lib.att_gcc_large(
                re.data_ptr(), im.data_ptr(), pairs32.data_ptr(),
                packed.data_ptr(), *optr, b, m, f, p, l,
                int(bf16), int(with_peaks), int(taper_enabled), taper_denom,
                torch.cuda.current_stream(dev).cuda_stream)
        if err == TENSOR_MAP_ERROR:
            raise RuntimeError("gcc_large_kernel: the TMA tensor map of the "
                               "packed synthesis matrix could not be encoded")
        with _build.count_lock:
            launches += 1
        _build.check(err, "gcc_large_kernel launch", lib)
    return outs if with_peaks else outs[0]


def operands(frames: torch.Tensor, pairs: torch.Tensor,
             cfg: PipelineConfig):
    """The kernel's operands for conditioned frames [B, M, N]: (re, im,
    sync, syns, the keyword arguments that :func:`launch`,
    :func:`gcc_large_reference` and :func:`gcc_large_split_reference`
    share)."""
    re, im = _prep_spectra(frames.float(), pairs, cfg)
    bf16 = cfg.matmul_dtype == "bfloat16"
    if bf16:
        re, im = mxu_fft._bf16(re), mxu_fft._bf16(im)
    sync, syns = synthesis(cfg, str(frames.device))
    kw = dict(bf16=bf16, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, taper_enabled=cfg.taper_enabled)
    return re, im, sync, syns, kw


def _run(frames, pairs, cfg: PipelineConfig, chunk: int, with_peaks: bool):
    if frames.ndim != 3:
        raise ValueError(f"frames must be [B, M, N]; got "
                         f"{tuple(frames.shape)}")
    pairs = torch.as_tensor(pairs, device=frames.device)
    re, im, sync, syns, kw = operands(frames, pairs, cfg)
    if frames.device.type == "cpu":
        return gcc_large_reference(re, im, pairs, sync, syns, **kw,
                                   with_peaks=with_peaks, pair_chunk=chunk)
    return launch(re, im, pairs, sync, syns, **kw, with_peaks=with_peaks,
                  packed=packed_synthesis(cfg, str(frames.device)))


def xcorr_large(frames: torch.Tensor, pairs, cfg: PipelineConfig, *,
                tile_b: int = 4, chunk: int = 64) -> torch.Tensor:
    """Correlograms [B, P, 2K+1] of conditioned (windowed) frames
    [B, M, N] for large pair counts.  ``tile_b`` is the reference's batch
    tile and changes nothing here (any B is taken); ``chunk`` is the pair
    chunk of the plain version on the CPU."""
    return _run(frames, pairs, cfg, chunk, False)


def xcorr_large_peaks(frames: torch.Tensor, pairs, cfg: PipelineConfig, *,
                      tile_b: int = 4, chunk: int = 64):
    """:func:`xcorr_large` with the peak stage in the kernel: (tapered
    correlograms [B, P, 2K+1], raw when ``cfg.taper_enabled`` is off; best
    shifts int32 [B, P]; sub-sample TDOAs [B, P] in lags; raw peak values
    [B, P]; psr [B, P]).  The same values as :func:`xcorr_large` followed
    by the plain peak ops."""
    return _run(frames, pairs, cfg, chunk, True)


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_gcc_large.argtypes is None:
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.att_gcc_large.argtypes = [vp] * 9 + [ci] * 8 + [cf, vp]
            lib.att_gcc_large.restype = ci
            lib.att_gcc_large_fits.argtypes = [ci, ci]
            lib.att_gcc_large_fits.restype = ci
    return lib
