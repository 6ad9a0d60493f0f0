"""GCC as matrix products: the DFT and the +-K lag synthesis as matmuls.

Counterpart of ``audio_triangulation_tpu.ops.mxu_fft`` (the unfused
engine, whole or a chunk of the pair axis at a time):

- forward: Re/Im spectra = frames @ cos / frames @ -sin, DFT matrices [N, F]
- the per-event auto band folded into the raw spectra (``band_hz='auto'``)
- cross-power per pair, optionally PHAT(-beta)-whitened (elementwise)
- inverse: correlogram = Re @ synC + Im @ synS, synthesising only the
  2K+1 lags the pipeline reads

The numpy matrix builders are the reference's, so both packages (and the
CUDA kernel, which reads the same matrices) see identical coefficients.
Products run in fp32 (the Localizer turns TF32 off on CUDA); with
``matmul_dtype='bfloat16'`` the operands are rounded to bf16 and the
products summed in fp32, as the reference's bf16 matmuls with f32
accumulation do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from ._device import device_constant


@functools.lru_cache(maxsize=16)
def dft_matrices(n: int, fft_length: int, dtype_str: str = "float32"):
    """Forward real-DFT matrices (cos, -sin) [n, F], F = L/2 + 1; the
    zero padding to ``fft_length`` is implicit."""
    f = fft_length // 2 + 1
    nn = np.arange(n)[:, None]
    ff = np.arange(f)[None, :]
    ang = 2.0 * np.pi * nn * ff / fft_length
    dtype = np.dtype(dtype_str)
    return np.cos(ang).astype(dtype), (-np.sin(ang)).astype(dtype)


@functools.lru_cache(maxsize=16)
def lag_synthesis_matrices(fft_length: int, max_shift: int,
                           dtype_str: str = "float32"):
    """Inverse matrices [F, 2K+1]: corr[s] = (1/L) sum_f w_f Re(R[f]
    e^{+j 2 pi f s / L}) = Re(R) @ C + Im(R) @ S, with the Hermitian
    weights w_f (1 at DC and Nyquist, else 2) folded in."""
    l, k = fft_length, max_shift
    f = l // 2 + 1
    lags = np.arange(-k, k + 1)[None, :]
    ff = np.arange(f)[:, None]
    ang = 2.0 * np.pi * ff * lags / l
    w = np.full((f, 1), 2.0)
    w[0] = 1.0
    if l % 2 == 0:
        w[-1] = 1.0
    c = (w * np.cos(ang)) / l
    s = (-w * np.sin(ang)) / l
    dtype = np.dtype(dtype_str)
    return c.astype(dtype), s.astype(dtype)


@functools.lru_cache(maxsize=16)
def band_bins(fft_length: int, sample_rate_hz: float,
              lo_hz: float, hi_hz: float) -> tuple:
    """(lo_bin, hi_bin) half-open rfft bin range covering [lo_hz, hi_hz]."""
    f = fft_length // 2 + 1
    freqs = np.arange(f) * (sample_rate_hz / fft_length)
    idx = np.nonzero((freqs >= lo_hz) & (freqs <= hi_hz))[0]
    if idx.size == 0:
        raise ValueError(f"band {lo_hz}:{hi_hz} Hz covers no rfft bins")
    return int(idx[0]), int(idx[-1] + 1)


@functools.lru_cache(maxsize=16)
def dft_matrices_band(n: int, fft_length: int, lo_bin: int, hi_bin: int,
                      dtype_str: str = "float32"):
    """Forward DFT matrices restricted to bins [lo_bin, hi_bin): [n, Fb]."""
    cos, msin = dft_matrices(n, fft_length, dtype_str)
    return (np.ascontiguousarray(cos[:, lo_bin:hi_bin]),
            np.ascontiguousarray(msin[:, lo_bin:hi_bin]))


@functools.lru_cache(maxsize=16)
def lag_synthesis_matrices_band(fft_length: int, max_shift: int,
                                lo_bin: int, hi_bin: int,
                                dtype_str: str = "float32"):
    """Lag-synthesis matrices restricted to bins [lo_bin, hi_bin): [Fb, 2K+1]."""
    c, s = lag_synthesis_matrices(fft_length, max_shift, dtype_str)
    return (np.ascontiguousarray(c[lo_bin:hi_bin]),
            np.ascontiguousarray(s[lo_bin:hi_bin]))


def crop_bins(cfg: PipelineConfig):
    """(lo_bin, hi_bin) when the band-crop path applies, else None."""
    if cfg.band_hz is None or not cfg.band_crop:
        return None
    return band_bins(cfg.fft_length, cfg.sample_rate_hz, *cfg.band_hz)


@functools.lru_cache(maxsize=16)
def masked_synthesis(cfg: PipelineConfig, matmul_dtype: str = "float32"):
    """Lag-synthesis matrices with ``cfg.band_hz`` folded in (out-of-band
    rows zeroed)."""
    from . import xcorr

    syn_c, syn_s = lag_synthesis_matrices(
        cfg.fft_length, cfg.max_shift, matmul_dtype)
    mask = xcorr.band_mask(cfg)
    if mask is not None:
        syn_c = syn_c * mask[:, None].astype(syn_c.dtype)
        syn_s = syn_s * mask[:, None].astype(syn_s.dtype)
    return syn_c, syn_s


def gcc_matrices(cfg: PipelineConfig, n: int):
    """(cos, msin, sync, syns) numpy f32 for ``cfg``: band-cropped bins
    when ``band_crop``, else all F = L/2 + 1 bins with out-of-band
    synthesis rows zeroed.  Shared by :func:`xcorr_mxu` and the GCC kernel."""
    crop = crop_bins(cfg)
    if crop is not None:
        cos, msin = dft_matrices_band(n, cfg.fft_length, *crop)
        sync, syns = lag_synthesis_matrices_band(
            cfg.fft_length, cfg.max_shift, *crop)
    else:
        cos, msin = dft_matrices(n, cfg.fft_length)
        sync, syns = masked_synthesis(cfg)
    return cos, msin, sync, syns


# the matmul DFT beats the FFT for short frames; past this the FFT wins
MATMUL_DFT_MAX_N = 4096


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16, carried as fp32 (a bf16 x bf16 torch matmul
    would round its output to bf16 too; the reference's keeps f32)."""
    return x.to(torch.bfloat16).float()


def rdft(frames: torch.Tensor, cos: torch.Tensor, msin: torch.Tensor,
         matmul_dtype: str = "float32"):
    """Real DFT as two matmuls: frames [..., N] -> (re, im) [..., F]."""
    if matmul_dtype == "bfloat16":
        frames, cos, msin = _bf16(frames), _bf16(cos), _bf16(msin)
    x = frames.to(cos.dtype)
    return torch.matmul(x, cos), torch.matmul(x, msin)


def forward_spectra(frames: torch.Tensor, fft_length: int,
                    matmul_dtype: str = "float32"):
    """(re, im) [..., F] via the matmul DFT (or torch.fft past
    ``MATMUL_DFT_MAX_N`` samples)."""
    n = frames.shape[-1]
    if n <= MATMUL_DFT_MAX_N:
        cos, msin = dft_matrices(n, fft_length)
        return rdft(frames, _dev(cos, frames), _dev(msin, frames),
                    matmul_dtype)
    spec = torch.fft.rfft(frames.float(), n=fft_length, dim=-1)
    return spec.real, spec.imag


def forward_spectra_band(frames: torch.Tensor, fft_length: int,
                         lo_bin: int, hi_bin: int,
                         matmul_dtype: str = "float32"):
    """(re, im) [..., Fb] of only the bins [lo_bin, hi_bin)."""
    n = frames.shape[-1]
    if n <= MATMUL_DFT_MAX_N:
        cos, msin = dft_matrices_band(n, fft_length, lo_bin, hi_bin)
        return rdft(frames, _dev(cos, frames), _dev(msin, frames),
                    matmul_dtype)
    spec = torch.fft.rfft(frames.float(), n=fft_length, dim=-1)
    spec = spec[..., lo_bin:hi_bin]
    return spec.real, spec.imag


def whiten_reim(re: torch.Tensor, im: torch.Tensor, eps: float = 1e-12,
                beta: float = 1.0):
    """Per-mic PHAT whitening of (re, im) [..., M, F]: the pair weight
    1/|X_i X_j*| factorizes into per-mic normalization; ``beta`` < 1 is
    partial whitening."""
    mag2 = re * re + im * im + eps * eps
    inv = torch.rsqrt(mag2) if beta == 1.0 else mag2 ** (-0.5 * beta)
    return re * inv, im * inv


def autoband_scale_reim(re: torch.Tensor, im: torch.Tensor,
                        pairs: torch.Tensor, cfg: PipelineConfig):
    """Fold the per-event auto band into RAW spectra [..., M, F] by
    scaling them with sqrt(w): w is 0/1, so the scaling commutes with
    PHAT whitening and the cross-power comes out w-weighted.  The weight
    is estimated in fp32 from :func:`xcorr.band_pair_subset` of the pairs."""
    from . import xcorr

    w = xcorr.auto_band_weight_reim(
        re.float(), im.float(), xcorr.band_pair_subset(pairs), cfg)
    ws = torch.sqrt(w)[..., None, :]
    return re * ws.to(re.dtype), im * ws.to(im.dtype)


def cross_power_reim(re: torch.Tensor, im: torch.Tensor,
                     pairs: torch.Tensor, *, phat: bool = False,
                     phat_eps: float = 1e-12, phat_beta: float = 1.0):
    """conj(X_i) X_j per pair on (re, im) [..., M, F] -> [..., P, F];
    PHAT whitens per mic for M >= 3 and per pair for 2-mic arrays."""
    from . import xcorr

    per_mic = phat and xcorr.phat_per_mic(re.shape[-2])
    if per_mic:
        re, im = whiten_reim(re, im, phat_eps, phat_beta)
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ri, ii = re.index_select(-2, i), im.index_select(-2, i)
    rj, ij = re.index_select(-2, j), im.index_select(-2, j)
    rr = ri * rj + ii * ij
    jj = ri * ij - ii * rj
    if phat and not per_mic:
        mag2 = rr * rr + jj * jj + phat_eps * phat_eps
        inv = (torch.rsqrt(mag2) if phat_beta == 1.0
               else mag2 ** (-0.5 * phat_beta))
        rr = rr * inv
        jj = jj * inv
    return rr, jj


def lag_correlogram(rr: torch.Tensor, jj: torch.Tensor,
                    syn_c: torch.Tensor, syn_s: torch.Tensor,
                    matmul_dtype: str = "float32") -> torch.Tensor:
    """Cross-power (re, im) [..., P, F] -> correlogram [..., P, 2K+1]."""
    if matmul_dtype == "bfloat16":
        rr, jj, syn_c, syn_s = (_bf16(t) for t in (rr, jj, syn_c, syn_s))
    return torch.matmul(rr, syn_c) + torch.matmul(jj, syn_s)


def xcorr_mxu(frames: torch.Tensor, pairs: torch.Tensor,
              cfg: PipelineConfig, *,
              matmul_dtype: str = "float32") -> torch.Tensor:
    """GCC correlograms [..., P, 2K+1] of conditioned frames [..., M, N]
    through the matmul chain (static band folded into the synthesis rows,
    only in-band bins under ``band_crop``, the auto band folded into the
    spectra)."""
    crop = crop_bins(cfg)
    if crop is not None:
        syn_c, syn_s = lag_synthesis_matrices_band(
            cfg.fft_length, cfg.max_shift, *crop)
        re, im = forward_spectra_band(frames, cfg.fft_length, *crop,
                                      matmul_dtype)
    else:
        syn_c, syn_s = masked_synthesis(cfg)
        re, im = forward_spectra(frames, cfg.fft_length, matmul_dtype)
    if cfg.band_auto:
        re, im = autoband_scale_reim(re, im, pairs, cfg)
    rr, jj = cross_power_reim(re, im, pairs, phat=cfg.phat,
                              phat_eps=cfg.phat_eps, phat_beta=cfg.phat_beta)
    return lag_correlogram(rr, jj, _dev(syn_c, frames), _dev(syn_s, frames),
                           matmul_dtype)


def xcorr_mxu_pairblocked(frames: torch.Tensor, pairs: torch.Tensor,
                          cfg: PipelineConfig, *,
                          matmul_dtype: str = "float32",
                          pair_chunk: int = 128) -> torch.Tensor:
    """:func:`xcorr_mxu` for large arrays: the spectra are computed (and
    PHAT-whitened per mic) once, then cross-power and lag synthesis run
    ``pair_chunk`` pairs at a time, so only [..., pair_chunk, F] of the
    cross-power is alive where 2,016 pairs would take tens of GB."""
    crop = crop_bins(cfg)
    if crop is not None:
        syn_c, syn_s = lag_synthesis_matrices_band(
            cfg.fft_length, cfg.max_shift, *crop)
        re, im = forward_spectra_band(frames, cfg.fft_length, *crop,
                                      matmul_dtype)
    else:
        syn_c, syn_s = masked_synthesis(cfg)
        re, im = forward_spectra(frames, cfg.fft_length, matmul_dtype)
    syn_c, syn_s = _dev(syn_c, frames), _dev(syn_s, frames)
    if cfg.band_auto:
        re, im = autoband_scale_reim(re, im, pairs, cfg)
    if cfg.phat:
        re, im = whiten_reim(re, im, cfg.phat_eps, cfg.phat_beta)
    out = []
    for p0 in range(0, pairs.shape[0], pair_chunk):
        rr, jj = cross_power_reim(re, im, pairs[p0:p0 + pair_chunk])
        out.append(lag_correlogram(rr, jj, syn_c, syn_s, matmul_dtype))
    return torch.cat(out, dim=-2)


def _dev(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """One of the cached numpy matrices above as an f32 tensor on ``like``'s
    device, copied there once."""
    return device_constant(arr, like.device)
