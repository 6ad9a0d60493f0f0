"""Pairwise GCC engines, spectral statistics and correlogram peak handling.

Counterpart of ``audio_triangulation_tpu.ops.xcorr``:

- the FFT engine (``rfft_frames``, ``whiten_spectra``, ``cross_power``,
  ``gcc_weight``, ``correlogram_from_cross_power``, ``xcorr_fft``), the
  float time-domain engine (``xcorr_time``) and its bit-exact integer form
  (``xcorr_time_int``);
- the smoothed spectral estimates behind the hands-free configuration:
  ``freq_smooth``, ``smoothed_cross_stats``, the per-event auto band
  (``auto_band_weight``, ``auto_band_weight_reim``) and the phase-slope
  sub-sample TDOA (``tdoa_phase_slope``);
- ``restrict_bins_to_band``, the static band of the frequency-domain and
  subspace estimators;
- the peak ops: first-max argmax, the Gaussian peak taper (and its
  integer form ``peak_taper_int``), 3-point parabolic sub-sample
  interpolation and the peak-to-sidelobe ratio;
- the correlogram EMA, float and integer (``ema_update_int``).

The peak ops are also the plain versions of the GCC kernel's peak stage.
Complex spectra are torch complex tensors (the reference's jnp complex).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from ._device import device_constant


# ----------------------------------------------------------------------
# FFT engine
# ----------------------------------------------------------------------

def rfft_frames(frames: torch.Tensor, fft_length: int) -> torch.Tensor:
    """rFFT of frames [..., N] zero-padded to ``fft_length``."""
    return torch.fft.rfft(frames, n=fft_length, dim=-1)


def whiten_spectra(spectra: torch.Tensor, eps: float = 1e-12,
                   beta: float = 1.0) -> torch.Tensor:
    """Per-mic PHAT whitening U = X (|X|^2 + eps^2)^(-beta/2); ``beta`` < 1
    is partial (PHAT-beta) whitening."""
    mag2 = spectra.real ** 2 + spectra.imag ** 2
    if beta == 1.0:
        return spectra * torch.rsqrt(mag2 + eps * eps)
    return spectra * (mag2 + eps * eps) ** (-0.5 * beta)


def phat_per_mic(n_mics: int) -> bool:
    """Whiten per mic iff that touches less data than per pair (M >= 3)."""
    return n_mics >= 3


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return x.index_select(-2, idx.long())


def cross_power(spectra: torch.Tensor, pairs: torch.Tensor, *,
                phat: bool = False, phat_eps: float = 1e-12,
                phat_beta: float = 1.0) -> torch.Tensor:
    """conj(X_i) X_j per pair: spectra [..., M, F] complex -> [..., P, F],
    optionally PHAT-whitened (per mic for M >= 3, per pair for 2 mics)."""
    per_mic = phat and phat_per_mic(spectra.shape[-2])
    if per_mic:
        spectra = whiten_spectra(spectra, phat_eps, phat_beta)
    r = _take(spectra, pairs[:, 0]).conj() * _take(spectra, pairs[:, 1])
    if phat and not per_mic:
        mag2 = r.real ** 2 + r.imag ** 2
        if phat_beta == 1.0:
            r = r * torch.rsqrt(mag2 + phat_eps * phat_eps)
        else:
            r = r * (mag2 + phat_eps * phat_eps) ** (-0.5 * phat_beta)
    return r


def restrict_bins_to_band(bins: np.ndarray,
                          cfg: PipelineConfig) -> np.ndarray:
    """The rfft bin indices ``bins`` inside ``cfg.band_hz`` (all of them
    without a band).  Raises for ``band_hz='auto'`` (its bins are chosen
    per event) and when the band keeps none of them."""
    if cfg.band_hz is None:
        return bins
    if cfg.band_auto:
        raise ValueError(
            "band_hz='auto' selects bins per event at runtime; the "
            "subspace/frequency-domain estimators need a static bin set — "
            "pass an explicit (lo_hz, hi_hz) band")
    freqs = bins * (cfg.sample_rate_hz / cfg.fft_length)
    lo, hi = cfg.band_hz
    keep = (freqs >= lo) & (freqs <= hi)
    if not keep.any():
        raise ValueError(
            f"band_hz={cfg.band_hz} covers none of the {bins.size} "
            f"candidate bins (stride too coarse or band too narrow)")
    return bins[keep]


def band_mask(cfg: PipelineConfig) -> np.ndarray | None:
    """0/1 float32 mask [F] of the rfft bins inside ``cfg.band_hz``, or None
    without a static band (``'auto'`` included: its mask is per event)."""
    if cfg.band_hz is None or cfg.band_auto:
        return None
    f = cfg.fft_length // 2 + 1
    freqs = np.arange(f) * (cfg.sample_rate_hz / cfg.fft_length)
    lo, hi = cfg.band_hz
    return ((freqs >= lo) & (freqs <= hi)).astype(np.float32)


def correlogram_from_cross_power(r: torch.Tensor, fft_length: int,
                                 max_shift: int) -> torch.Tensor:
    """irFFT the cross-power and keep lags [-K..K] -> [..., 2K+1]."""
    c = torch.fft.irfft(r, n=fft_length, dim=-1)
    return torch.cat([c[..., fft_length - max_shift:], c[..., :max_shift + 1]],
                     dim=-1)


def _counts(f: int, half_width: int) -> np.ndarray:
    """Bins each smoothing window covers (edges counted over all F bins)."""
    return (np.minimum(np.arange(f) + half_width + 1, f)
            - np.maximum(np.arange(f) - half_width, 0))


def freq_smooth(x: torch.Tensor, half_width: int) -> torch.Tensor:
    """Moving average over ``2 * half_width + 1`` bins of the last axis,
    edge bins divided by their actual support.  A direct windowed sum,
    never a difference of running sums: power spectra reach ~1e18 after
    the shift8 gain, where a running-sum difference leaves only rounding
    noise at quiet bins."""
    if half_width <= 0:
        return x
    f = x.shape[-1]
    padded = torch.nn.functional.pad(x, (half_width, half_width))
    total = padded[..., 0:f]
    for o in range(1, 2 * half_width + 1):
        total = total + padded[..., o:o + f]
    return total / torch.as_tensor(_counts(f, half_width), dtype=x.dtype,
                                   device=x.device)


def smoothed_cross_stats(spectra: torch.Tensor, pairs: torch.Tensor,
                         half_width: int, *, r: torch.Tensor | None = None,
                         eps: float = 1e-12):
    """Per-pair (Gaa, Gbb, |Gab_s|^2, gamma^2), each [..., P, F], from
    per-mic spectra [..., M, F]; ``r`` is the raw cross-power when the
    caller has it.  gamma^2 is the magnitude-squared coherence in [0, 1]."""
    auto_s = freq_smooth(spectra.real ** 2 + spectra.imag ** 2, half_width)
    gaa = _take(auto_s, pairs[:, 0])
    gbb = _take(auto_s, pairs[:, 1])
    if r is None:
        r = _take(spectra, pairs[:, 0]).conj() * _take(spectra, pairs[:, 1])
    gab_mag2 = (freq_smooth(r.real, half_width) ** 2
                + freq_smooth(r.imag, half_width) ** 2)
    g2 = (gab_mag2 / (gaa * gbb + eps * eps)).clamp(0.0, 1.0)
    return gaa, gbb, gab_mag2, g2


def auto_band_weight(spectra: torch.Tensor, pairs: torch.Tensor,
                     cfg: PipelineConfig) -> torch.Tensor:
    """Per-event 0/1 band weight [..., F] for ``band_hz='auto'`` from RAW
    spectra [..., M, F]: bins whose pair-mean smoothed coherence clears
    ``max(auto_band_rel * peak, auto_band_floor)``, DC and Nyquist out,
    the whole interior when fewer than ``auto_band_min_bins`` qualify."""
    _, _, _, g2 = smoothed_cross_stats(spectra, pairs, cfg.coherence_bins,
                                       eps=cfg.phat_eps)
    return _auto_band_from_g2(g2.mean(dim=-2), cfg)


def _auto_band_from_g2(g2m: torch.Tensor,
                       cfg: PipelineConfig) -> torch.Tensor:
    """Threshold tail of the auto band: pair-mean coherence [..., F] ->
    0/1 weight [..., F] (see :func:`auto_band_weight`)."""
    f = g2m.shape[-1]
    k = torch.arange(f, device=g2m.device)
    interior = (k > 0) & (k < f - 1)
    g2i = torch.where(interior, g2m, torch.zeros_like(g2m))
    thr = (cfg.auto_band_rel * g2i.amax(dim=-1, keepdim=True)).clamp_min(
        cfg.auto_band_floor)
    sel = g2i >= thr
    enough = sel.sum(dim=-1, keepdim=True) >= cfg.auto_band_min_bins
    return torch.where(enough, sel, interior).to(torch.float32)


@functools.lru_cache(maxsize=16)
def _subset_index(p: int, limit: int) -> np.ndarray:
    return (np.arange(p) if p <= limit else np.unique(
        np.linspace(0, p - 1, limit).round().astype(np.int64)))


def band_pair_subset(pairs, limit: int = 64):
    """The evenly strided subset of ``limit`` pairs that estimates the auto
    band's pair mean on large arrays (all pairs up to ``limit``); numpy in,
    numpy out, tensor in, tensor out."""
    idx = _subset_index(len(pairs), limit)
    if isinstance(pairs, torch.Tensor):
        return pairs[device_constant(idx, pairs.device, torch.int64)]
    return np.asarray(pairs)[idx]


@functools.lru_cache(maxsize=8)
def _smooth_matrix(f: int, half_width: int) -> np.ndarray:
    """Banded [F, F] moving-average matrix: x @ S == freq_smooth(x)."""
    ks = np.arange(f)[:, None]
    fs_ = np.arange(f)[None, :]
    counts = (np.minimum(fs_ + half_width, f - 1)
              - np.maximum(fs_ - half_width, 0) + 1).astype(np.float64)
    return np.where(np.abs(ks - fs_) <= half_width,
                    1.0 / counts, 0.0).astype(np.float32)


def freq_smooth_matmul(x: torch.Tensor, half_width: int) -> torch.Tensor:
    """:func:`freq_smooth` as one fp32 matmul against the banded matrix
    (TF32 off: the estimates feed the auto-band threshold)."""
    if half_width <= 0:
        return x
    s = device_constant(_smooth_matrix(x.shape[-1], half_width), x.device,
                        x.dtype)
    return torch.matmul(x, s)


def auto_band_weight_reim(re: torch.Tensor, im: torch.Tensor,
                          pairs: torch.Tensor,
                          cfg: PipelineConfig) -> torch.Tensor:
    """:func:`auto_band_weight` on split RAW spectra [..., M, F] with the
    smoothing as matmuls.  For F > 1,024 the coherence is estimated on a
    4x decimated bin grid (same span in Hz, minimum bins counted in coarse
    bins) and the weight repeated back, DC and Nyquist out.  Returns
    [..., F]."""
    f = re.shape[-1]
    d = 4 if f > 1024 else 1
    if d > 1:
        re_d, im_d = re[..., ::d], im[..., ::d]
        hw = max(1, cfg.coherence_bins // d)
    else:
        re_d, im_d, hw = re, im, cfg.coherence_bins
    auto_s = freq_smooth_matmul(re_d * re_d + im_d * im_d, hw)
    gaa, gbb = _take(auto_s, pairs[:, 0]), _take(auto_s, pairs[:, 1])
    ri, ii = _take(re_d, pairs[:, 0]), _take(im_d, pairs[:, 0])
    rj, ij = _take(re_d, pairs[:, 1]), _take(im_d, pairs[:, 1])
    rr_s = freq_smooth_matmul(ri * rj + ii * ij, hw)
    jj_s = freq_smooth_matmul(ri * ij - ii * rj, hw)
    eps = cfg.phat_eps
    g2 = ((rr_s * rr_s + jj_s * jj_s) / (gaa * gbb + eps * eps)).clamp(
        0.0, 1.0)
    if d == 1:
        return _auto_band_from_g2(g2.mean(dim=-2), cfg)
    cfg_d = dataclasses.replace(
        cfg, auto_band_min_bins=max(1, cfg.auto_band_min_bins // d))
    w_d = _auto_band_from_g2(g2.mean(dim=-2), cfg_d)
    w = torch.repeat_interleave(w_d, d, dim=-1)[..., :f]
    fine = torch.arange(f, device=re.device)
    return torch.where((fine > 0) & (fine < f - 1), w, torch.zeros_like(w))


def gcc_weight(spectra: torch.Tensor, pairs: torch.Tensor, weighting: str,
               *, half_width: int = 16, eps: float = 1e-12,
               r: torch.Tensor | None = None) -> torch.Tensor:
    """Smoothed GCC frequency weights psi [..., P, F] (Knapp & Carter):
    'roth' 1/Gaa, 'scot' 1/sqrt(Gaa Gbb), 'ml' g2 / (|Gab| (1 - g2))."""
    if weighting in ("roth", "scot"):
        auto_s = freq_smooth(spectra.real ** 2 + spectra.imag ** 2,
                             half_width)
        gaa = _take(auto_s, pairs[:, 0])
        if weighting == "roth":
            return 1.0 / (gaa + eps)
        return torch.rsqrt(gaa * _take(auto_s, pairs[:, 1]) + eps * eps)
    if weighting == "ml":
        _, _, gab_mag2, g2 = smoothed_cross_stats(spectra, pairs, half_width,
                                                  r=r, eps=eps)
        g2 = g2.clamp_max(1.0 - 1e-4)
        return g2 / ((gab_mag2.sqrt() + eps) * (1.0 - g2))
    raise ValueError(f"unknown GCC weighting {weighting!r}")


def xcorr_fft(frames: torch.Tensor, pairs: torch.Tensor,
              cfg: PipelineConfig) -> torch.Tensor:
    """GCC correlograms [..., P, 2K+1] from conditioned frames [..., M, N]
    through the FFT (any weighting, static or auto band)."""
    spectra = rfft_frames(frames, cfg.fft_length)
    weighting = cfg.effective_weighting
    if weighting in ("roth", "scot", "ml"):
        r = cross_power(spectra, pairs)
        r = r * gcc_weight(spectra, pairs, weighting,
                           half_width=cfg.coherence_bins, eps=cfg.phat_eps,
                           r=r)
    else:
        r = cross_power(spectra, pairs, phat=weighting == "phat",
                        phat_eps=cfg.phat_eps, phat_beta=cfg.phat_beta)
    mask = band_mask(cfg)
    if mask is not None:
        r = r * torch.as_tensor(mask, device=r.device)
    elif cfg.band_auto:
        r = r * auto_band_weight(spectra, pairs, cfg)[..., None, :]
    return correlogram_from_cross_power(r, cfg.fft_length, cfg.max_shift)


# ----------------------------------------------------------------------
# Time-domain engine
# ----------------------------------------------------------------------

def _lag_window_indices(n: int, max_shift: int) -> np.ndarray:
    """Gather index matrix [2K+1, N]: row l reads b_padded[l + arange(N)]
    (b padded with K zeros on each side)."""
    lags = np.arange(2 * max_shift + 1)[:, None]
    return (lags + np.arange(n)[None, :]).astype(np.int64)


def xcorr_time(frames: torch.Tensor, pairs: torch.Tensor,
               max_shift: int) -> torch.Tensor:
    """Float time-domain correlation over the overlap [..., P, 2K+1]:
    corr[l] = sum_n a[n] b_pad[n + l]."""
    a, b = _take(frames, pairs[:, 0]), _take(frames, pairs[:, 1])
    bp = torch.nn.functional.pad(b, (max_shift, max_shift))
    idx = torch.as_tensor(_lag_window_indices(frames.shape[-1], max_shift),
                          device=frames.device)
    return torch.einsum("...n,...ln->...l", a, bp[..., idx])


# the integer engine's lag windows [frames, P, 2K+1, N] are formed at most
# this many bytes at a time
XCORR_INT_CHUNK_BYTES = 1 << 30
SMALL_INT_TYPES = (torch.int16, torch.int8, torch.uint8)


def xcorr_time_int(frames: torch.Tensor, pairs: torch.Tensor,
                   max_shift: int) -> torch.Tensor:
    """Bit-exact int64 correlogram [..., P, 2K+1] of integer frames of at
    most 16 bits: corr[l] = sum_n a[n] b_pad[n + l], the firmware's int16
    products summed in int64 (``correlations.c:16``).

    CUDA has no int64 matmul, so the products are summed in float64, which
    is exact here: |x| <= 2^15, so a product is at most 2^30 and a sum of
    N < 2^23 of them less than 2^53; every partial sum is then an integer
    that float64 holds exactly, in any order of additions (FMA included),
    and the CPU and the card agree bit for bit.  The lag windows, 2K+1
    copies of each frame, are formed a chunk of frames at a time of at
    most ``XCORR_INT_CHUNK_BYTES`` (at 16,384 frames of 3 pairs and
    K = 46 they would take 37.5 GB at once)."""
    if frames.dtype not in SMALL_INT_TYPES:
        raise TypeError("xcorr_time_int takes int16 / int8 / uint8 frames "
                        f"(float64 sums are exact for them); got "
                        f"{frames.dtype}")
    n = frames.shape[-1]
    if n >= 1 << 23:
        raise ValueError(f"{n} samples a frame: float64 sums are exact "
                         "below 2^23")
    lead, p = frames.shape[:-2], pairs.shape[0]
    a = _take(frames, pairs[:, 0]).to(torch.float64).reshape(-1, p, n, 1)
    b = _take(frames, pairs[:, 1]).to(torch.float64).reshape(-1, p, n)
    bp = torch.nn.functional.pad(b, (max_shift, max_shift))
    chunk = max(1, XCORR_INT_CHUNK_BYTES // (p * (2 * max_shift + 1) * n * 8))
    out = torch.cat([
        torch.matmul(bp[i: i + chunk].unfold(-1, n, 1), a[i: i + chunk])
        for i in range(0, a.shape[0], chunk)])
    return out[..., 0].to(torch.int64).reshape(*lead, p, 2 * max_shift + 1)


# ----------------------------------------------------------------------
# Peak handling
# ----------------------------------------------------------------------

def best_lag(correlograms: torch.Tensor, max_shift: int) -> torch.Tensor:
    """Integer best shift in [-K, K] per correlogram [..., 2K+1]; the first
    maximum wins."""
    return correlograms.argmax(dim=-1).to(torch.int32) - max_shift


def peak_taper(correlograms: torch.Tensor, max_shift: int,
               denom: float = 36.0,
               shifts: torch.Tensor | None = None) -> torch.Tensor:
    """c[s] *= exp(-(s - s_best)^2 / denom) around the integer peak."""
    if shifts is None:
        shifts = best_lag(correlograms, max_shift)
    lags = torch.arange(-max_shift, max_shift + 1, dtype=correlograms.dtype,
                        device=correlograms.device)
    d = lags - shifts[..., None].to(correlograms.dtype)
    return correlograms * torch.exp(-(d * d) / denom)


@functools.lru_cache(maxsize=16)
def _taper_table(max_shift: int, denom: float) -> np.ndarray:
    """exp(-d^2 / denom) for every d = s - s_best in [-2K, 2K], as the C
    computes it: a float32 argument, a float64 exp, narrowed to float32."""
    diffs = np.arange(-2 * max_shift, 2 * max_shift + 1, dtype=np.int64)
    args = np.float32(-(diffs * diffs)) / np.float32(denom)
    return np.exp(args.astype(np.float64)).astype(np.float32)


def peak_taper_int(correlograms: torch.Tensor, max_shift: int,
                   denom: float = 36.0) -> torch.Tensor:
    """Bit-exact integer taper (``correlations.c:26-33``): each int64 bin
    rounded to float32 (to nearest), times the host-built float32 scale of
    its distance from the first-max lag, truncated back to int64."""
    shifts = best_lag(correlograms, max_shift)
    table = device_constant(_taper_table(max_shift, float(denom)),
                            correlograms.device)
    lags = torch.arange(-max_shift, max_shift + 1,
                        device=correlograms.device)
    scale = table[lags - shifts[..., None] + 2 * max_shift]
    return torch.trunc(correlograms.to(torch.float32) * scale).to(
        torch.int64)


def subsample_peak(correlograms: torch.Tensor, max_shift: int):
    """Parabolic sub-sample peak: (tdoa_samples [...], peak_value [...]).
    Interior peaks only, delta clipped to +-0.5, |den| > 1e-20 guard."""
    n_lags = correlograms.shape[-1]
    c = correlograms
    peak = c.amax(dim=-1)
    p = c.argmax(dim=-1)
    pc = p.clamp(1, n_lags - 2)
    cm = c.gather(-1, (pc - 1)[..., None])[..., 0]
    c0 = c.gather(-1, pc[..., None])[..., 0]
    cp = c.gather(-1, (pc + 1)[..., None])[..., 0]
    den = cm - 2.0 * c0 + cp
    delta = torch.where(den.abs() > 1e-20, 0.5 * (cm - cp) / den,
                        torch.zeros_like(den))
    delta = torch.where((p >= 1) & (p <= n_lags - 2), delta,
                        torch.zeros_like(delta))
    delta = delta.clamp(-0.5, 0.5)
    return (p - max_shift).to(c.dtype) + delta, peak


def tdoa_phase_slope(spectra: torch.Tensor, pairs: torch.Tensor,
                     coarse_lag: torch.Tensor, *, fft_length: int,
                     half_width: int = 16, eps: float = 1e-12,
                     weight_mask=None) -> torch.Tensor:
    """Sub-sample TDOA [..., P] (samples) by coherence-weighted phase-slope
    regression from the integer ``coarse_lag`` [..., P]: two Gauss-Newton
    steps on the wrapped phase of the derotated cross-power, bins weighted
    by |R|^2 gamma^2 (Nyquist out, times ``weight_mask`` when given)."""
    r = _take(spectra, pairs[:, 0]).conj() * _take(spectra, pairs[:, 1])
    f = spectra.shape[-1]
    k = torch.arange(f, dtype=torch.float32, device=spectra.device)
    _, _, _, g2 = smoothed_cross_stats(spectra, pairs, half_width, r=r,
                                       eps=eps)
    w = (r.real ** 2 + r.imag ** 2) * g2
    w = w * (k < (f - 1))
    if weight_mask is not None:
        w = w * torch.as_tensor(weight_mask, device=w.device)
    den = (w * k * k).sum(dim=-1)
    d = coarse_lag.to(torch.float32)
    for _ in range(2):
        ang = (2.0 * np.pi / fft_length) * k * d[..., None]
        rr = r * torch.complex(torch.cos(ang), torch.sin(ang))
        phi = torch.atan2(rr.imag, rr.real)
        num = (w * k * phi).sum(dim=-1)
        delta = -(fft_length / (2.0 * np.pi)) * num / den.clamp_min(eps)
        d = d + delta.clamp(-1.0, 1.0)
    return d


def peak_confidence(correlograms: torch.Tensor, max_shift: int,
                    guard: int = 3) -> torch.Tensor:
    """Peak-to-sidelobe ratio: |peak| / |max outside +-guard of the peak|
    (floor 1e-20)."""
    n_lags = correlograms.shape[-1]
    p = correlograms.argmax(dim=-1)
    peak = correlograms.amax(dim=-1)
    lags = torch.arange(n_lags, device=correlograms.device)
    outside = (lags - p[..., None]).abs() > guard
    side = torch.where(outside, correlograms,
                       torch.full_like(correlograms, -torch.inf)).amax(dim=-1)
    return peak.abs() / side.abs().clamp_min(1e-20)


# ----------------------------------------------------------------------
# Temporal smoothing
# ----------------------------------------------------------------------

def ema_decay(dt_s: torch.Tensor, tau_s: float) -> torch.Tensor:
    """decay = 1 - exp(-dt / tau)."""
    return 1.0 - torch.exp(-dt_s / tau_s)


def ema_update(state: torch.Tensor, new: torch.Tensor,
               decay: torch.Tensor) -> torch.Tensor:
    """state + (new - state) * decay."""
    return state + (new - state) * decay


def ema_update_int(state: torch.Tensor, new: torch.Tensor, dt_s: float,
                   tau_s: float = 0.5) -> torch.Tensor:
    """Bit-exact integer EMA (``correlations.c:45-49``): the float32 delta
    and sum truncated to int64.  The decay is a host float32 built as the C
    builds it: a float32 argument, a float64 exp, narrowed to float32."""
    arg = np.float64(-np.float32(dt_s) / np.float32(tau_s))
    decay = float(np.float32(np.float64(1.0) - np.exp(arg)))
    delta = (new - state).to(torch.float32) * decay
    return torch.trunc(state.to(torch.float32) + delta).to(torch.int64)
