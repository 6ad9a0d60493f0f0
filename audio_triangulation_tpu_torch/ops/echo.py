"""Per-mic echo detection: band-limited autocorrelation + peak extraction.

Counterpart of ``audio_triangulation_tpu.ops.echo``, the foundation of
reflector mapping (``models.mapping``).  A mic receives
``s(t - t_dir) + a s(t - t_ref)``; its autocorrelation carries a cross term
at lag ``D = t_ref - t_dir``, the per-mic echo delay.  For a broadband
source the compressed source autocorrelation decays within a few samples
of lag 0, so the echo term stands out; restricting the spectrum to the
source band keeps out-of-band noise from flattening the peak.

Plain torch on the frames' device: one rFFT at 2N -> |X|^2 * band mask ->
irFFT, then a fixed number of masked first-max argmax steps with a
parabolic refinement (greedy non-maximum suppression).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from ._device import device_constant, pin_fp32_for


@functools.lru_cache(maxsize=16)
def _band_mask(n_fft: int, fs: float, band) -> np.ndarray:
    f = np.fft.rfftfreq(n_fft, 1.0 / fs)
    mask = f > 0.0  # DC never carries echo information
    if band is not None:
        lo, hi = band
        mask &= (f >= lo) & (f <= hi)
    return mask.astype(np.float32)


def echo_profile(
    frames: torch.Tensor,
    cfg: PipelineConfig,
    *,
    band_hz: tuple | None = None,
) -> torch.Tensor:
    """Normalized band-limited autocorrelation [..., M, N] of frames
    [..., M, N] (r[0] = 1 per channel).

    ``band_hz`` defaults to ``cfg.band_hz`` (full band if unset).  The
    transform is zero-padded to 2N, so the autocorrelation is linear and
    every lag up to N-1 unambiguous."""
    pin_fp32_for(frames)
    n = frames.shape[-1]
    x = frames - frames.mean(dim=-1, keepdim=True)
    spec = torch.fft.rfft(x, n=2 * n, dim=-1).abs() ** 2  # [..., M, F]
    band = band_hz if band_hz is not None else cfg.band_hz
    mask = device_constant(_band_mask(
        2 * n, float(cfg.sample_rate_hz),
        None if band is None else tuple(float(b) for b in band)),
        frames.device, spec.dtype)
    r = torch.fft.irfft(spec * mask, dim=-1)
    r0 = r[..., :1].clamp_min(1e-30)
    return (r / r0)[..., :n]


def top_delays(
    profile: torch.Tensor,
    *,
    q_min: int,
    q_max: int,
    n_echoes: int = 1,
    min_separation: int = 16,
):
    """Top-K autocorrelation peaks per channel with sub-sample refinement.

    profile: [..., N] (normalized autocorrelation; any leading dims).
    Searches lags in [q_min, q_max): q_min excludes the source
    autocorrelation's mainlobe near 0, q_max bounds the echo range.

    Returns (delays [..., K] float32: parabolic sub-sample lags,
    amps [..., K]) strongest first; slots beyond the number of real peaks
    hold whatever residual maxima remain (filter by amp).  Each extracted
    peak suppresses +-``min_separation`` lags; ties take the first lag."""
    n = profile.shape[-1]
    q = torch.arange(n, device=profile.device)
    valid = (q >= q_min) & (q < q_max)
    neg_inf = torch.tensor(float("-inf"), dtype=profile.dtype,
                           device=profile.device)
    p = torch.where(valid, profile, neg_inf)
    delays, amps = [], []
    for _ in range(n_echoes):
        i = torch.argmax(p, dim=-1, keepdim=True)  # [..., 1], first max
        amp = torch.take_along_dim(profile, i, dim=-1)[..., 0]
        # parabolic 3-point refinement on the (unmasked) profile
        ym = torch.take_along_dim(profile, (i - 1).clamp(0, n - 1),
                                  dim=-1)[..., 0]
        yp = torch.take_along_dim(profile, (i + 1).clamp(0, n - 1),
                                  dim=-1)[..., 0]
        denom = ym - 2.0 * amp + yp
        frac = torch.where(denom.abs() > 1e-12, 0.5 * (ym - yp) / denom,
                           torch.zeros_like(denom)).clamp(-0.5, 0.5)
        delays.append(i[..., 0].float() + frac)
        amps.append(amp)
        p = torch.where((q - i).abs() <= min_separation, neg_inf, p)
    return torch.stack(delays, dim=-1), torch.stack(amps, dim=-1)
