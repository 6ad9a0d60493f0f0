"""Correlogram peak handling and the static band mask.

Counterpart of the peak subset of ``audio_triangulation_tpu.ops.xcorr``:
first-max argmax, the Gaussian peak taper, 3-point parabolic sub-sample
interpolation and the peak-to-sidelobe ratio.  These are also the plain
versions of the peak stage of the GCC kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.config import PipelineConfig


def phat_per_mic(n_mics: int) -> bool:
    """Whiten per mic iff that touches less data than per pair (M >= 3)."""
    return n_mics >= 3


def band_mask(cfg: PipelineConfig) -> np.ndarray | None:
    """0/1 float32 mask [F] of the rfft bins inside ``cfg.band_hz``, or None
    without a static band."""
    if cfg.band_hz is None or cfg.band_auto:
        return None
    f = cfg.fft_length // 2 + 1
    freqs = np.arange(f) * (cfg.sample_rate_hz / cfg.fft_length)
    lo, hi = cfg.band_hz
    return ((freqs >= lo) & (freqs <= hi)).astype(np.float32)


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
