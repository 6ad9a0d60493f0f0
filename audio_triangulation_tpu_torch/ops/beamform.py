"""Beamformed source-audio extraction: after localization says where, these
ops recover what: an enhanced single-channel waveform of the source at a
given position, from the same multi-mic frames.

Counterpart of ``audio_triangulation_tpu.ops.beamform``; plain torch (the
reference's is plain XLA, no Pallas kernel).  Functions run on the device
of the frames (or positions) they are given.

- :func:`source_delays`: per-mic relative propagation delays for a source
  position under the solver's geometry (``ops.solver.lift_to_model``).
- :func:`extract_das`: delay-and-sum: exact fractional-delay alignment by a
  linear phase on the rFFT at 2N (so the shift is linear, not circular),
  mean over mics.
- :func:`extract_mvdr`: MVDR (Capon) filter-and-sum on the aligned frames:
  the spatial covariance is a moving average of the per-bin outer products
  over ``2 smooth_bins + 1`` bins (frequency smoothing), loaded on its
  diagonal, and w = R^-1 1 / (1^H R^-1 1) is applied per bin.  The average
  is a direct windowed sum of the same terms in the reference's order (a
  cumsum difference would cancel in float32 at quiet bins); the per-bin
  solve is ``ops.linalg.complex_solve``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from ._device import device_constant, irfft, pin_fp32_for


def _mics3(mic_positions, device) -> torch.Tensor:
    """Mics [M, 2 or 3] as float32 [M, 3] on ``device``; a numpy array is
    copied there once (``device_constant``)."""
    if isinstance(mic_positions, torch.Tensor):
        mics = mic_positions.to(device=device, dtype=torch.float32)
    else:
        mics = device_constant(np.asarray(mic_positions, np.float32), device)
    if mics.shape[-1] == 3:
        return mics
    return torch.cat([mics, mics.new_zeros(mics.shape[0],
                                           3 - mics.shape[-1])], dim=-1)


def source_delays(
    pos: torch.Tensor,           # [..., 2 or 3] source position (meters)
    mic_positions,               # [M, 2 or 3] numpy or tensor
    cfg: PipelineConfig,
    *,
    height: float | None = None,
    constrain_sphere: bool = True,
) -> torch.Tensor:
    """Per-mic propagation delays [..., M] (seconds) on ``pos``'s device,
    centred so the mean delay is zero (only relative alignment matters).
    2-D positions are lifted with the solver's geometric model (the
    radius-height sphere by default), so positions from ``Localizer``
    outputs are consistent."""
    from . import solver as solver_ops

    pos = torch.as_tensor(pos, dtype=torch.float32)
    if pos.shape[-1] == 2:
        h = 1.2 if height is None else float(height)
        pos = solver_ops.lift_to_model(pos, h, constrain_sphere)
    mic3 = _mics3(mic_positions, pos.device)
    d = torch.linalg.vector_norm(pos[..., None, :] - mic3, dim=-1)  # [..., M]
    d = d - d.mean(dim=-1, keepdim=True)
    return d / cfg.speed_of_sound_mps


@functools.lru_cache(maxsize=16)
def _bin_hz(n_bins: int, hz_per_bin: float) -> np.ndarray:
    return np.arange(n_bins, dtype=np.float32) * np.float32(hz_per_bin)


def _aligned_spectra(frames, delays, cfg):
    """rFFT at 2N (linear shift) with per-mic advance e^{+j 2 pi f tau}."""
    pin_fp32_for(frames)
    n = frames.shape[-1]
    l2 = 2 * n
    spec = torch.fft.rfft(frames.float(), n=l2, dim=-1)
    f_hz = device_constant(
        _bin_hz(spec.shape[-1], cfg.sample_rate_hz / l2), frames.device)
    # x_m(t) = s(t - tau_m)  =>  align with e^{+j 2 pi f tau_m}
    theta = (2.0 * np.pi) * f_hz * delays.to(frames.device)[..., None]
    return spec * torch.polar(torch.ones_like(theta), theta), l2


def extract_das(
    frames: torch.Tensor,   # [..., M, N]
    delays: torch.Tensor,   # [..., M] seconds (from source_delays)
    cfg: PipelineConfig,
) -> torch.Tensor:
    """Delay-and-sum extraction -> [..., N] enhanced waveform."""
    n = frames.shape[-1]
    aligned, l2 = _aligned_spectra(frames, delays, cfg)
    y = aligned.mean(dim=-2)
    return irfft(y, l2)[..., :n]


@functools.lru_cache(maxsize=16)
def _window_counts(n_bins: int, half: int) -> np.ndarray:
    """Bins inside each bin's smoothing window (the edges hold fewer)."""
    k = np.arange(n_bins)
    return (np.minimum(k + half, n_bins - 1)
            - np.maximum(k - half, 0) + 1).astype(np.float32)


def extract_mvdr(
    frames: torch.Tensor,   # [..., M, N]
    delays: torch.Tensor,   # [..., M] seconds
    cfg: PipelineConfig,
    *,
    smooth_bins: int = 15,
    diagonal_loading: float = 1e-2,
) -> torch.Tensor:
    """MVDR filter-and-sum extraction -> [..., N].

    Frames are delay-aligned first, so the target manifold is the all-ones
    vector at every frequency and the distortionless constraint w^H 1 = 1
    passes the target.  The covariance of bin k sums the aligned outer
    products of bins k - smooth_bins .. k + smooth_bins that exist, in that
    order, divided by their count; alignment keeps the target direction
    constant across bins while an interferer's relative phase rotates, so
    the sum builds rank for the interference subspace."""
    m, n = frames.shape[-2], frames.shape[-1]
    aligned, l2 = _aligned_spectra(frames, delays, cfg)   # [..., M, F2]
    xk = aligned.transpose(-1, -2)                        # [..., F2, M]
    outer = xk[..., :, None] * xk.conj()[..., None, :]    # [..., F2, M, M]
    f2 = xk.shape[-2]
    w_half = int(smooth_bins)
    # term o of bin k is bin k - w_half + o: added in o order, skipping
    # bins off either edge (the reference's zero padding adds exact zeros)
    r = torch.zeros_like(outer)
    for o in range(2 * w_half + 1):
        s = o - w_half
        lo, hi = max(0, -s), min(f2, f2 - s)
        if lo < hi:
            r[..., lo:hi, :, :] += outer[..., lo + s:hi + s, :, :]
    del outer
    r /= device_constant(_window_counts(f2, w_half), r.device)[:, None, None]

    tr = torch.diagonal(r.real, dim1=-2, dim2=-1).sum(dim=-1) / m
    torch.diagonal(r, dim1=-2, dim2=-1).add_(
        (diagonal_loading * tr + 1e-20)[..., None])

    from . import linalg

    ones = torch.ones(*r.shape[:-1], 1, dtype=r.dtype, device=r.device)
    rinv1 = linalg.complex_solve(r, ones)[..., 0]         # [..., F2, M]
    den = rinv1.sum(dim=-1).real                          # 1^T R^-1 1
    den = torch.where(den.abs() > 1e-12, den, torch.full_like(den, 1e-12))
    w = rinv1 / den[..., None]                            # [..., F2, M]
    y = (w.conj() * xk).sum(dim=-1)                       # [..., F2]
    return irfft(y, l2)[..., :n]
