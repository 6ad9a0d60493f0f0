"""Delay-Doppler estimation: the wideband cross-ambiguity function (CAF).

Counterpart of ``audio_triangulation_tpu.ops.caf``.  A moving source
time-scales each mic's signal by (1 - rdot_i / c) besides delaying it, so
over a 20 ms frame at 10 m/s the correlation peak smears and plain GCC
biases the TDOA.  The CAF scans a small set of pair time-scale hypotheses
alpha = 1 + dv / c:

    A_p(tau, alpha) = sum_t x_i(t) * x_j((t - t0) * alpha + t0)

Each hypothesis is a windowed-sinc resampling matrix (one [N, N] product
per scale), after which the matmul-DFT GCC chain gives a correlogram per
(hypothesis, pair); the joint (scale, lag) peak is refined parabolically on
both axes.  Per-pair scales are linear in the source velocity:

    c * (alpha_p - 1) = rdot_j - rdot_i = (u_j - u_i) . v

with u_i the unit vector from the source toward mic i, so one frame gives
the position (the existing solvers) and an instantaneous velocity
(:func:`solve_velocity`).  The products run in fp32 with TF32 off
(``localizer.pin_fp32``), where the reference asks for its highest
precision.  Nothing here waits for the host, so the stream step that calls
it can be captured as a CUDA graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from . import mxu_fft, xcorr
from ._device import device_constant


@functools.lru_cache(maxsize=8)
def _resample_matrices_cached(n: int, scales: tuple, half_width: int):
    """Windowed-sinc time-scale resampling matrices [S, N, N] (float32).

    Row t of matrix s interpolates the input at (t - t0) * scales[s] + t0,
    t0 the frame center (so a pure scale change adds no mid-frame delay).
    The kernel is a Hann-windowed sinc of half-width ``half_width``."""
    t0 = (n - 1) / 2.0
    t = np.arange(n, dtype=np.float64)
    out = np.zeros((len(scales), n, n), np.float64)
    for s, a in enumerate(scales):
        p = (t - t0) * float(a) + t0  # source positions per output sample
        base = np.floor(p).astype(np.int64)
        frac = p - base
        for k in range(-half_width + 1, half_width + 1):
            idx = base + k
            x = frac - k  # signed distance source-sample -> tap
            w = np.sinc(x) * (0.5 + 0.5 * np.cos(np.pi * x / half_width))
            valid = (idx >= 0) & (idx < n) & (np.abs(x) < half_width)
            rows = t[valid].astype(np.int64)
            out[s, rows, idx[valid]] += w[valid]
    return out.astype(np.float32)


def resample_matrices(n: int, scales, half_width: int = 16) -> np.ndarray:
    """Scales (an iterable of alpha) -> [S, N, N] float32."""
    return _resample_matrices_cached(
        n, tuple(float(a) for a in scales), half_width)


def speed_grid(v_max: float = 8.0, n: int = 9) -> np.ndarray:
    """Symmetric pair relative-speed hypotheses [S] (m/s); scales are
    ``1 + grid / c``.  An odd n keeps alpha = 1 (a static source) on the
    grid."""
    return np.linspace(-v_max, v_max, n)


def scale_grid(v_max: float, n_scales: int, speed_of_sound: float):
    """The CAF's scale hypotheses [S] (float64)."""
    return 1.0 + speed_grid(v_max, n_scales) / speed_of_sound


def precompute_resample(n: int, v_max: float, n_scales: int,
                        speed_of_sound: float, cfg=None, *, device):
    """The resampling operator for the standard scale set, on ``device``;
    build it once and pass it as ``resample=`` to the estimators.

    The time-domain matrices [S, N, N] (138 MB at 33 scales and N = 1,024),
    or, with a band-cropping ``cfg``, the spectral fold (cos_rs, msin_rs)
    [S, N, Fb]: the resampling matrices multiplied into the band DFT, so
    the scaled spectra are one product per frame (S N Fb multiply-adds in
    place of S N^2 + S N Fb), equal up to fp32 summation order."""
    scales = tuple(scale_grid(v_max, n_scales, speed_of_sound))
    crop = None if cfg is None else mxu_fft.crop_bins(cfg)
    r = resample_matrices(n, scales)
    if crop is None:
        return torch.as_tensor(r, device=device)
    cos, msin = mxu_fft.dft_matrices_band(n, cfg.fft_length, *crop)
    # cos_rs[s, u, f] = sum_t R[s, t, u] cos[t, f]
    cos_rs = np.einsum("stu,tf->suf", r, cos.astype(np.float32),
                       optimize=True)
    msin_rs = np.einsum("stu,tf->suf", r, msin.astype(np.float32),
                        optimize=True)
    return (torch.as_tensor(cos_rs, device=device),
            torch.as_tensor(msin_rs, device=device))


def caf_correlograms(frames: torch.Tensor, window: torch.Tensor,
                     pairs: torch.Tensor, cfg: PipelineConfig, scales,
                     resample=None) -> torch.Tensor:
    """Raw frames [..., M, N] -> CAF correlograms [..., P, S, L].

    For each scale the j-channel of every pair is time-scaled by the
    resampling product, then correlated against the unscaled i-channel
    through the conditioned matmul-DFT GCC chain (PHAT and band weighting
    per ``cfg``).  The reference concatenates original and scaled spectra
    on the mic axis and offsets the pair list into the scaled half; its
    whitening is then per mic (2M >= 4 channels), so here each half is
    whitened and indexed on its own, without the concatenated copy.
    ``pairs`` is the [P, 2] tensor on the frames' device.

    ``resample`` takes the [S, N, N] matrices or the spectral fold of
    :func:`precompute_resample` (a band-cropping ``cfg``); None uses the
    time-domain matrices of ``scales``."""
    from ..models import localizer as localizer_mod

    n = frames.shape[-1]
    x = localizer_mod.condition_frames(frames, window, cfg)
    crop = mxu_fft.crop_bins(cfg)
    spectral = isinstance(resample, tuple)
    if spectral and crop is None:
        raise ValueError("spectral resample operator requires a "
                         "band-cropping cfg (band_hz + band_crop)")

    if crop is not None:
        re0, im0 = mxu_fft.forward_spectra_band(
            x, cfg.fft_length, *crop, cfg.matmul_dtype)
        syn_c, syn_s = mxu_fft.lag_synthesis_matrices_band(
            cfg.fft_length, cfg.max_shift, *crop)
    else:
        re0, im0 = mxu_fft.forward_spectra(x, cfg.fft_length,
                                           cfg.matmul_dtype)
        syn_c, syn_s = mxu_fft.masked_synthesis(cfg)

    # each product below writes its [S, B*M, .] output contiguously: the
    # DFT of a strided operand takes a batched GEMM many times slower
    x2 = x.reshape(-1, n)
    if spectral:
        cos_rs, msin_rs = resample
        res = torch.matmul(x2, cos_rs).reshape(-1, *x.shape[:-1],
                                               cos_rs.shape[-1])
        ims = torch.matmul(x2, msin_rs).reshape(res.shape)
    else:
        r = (device_constant(resample_matrices(n, scales), x.device)
             if resample is None else resample)
        # scaled channels: xs[s, ..., m, t] = sum_u R[s, t, u] x[..., m, u]
        xs = torch.matmul(x2, r.transpose(1, 2)).reshape(-1, *x.shape)
        if crop is not None:
            res, ims = mxu_fft.forward_spectra_band(
                xs, cfg.fft_length, *crop, cfg.matmul_dtype)
        else:
            res, ims = mxu_fft.forward_spectra(xs, cfg.fft_length,
                                               cfg.matmul_dtype)
    if cfg.phat:
        re0w, im0w = mxu_fft.whiten_reim(re0, im0, cfg.phat_eps,
                                         cfg.phat_beta)
        res, ims = mxu_fft.whiten_reim(res, ims, cfg.phat_eps, cfg.phat_beta)
    else:
        re0w, im0w = re0, im0
    # conj(X_i) X_j(scaled), broadcast over the scale axis
    i, j = pairs[:, 0].long(), pairs[:, 1].long()
    ri, ii = re0w.index_select(-2, i), im0w.index_select(-2, i)
    rj, ij = res.index_select(-2, j), ims.index_select(-2, j)
    rr = ri * rj + ii * ij
    jj = ri * ij - ii * rj
    if cfg.band_auto:
        # the per-event band weight of the localization path, from the
        # unscaled (full-band: 'auto' forbids band_crop) spectra, the same
        # for every scale
        w = xcorr.auto_band_weight(torch.complex(re0, im0), pairs,
                                   cfg)[..., None, :]
        rr = rr * w
        jj = jj * w
    corr = mxu_fft.lag_correlogram(
        rr, jj, device_constant(syn_c, x.device),
        device_constant(syn_s, x.device), cfg.matmul_dtype)  # [S, ..., P, L]
    return torch.movedim(corr, 0, -2)  # [..., P, S, L]


def _parabolic(sm, s0, sp):
    den = sm - 2.0 * s0 + sp
    d = torch.where(den.abs() > 1e-20, 0.5 * (sm - sp) / den,
                    torch.zeros_like(den))
    return d.clamp(-0.5, 0.5)


def delay_doppler_peak(caf: torch.Tensor, max_shift: int, scales):
    """Joint peak of the CAF [..., P, S, L] (the first maximum over the
    flattened scale-lag axis) -> (tdoa_samples [..., P], alpha [..., P],
    peak_value [..., P]), both axes refined parabolically (the scale
    refinement assumes a uniform ``scales`` grid)."""
    s_n, l_n = caf.shape[-2:]
    flat = caf.reshape(*caf.shape[:-2], s_n * l_n)
    idx = flat.argmax(dim=-1)
    si = torch.div(idx, l_n, rounding_mode="floor")
    li = idx % l_n

    def at(ds, dl):
        s = (si + ds).clamp(0, s_n - 1)
        lag = (li + dl).clamp(0, l_n - 1)
        return flat.gather(-1, (s * l_n + lag)[..., None])[..., 0]

    s0 = at(0, 0)
    dl = _parabolic(at(0, -1), s0, at(0, 1))
    ds = _parabolic(at(-1, 0), s0, at(1, 0))
    tdoa = li.to(torch.float32) + dl - max_shift
    sc = np.asarray(scales, np.float64)
    step = float(sc[1] - sc[0]) if len(sc) > 1 else 0.0
    # both constants rounded to f32 first, as the reference's are
    alpha = float(np.float32(sc[0])) + (si.to(torch.float32) + ds) * float(
        np.float32(step))
    return tdoa, alpha, s0


def estimate_delay_doppler(frames: torch.Tensor, window: torch.Tensor,
                           pairs: torch.Tensor, cfg: PipelineConfig, *,
                           v_max: float = 8.0, n_scales: int = 9,
                           resample=None) -> dict:
    """frames [..., M, N] -> joint TDOA and Doppler per pair: a dict of
    'tdoa_samples' [..., P] (estimated at the best scale), 'alpha' [..., P]
    (pair time scale), 'pair_rel_speed' [..., P] = c (alpha - 1) ~ rdot_j -
    rdot_i (m/s), 'caf' [..., P, S, L] and 'peak' [..., P].  The parabolic
    refinement needs the ridge sampled a few times per resolution cell: for
    a velocity solve use n_scales ~ 4 v_max (0.5 m/s steps)."""
    scales = scale_grid(v_max, n_scales, cfg.speed_of_sound_mps)
    caf = caf_correlograms(frames, window, pairs, cfg, scales,
                           resample=resample)
    tdoa, alpha, peak = delay_doppler_peak(caf, cfg.max_shift, scales)
    return {
        "tdoa_samples": tdoa,
        "alpha": alpha,
        "pair_rel_speed": (alpha - 1.0) * cfg.speed_of_sound_mps,
        "caf": caf,
        "peak": peak,
    }


def solve_velocity(position: torch.Tensor, pair_rel_speed: torch.Tensor,
                   mic_positions: torch.Tensor, pairs: torch.Tensor, *,
                   damping: float = 1e-6,
                   in_plane: bool = False) -> torch.Tensor:
    """Source velocity from per-pair Doppler, a batched linear least
    squares: pair_rel_speed_p = (u_j - u_i) . v with u_i = (x - m_i) /
    |x - m_i| at the source position x (position [..., D], D the mic
    dimension; pair_rel_speed [..., P]).  Returns v [..., D], or [..., 2]
    with ``in_plane`` (a coplanar array with the source on the grid's
    plane, where v_z is near-unobservable).  The damped [D, D] system is
    solved without a check that would wait for the device."""
    dt = position.dtype
    diff = position[..., None, :] - mic_positions.to(dt)  # [..., M, D]
    u = diff / torch.linalg.vector_norm(
        diff, dim=-1, keepdim=True).clamp_min(1e-12)
    rows = (u.index_select(-2, pairs[:, 1].long())
            - u.index_select(-2, pairs[:, 0].long()))  # [..., P, D]
    if in_plane:
        rows = rows[..., :2]
    ata = torch.einsum("...pi,...pj->...ij", rows, rows)
    atb = torch.einsum("...pi,...p->...i", rows, pair_rel_speed.to(dt))
    d = rows.shape[-1]
    a = ata + damping * torch.eye(d, dtype=dt, device=rows.device)
    return torch.linalg.solve_ex(a, atb[..., None],
                                 check_errors=False)[0][..., 0]
