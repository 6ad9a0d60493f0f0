"""Far-field direction of arrival: azimuth SRP (with SMP pair merging),
azimuth MUSIC and spherical (azimuth + elevation) SRP.

Counterpart of ``audio_triangulation_tpu.models.doa``.  Each azimuth a of
the circle has pair TDOAs tau_p(a) = -(m_j - m_i) . u(a) / c; the raw
correlograms (``localizer.conditioned_correlograms``: the GCC kernel
without peaks, row 2 of the kernel table, where the configuration takes
it; the large-array kernel for a frame too large for it) are tapered and
scored against a one-hot steering matrix [P * L, A] (on the card the SRP
gather kernel gives the product's scores and first-max azimuth,
``ops.cuda.srp_gather``, where the matrix is the lag table's one-hot), the
peak refined by circular parabolic interpolation and a least-squares
bearing solve.  :class:`Doa3dEstimator` scores a Fibonacci lattice of
unit bearings with the product.  With ``smp=True`` pairs of equal
displacement are merged before the lag synthesis (Grondin et al.,
arXiv:2203.14409): unfused spectra, no GCC kernel, as in the reference.
:func:`estimate_doa_music` is the azimuth form of
``ops.srp_freq.music_spectrum``.

The estimators are ``nn.Module`` s whose buffers live on the device given
to ``create``; every lag window widens to the array's aperture unless
``max_shift_samples`` is set.

Spans (``utils/profiling``, on only while tracing): ``doa.forward`` (host)
around a :class:`DoaEstimator` call, and inside it, under one call id,
``doa.gcc`` (the correlograms), ``doa.srp`` (best lag, taper, azimuth
scores) and ``doa.tail`` (sub-sample peak, bearing solve, azimuth
refinement), timed by CUDA events on the card; counts ``doa.frames`` and
the GCC route of the call, ``doa.route.kernel`` / ``large`` / ``unfused``,
and the scoring's, ``srp.route.kernel`` / ``product``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
from torch import nn

from ..core import geometry
from ..core.config import PipelineConfig
from ..ops import mxu_fft, srp, srp_freq, xcorr
from ..ops import solver as solver_ops, window as window_ops
from ..ops._device import device_constant
from ..ops.cuda import srp_gather
from ..utils import profiling
from . import localizer as localizer_mod


def azimuth_lag_lut(
    mic_positions: np.ndarray,
    pairs: np.ndarray,
    pipeline: PipelineConfig,
    n_azimuths: int,
) -> np.ndarray:
    """Integer lag LUT [P, A] over the azimuth circle."""
    ang = 2 * np.pi * np.arange(n_azimuths) / n_azimuths
    u = np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # [A, 2]
    d = (mic_positions[pairs[:, 1]] - mic_positions[pairs[:, 0]])  # [P, 2]
    # a wave from u reaches the mic further along u first
    tau = -(d @ u.T) / pipeline.speed_of_sound_mps  # [P, A] seconds
    v = tau * pipeline.sample_rate_hz
    shifts = np.trunc(v + np.copysign(0.5, v)).astype(np.int32)
    k = pipeline.max_shift
    return np.clip(shifts, -k, k) + k


def merge_pairs(mic_positions: np.ndarray, pairs: np.ndarray,
                tol: float = 1e-6):
    """SMP pair merging: pairs with the same displacement m_j - m_i share
    their far-field TDOA at every bearing, so their cross-power can be
    summed before the lag synthesis (exact for the azimuth scores with the
    taper off).  Returns (merge [P, P'] 0/1 float32, disp [P', 2] the
    unique displacements)."""
    d = (mic_positions[pairs[:, 1]]
         - mic_positions[pairs[:, 0]]).astype(np.float64)  # [P, 2]
    uniq: list = []
    group = np.empty(d.shape[0], np.int64)
    for p, v in enumerate(d):
        for gi, u in enumerate(uniq):
            if np.linalg.norm(v - u) <= tol:
                group[p] = gi
                break
        else:
            uniq.append(v)
            group[p] = len(uniq) - 1
    merge = np.zeros((d.shape[0], len(uniq)), np.float32)
    merge[np.arange(d.shape[0]), group] = 1.0
    return merge, np.asarray(uniq, np.float32)


def _pseudo_geometry(disp: np.ndarray):
    """(mics [P'+1, 2], pairs [P', 2]): one origin -> displacement pair per
    merged group, the geometry of the merged LUT and bearing solve."""
    mics = np.concatenate(
        [np.zeros((1, 2), np.float32), np.asarray(disp, np.float32)])
    pairs = np.stack([np.zeros(disp.shape[0], np.int32),
                      np.arange(1, disp.shape[0] + 1, dtype=np.int32)], -1)
    return mics, pairs


def _widened(pipeline: PipelineConfig, mics: np.ndarray) -> PipelineConfig:
    """``pipeline`` with its lag window covering the array's aperture,
    unless ``max_shift_samples`` is set (the default +-46 assumes the
    reference's 0.2 m triangle: a clipped lag silently biases the bearing)."""
    if pipeline.max_shift_samples is not None:
        return pipeline
    return dataclasses.replace(
        pipeline, max_shift_samples=geometry.max_lag_for_array(mics,
                                                               pipeline))


def _params(est, lag_onehot: bool = False) -> localizer_mod.LocalizerParams:
    """An estimator's buffers as the pipeline's ``LocalizerParams``
    (``lag_onehot``: its steering matrix is the one-hot of ``lut_flat``)."""
    return localizer_mod.LocalizerParams(
        mic_positions=est.mic_positions, pairs=est.pairs, window=est.window,
        lut_flat=est.lut_flat, onehot=None, lag_onehot=lag_onehot)


def _tensors(arrays: dict, device) -> dict:
    return {k: None if v is None else torch.as_tensor(
        np.array(v, copy=True), device=device) for k, v in arrays.items()}


def _check_frames(frames, window: torch.Tensor, m: int, n: int) -> None:
    if not isinstance(frames, torch.Tensor):
        raise TypeError("frames must be a torch.Tensor on the estimator's "
                        "device")
    if frames.ndim < 2 or frames.shape[-2] != m or frames.shape[-1] != n:
        raise ValueError(f"frames must be [..., {m} mics, {n} samples]; "
                         f"got {tuple(frames.shape)}")
    if frames.device != window.device:
        raise ValueError(f"frames are on {frames.device}; this estimator "
                         f"lives on {window.device}")
    if frames.is_cuda:
        localizer_mod.pin_fp32()


class DoaEstimator(nn.Module):
    """Azimuth SRP estimator on one device.

    >>> est = DoaEstimator.create(geometry.circular_array(8, 0.15),
    ...                           device="cuda")
    >>> out = est(frames)          # frames [B, M, N] on the same device
    >>> out["azimuth_deg"]         # [B]

    With ``smp=True`` same-displacement pairs are merged before the lag
    synthesis (:func:`merge_pairs`): fewer correlogram rows, the same
    azimuth scores with the taper off; 'tdoa_samples', 'best_shift' and
    'bearing' are then per merged group."""

    def __init__(self, pipeline: PipelineConfig, n_azimuths: int,
                 tensors: dict, disp: np.ndarray | None = None):
        super().__init__()
        self.pipeline = pipeline
        self.n_azimuths = n_azimuths
        self.disp = disp
        for name in ("mic_positions", "pairs", "window", "lut_flat",
                     "onehot_az", "merge"):
            self.register_buffer(name, tensors.get(name))
        # whether the SRP gather kernel may score from lut_flat
        self.lag_onehot = srp_gather.is_lag_onehot(
            self.lut_flat, self.onehot_az, pipeline.num_lags)
        dev = self.window.device
        if disp is not None:
            mics_p, pairs_p = _pseudo_geometry(disp)
            self.register_buffer("pseudo_mics", torch.as_tensor(mics_p,
                                                                device=dev))
            self.register_buffer("pseudo_pairs", torch.as_tensor(
                pairs_p, device=dev))
        if self.window.is_cuda:
            localizer_mod.pin_fp32()

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(phat=True),
        n_azimuths: int = 360,
        *,
        smp: bool = False,
        device,
    ) -> "DoaEstimator":
        mic_positions = np.asarray(mic_positions, np.float32)
        pipeline = _widened(pipeline, mic_positions)
        pairs = geometry.mic_pairs(mic_positions.shape[0])
        merge = disp = None
        if smp:
            # the merged path forms the cross-power from the matmul spectra
            if pipeline.effective_weighting not in ("none", "phat"):
                raise ValueError(
                    "smp=True supports weighting none/phat only "
                    f"(got {pipeline.effective_weighting!r})")
            if pipeline.xcorr_mode != "mxu":
                raise ValueError(
                    "smp=True requires xcorr_mode='mxu' "
                    f"(got {pipeline.xcorr_mode!r})")
            merge, disp = merge_pairs(mic_positions, pairs)
            lut_mics, lut_pairs = _pseudo_geometry(disp)
        else:
            lut_mics, lut_pairs = mic_positions, pairs
        lut = azimuth_lag_lut(lut_mics, lut_pairs, pipeline, n_azimuths)
        onehot = geometry.lag_onehot(lut[:, None, :], pipeline.num_lags)
        return cls(pipeline, n_azimuths, _tensors(dict(
            mic_positions=mic_positions, pairs=pairs,
            window=window_ops.window_for(pipeline), lut_flat=lut,
            onehot_az=onehot, merge=merge), device), disp)

    @classmethod
    def from_reference_params(cls, arrays: dict, pipeline: PipelineConfig,
                              n_azimuths: int, *, device) -> "DoaEstimator":
        """An estimator from the JAX package's ``DoaEstimator`` constants
        as numpy arrays (``utils.convert.doa_from_reference``); ``pipeline``
        is the reference's, already widened."""
        from ..utils.convert import doa_from_reference

        tensors, disp = doa_from_reference(arrays, device)
        return cls(pipeline, n_azimuths, tensors, disp)

    @property
    def params(self) -> localizer_mod.LocalizerParams:
        return _params(self, self.lag_onehot)

    def forward(self, frames: torch.Tensor) -> dict:
        with profiling.annotate("doa.forward"):
            _check_frames(frames, self.window, self.mic_positions.shape[0],
                          self.pipeline.frame_size)
            if self.merge is None:
                return estimate_doa(
                    self.params, self.onehot_az, frames, cfg=self.pipeline,
                    n_azimuths=self.n_azimuths)
            return estimate_doa_smp(
                self.params, self.onehot_az, self.merge, frames,
                cfg=self.pipeline, n_azimuths=self.n_azimuths,
                pseudo_mics=self.pseudo_mics, pseudo_pairs=self.pseudo_pairs)


def _refine_azimuth(scores: torch.Tensor, n_azimuths: int,
                    a: torch.Tensor | None = None) -> torch.Tensor:
    """Circular 3-point parabolic refinement of the first-max azimuth (``a``
    [...], when the caller has it) -> bearing in degrees [...]."""
    if a is None:
        a = scores.argmax(dim=-1)

    def take(i):
        return scores.gather(-1, (i % n_azimuths)[..., None])[..., 0]

    sm, s0, sp = take(a - 1), take(a), take(a + 1)
    den = sm - 2.0 * s0 + sp
    delta = torch.where(den.abs() > 1e-20, 0.5 * (sm - sp) / den,
                        torch.zeros_like(den)).clamp(-0.5, 0.5)
    return ((a.to(scores.dtype) + delta) * (360.0 / n_azimuths)) % 360.0


def _doa_result(corr, scores, shifts, mics, pairs, cfg, n_azimuths,
                best=None):
    """Refined azimuth (from the first-max azimuth ``best`` when given),
    per-pair sub-sample TDOAs and the least-squares far-field bearing."""
    tdoa_samples, _ = xcorr.subsample_peak(corr, cfg.max_shift)
    bearing = solver_ops.farfield_bearing(
        tdoa_samples / cfg.sample_rate_hz, mics, pairs,
        cfg.speed_of_sound_mps)
    return {
        "azimuth_deg": _refine_azimuth(scores, n_azimuths, best),
        "scores": scores,
        "bearing": bearing,
        "tdoa_samples": tdoa_samples,
        "best_shift": shifts,
    }


def _count_call(frames: torch.Tensor, route: str) -> None:
    """The counts of one estimator call on ``frames`` [..., M, N] (nothing
    with tracing off)."""
    profiling.count("doa.frames", math.prod(frames.shape[:-2]))
    profiling.count("doa.route." + route)


def _steered_scores(corr, onehot, cfg, params):
    """(best shifts [B, P], scores [B, D], first-max azimuth [B] or None)
    of raw correlograms: the first-max lag, the taper around it, the
    one-hot steering product's scores, and their first maximum where the
    gather kernel gives them (``srp_gather.route`` on ``params``' lag
    table)."""
    shifts = xcorr.best_lag(corr, cfg.max_shift)
    corr_t = (xcorr.peak_taper(corr, cfg.max_shift, cfg.taper_denom, shifts)
              if cfg.taper_enabled else corr)
    if srp_gather.route(corr_t, params.lut_flat, params.lag_onehot):
        return (shifts, *srp_gather.launch(corr_t, params.lut_flat))
    return shifts, srp.srp_scores_matmul(corr_t, onehot), None


def _lead(out: dict, lead) -> dict:
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}


def _raw_correlograms(params, frames, cfg):
    """frames [..., M, N] -> (flat raw correlograms [B, P, L], lead)."""
    flat = localizer_mod._flat_frames(frames, cfg)
    return localizer_mod.conditioned_correlograms(
        flat, params, cfg), frames.shape[:-2]


def estimate_doa(
    params: localizer_mod.LocalizerParams,
    onehot_az: torch.Tensor,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    n_azimuths: int,
) -> dict:
    """frames [..., M, N] -> 'azimuth_deg' [...], 'scores' [..., A],
    'bearing' [..., 2], 'tdoa_samples' and 'best_shift' [..., P]."""
    lead = frames.shape[:-2]
    flat = localizer_mod._flat_frames(frames, cfg)
    if profiling.enabled():
        on_kernel, on_large = localizer_mod.gcc_routes(
            flat, cfg, params.pairs.shape[0], with_peaks=False)
        _count_call(flat, "kernel" if on_kernel
                    else "large" if on_large else "unfused")
    call = profiling.call_id()
    with profiling.annotate("doa.gcc", flat.device, call):
        corr = localizer_mod.conditioned_correlograms(flat, params, cfg)
    with profiling.annotate("doa.srp", flat.device, call):
        shifts, scores, best = _steered_scores(  # scores [B, A]
            corr, onehot_az, cfg, params)
    with profiling.annotate("doa.tail", flat.device, call):
        out = _doa_result(corr, scores, shifts, params.mic_positions,
                          params.pairs, cfg, n_azimuths, best)
    return _lead(out, lead)


def estimate_doa_smp(
    params: localizer_mod.LocalizerParams,
    onehot_az: torch.Tensor,
    merge: torch.Tensor,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    n_azimuths: int,
    pseudo_mics: torch.Tensor,
    pseudo_pairs: torch.Tensor,
) -> dict:
    """SMP azimuth estimate of frames [..., M, N]: the cross-power spectra
    of the matmul DFT summed within displacement groups (``merge`` [P, P'])
    before the lag synthesis, then :func:`estimate_doa`'s scoring and tail
    against the pseudo geometry (one origin -> displacement pair a
    group).  With the taper on, the taper acts on the merged correlogram."""
    k = cfg.max_shift
    pairs = params.pairs
    _count_call(frames, "unfused")
    call = profiling.call_id()
    with profiling.annotate("doa.gcc", frames.device, call):
        crop = mxu_fft.crop_bins(cfg)
        x = localizer_mod.condition_frames(frames, params.window, cfg)
        if crop is not None:
            re, im = mxu_fft.forward_spectra_band(
                x, cfg.fft_length, *crop, cfg.matmul_dtype)
            syn_c, syn_s = mxu_fft.lag_synthesis_matrices_band(
                cfg.fft_length, k, *crop)
        else:
            re, im = mxu_fft.forward_spectra(x, cfg.fft_length,
                                             cfg.matmul_dtype)
            syn_c, syn_s = mxu_fft.masked_synthesis(cfg)
        rr, jj = mxu_fft.cross_power_reim(
            re, im, pairs, phat=cfg.phat, phat_eps=cfg.phat_eps,
            phat_beta=cfg.phat_beta)
        if cfg.band_auto:
            # pair-averaged, so the same for every group: weight before
            # merging
            w = xcorr.auto_band_weight(torch.complex(re, im), pairs,
                                       cfg)[..., None, :]
            rr = rr * w
            jj = jj * w
        rr = torch.einsum("pq,...pf->...qf", merge, rr)  # [..., P', F]
        jj = torch.einsum("pq,...pf->...qf", merge, jj)
        corr = mxu_fft.lag_correlogram(
            rr, jj, device_constant(syn_c, frames.device),
            device_constant(syn_s, frames.device), cfg.matmul_dtype)
    with profiling.annotate("doa.srp", frames.device, call):
        shifts, scores, best = _steered_scores(corr, onehot_az, cfg, params)
    with profiling.annotate("doa.tail", frames.device, call):
        return _doa_result(corr, scores, shifts, pseudo_mics, pseudo_pairs,
                           cfg, n_azimuths, best)


# ----------------------------------------------------------------------
# Subspace (MUSIC) DoA
# ----------------------------------------------------------------------

def azimuth_steering_vectors(
    mic_positions: np.ndarray,
    pipeline: PipelineConfig,
    n_azimuths: int,
    *,
    bin_stride: int = 8,
):
    """Far-field per-mic steering a[Fk, M, A] complex64 over the bearing
    circle, tau_m(az) = -(m . u(az)) / c less its mean over the mics.
    Returns (a, bins, weights) as ``ops.srp_freq.mic_steering_vectors``."""
    mics = np.asarray(mic_positions, np.float64)[:, :2]
    ang = 2 * np.pi * np.arange(n_azimuths) / n_azimuths
    u = np.stack([np.cos(ang), np.sin(ang)], axis=-1)     # [A, 2]
    tau = -(mics @ u.T) / pipeline.speed_of_sound_mps     # [M, A] seconds
    tau = tau - tau.mean(axis=0, keepdims=True)

    l = pipeline.fft_length
    f_full = l // 2 + 1
    bins = np.arange(1, f_full - 1, bin_stride)
    w = np.full(bins.shape[0], 1.0 / bins.shape[0], np.float32)
    phase = (-2.0 * np.pi * pipeline.sample_rate_hz / l
             * bins[:, None, None] * tau[None])           # [Fk, M, A]
    return np.exp(1j * phase).astype(np.complex64), bins, w


@functools.lru_cache(maxsize=8)
def _azimuth_steering_cached(mics: tuple, pipeline: PipelineConfig,
                             n_azimuths: int, bin_stride: int):
    return azimuth_steering_vectors(np.asarray(mics, np.float32), pipeline,
                                    n_azimuths, bin_stride=bin_stride)


def circular_peaks(scores: np.ndarray, n_peaks: int,
                   min_separation: int) -> np.ndarray:
    """Indices of the ``n_peaks`` strongest maxima on a circular axis (host
    numpy), each suppressing +-``min_separation`` bins around it."""
    s = np.asarray(scores, np.float64).copy()
    a = s.shape[-1]
    out = []
    for _ in range(n_peaks):
        i = int(np.argmax(s))
        out.append(i)
        idx = (np.arange(i - min_separation, i + min_separation + 1)) % a
        s[idx] = -np.inf
    return np.asarray(out)


def estimate_doa_music(
    frames: torch.Tensor,
    mic_positions: np.ndarray,
    cfg: PipelineConfig,
    *,
    n_azimuths: int = 360,
    n_sources: int | str = 1,
    bin_stride: int = 8,
    diagonal_loading: float = 0.0,
    min_separation_deg: float = 10.0,
) -> dict:
    """Snapshot frames [S, M, N] on their device -> wideband MUSIC azimuth
    spectrum 'scores' [A] and the ``n_sources`` strongest bearings
    'azimuth_deg' (host numpy, degrees; the spectrum is read back for
    :func:`circular_peaks`).  ``n_sources='auto'`` counts them first
    (``srp_freq.estimate_n_sources``)."""
    n_estimated = None
    if n_sources == "auto":
        n_estimated = srp_freq.estimate_n_sources(
            frames, cfg, bin_stride=bin_stride,
            diagonal_loading=max(diagonal_loading, 1e-3))
        n_sources = max(1, n_estimated)
    steer, bins, w = _azimuth_steering_cached(
        srp_freq._mics_key(mic_positions), cfg, n_azimuths, bin_stride)
    re, im = srp_freq._spectra(frames, cfg)
    scores = srp_freq.music_spectrum(
        re, im, steer, bins, w, n_sources=n_sources,
        diagonal_loading=diagonal_loading)
    sep = max(1, int(round(min_separation_deg * n_azimuths / 360.0)))
    peaks = circular_peaks(scores.cpu().numpy(), n_sources, sep)
    out = {"scores": scores,
           "azimuth_deg": (peaks * (360.0 / n_azimuths)) % 360.0,
           "n_sources": n_sources}
    if n_estimated is not None:
        out["n_sources_estimated"] = n_estimated
    return out


# ----------------------------------------------------------------------
# Spherical (azimuth + elevation) SRP DoA
# ----------------------------------------------------------------------

def sphere_directions(n_dirs: int, hemisphere: bool = False) -> np.ndarray:
    """Fibonacci lattice of unit bearings [D, 3] over the sphere (or the
    upper hemisphere: the steering set of a coplanar array)."""
    i = np.arange(n_dirs, dtype=np.float64) + 0.5
    z = 1.0 - (i / n_dirs if hemisphere else 2.0 * i / n_dirs)
    phi = i * (np.pi * (3.0 - np.sqrt(5.0)))  # golden angle
    r = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack(
        [r * np.cos(phi), r * np.sin(phi), z], axis=-1).astype(np.float32)


def sphere_lag_lut(
    mic_positions: np.ndarray,
    pairs: np.ndarray,
    pipeline: PipelineConfig,
    dirs: np.ndarray,
) -> np.ndarray:
    """Integer lag LUT [P, D] over unit bearings ``dirs`` [D, 3], with
    :func:`azimuth_lag_lut`'s far-field model and rounding."""
    m = np.asarray(mic_positions, np.float64)
    m3 = np.zeros((m.shape[0], 3))
    m3[:, : m.shape[1]] = m
    d = m3[pairs[:, 1]] - m3[pairs[:, 0]]  # [P, 3]
    tau = -(d @ np.asarray(dirs, np.float64).T) / pipeline.speed_of_sound_mps
    v = tau * pipeline.sample_rate_hz
    shifts = np.trunc(v + np.copysign(0.5, v)).astype(np.int32)
    k = pipeline.max_shift
    return np.clip(shifts, -k, k) + k


class Doa3dEstimator(nn.Module):
    """Spherical SRP estimator (azimuth and elevation) on one device.

    Scores a Fibonacci lattice of bearings with the one-hot steering
    product, then refines the lattice peak with the least-squares bearing
    solve on the sub-sample TDOAs.  Elevation needs a non-coplanar array;
    a coplanar one steers the upper hemisphere (its +-z is ambiguous) and
    takes the elevation from the lattice peak."""

    def __init__(self, pipeline: PipelineConfig, tensors: dict):
        super().__init__()
        self.pipeline = pipeline
        for name in ("mic_positions", "pairs", "window", "lut_flat", "dirs",
                     "onehot_sph"):
            self.register_buffer(name, tensors[name])
        mics = self.mic_positions.cpu().numpy()
        self.coplanar = bool(np.ptp(mics[:, 2]) < 1e-6)
        if self.window.is_cuda:
            localizer_mod.pin_fp32()

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(phat=True),
        n_dirs: int = 2048,
        *,
        hemisphere: bool | None = None,
        device,
    ) -> "Doa3dEstimator":
        """``hemisphere=None`` takes the upper hemisphere for a coplanar
        array and the full sphere otherwise."""
        m = np.asarray(mic_positions, np.float32)
        m3 = np.zeros((m.shape[0], 3), np.float32)
        m3[:, : m.shape[1]] = m
        pipeline = _widened(pipeline, m3)
        if hemisphere is None:
            hemisphere = bool(np.ptp(m3[:, 2]) < 1e-6)
        dirs = sphere_directions(n_dirs, hemisphere=hemisphere)
        pairs = geometry.mic_pairs(m3.shape[0])
        lut = sphere_lag_lut(m3, pairs, pipeline, dirs)  # [P, D]
        return cls(pipeline, _tensors(dict(
            mic_positions=m3, pairs=pairs,
            window=window_ops.window_for(pipeline), lut_flat=lut, dirs=dirs,
            onehot_sph=geometry.lag_onehot(lut[:, None, :],
                                           pipeline.num_lags)), device))

    @classmethod
    def from_reference_params(cls, arrays: dict, pipeline: PipelineConfig,
                              *, device) -> "Doa3dEstimator":
        """An estimator from the JAX package's ``Doa3dEstimator`` constants
        as numpy arrays (``utils.convert.doa3d_from_reference``)."""
        from ..utils.convert import doa3d_from_reference

        return cls(pipeline, doa3d_from_reference(arrays, device))

    @property
    def params(self) -> localizer_mod.LocalizerParams:
        return _params(self)

    def forward(self, frames: torch.Tensor) -> dict:
        _check_frames(frames, self.window, self.mic_positions.shape[0],
                      self.pipeline.frame_size)
        return estimate_doa_3d(
            self.params, self.onehot_sph, self.dirs, frames,
            cfg=self.pipeline, coplanar=self.coplanar)


def estimate_doa_3d(
    params: localizer_mod.LocalizerParams,
    onehot_sph: torch.Tensor,
    dirs: torch.Tensor,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    coplanar: bool = False,
) -> dict:
    """frames [..., M, N] -> 'azimuth_deg' / 'elevation_deg' [...],
    'bearing' [..., 3] (refined), 'bearing_grid' [..., 3] (lattice peak),
    'scores' [..., D], 'tdoa_samples', 'best_shift'.  A non-coplanar array
    takes both angles from the least-squares bearing; ``coplanar`` keeps
    its azimuth and the lattice peak's elevation."""
    corr, lead = _raw_correlograms(params, frames, cfg)
    # the spherical lattice keeps the product (``lag_onehot`` False)
    shifts, scores, _ = _steered_scores(corr, onehot_sph, cfg,
                                        params)  # [B, D]
    u_grid = dirs[scores.argmax(dim=-1)]  # [B, 3]

    tdoa_samples, _ = xcorr.subsample_peak(corr, cfg.max_shift)
    u_ls = solver_ops.farfield_bearing(
        tdoa_samples / cfg.sample_rate_hz, params.mic_positions,
        params.pairs, cfg.speed_of_sound_mps)
    if coplanar:
        el_rad = torch.asin(u_grid[..., 2].clamp(-1.0, 1.0))
        az_rad = torch.atan2(u_ls[..., 1], u_ls[..., 0])
        ce = torch.cos(el_rad)
        u = torch.stack([ce * torch.cos(az_rad), ce * torch.sin(az_rad),
                         torch.sin(el_rad)], dim=-1)
    else:
        u = u_ls
    az = torch.rad2deg(torch.atan2(u[..., 1], u[..., 0])) % 360.0
    el = torch.rad2deg(torch.asin(u[..., 2].clamp(-1.0, 1.0)))
    return _lead({
        "azimuth_deg": az,
        "elevation_deg": el,
        "bearing": u,
        "bearing_grid": u_grid,
        "scores": scores,
        "tdoa_samples": tdoa_samples,
        "best_shift": shifts,
    }, lead)
