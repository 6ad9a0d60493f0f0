"""Frequency-domain grid scoring: frequency-steered SRP, MVDR, MUSIC / CSSM
and model-order selection.

Counterpart of ``audio_triangulation_tpu.ops.srp_freq``:

- frequency SRP: every cell scored with its exact fractional delay,
  score = Re(R) @ C + Im(R) @ S over the cross-power R at every
  ``bin_stride``-th bin (:func:`freq_steering_matrices`,
  :func:`srp_scores_freq`, :func:`localize_freq`);
- from S snapshots [S, M, N], the per-bin spatial covariance R_f and over
  per-mic steering vectors a[Fk, M, G] (:func:`mic_steering_vectors`): the
  MVDR (Capon) spectrum sum_f w_f / (a^H R_f^-1 a), wideband MUSIC
  sum_f w_f / (M - ||P_sig a||^2), the Bartlett spectrum and CSSM (coherent
  MUSIC on the focused covariance, :func:`focusing_matrices` and
  :func:`select_focus_cells` on the host);
- :func:`estimate_n_sources`: the wideband MDL / AIC source count.

The reference keeps every complex quantity in real block embeddings
because the TPU has no complex eigh or LU; here the covariances, the
solves and the eigendecompositions are ``complex64`` torch
(``ops.linalg``), and its three jitted stages a call are one call.  The
steering constants are numpy, built once per configuration and copied to
the frames' device once (``_device.device_constant``).  The host reads
the device where the reference does: ``estimate_n_sources``'s eigenvalues
and CSSM's preliminary spectrum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import geometry
from ..core.config import GridConfig, PipelineConfig
from . import linalg, mxu_fft, srp, xcorr
from . import window as window_ops
from ._device import device_constant


def freq_steering_matrices(
    grid: GridConfig,
    mic_positions: np.ndarray,
    pairs: np.ndarray,
    pipeline: PipelineConfig,
    *,
    bin_stride: int = 4,
    dtype=np.float32,
):
    """Steering matrices (C, S) of shape [P * Fk, G] and the kept bin
    indices [Fk], where Fk = ceil(F / bin_stride) (fewer under a band)."""
    pts = geometry.grid_points(grid)  # [H, W, 3]
    tau = geometry.expected_tdoas(
        pts, mic_positions, pairs, pipeline.speed_of_sound_mps)  # [H, W, P]
    g = grid.num_cells
    p = pairs.shape[0]
    tau = tau.reshape(g, p).T  # [P, G] seconds

    l = pipeline.fft_length
    f_full = l // 2 + 1
    bins = xcorr.restrict_bins_to_band(
        np.arange(0, f_full, bin_stride), pipeline)
    # Hermitian weights (1 at DC / Nyquist, else 2) times the stride, so the
    # strided sum stays an unbiased estimate of the full one
    w = np.full(f_full, 2.0)
    w[0] = 1.0
    if l % 2 == 0:
        w[-1] = 1.0
    w = (w * bin_stride / l)[bins]  # [Fk]

    ang = (2.0 * np.pi * bins[None, :, None] * pipeline.sample_rate_hz / l
           * tau[:, None, :])  # [P, Fk, G]
    c = (w[None, :, None] * np.cos(ang)).astype(dtype)
    s = (-w[None, :, None] * np.sin(ang)).astype(dtype)
    fk = bins.shape[0]
    return c.reshape(p * fk, g), s.reshape(p * fk, g), bins


def srp_scores_freq(
    rr: torch.Tensor,
    jj: torch.Tensor,
    steer_c: torch.Tensor,
    steer_s: torch.Tensor,
    bins: np.ndarray,
) -> torch.Tensor:
    """Scores [..., G] from cross-power (re, im) [..., P, F]: Re(R) @ C +
    Im(R) @ S with R taken at ``bins``."""
    idx = device_constant(bins, rr.device, torch.long)
    rr_k = rr.index_select(-1, idx)
    jj_k = jj.index_select(-1, idx)
    *lead, p, fk = rr_k.shape
    return (torch.matmul(rr_k.reshape(*lead, p * fk), steer_c)
            + torch.matmul(jj_k.reshape(*lead, p * fk), steer_s))


def mic_steering_vectors(
    grid: GridConfig,
    mic_positions: np.ndarray,
    pipeline: PipelineConfig,
    *,
    bin_stride: int = 8,
):
    """Per-mic steering a[Fk, M, G] complex64 of every grid cell,
    a_m(f, g) = exp(-j 2 pi f fs / L tau_m(g)) with tau_m the propagation
    delay from cell g to mic m less its mean over the mics.  Returns (a,
    bins [Fk] without DC and Nyquist, weights [Fk] float32)."""
    pts = geometry.grid_points(grid)  # [H, W, 3]
    mic3 = np.zeros((mic_positions.shape[0], 3), np.float64)
    mic3[:, : mic_positions.shape[1]] = mic_positions
    d = np.linalg.norm(
        pts.reshape(-1, 1, 3) - mic3[None], axis=-1)  # [G, M]
    d = d - d.mean(axis=1, keepdims=True)
    tau = (d / pipeline.speed_of_sound_mps).T  # [M, G] seconds

    l = pipeline.fft_length
    f_full = l // 2 + 1
    bins = xcorr.restrict_bins_to_band(
        np.arange(1, f_full - 1, bin_stride), pipeline)
    w = np.full(bins.shape[0], 1.0 / bins.shape[0])
    ang = (-2.0 * np.pi * pipeline.sample_rate_hz / l
           * bins[:, None, None] * tau[None])  # [Fk, M, G]
    a = np.exp(1j * ang).astype(np.complex64)
    return a, bins, w.astype(np.float32)


def _steering(steering, device) -> torch.Tensor:
    """A steering tensor, numpy or torch, as complex64 on ``device``."""
    if isinstance(steering, np.ndarray):
        return device_constant(steering, device, torch.complex64)
    return steering.to(device=device, dtype=torch.complex64)


def spatial_covariance(re: torch.Tensor, im: torch.Tensor, bins: np.ndarray,
                       diagonal_loading: float) -> torch.Tensor:
    """Per-bin spatial covariance R_f = E_s[x x^H] [Fk, M, M] complex64 of
    the spectra x = re + i im [S, M, F] at ``bins``, with the
    scale-invariant loading ``diagonal_loading`` * tr(R_f) / M on the
    diagonal (counterpart of ``_spatial_covariance_reim``)."""
    idx = device_constant(bins, re.device, torch.long)
    x = torch.complex(re.index_select(-1, idx), im.index_select(-1, idx))
    x = x.permute(2, 0, 1)  # [Fk, S, M]
    r = torch.matmul(x.transpose(-1, -2), x.conj()) / x.shape[1]
    if diagonal_loading:
        m = r.shape[-1]
        tr = torch.diagonal(r.real, dim1=-2, dim2=-1).sum(-1) / m  # [Fk]
        eye = torch.eye(m, dtype=r.dtype, device=r.device)
        r = r + (diagonal_loading * tr)[:, None, None] * eye
    return r


def mvdr_spectrum(
    re: torch.Tensor,
    im: torch.Tensor,
    steering,                # [Fk, M, G] complex64
    bins: np.ndarray,
    weights: np.ndarray,     # [Fk]
    *,
    diagonal_loading: float = 1e-2,
) -> torch.Tensor:
    """MVDR (Capon) spectrum [G]: sum_f w_f / Re(a_g^H R_f^-1 a_g), the
    covariance estimated over the snapshot axis of (re, im) [S, M, F] and
    diagonally loaded."""
    a = _steering(steering, re.device)
    r = spatial_covariance(re, im, bins, diagonal_loading)
    x = linalg.complex_solve(r, a)  # R^-1 a [Fk, M, G]
    den = (a.conj() * x).sum(dim=-2).real.clamp_min(1e-12)  # [Fk, G]
    w = device_constant(weights, re.device)
    return (w[:, None] / den).sum(dim=0)


def _check_order(n_sources: int, m: int) -> None:
    if not 0 < n_sources < m:
        raise ValueError(f"n_sources must be in [1, {m - 1}], "
                         f"got {n_sources}")


def music_spectrum(
    re: torch.Tensor,
    im: torch.Tensor,
    steering,                # [Fk, M, G] complex64
    bins: np.ndarray,
    weights: np.ndarray,     # [Fk]
    *,
    n_sources: int = 1,
    diagonal_loading: float = 0.0,
) -> torch.Tensor:
    """Wideband (incoherent) MUSIC pseudo-spectrum [G]:
    sum_f w_f / max(M - ||P_sig a_g||^2, 1e-6), P_sig the projector on the
    ``n_sources`` strongest eigenvectors of R_f (estimated over the snapshot
    axis of (re, im) [S, M, F])."""
    m = re.shape[-2]
    _check_order(n_sources, m)
    a = _steering(steering, re.device)
    r = spatial_covariance(re, im, bins, diagonal_loading)
    _, v = linalg.complex_eigh(r)  # ascending
    sig = linalg.subspace_projector_quadform(v[..., -n_sources:], a)
    den = (m - sig).clamp_min(1e-6)
    w = device_constant(weights, re.device)
    return (w[:, None] / den).sum(dim=0)


def focusing_matrices(
    steering: np.ndarray,   # [Fk, M, G] complex64 (mic_steering_vectors)
    f0_idx: int,
    focus_cells: np.ndarray,
) -> np.ndarray:
    """RSS focusing matrices T_f [Fk, M, M] complex64 (host numpy): the
    unitary T_f = U V^H of the SVD A_0 A_f^H = U S V^H, A_f the steering
    restricted to the focus cells (a small sector around the preliminary
    peaks: one rotation cannot align two bins' manifolds over a wide
    one)."""
    a0 = steering[f0_idx][:, focus_cells]            # [M, C]
    ts = []
    for f in range(steering.shape[0]):
        af = steering[f][:, focus_cells]             # [M, C]
        q = a0 @ af.conj().T                         # [M, M]
        u, _, vh = np.linalg.svd(q)
        ts.append(u @ vh)
    return np.stack(ts).astype(np.complex64)        # [Fk, M, M]


def conventional_spectrum(
    re: torch.Tensor,
    im: torch.Tensor,
    steering,                # [Fk, M, G] complex64
    bins: np.ndarray,
    weights: np.ndarray,     # [Fk]
) -> torch.Tensor:
    """Wideband conventional (Bartlett) spectrum [G]:
    sum_f w_f Re(a_g^H R_f a_g) / M, the preliminary whose peaks seed
    CSSM's focusing sector."""
    a = _steering(steering, re.device)
    r = spatial_covariance(re, im, bins, 0.0)
    quad = (a.conj() * torch.matmul(r, a)).sum(dim=-2).real  # [Fk, G]
    w = device_constant(weights, re.device)
    return torch.matmul(w, quad) / re.shape[-2]


def select_focus_cells(
    spectrum: np.ndarray,     # [G] preliminary (Bartlett) spectrum
    grid_hw: tuple[int, int],
    n_peaks: int,
    *,
    radius_cells: int = 3,
    suppress_cells: int = 8,
) -> np.ndarray:
    """CSSM's focusing sector (host numpy): the union of the (2r+1)^2
    neighbourhoods of the ``n_peaks`` strongest peaks of ``spectrum``, taken
    greedily with a ``suppress_cells`` exclusion zone."""
    h, w = grid_hw
    flat = np.asarray(spectrum, np.float64).reshape(-1).copy()
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    mask = np.zeros(h * w, bool)
    for _ in range(max(1, int(n_peaks))):
        gi = int(np.argmax(flat))
        if not np.isfinite(flat[gi]):
            break
        r0, c0 = divmod(gi, w)
        mask |= ((np.abs(rr - r0) <= radius_cells)
                 & (np.abs(cc - c0) <= radius_cells)).reshape(-1)
        flat[((np.abs(rr - r0) < suppress_cells)
              & (np.abs(cc - c0) < suppress_cells)).reshape(-1)] = -np.inf
    return np.nonzero(mask)[0]


def music_spectrum_coherent(
    re: torch.Tensor,
    im: torch.Tensor,
    steering: np.ndarray,    # [Fk, M, G] complex64
    bins: np.ndarray,
    weights: np.ndarray,     # [Fk]
    focus_cells: np.ndarray,
    *,
    n_sources: int = 1,
    f0_idx: int | None = None,
    diagonal_loading: float = 1e-3,
) -> torch.Tensor:
    """Coherent wideband MUSIC (CSSM) pseudo-spectrum [G]: every bin's
    covariance focused onto bin ``f0_idx`` (the middle one by default),
    R_coh = sum_f w_f T_f R_f T_f^H made exactly Hermitian, then
    narrowband MUSIC at f0.  ``focus_cells`` is the focusing sector
    (:func:`select_focus_cells`); use a band-limited ``band_hz`` (one
    unitary focusing a bin holds over a moderate fractional bandwidth)."""
    m = re.shape[-2]
    _check_order(n_sources, m)
    steering = np.asarray(steering)
    if f0_idx is None:
        f0_idx = steering.shape[0] // 2
    t = torch.as_tensor(
        focusing_matrices(steering, f0_idx, np.asarray(focus_cells)),
        device=re.device)  # [Fk, M, M]
    r = spatial_covariance(re, im, bins, diagonal_loading)
    c = torch.matmul(torch.matmul(t, r), t.conj().transpose(-1, -2))
    w = device_constant(weights, re.device)
    r_coh = (w[:, None, None] * c).sum(dim=0)  # [M, M]
    r_coh = 0.5 * (r_coh + r_coh.conj().T)
    _, v = linalg.complex_eigh(r_coh)
    a0 = _steering(steering[f0_idx], re.device)  # [M, G]
    sig = linalg.subspace_projector_quadform(v[:, -n_sources:], a0)
    return 1.0 / (m - sig).clamp_min(1e-6)


def _spectra(frames: torch.Tensor, cfg: PipelineConfig):
    """Conditioned frames' matmul-DFT spectra (re, im) [..., M, F].  Every
    entry point of the module starts here, so on the card TF32 is turned
    off here (``localizer.pin_fp32``), as the estimators' ``create`` does."""
    from ..models.localizer import condition_frames, pin_fp32

    if frames.is_cuda:
        pin_fp32()
    win = device_constant(window_ops.window_for(cfg), frames.device)
    x = condition_frames(frames, win, cfg)
    return mxu_fft.forward_spectra(x, cfg.fft_length, cfg.matmul_dtype)


def estimate_n_sources(
    frames: torch.Tensor,
    cfg: PipelineConfig,
    *,
    bin_stride: int = 8,
    criterion: str = "mdl",
    diagonal_loading: float = 1e-3,
    max_sources: int | None = None,
) -> int:
    """How many sources are present in snapshot frames [S, M, N]: the k in
    [0, max_sources] that minimises the wideband Wax-Kailath criterion over
    the per-bin covariance eigenvalues, S (M - k) sum_f ln(arithmetic /
    geometric mean of the M - k smallest) plus 'mdl' 0.5 k (2M - k) Fk
    ln S or 'aic' k (2M - k) Fk.  The eigenvalues are read back to the
    host."""
    s_count, m = frames.shape[0], frames.shape[1]
    k_max = min(m - 1, max_sources if max_sources is not None else m - 1)
    re, im = _spectra(frames, cfg)
    f_full = cfg.fft_length // 2 + 1
    bins = xcorr.restrict_bins_to_band(
        np.arange(1, f_full - 1, bin_stride), cfg)
    r = spatial_covariance(re, im, bins, diagonal_loading)
    lam = np.maximum(torch.linalg.eigvalsh(r).cpu().numpy(), 1e-20)

    # the d smallest eigenvalues (ascending) for every noise dimension d
    csum = np.cumsum(lam, axis=-1)  # [Fk, M]
    clog = np.cumsum(np.log(lam), axis=-1)
    d = np.arange(1, m + 1)
    arith = csum / d
    geo = clog / d
    spread = np.log(np.maximum(arith, 1e-20)) - geo  # [Fk, M], >= 0
    fk = lam.shape[0]
    crit = np.empty(k_max + 1)
    for k in range(k_max + 1):
        dd = m - k
        ll = s_count * dd * spread[:, dd - 1].sum()
        if criterion == "mdl":
            pen = 0.5 * k * (2 * m - k) * fk * np.log(s_count)
        elif criterion == "aic":
            pen = k * (2 * m - k) * fk
        else:
            raise ValueError(f"criterion={criterion!r}")
        crit[k] = ll + pen
    return int(np.argmin(crit))


def _mics_key(mic_positions) -> tuple:
    return tuple(map(tuple, np.asarray(mic_positions, np.float32).tolist()))


@functools.lru_cache(maxsize=8)
def _mic_steering_cached(grid: GridConfig, mics: tuple, cfg: PipelineConfig,
                         bin_stride: int):
    return mic_steering_vectors(grid, np.asarray(mics, np.float32), cfg,
                                bin_stride=bin_stride)


@functools.lru_cache(maxsize=8)
def _freq_steering_cached(grid: GridConfig, mics: tuple, cfg: PipelineConfig,
                          bin_stride: int):
    mics = np.asarray(mics, np.float32)
    pairs = geometry.mic_pairs(mics.shape[0])
    return (*freq_steering_matrices(grid, mics, pairs, cfg,
                                    bin_stride=bin_stride), pairs)


def _grid_peak(scores: torch.Tensor, grid: GridConfig) -> torch.Tensor:
    return srp.grid_peak_xy(
        scores, (grid.height, grid.width),
        (grid.half_cells_x, grid.half_cells_y), grid.cells_per_m,
        refine=True)


def localize_music(
    frames: torch.Tensor,
    mic_positions: np.ndarray,
    grid: GridConfig,
    cfg: PipelineConfig,
    *,
    n_sources: int | str = 1,
    bin_stride: int = 8,
    diagonal_loading: float = 0.0,
    coherent: bool = False,
    focus_radius_cells: int = 3,
) -> dict:
    """Snapshot frames [S, M, N] on their device -> wideband MUSIC grid
    spectrum 'scores' [G] and its refined peak 'xy_grid' [2], with
    'n_sources'.  ``n_sources='auto'`` counts them first
    (:func:`estimate_n_sources`, reported raw as 'n_sources_estimated', 0
    for silence; MUSIC runs with at least 1).  ``coherent=True`` runs CSSM
    (:func:`music_spectrum_coherent`) on the sector around the
    ``n_sources`` peaks of the Bartlett spectrum, read back to the host;
    set ``cfg.band_hz`` for it."""
    n_estimated = None
    if n_sources == "auto":
        n_estimated = estimate_n_sources(
            frames, cfg, bin_stride=bin_stride,
            diagonal_loading=max(diagonal_loading, 1e-3))
        n_sources = max(1, n_estimated)
    steer, bins, w = _mic_steering_cached(
        grid, _mics_key(mic_positions), cfg, bin_stride)
    re, im = _spectra(frames, cfg)
    if coherent:
        prelim = conventional_spectrum(re, im, steer, bins, w)
        cells = select_focus_cells(
            prelim.cpu().numpy(), (grid.height, grid.width), n_sources,
            radius_cells=focus_radius_cells)
        scores = music_spectrum_coherent(
            re, im, steer, bins, w, cells, n_sources=n_sources,
            diagonal_loading=max(diagonal_loading, 1e-3))
    else:
        scores = music_spectrum(re, im, steer, bins, w, n_sources=n_sources,
                                diagonal_loading=diagonal_loading)
    out = {"scores": scores, "xy_grid": _grid_peak(scores[None], grid)[0],
           "n_sources": n_sources}
    if n_estimated is not None:
        out["n_sources_estimated"] = n_estimated
    return out


def localize_mvdr(
    frames: torch.Tensor,
    mic_positions: np.ndarray,
    grid: GridConfig,
    cfg: PipelineConfig,
    *,
    bin_stride: int = 8,
    diagonal_loading: float = 1e-2,
) -> dict:
    """Snapshot frames [S, M, N] on their device -> MVDR grid spectrum
    'scores' [G] and its refined peak 'xy_grid' [2]."""
    steer, bins, w = _mic_steering_cached(
        grid, _mics_key(mic_positions), cfg, bin_stride)
    re, im = _spectra(frames, cfg)
    scores = mvdr_spectrum(re, im, steer, bins, w,
                           diagonal_loading=diagonal_loading)
    return {"scores": scores, "xy_grid": _grid_peak(scores[None], grid)[0]}


def localize_freq(
    frames: torch.Tensor,
    mic_positions: np.ndarray,
    grid: GridConfig,
    cfg: PipelineConfig,
    *,
    bin_stride: int = 4,
) -> dict:
    """Frames [..., M, N] on their device -> frequency-steered SRP 'scores'
    [..., G] (PHAT per ``cfg.phat``) and the refined grid peak 'xy_grid'
    [..., 2]."""
    steer_c, steer_s, bins, pairs = _freq_steering_cached(
        grid, _mics_key(mic_positions), cfg, bin_stride)
    dev = frames.device
    re, im = _spectra(frames, cfg)
    rr, jj = mxu_fft.cross_power_reim(
        re, im, device_constant(pairs, dev, torch.int64), phat=cfg.phat,
        phat_eps=cfg.phat_eps)
    scores = srp_scores_freq(rr, jj, device_constant(steer_c, dev),
                             device_constant(steer_s, dev), bins)
    return {"scores": scores, "xy_grid": _grid_peak(scores, grid)}
