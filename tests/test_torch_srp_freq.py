"""PyTorch port, ``ops/linalg`` and ``ops/srp_freq`` against the JAX
package's, on the same seeded numpy inputs.

The port computes on complex64 where the reference keeps real block
embeddings, so eigenvectors are never compared (any basis of an
eigenspace, any phase): eigenvalues within 1e-5 of their scale,
projectors and projector quadratic forms within 1e-5, solves within 1e-5
of their scale.  Held exactly: ``restrict_bins_to_band`` and its
refusals, the steering constants, ``select_focus_cells``;
``focusing_matrices`` within 1e-6 (two SVD routines).  On snapshot scenes
of an 8-mic array (the JAX package's ``tests/test_srp_freq.py`` and
``tests/test_source_counting.py`` scenes, 12-24 snapshots, 21 x 21 to
25 x 25 cells): frequency-SRP and Bartlett scores within 1e-4 of their
scale, MVDR spectra within 1e-4 relative, MUSIC and CSSM spectra within
1e-3 relative per cell, or where the denominator M - ||P_sig a||^2 nears
its 1e-6 floor (the source cells: there two fp32 eigensolvers differ most
in relative terms) within 1e-5 P^2, that is the reciprocal within 1e-5
absolute (worst measured: 1.3e-3 relative at a peak of 669, its
reciprocal 2.0e-6 off), the refined peak 'xy_grid' within 2e-4 m where
the top cell is 1e-3 of scale clear of the runner-up, and
``estimate_n_sources`` equal, and equal to the planted count.

MUSIC's M - ||P_sig a||^2 is only as well defined as the per-bin signal
subspace.  The 1e-3 holds where every bin's n-th and (n+1)-th eigenvalues
stand apart (band-limited scenes: the third eigenvalue at most 0.25 of
the second at every bin, asserted).  Where a source has no energy in
some bins (``colored_burst``'s default 600 Hz tilt over the full band) the
subspace there is degenerate and the smallest rounding moves cells by
more than 1e-3, in the reference as in the port.  That scene is held on
its peak cell and on the spectrum's reciprocal, the weighted
noise-subspace power, within 2e-3 (2.5e-4 of ||a||^2 = M = 8): worst
measured 7.1e-4.

Against the same spectrum in float64 the port's fp32 MUSIC is 8.0e-4
relative off over the 800-6,000 Hz band and 9.5e-3 (its reciprocal
5.0e-4) over the full band.  The fp32 eigensolver makes nearly all of it:
fp32 spectra and covariance, the rest in float64, stay within 6e-5
(``chip_precision.py``).  On an H100 cuSOLVER's fp32 eigensolver puts the
card 1.2e-3 and 2.0e-2 (reciprocal 6.0e-4) off float64, so the card and
the CPU, each rounded its own way, part by 4.4e-4 over the band and by
1.7e-2 over the full band.  The ``gpu`` cases hold MUSIC and CSSM on the
card to the CPU path over the band per cell within 1e-3, and MUSIC over
the full band by its reciprocal, within 2e-3 of the CPU's and within
1e-3 of float64's; MVDR and frequency SRP keep their rules."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import linalg as jlinalg
from audio_triangulation_tpu.ops import srp_freq as jsf, xcorr as jx
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import linalg, srp_freq, xcorr

MICS8 = jgeo.circular_array(8, 0.25)
H = 1.2
GRID = dict(half_cells_x=12, half_cells_y=12, cells_per_m=10.0)
GRID8 = dict(half_cells_x=30, half_cells_y=30, cells_per_m=20.0)
BAND = dict(band_hz=(800.0, 6000.0))


def _place(x, y):
    p = np.array([x, y, H])
    return p * (H / np.linalg.norm(p))


def _snapshots(sources, n_snap=12, seed=0, noise=0.02, cutoff_hz=2500.0):
    """[S, 8, 1024] f32: simultaneous sources, a fresh noise draw and
    independent waveforms each snapshot."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(n_snap):
        acc = np.zeros((MICS8.shape[0], 1024))
        for k, src in enumerate(sources):
            sig = jsynth.colored_burst(1024, 50_000.0, cutoff_hz=cutoff_hz,
                                       seed=seed + 100 * s + k)
            acc = acc + jsynth.synth_scene(src, MICS8, signal=sig,
                                           noise_rms=0.0, seed=0)[0]
        out.append(acc + rng.normal(0, noise, acc.shape))
    return np.stack(out).astype(np.float32)


_SCENES = {}


def _scene(name):
    if name not in _SCENES:
        one, two = [_place(0.6, 0.3)], [_place(0.6, 0.3), _place(-0.5, -0.4)]
        _SCENES[name] = {
            "one": lambda: _snapshots(one, n_snap=16, seed=5),
            "two": lambda: _snapshots(two, n_snap=16, seed=5),
            "two_tilted": lambda: _snapshots(two, n_snap=16, seed=5,
                                             cutoff_hz=600.0)}[name]()
    return _SCENES[name]


def _gap_ratio(frames, cfg, n):
    """Largest ratio over bins of the covariance's (n+1)-th to n-th
    largest eigenvalue (eigenvalues in double precision): how well the
    signal subspace is defined."""
    re, im = srp_freq._spectra(torch.from_numpy(frames), cfg)
    bins = xcorr.restrict_bins_to_band(
        np.arange(1, cfg.fft_length // 2, 8), cfg)
    ev = torch.linalg.eigvalsh(srp_freq.spatial_covariance(
        re, im, bins, 0.0).to(torch.complex128))
    return float((ev[:, -n - 1] / ev[:, -n]).max())


def _hermitian(rng, m, n=None):
    x = rng.normal(size=(n or 2 * m, m)) + 1j * rng.normal(
        size=(n or 2 * m, m))
    return ((x.conj().T @ x) / x.shape[0]).astype(np.complex64)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _clear_top(scores, margin=1e-3):
    """Rows [..., G] whose best cell leads the runner-up by ``margin`` of
    the scale."""
    s = np.asarray(scores, np.float64).reshape(-1, np.shape(scores)[-1])
    top2 = np.sort(s, axis=-1)[:, -2:]
    return (top2[:, 1] - top2[:, 0]) > margin * np.abs(s).max()


def _music64(frames, cfg, n_sources):
    """MUSIC's spectrum [G] of snapshot frames on ``GRID`` with every step
    in float64 / complex128 on the CPU: conditioning, DFT, covariance,
    eigh, projection."""
    from audio_triangulation_tpu_torch.models.localizer import (
        condition_frames)
    from audio_triangulation_tpu_torch.ops import window

    steer, bins, w = srp_freq.mic_steering_vectors(
        tcfg.GridConfig(**GRID), MICS8, cfg)
    x = condition_frames(torch.from_numpy(frames).double(), torch.as_tensor(
        window.window_for(cfg), dtype=torch.float64), cfg)
    spec = torch.fft.rfft(x, n=cfg.fft_length, dim=-1)[..., bins]
    spec = spec.permute(2, 0, 1)  # [Fk, S, M]
    r = spec.transpose(-1, -2) @ spec.conj() / spec.shape[1]
    u = torch.linalg.eigh(r)[1][..., -n_sources:]
    p = u.conj().transpose(-1, -2) @ torch.from_numpy(steer).to(
        torch.complex128)
    den = (MICS8.shape[0] - (p.abs() ** 2).sum(-2)).clamp_min(1e-6)
    return (torch.from_numpy(w).double()[:, None] / den).sum(0).numpy()


def _check_spectrum(r, g, rtol=None, scale_tol=None, floor_tol=0.0,
                    where=""):
    """'scores' per cell (``rtol`` relative, or ``scale_tol`` of the scale;
    with ``floor_tol`` a cell may also be off by floor_tol P^2, its
    reciprocal by floor_tol) and 'xy_grid' within 2e-4 m where the peak is
    clear."""
    rs, gs = np.asarray(r["scores"], np.float64), _np(g["scores"])
    assert gs.shape == rs.shape and gs.dtype == np.float32, where
    if rtol is not None:
        bad = np.abs(gs - rs) > rtol * np.abs(rs) + floor_tol * rs * rs
        assert not bad.any(), (where, np.flatnonzero(bad), gs[bad], rs[bad])
    else:
        np.testing.assert_allclose(gs / np.abs(rs).max(),
                                   rs / np.abs(rs).max(), atol=scale_tol,
                                   err_msg=where)
    clear = _clear_top(rs)
    assert clear.any(), where
    rxy = np.asarray(r["xy_grid"]).reshape(-1, 2)
    gxy = _np(g["xy_grid"]).reshape(-1, 2)
    np.testing.assert_allclose(gxy[clear], rxy[clear], atol=2e-4,
                               err_msg=where)


# ----------------------------------------------------------------------
# ops/linalg
# ----------------------------------------------------------------------

@pytest.mark.parametrize("m", [3, 4, 8])
def test_complex_eigh_matches_reference(m):
    """Eigenvalues within 1e-5 of their scale (the reference returns each
    once of its doubled pair), every column an eigenvector, and the
    projector on the top two (three) equal to the reference's."""
    rng = np.random.default_rng(m)
    r = np.stack([_hermitian(rng, m) for _ in range(3)])
    w_ref, v_ref = jlinalg.complex_eigh(jnp.asarray(r))
    w, v = linalg.complex_eigh(torch.from_numpy(r))
    w, v = w.numpy(), v.numpy()
    scale = np.abs(np.asarray(w_ref)).max()
    np.testing.assert_allclose(w / scale, np.asarray(w_ref) / scale,
                               atol=1e-5)
    np.testing.assert_allclose(w / scale, np.linalg.eigvalsh(r) / scale,
                               atol=1e-5)
    resid = np.einsum("bmn,bnk->bmk", r, v) - v * w[:, None, :]
    assert np.abs(resid).max() < 1e-4 * scale
    k = min(3, m - 1)
    v_ref = np.asarray(v_ref)[..., -k:]
    p_ref = v_ref @ v_ref.conj().transpose(0, 2, 1)
    p = v[..., -k:] @ v[..., -k:].conj().transpose(0, 2, 1)
    np.testing.assert_allclose(p, p_ref, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2, 5])
def test_subspace_projector_quadform_matches_reference(k):
    """||U^H a||^2 of the complex basis equals the reference's 0.5
    ||W^H a||^2 of its real-embedded basis (the last 2k columns)."""
    rng = np.random.default_rng(10 + k)
    m = 8
    r = np.stack([_hermitian(rng, m) for _ in range(4)])
    a = (np.exp(1j * rng.uniform(0, 2 * np.pi, (4, m, 37)))
         .astype(np.complex64))
    block = np.block([[r.real, -r.imag], [r.imag, r.real]])
    _, v2 = np.linalg.eigh(block.astype(np.float32))
    w_sig = v2[..., -2 * k:]
    ref = np.asarray(jlinalg.subspace_projector_quadform(
        jnp.asarray(w_sig[:, :m]), jnp.asarray(w_sig[:, m:]),
        jnp.asarray(a.real), jnp.asarray(a.imag)))
    _, v = linalg.complex_eigh(torch.from_numpy(r))
    got = linalg.subspace_projector_quadform(
        v[..., -k:], torch.from_numpy(a)).numpy()
    assert got.shape == ref.shape == (4, 37)
    np.testing.assert_allclose(got / m, ref / m, atol=1e-5)


def test_complex_solve_matches_reference():
    rng = np.random.default_rng(3)
    r = np.stack([_hermitian(rng, 6) + np.eye(6, dtype=np.complex64)
                  for _ in range(5)])
    b = (rng.normal(size=(5, 6, 7))
         + 1j * rng.normal(size=(5, 6, 7))).astype(np.complex64)
    ref = np.asarray(jlinalg.complex_solve(jnp.asarray(r), jnp.asarray(b)))
    got = linalg.complex_solve(torch.from_numpy(r), torch.from_numpy(b))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy() / np.abs(ref).max(),
                               ref / np.abs(ref).max(), atol=1e-5)


# ----------------------------------------------------------------------
# constants
# ----------------------------------------------------------------------

@pytest.mark.parametrize("band", [None, (800.0, 6000.0), (0.0, 25_000.0)])
def test_restrict_bins_to_band_equals_reference(band):
    bins = np.arange(1, 1024, 8)
    j = jx.restrict_bins_to_band(bins, jcfg.PipelineConfig(band_hz=band))
    t = xcorr.restrict_bins_to_band(bins, tcfg.PipelineConfig(band_hz=band))
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("band,match", [
    ("auto", "static bin set"), ((1000.0, 1010.0), "covers none")])
def test_restrict_bins_to_band_refusals(band, match):
    bins = np.arange(1, 1024, 64)
    for mod, cfg in ((jx, jcfg), (xcorr, tcfg)):
        with pytest.raises(ValueError, match=match):
            mod.restrict_bins_to_band(bins, cfg.PipelineConfig(band_hz=band))


@pytest.mark.parametrize("band", [{}, BAND])
def test_steering_constants_equal_reference(band):
    grid = dict(half_cells_x=5, half_cells_y=4, cells_per_m=8.0)
    pairs = jgeo.mic_pairs(8)
    for stride in (4, 8):
        j = jsf.freq_steering_matrices(
            jcfg.GridConfig(**grid), MICS8, pairs,
            jcfg.PipelineConfig(phat=True, **band), bin_stride=stride)
        t = srp_freq.freq_steering_matrices(
            tcfg.GridConfig(**grid), MICS8, pairs,
            tcfg.PipelineConfig(phat=True, **band), bin_stride=stride)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
        j = jsf.mic_steering_vectors(jcfg.GridConfig(**grid), MICS8,
                                     jcfg.PipelineConfig(**band),
                                     bin_stride=stride)
        t = srp_freq.mic_steering_vectors(tcfg.GridConfig(**grid), MICS8,
                                          tcfg.PipelineConfig(**band),
                                          bin_stride=stride)
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)


def test_focusing_and_sector_selection_match_reference():
    rng = np.random.default_rng(4)
    steer, _, _ = srp_freq.mic_steering_vectors(
        tcfg.GridConfig(**GRID), MICS8, tcfg.PipelineConfig(**BAND))
    spec = rng.normal(size=625)
    spec[100] += 9.0
    spec[500] += 8.0
    for n_peaks in (1, 2, 3):
        cells = srp_freq.select_focus_cells(spec, (25, 25), n_peaks)
        np.testing.assert_array_equal(
            cells, jsf.select_focus_cells(spec, (25, 25), n_peaks))
        t = srp_freq.focusing_matrices(steer, 4, cells)
        np.testing.assert_allclose(
            t, jsf.focusing_matrices(steer, 4, cells), atol=1e-6)
        eye = np.einsum("fij,fkj->fik", t, t.conj())
        np.testing.assert_allclose(eye, np.broadcast_to(np.eye(8), eye.shape),
                                   atol=1e-5)


# ----------------------------------------------------------------------
# spectra and their entry points
# ----------------------------------------------------------------------

@pytest.mark.parametrize("phat", [True, False])
def test_localize_freq_matches_reference(phat):
    frames = _scene("one")[:3]
    r = jsf.localize_freq(jnp.asarray(frames), MICS8,
                          jcfg.GridConfig(**GRID),
                          jcfg.PipelineConfig(phat=phat))
    g = srp_freq.localize_freq(torch.from_numpy(frames), MICS8,
                               tcfg.GridConfig(**GRID),
                               tcfg.PipelineConfig(phat=phat))
    assert g["scores"].shape == (3, 625) and g["xy_grid"].shape == (3, 2)
    _check_spectrum(r, g, scale_tol=1e-4, where=f"phat={phat}")


@pytest.mark.parametrize("scene", ["one", "two"])
def test_localize_mvdr_matches_reference(scene):
    frames = _scene(scene)
    r = jsf.localize_mvdr(jnp.asarray(frames), MICS8,
                          jcfg.GridConfig(**GRID), jcfg.PipelineConfig())
    g = srp_freq.localize_mvdr(torch.from_numpy(frames), MICS8,
                               tcfg.GridConfig(**GRID), tcfg.PipelineConfig())
    _check_spectrum(r, g, rtol=1e-4, where=scene)
    assert min(np.linalg.norm(_np(g["xy_grid"]) - xy)
               for xy in ([0.6, 0.3], [-0.5, -0.4])) < 0.15


@pytest.mark.parametrize("scene,n", [("one", 1), ("two", 2)])
def test_localize_music_matches_reference(scene, n):
    frames = _scene(scene)
    assert _gap_ratio(frames, tcfg.PipelineConfig(**BAND), n) < 0.25
    r = jsf.localize_music(jnp.asarray(frames), MICS8,
                           jcfg.GridConfig(**GRID),
                           jcfg.PipelineConfig(**BAND), n_sources=n)
    g = srp_freq.localize_music(torch.from_numpy(frames), MICS8,
                                tcfg.GridConfig(**GRID),
                                tcfg.PipelineConfig(**BAND), n_sources=n)
    assert g["n_sources"] == r["n_sources"] == n
    _check_spectrum(r, g, rtol=1e-3, floor_tol=1e-5, where=f"{scene} n={n}")
    for xy in ([0.6, 0.3], [-0.5, -0.4])[:n]:
        cells = _top_cells(_np(g["scores"]), n)
        assert min(np.linalg.norm(c - xy) for c in cells) < 0.15


def _top_cells(scores, n, grid=GRID, suppress=8):
    """The n strongest cells (x, y) of a spectrum on ``grid``, each hiding
    the cells within ``suppress`` of it (the JAX package's test helper)."""
    g = tcfg.GridConfig(**grid)
    flat = np.asarray(scores, np.float64).copy()
    rr, cc = np.meshgrid(np.arange(g.height), np.arange(g.width),
                         indexing="ij")
    out = []
    for _ in range(n):
        r, c = divmod(int(np.argmax(flat)), g.width)
        out.append(np.array([(c - g.half_cells_x) / g.cells_per_m,
                             (g.half_cells_y - r) / g.cells_per_m]))
        flat[((np.abs(rr - r) < suppress)
              & (np.abs(cc - c) < suppress)).reshape(-1)] = -np.inf
    return out


def test_localize_music_tilted_full_band():
    """The degenerate scene: sources with no energy above a few kHz, the
    full band.  The peak where clear, and the reciprocal of the spectrum
    within 2e-3 per cell (see the module docstring)."""
    frames = _scene("two_tilted")
    assert _gap_ratio(frames, tcfg.PipelineConfig(), 2) > 0.9
    r = jsf.localize_music(jnp.asarray(frames), MICS8,
                           jcfg.GridConfig(**GRID), jcfg.PipelineConfig(),
                           n_sources=2)
    g = srp_freq.localize_music(torch.from_numpy(frames), MICS8,
                                tcfg.GridConfig(**GRID),
                                tcfg.PipelineConfig(), n_sources=2)
    rs, gs = np.asarray(r["scores"], np.float64), _np(g["scores"])
    np.testing.assert_allclose(1.0 / gs, 1.0 / rs, atol=2e-3, rtol=0)
    assert _clear_top(rs).all() and gs.argmax() == rs.argmax()


@pytest.mark.parametrize("band", [True, False], ids=["800_6000hz",
                                                    "full_band"])
def test_music_fp32_within_its_rounding_of_float64(band):
    """The port's fp32 MUSIC against the same spectrum in float64: over
    the 800-6,000 Hz band within 1e-3 relative per cell (worst measured
    8.0e-4, at the peak); over the full band, where some bins' subspaces
    are degenerate, its reciprocal within 1e-3 (worst measured 5.0e-4).
    The fp32 eigensolver makes nearly all of it: the spectra and the
    covariance in fp32, the rest in float64, stay within 6e-5 relative
    (``chip_precision.py``)."""
    frames = _scene("two")
    cfg = tcfg.PipelineConfig(**(BAND if band else {}))
    g = _np(srp_freq.localize_music(torch.from_numpy(frames), MICS8,
                                    tcfg.GridConfig(**GRID), cfg,
                                    n_sources=2)["scores"])
    ref = _music64(frames, cfg, 2)
    if band:
        np.testing.assert_allclose(g, ref, rtol=1e-3)
    else:
        np.testing.assert_allclose(1.0 / g, 1.0 / ref, atol=1e-3, rtol=0)
    assert _clear_top(ref).all() and g.argmax() == ref.argmax()


def test_music_loading_and_bartlett_match_reference():
    """MUSIC with diagonal loading, and the Bartlett preliminary of CSSM,
    on their own."""
    frames = _scene("two")
    cfg = tcfg.PipelineConfig(**BAND)
    steer, bins, w = srp_freq.mic_steering_vectors(
        tcfg.GridConfig(**GRID), MICS8, cfg)
    re, im = srp_freq._spectra(torch.from_numpy(frames), cfg)
    jre, jim = jnp.asarray(re.numpy()), jnp.asarray(im.numpy())
    ref = np.asarray(jsf.music_spectrum(jre, jim, steer, bins, w,
                                        n_sources=2, diagonal_loading=1e-2))
    got = srp_freq.music_spectrum(re, im, steer, bins, w, n_sources=2,
                                  diagonal_loading=1e-2).numpy()
    assert (np.abs(got - ref) <= 1e-3 * ref + 1e-5 * ref * ref).all()
    ref = np.asarray(jsf.conventional_spectrum(jre, jim, steer, bins, w))
    got = srp_freq.conventional_spectrum(re, im, steer, bins, w).numpy()
    np.testing.assert_allclose(got / np.abs(ref).max(),
                               ref / np.abs(ref).max(), atol=1e-4)


def _coherent_pair(n_snap=16, seed=11, delay=7, gain_b=0.8):
    """tests/test_srp_freq.py's CSSM scene: the second source radiates a
    delayed copy of the first's signal (a specular reflection)."""
    rng = np.random.default_rng(seed)
    frames = []
    for s in range(n_snap):
        sig = jsynth.colored_burst(1024, 50_000.0, seed=seed + 31 * s)
        fa = jsynth.synth_scene(_place(0.6, 0.3), MICS8, signal=sig,
                                noise_rms=0.0, seed=0)[0]
        fb = jsynth.synth_scene(_place(-0.5, -0.4), MICS8,
                                signal=gain_b * np.roll(sig, delay),
                                noise_rms=0.0, seed=0)[0]
        frames.append(fa + fb + rng.normal(0, 0.01, fa.shape))
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("scene,n", [("one", 1), ("coherent", 2)])
def test_localize_music_coherent_matches_reference(scene, n):
    """CSSM: the Bartlett preliminary read back, the same focusing sector,
    the focused spectrum within MUSIC's tolerance.  The coherent pair on
    the JAX package's 61 x 61 grid (its focusing sector is 3 cells)."""
    frames = _coherent_pair() if scene == "coherent" else _scene(scene)
    grid = GRID8 if scene == "coherent" else GRID
    r = jsf.localize_music(jnp.asarray(frames), MICS8,
                           jcfg.GridConfig(**grid),
                           jcfg.PipelineConfig(**BAND), n_sources=n,
                           coherent=True)
    g = srp_freq.localize_music(torch.from_numpy(frames), MICS8,
                                tcfg.GridConfig(**grid),
                                tcfg.PipelineConfig(**BAND), n_sources=n,
                                coherent=True)
    _check_spectrum(r, g, rtol=1e-3, floor_tol=1e-5, where=f"cssm {scene}")
    for xy in ([0.6, 0.3], [-0.5, -0.4])[:n]:
        cells = _top_cells(_np(g["scores"]), n, grid)
        assert min(np.linalg.norm(c - xy) for c in cells) < 0.15


def _counting_snaps(k, n_snap=24, seed=0):
    """tests/test_source_counting.py's scene: k of three sources."""
    mics = jgeo.circular_array(8, 0.25)
    srcs = [_place(0.6, -0.4), _place(-0.7, 0.5), _place(0.1, 0.9)][:k]
    rng = np.random.default_rng(seed)
    out = []
    for t in range(n_snap):
        fr = np.zeros((8, 1024))
        for j, src in enumerate(srcs):
            sig = jsynth.colored_burst(1024, 50_000.0, seed=100 * t + j)
            fr = fr + jsynth.synth_scene(src, mics, signal=sig,
                                         noise_rms=0.0, seed=0)[0]
        out.append(fr + rng.normal(0, 0.02, fr.shape))
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("k,criterion,kw", [
    (0, "mdl", {}), (1, "mdl", {}), (2, "mdl", {}), (3, "mdl", {}),
    (2, "aic", {}), (1, "mdl", BAND), (2, "mdl", {"max_sources": 1})])
def test_estimate_n_sources_matches_reference(k, criterion, kw):
    frames = _counting_snaps(k)
    band = {"band_hz": kw["band_hz"]} if "band_hz" in kw else {}
    extra = {"max_sources": kw["max_sources"]} if "max_sources" in kw else {}
    ref = jsf.estimate_n_sources(jnp.asarray(frames),
                                 jcfg.PipelineConfig(**band),
                                 criterion=criterion, **extra)
    got = srp_freq.estimate_n_sources(torch.from_numpy(frames),
                                      tcfg.PipelineConfig(**band),
                                      criterion=criterion, **extra)
    assert isinstance(got, int)
    assert got == ref == min(k, extra.get("max_sources", k))


def test_music_auto_order_matches_reference():
    """``n_sources='auto'``: the raw count reported, MUSIC run with it."""
    frames = _counting_snaps(1, n_snap=16)
    grid = dict(half_cells_x=10, half_cells_y=10, cells_per_m=12.0)
    r = jsf.localize_music(jnp.asarray(frames), MICS8,
                           jcfg.GridConfig(**grid), jcfg.PipelineConfig(),
                           n_sources="auto")
    g = srp_freq.localize_music(torch.from_numpy(frames), MICS8,
                                tcfg.GridConfig(**grid),
                                tcfg.PipelineConfig(), n_sources="auto")
    assert g["n_sources_estimated"] == r["n_sources_estimated"] == 1
    assert g["n_sources"] == 1
    # the full band of a 600 Hz-tilted burst: held as the degenerate scene
    assert _gap_ratio(frames, tcfg.PipelineConfig(), 1) > 0.5
    rs, gs = np.asarray(r["scores"], np.float64), _np(g["scores"])
    np.testing.assert_allclose(1.0 / gs, 1.0 / rs, atol=2e-3, rtol=0)
    assert _clear_top(rs).all()
    np.testing.assert_allclose(_np(g["xy_grid"]), np.asarray(r["xy_grid"]),
                               atol=2e-4)
    silent = _counting_snaps(0, n_snap=16)
    g = srp_freq.localize_music(torch.from_numpy(silent), MICS8,
                                tcfg.GridConfig(**grid),
                                tcfg.PipelineConfig(), n_sources="auto")
    assert g["n_sources_estimated"] == 0 and g["n_sources"] == 1


def test_refusals_match_reference():
    frames = torch.from_numpy(_scene("one")[:4])
    grid = tcfg.GridConfig(half_cells_x=4, half_cells_y=4, cells_per_m=8.0)
    for n in (0, 8):
        with pytest.raises(ValueError, match="n_sources"):
            srp_freq.localize_music(frames, MICS8, grid,
                                    tcfg.PipelineConfig(), n_sources=n)
    with pytest.raises(ValueError, match="criterion"):
        srp_freq.estimate_n_sources(frames, tcfg.PipelineConfig(),
                                    criterion="bic")
    with pytest.raises(ValueError, match="static bin set"):
        srp_freq.localize_mvdr(frames, MICS8, grid,
                               tcfg.PipelineConfig(band_hz="auto"))


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["music", "music_full_band", "music_auto",
                                  "cssm", "mvdr", "freq"])
def test_spectra_card_match_cpu(cuda_device, what):
    """MUSIC over the 800-6,000 Hz band and CSSM per cell within 1e-3
    relative (MUSIC worst measured 4.4e-4 on an H100); MUSIC over the full
    band, with 2 sources or their count, by its reciprocal: within 2e-3 of
    the CPU's and 1e-3 of float64's (see the module docstring); MVDR and
    frequency SRP by their rules."""
    frames = _scene("two")
    grid = tcfg.GridConfig(**GRID)
    full, band = tcfg.PipelineConfig(), tcfg.PipelineConfig(**BAND)
    fn, cfg = {
        "music": (lambda f, c: srp_freq.localize_music(
            f, MICS8, grid, c, n_sources=2), band),
        "music_full_band": (lambda f, c: srp_freq.localize_music(
            f, MICS8, grid, c, n_sources=2), full),
        "music_auto": (lambda f, c: srp_freq.localize_music(
            f, MICS8, grid, c, n_sources="auto"), full),
        "cssm": (lambda f, c: srp_freq.localize_music(
            f, MICS8, grid, c, n_sources=2, coherent=True), band),
        "mvdr": (lambda f, c: srp_freq.localize_mvdr(f, MICS8, grid, c),
                 full),
        "freq": (lambda f, c: srp_freq.localize_freq(
            f, MICS8, grid, c), dataclasses.replace(full, phat=True)),
    }[what]
    cpu = fn(torch.from_numpy(frames), cfg)
    card = fn(torch.from_numpy(frames).to(cuda_device), cfg)
    assert card["scores"].is_cuda
    r = {k: v.numpy() if isinstance(v, torch.Tensor) else v
         for k, v in cpu.items()}
    if what in ("music_full_band", "music_auto"):
        assert card["n_sources"] == r["n_sources"] == 2
        rs, gs = r["scores"].astype(np.float64), _np(card["scores"])
        np.testing.assert_allclose(1.0 / gs, 1.0 / rs, atol=2e-3, rtol=0)
        ref = _music64(frames, cfg, 2)
        np.testing.assert_allclose(1.0 / gs, 1.0 / ref, atol=1e-3, rtol=0)
        clear = _clear_top(rs)
        assert clear.all() and gs.argmax() == rs.argmax(), what
        return
    _check_spectrum(r, card, where=what, **{
        "music": {"rtol": 1e-3}, "cssm": {"rtol": 1e-3},
        "mvdr": {"rtol": 1e-4}, "freq": {"scale_tol": 1e-4}}[what])
