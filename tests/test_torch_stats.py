"""PyTorch port, spectral statistics and unfused GCC engines: each function
of ``ops/xcorr.py`` and ``ops/mxu_fft.py`` that the hands-free
configuration and the other engines use, against its JAX counterpart on
the same numpy inputs (chirp scenes and white noise made from a seed).

Tolerances, and why:
- smoothing and coherence: 1e-5 relative; both sum the same terms in f32,
  in the same order or (matmul forms) in the BLAS's order;
- band weights and pair subsets: exact (0/1 decisions; these scenes hold
  no bin within rounding of its threshold);
- correlograms: 1e-5 of scale (f32 FFT / matmul rounding), 2e-3 for bf16
  operands (the rounding of the operands is the same, the products' sums
  are not);
- phase-slope TDOA: 1e-4 samples (f32 atan2 on both sides).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import localizer as jloc
from audio_triangulation_tpu.ops import (mxu_fft as jmxu, window as jwin,
                                         xcorr as jx)
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import mxu_fft as tmxu, xcorr as tx

MICS = jgeo.square_array(0.3)
PAIRS = jgeo.mic_pairs(4)


def _frames(b=6, noise=0.01, seed=3):
    """Conditioned chirp frames [b, 4, 1024] f32 (shift8, DPSS window)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (b, 2))
    v = np.concatenate([xy, np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    raw = jsynth.synth_scene(src, MICS, noise_rms=noise, seed=seed)
    x = raw - raw.mean(axis=-1, keepdims=True)
    return (x * 256.0 * jwin.dpss_window(1024)).astype(np.float32)


def _spectra(x, fft_length=1024):
    return np.fft.rfft(x, n=fft_length, axis=-1).astype(np.complex64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, ref):
    """max |got - ref| / max |ref| (real or complex)."""
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


def test_rfft_frames_matches_reference():
    x = _frames(b=2)
    for n_fft in (1024, 2048):
        got = tx.rfft_frames(_t(x), n_fft).numpy()
        ref = np.asarray(jx.rfft_frames(jnp.asarray(x), n_fft))
        assert got.dtype == np.complex64 and got.shape == ref.shape
        assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("half_width", [0, 3, 16])
def test_freq_smooth_matches_reference(half_width):
    power = np.abs(_spectra(_frames(b=2))) ** 2  # spans ~1e18
    got = tx.freq_smooth(_t(power), half_width).numpy()
    ref = np.asarray(jx.freq_smooth(jnp.asarray(power), half_width))
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    mat = tx.freq_smooth_matmul(_t(power), half_width).numpy()
    np.testing.assert_allclose(mat, ref, rtol=1e-5)
    np.testing.assert_array_equal(tx._smooth_matrix(513, max(half_width, 1)),
                                  jx._smooth_matrix(513, max(half_width, 1)))


def test_smoothed_cross_stats_matches_reference():
    spec = _spectra(_frames())
    got = tx.smoothed_cross_stats(_t(spec), _t(PAIRS), 16, eps=1e-12)
    ref = jx.smoothed_cross_stats(jnp.asarray(spec), jnp.asarray(PAIRS), 16,
                                  eps=1e-12)
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) < 1e-5
    g2 = got[3].numpy()
    assert g2.min() >= 0.0 and g2.max() <= 1.0


@pytest.mark.parametrize("noise", ["chirp", "white"])
def test_auto_band_weight_matches_reference(noise):
    """On a chirp the coherent band is picked; on white noise the coherence
    is flat, too few bins clear the threshold, and the weight falls back
    to the whole interior (DC and Nyquist out)."""
    if noise == "chirp":
        x = _frames()
    else:
        x = np.random.default_rng(5).normal(size=(6, 4, 1024)).astype(
            np.float32)
    spec = _spectra(x)
    cfg = dict(phat=True, fft_pad_mode="circular", band_hz="auto",
               auto_band_min_bins=64 if noise == "white" else 8)
    got = tx.auto_band_weight(_t(spec), _t(PAIRS),
                              tcfg.PipelineConfig(**cfg)).numpy()
    ref = np.asarray(jx.auto_band_weight(
        jnp.asarray(spec), jnp.asarray(PAIRS), jcfg.PipelineConfig(**cfg)))
    np.testing.assert_array_equal(got, ref)
    interior = np.r_[0.0, np.ones(511), 0.0]
    if noise == "white":
        np.testing.assert_array_equal(got, np.broadcast_to(interior,
                                                           got.shape))
    else:
        assert 8 <= got.sum(axis=-1).min() and got.sum(axis=-1).max() < 511


@pytest.mark.parametrize("n_fft", [1024, 2048], ids=["F513", "F1025_dec4"])
def test_auto_band_weight_reim_matches_reference(n_fft):
    spec = _spectra(_frames(), n_fft)
    re, im = spec.real.copy(), spec.imag.copy()
    cfg = dict(band_hz="auto", fft_size=n_fft)
    got = tx.auto_band_weight_reim(_t(re), _t(im), _t(PAIRS),
                                   tcfg.PipelineConfig(**cfg)).numpy()
    ref = np.asarray(jx.auto_band_weight_reim(
        jnp.asarray(re), jnp.asarray(im), PAIRS, jcfg.PipelineConfig(**cfg)))
    np.testing.assert_array_equal(got, ref)
    assert got[:, 0].max() == 0 and got[:, -1].max() == 0


@pytest.mark.parametrize("n_pairs", [6, 64, 66, 2016])
def test_band_pair_subset_matches_both_reference_policies(n_pairs):
    """The port's one helper against ``xcorr.band_pair_subset`` and the
    copy of its policy inlined in ``mxu_fft.autoband_scale_reim``."""
    pairs = np.stack([np.arange(n_pairs), np.arange(n_pairs) + 1], axis=1)
    got = tx.band_pair_subset(pairs)
    np.testing.assert_array_equal(got, jx.band_pair_subset(pairs))
    inline = (np.unique(np.linspace(0, n_pairs - 1, 64).round().astype(
        np.int64)) if n_pairs > 64 else np.arange(n_pairs))
    np.testing.assert_array_equal(got, pairs[inline])
    np.testing.assert_array_equal(
        tx.band_pair_subset(torch.from_numpy(pairs)).numpy(), got)
    assert len(got) == min(n_pairs, 64)


@pytest.mark.parametrize("mics", [4, 12], ids=["6_pairs", "66_pairs"])
def test_autoband_scale_reim_matches_reference(mics):
    """Scaling the raw spectra by sqrt(w); at 66 pairs the weight comes
    from the 64-pair subset."""
    rng = np.random.default_rng(11)
    arr = jgeo.circular_array(mics, 0.3)
    xy = rng.uniform(-0.9, 0.9, (3, 2))
    src = np.concatenate([xy, np.full((3, 1), 1.2)], axis=1)
    x = jsynth.synth_scene(src, arr, noise_rms=0.01, seed=2) * 256.0
    spec = _spectra(x.astype(np.float32))
    re, im = spec.real.copy(), spec.imag.copy()
    pairs = jgeo.mic_pairs(mics)
    kw = dict(band_hz="auto", fft_pad_mode="circular")
    got = tmxu.autoband_scale_reim(_t(re), _t(im), _t(pairs),
                                   tcfg.PipelineConfig(**kw))
    ref = jmxu.autoband_scale_reim(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(pairs),
                                   jcfg.PipelineConfig(**kw))
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) < 1e-6


@pytest.mark.parametrize("mask", ["none", "static", "auto"])
def test_tdoa_phase_slope_matches_reference(mask):
    x = _frames()
    spec = _spectra(x)
    cfg = tcfg.PipelineConfig(fft_pad_mode="circular", band_hz=(800.0,
                                                                6000.0))
    coarse = np.asarray(jx.best_lag(jx.xcorr_fft(
        jnp.asarray(x), jnp.asarray(PAIRS),
        jcfg.PipelineConfig(fft_pad_mode="circular", phat=True)), 46))
    wm = {"none": None, "static": tx.band_mask(cfg),
          "auto": np.array(jx.auto_band_weight(
              jnp.asarray(spec), jnp.asarray(PAIRS),
              jcfg.PipelineConfig(band_hz="auto")))[:, None, :]}[mask]
    got = tx.tdoa_phase_slope(_t(spec), _t(PAIRS), _t(coarse),
                              fft_length=1024, weight_mask=wm).numpy()
    ref = np.asarray(jx.tdoa_phase_slope(
        jnp.asarray(spec), jnp.asarray(PAIRS), jnp.asarray(coarse),
        fft_length=1024,
        weight_mask=None if wm is None else jnp.asarray(wm)))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.abs(got - coarse).max() <= 2.0


ENGINES = {
    # (PipelineConfig kwargs, tolerance of the correlograms / scale)
    "fft_phat": (dict(xcorr_mode="fft", phat=True), 1e-5),
    "fft_phat_beta": (dict(xcorr_mode="fft", phat=True, phat_beta=0.6), 1e-5),
    "fft_static_band": (dict(xcorr_mode="fft", band_hz=(800.0, 6000.0)), 1e-5),
    "fft_auto_band": (dict(xcorr_mode="fft", phat=True, band_hz="auto"), 1e-5),
    "scot": (dict(weighting="scot"), 1e-5),
    "roth": (dict(weighting="roth"), 1e-5),
    # 'ml' divides by 1 - g2 >= 1e-4: near-coherent bins amplify f32
    # rounding of g2 up to 1e4-fold
    "ml": (dict(weighting="ml"), 2e-3),
    "time": (dict(xcorr_mode="time"), 1e-5),
    "mxu_auto_band": (dict(phat=True, band_hz="auto"), 1e-5),
    "mxu_auto_band_circular": (dict(band_hz="auto",
                                    fft_pad_mode="circular"), 1e-5),
    "mxu_phat_beta": (dict(phat=True, phat_beta=0.5), 1e-5),
    "mxu_2mic_phat_beta": (dict(phat=True, phat_beta=0.7), 1e-5),
    "mxu_bf16": (dict(phat=True, matmul_dtype="bfloat16"), 2e-3),
    "mxu_bf16_crop": (dict(matmul_dtype="bfloat16", band_hz=(800.0, 6000.0),
                           band_crop=True), 2e-3),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_correlate_frames_engines_match_reference(name):
    """Each unfused engine through ``correlate_frames``, as the localizer
    routes it off the kernel."""
    from audio_triangulation_tpu_torch.models import localizer as tloc

    kw, tol = ENGINES[name]
    x = _frames(b=3)
    pairs = PAIRS
    if name.startswith("mxu_2mic"):
        x, pairs = x[:, :2], jgeo.mic_pairs(2)
    ref = np.asarray(jloc.correlate_frames(
        jnp.asarray(x), jloc.LocalizerParams(None, jnp.asarray(pairs), None,
                                             None, None),
        jcfg.PipelineConfig(**kw)))
    got = tloc.correlate_frames(
        _t(x), tloc.LocalizerParams(None, _t(pairs), None, None, None),
        tcfg.PipelineConfig(**kw)).numpy()
    assert got.shape == ref.shape == (3, len(pairs), 93)
    assert _rel(got, ref) < tol


def test_gcc_weight_and_cross_power_match_reference():
    spec = _spectra(_frames(b=2))
    r_t = tx.cross_power(_t(spec), _t(PAIRS), phat=True, phat_beta=0.8)
    r_j = jx.cross_power(jnp.asarray(spec), jnp.asarray(PAIRS), phat=True,
                         phat_beta=0.8)
    assert _rel(r_t.numpy(), r_j) < 1e-5
    for w in ("roth", "scot", "ml"):
        got = tx.gcc_weight(_t(spec), _t(PAIRS), w).numpy()
        ref = np.asarray(jx.gcc_weight(jnp.asarray(spec), jnp.asarray(PAIRS),
                                       w))
        np.testing.assert_allclose(got, ref, rtol=2e-3 if w == "ml" else 1e-5)
    with pytest.raises(ValueError, match="weighting"):
        tx.gcc_weight(_t(spec), _t(PAIRS), "phat")


def test_auto_band_decimated_min_bins_counts_coarse_bins():
    """The 4x decimated estimate counts ``auto_band_min_bins`` in coarse
    bins, as the reference's does."""
    cfg = tcfg.PipelineConfig(band_hz="auto", auto_band_min_bins=40)
    x = np.random.default_rng(2).normal(size=(2, 4, 1024)).astype(np.float32)
    spec = _spectra(x, 2048)
    re, im = _t(spec.real.copy()), _t(spec.imag.copy())
    got = tx.auto_band_weight_reim(re, im, _t(PAIRS), cfg).numpy()
    ref = np.asarray(jx.auto_band_weight_reim(
        jnp.asarray(spec.real), jnp.asarray(spec.imag), PAIRS,
        dataclasses.replace(jcfg.PipelineConfig(band_hz="auto"),
                            auto_band_min_bins=40)))
    np.testing.assert_array_equal(got, ref)
