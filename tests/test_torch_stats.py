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
from audio_triangulation_tpu_torch.ops.cuda import _build
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel as tgcc
from audio_triangulation_tpu_torch.ops.cuda import srp_kernel as tsrpk

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


# ---------------------------------------------------------------------------
# the fused stats mode's synthesis stage in the kernel's arithmetic

SPLIT_STATS = {
    "auto_hybrid": (4, dict(phat=True, band_hz="auto",
                            subsample_method="hybrid")),
    "hybrid_fullband": (4, dict(phat=True, subsample_method="hybrid")),
    "auto_nophat": (4, dict(band_hz="auto")),
    "linear_auto_phase": (4, dict(phat=True, band_hz="auto",
                                  subsample_method="phase",
                                  fft_pad_mode="linear")),
    "2mic_auto_hybrid": (2, dict(phat=True, band_hz="auto",
                                 subsample_method="hybrid")),
}


def _stats_operands(m, kw, b=8):
    mics = (MICS if m == 4
            else np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32))
    rng = np.random.default_rng(7)
    planes = rng.uniform(-1.2, 1.2, (b, 2))
    src = np.stack([np.array([x, y, 1.2]) * (1.2 / np.linalg.norm([x, y, 1.2]))
                    for x, y in planes])
    frames = torch.from_numpy(jsynth.synth_scene(
        src, mics, noise_rms=0.02, seed=1).astype(np.float32))
    cfg = tcfg.PipelineConfig(**{"fft_pad_mode": "circular", **kw})
    win = torch.from_numpy(np.asarray(jwin.dpss_window(1024)))
    pairs = torch.from_numpy(jgeo.mic_pairs(m))
    win_gain, mats = tgcc.operands(frames, win, cfg)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
                taper_denom=cfg.taper_denom)
    return cfg, frames, win, pairs, win_gain, mats, args


@pytest.mark.parametrize("case", sorted(SPLIT_STATS))
def test_stats_split_reference_against_float64(case):
    """The stats mode with its synthesis as a split-fp32 product against the
    all-float64 plain version: the synthesis stage alone (float64 spectra
    and statistics in front of it) within 2e-5 of scale with equal shifts;
    the whole f32 path within 1e-4 of scale with shifts equal on rows whose
    two best values are clear of that."""
    m, kw = SPLIT_STATS[case]
    cfg, frames, _, pairs, win_gain, mats, args = _stats_operands(m, kw)
    sp = tgcc.stats_params(cfg, True)
    ops64 = (frames.double(), win_gain.double(), mats.to(torch.float64),
             pairs, sp)
    ref = tgcc.gcc_stats_reference(*ops64, **args, with_peaks=True)
    stage = tgcc.gcc_stats_reference(*ops64, **args, with_peaks=True,
                                     split=True)
    scale = float(ref[0].abs().max())
    assert stage[0].dtype == torch.float32
    assert float((stage[0].double() - ref[0]).abs().max()) <= 2e-5 * scale
    top2 = ref[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3 * scale
    assert int(clear.sum()) * 2 > clear.numel()
    assert not bool(((stage[1] != ref[1]) & clear).any())
    whole = tgcc.gcc_stats_reference(frames, win_gain, mats, pairs, sp,
                                     **args, with_peaks=True, split=True)
    assert float((whole[0].double() - ref[0]).abs().max()) <= 1e-4 * scale
    assert not bool(((whole[1] != ref[1]) & clear).any())


@pytest.mark.parametrize("case", ["auto_hybrid", "hybrid_fullband",
                                  "2mic_auto_hybrid"])
def test_stats_split_reference_matches_pallas_interpret(case):
    """The same against the JAX package's fused kernel in interpret mode on
    the same frames: correlograms within 2e-5 of scale (f32 sums there,
    split-fp32 sums here), shifts equal, tdoa within 1e-4 samples."""
    from audio_triangulation_tpu.ops.pallas import gcc_kernel as jgcc

    m, kw = SPLIT_STATS[case]
    cfg, frames, win, pairs, win_gain, mats, args = _stats_operands(m, kw)
    ref = jgcc.fused_gcc_peaks(
        jnp.asarray(frames.numpy()), jnp.asarray(win.numpy()), pairs.numpy(),
        jcfg.PipelineConfig(**{"fft_pad_mode": "circular", **kw}), tile_b=8,
        interpret=True)
    got = tgcc.gcc_stats_reference(frames, win_gain, mats, pairs,
                                   tgcc.stats_params(cfg, True), **args,
                                   with_peaks=True, split=True)
    ref0 = np.asarray(ref[0])
    scale = np.abs(ref0).max()
    np.testing.assert_allclose(got[0].numpy() / scale, ref0 / scale,
                               atol=2e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]), atol=1e-4)


def test_split_lag_correlogram_is_the_three_kept_products(rng):
    """One step of 4 bins in float64: a_lo b_hi + a_hi b_lo + a_hi b_hi of
    the rr and jj columns; with ``hi_only`` the last alone; a flush only
    moves where the f32 adds are made."""
    rr = torch.from_numpy(rng.standard_normal((3, 5, 37)).astype(np.float32))
    jj = torch.from_numpy(rng.standard_normal((3, 5, 37)).astype(np.float32))
    sc = torch.from_numpy(rng.standard_normal((37, 21)).astype(np.float32))
    ss = torch.from_numpy(rng.standard_normal((37, 21)).astype(np.float32))
    (rh, rl), (jh, jl) = tsrpk.tf32_split(rr), tsrpk.tf32_split(jj)
    (ch, cl), (sh, sl) = tsrpk.tf32_split(sc), tsrpk.tf32_split(ss)
    d = torch.Tensor.double
    kept = (d(rl) @ d(ch) + d(rh) @ d(cl) + d(rh) @ d(ch)
            + d(jl) @ d(sh) + d(jh) @ d(sl) + d(jh) @ d(sh))
    got = tgcc.split_lag_correlogram(rr, jj, sc, ss)
    scale = float(kept.abs().max())
    assert float((got.double() - kept).abs().max()) <= 2e-6 * scale
    flushed = tgcc.split_lag_correlogram(rr, jj, sc, ss, flush_steps=2)
    assert float((flushed - got).abs().max()) <= 2e-6 * scale
    hi = tgcc.split_lag_correlogram(rr, jj, sc, ss, hi_only=True)
    assert float((hi.double() - d(rh) @ d(ch) - d(jh) @ d(sh)).abs().max()
                 ) <= 2e-6 * scale
    full = d(rr) @ d(sc) + d(jj) @ d(ss)
    assert float((kept - full).abs().max()) <= 74 * 3 * 2.0 ** -22 * float(
        rr.abs().max() * sc.abs().max())


@pytest.mark.parametrize("n,f", [(1024, 513), (64, 33), (100, 106),
                                 (256, 7)])
def test_pack_dft_layout(rng, n, f):
    """The stats mode's DFT operand: samples padded with zeros to whole
    steps of 8, bins to whole column tiles of 4; lane 4 g + t of step s and
    tile j holds column g of the tile (bin 4 j + g // 2; cos for even g,
    -sin for odd) at samples 8 s + t and 8 s + t + 4."""
    cos = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    msin = torch.from_numpy(rng.standard_normal((n, f)).astype(np.float32))
    packed = tgcc.pack_dft(cos, msin)
    steps, tiles = -(-n // 8), -(-f // 4)
    assert packed.shape == (steps, tiles, 32, 2) and packed.is_contiguous()
    c, s = tgcc.unpack_dft(packed, n, f)
    assert torch.equal(c, cos) and torch.equal(s, msin)
    assert float(packed.abs().sum()) == pytest.approx(
        float(cos.abs().sum() + msin.abs().sum()), rel=1e-5)
    for nn, ff in ((0, 0), (n - 1, f - 1), (n // 2, f // 3)):
        step, k = divmod(nn, 8)
        tile, b = divmod(ff, 4)
        for comp, mat in ((0, cos), (1, msin)):
            lane = 4 * (2 * b + comp) + k % 4
            assert packed[step, tile, lane, k // 4] == mat[nn, ff]


def test_split_rdft_against_float64(rng):
    """The stats mode's DFT arithmetic (steps of 8 samples summed from zero,
    16 steps to a chunk, chunks into the total) within 2e-6 of the spectrum
    scale of float64, like the plain f32 product; one TF32 product is not."""
    x = torch.from_numpy(rng.standard_normal((5, 4, 1024)).astype(np.float32))
    cos, msin = (torch.from_numpy(a) for a in tmxu.dft_matrices(1024, 1024))
    re64, im64 = tmxu.rdft(x.double(), cos.double(), msin.double())
    scale = float(re64.abs().max())
    re, im = tgcc.split_rdft(x, cos, msin)
    assert re.dtype == torch.float32 and re.shape == (5, 4, 513)
    assert float((re.double() - re64).abs().max()) <= 2e-6 * scale
    assert float((im.double() - im64).abs().max()) <= 2e-6 * scale
    pre, _ = tmxu.rdft(x, cos, msin)
    assert float((pre.double() - re64).abs().max()) <= 2e-6 * scale
    one = tsrpk.tf32_round(x) @ tsrpk.tf32_round(cos)
    assert float((one.double() - re64).abs().max()) > 1e-4 * scale
    # 100 samples: the last step is padded, the only chunk is cut short
    r2, _ = tgcc.split_rdft(x[..., :100], cos[:100], msin[:100])
    want = x[..., :100].double() @ cos[:100].double()
    assert float((r2.double() - want).abs().max()) <= 2e-6 * scale


def test_gcc_matrices_carry_the_packed_synthesis():
    """The stats mode's B operand is made once with the other matrices:
    split, padded to 16 bins and to lag blocks of at most 16 tiles, f32
    whatever dtype the plain version's copies are cast to."""
    cfg = tcfg.PipelineConfig(phat=True, fft_pad_mode="circular",
                              band_hz="auto")
    frames = torch.zeros((1, 4, 1024))
    _, mats = tgcc.operands(frames, torch.ones(1024), cfg)
    f, l = mats.sync.shape
    assert (f, l) == (513, 93)
    assert mats.synp.shape == (1, 528 // 4, 12, 32, 4)
    c_hi, s_hi, c_lo, s_lo = tgcc.unpack_split_synthesis(mats.synp, f, l)
    assert torch.equal(c_hi, tsrpk.tf32_round(mats.sync))
    assert float((c_hi.double() + c_lo.double() - mats.sync.double()
                  ).abs().max()) <= 2.0 ** -21 * float(mats.sync.abs().max())
    assert float((s_hi.double() + s_lo.double() - mats.syns.double()
                  ).abs().max()) <= 2.0 ** -21 * float(mats.syns.abs().max())
    assert mats.dft.shape == (128, 129, 32, 2)
    c, s = tgcc.unpack_dft(mats.dft, 1024, f)
    assert torch.equal(c, mats.cos) and torch.equal(s, mats.msin)
    m64 = mats.to(torch.float64)
    assert m64.sync.dtype == torch.float64 and m64.cos.dtype == torch.float64
    assert m64.synp is mats.synp and m64.dft is mats.dft
    wide = tgcc.pack_split_synthesis(torch.ones((5, 300)),
                                     torch.ones((5, 300)),
                                     tgcc.STATS_LAG_TILES)
    assert wide.shape == (3, 4, 16, 32, 4)  # 38 tiles in 3 lag blocks


def test_stats_kernel_source_keeps_the_layout_constants():
    src = (_build.CSRC_DIR / "gcc_kernel.cu").read_text()
    assert f"constexpr int kFChunk = {tgcc.SPLIT_CHUNK_BINS};" in src
    assert "constexpr int kLagBlock = 128;" in src
    assert tgcc.STATS_LAG_TILES == 128 // 8
    assert "constexpr int kStatsTilesN = kLagBlock / 8;" in src
    assert f"constexpr int kAChunk = {8 * tgcc.DFT_FLUSH_STEPS};" in src
    assert "constexpr int kRegHw = 16;" in src  # window sums from registers


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 5, 7])
@pytest.mark.parametrize("case", sorted(SPLIT_STATS))
def test_cuda_stats_kernel_ragged_batches(cuda_device, case, b):
    """Batches that no block of 4 frames divides: the kernel against
    float64 (1e-4 of scale, shifts equal on clear rows), against its
    synthesis stage's arithmetic behind float64 statistics (2e-5), and
    against its DFT and synthesis stages' arithmetic on the f32 operands
    (2e-5)."""
    m, kw = SPLIT_STATS[case]
    cfg, frames, _, pairs, win_gain, mats, args = _stats_operands(m, kw, b=b)
    sp = tgcc.stats_params(cfg, True)
    x, p = frames.to(cuda_device), pairs.to(cuda_device)
    win_gain, mats = tgcc.operands(x, win_gain.to(cuda_device) / (
        256.0 if cfg.normalize_mode == "shift8" else 1.0), cfg)
    ops64 = (x.double(), win_gain.double(), mats.to(torch.float64), p, sp)
    ref = tgcc.gcc_stats_reference(*ops64, **args, with_peaks=True)
    stage = tgcc.gcc_stats_reference(*ops64, **args, with_peaks=True,
                                     split=True)
    both = tgcc.gcc_stats_reference(x, win_gain, mats, p, sp, **args,
                                    with_peaks=True, split=True)
    got = tgcc.launch_stats(x, win_gain, mats, p, sp, **args,
                            with_peaks=True)
    scale = float(ref[0].abs().max())
    top2 = ref[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 1e-3 * scale
    d = (got[0].double() - ref[0]).abs().amax(dim=-1)
    assert float((d * clear).max()) <= 1e-4 * scale
    assert not bool(((got[1] != ref[1]) & clear).any())
    for plain in (stage, both):
        d = (got[0] - plain[0]).abs().amax(dim=-1)
        assert float((d * clear).max()) <= 2e-5 * scale
