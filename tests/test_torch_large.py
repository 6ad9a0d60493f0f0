"""PyTorch port, large arrays (more than 256 pairs): the large-array GCC
module (its plain version on the CPU) against the JAX package's chunked
Pallas kernel in interpret mode, the pair-blocked matmul engine against the
reference's, and the port's Localizer against the JAX Localizer at 276 pairs
on each scoring branch; all on the same numpy inputs."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import mxu_fft as jmxu
from audio_triangulation_tpu.ops.pallas import gcc_large as jlarge
from audio_triangulation_tpu_torch import Localizer
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import localizer as tloc
from audio_triangulation_tpu_torch.ops import mxu_fft as tmxu
from audio_triangulation_tpu_torch.ops.cuda import _build
from audio_triangulation_tpu_torch.ops.cuda import gcc_large as tlarge
from audio_triangulation_tpu_torch.ops.cuda.split_fp32 import tf32_round
from audio_triangulation_tpu_torch.utils import synth

SMALL = dict(fft_pad_mode="circular", frame_size_bits=8,
             max_shift_samples=20)
# (mics, samples, the reference's pair chunk, PipelineConfig kwargs)
CASES = {
    "24mic_phat": (24, 256, 64, dict(SMALL, phat=True)),
    "24mic_unweighted": (24, 256, 64, dict(SMALL)),
    "24mic_band_crop": (24, 256, 64, dict(
        SMALL, phat=True, band_hz=(800.0, 6000.0), band_crop=True)),
    "24mic_auto_band": (24, 256, 64, dict(SMALL, phat=True, band_hz="auto")),
    "24mic_taper_off": (24, 256, 64, dict(SMALL, phat=True,
                                          taper_enabled=False)),
    "12mic_small_chunk": (12, 512, 24, dict(
        fft_pad_mode="circular", frame_size_bits=9, max_shift_samples=30,
        phat=True)),
    "12mic_linear_pad": (12, 256, 24, dict(frame_size_bits=8,
                                           max_shift_samples=20, phat=True)),
}


def _frames(rng, m, n, b=4, band_limited=False):
    """White noise (sharp PHAT peaks), or band-limited bursts plus noise,
    so that the auto band selects a band."""
    if not band_limited:
        return rng.normal(size=(b, m, n)).astype(np.float32)
    t = np.arange(n)
    base = np.sin(2 * np.pi * 0.08 * t) * np.exp(
        -0.5 * ((t - n / 2) / (n / 6)) ** 2)
    delays = rng.integers(-3, 4, size=(b, m))
    x = np.stack([[np.roll(base, d) for d in row] for row in delays])
    return (x + 0.05 * rng.normal(size=(b, m, n))).astype(np.float32)


def _float64_correlograms(frames, pairs, cfg, with_peaks):
    """The correlograms (tapered with peaks) in float64: numpy's rFFT, the
    per-mic PHAT, and the kernel's plain version on float64 operands."""
    from audio_triangulation_tpu_torch.ops import mxu_fft

    spec = np.fft.rfft(frames.astype(np.float64), n=cfg.fft_length)
    re, im = torch.from_numpy(spec.real), torch.from_numpy(spec.imag)
    if cfg.phat:
        re, im = mxu_fft.whiten_reim(re, im, cfg.phat_eps, cfg.phat_beta)
    sync, syns = tlarge.synthesis(cfg, "cpu")
    out = tlarge.gcc_large_reference(
        re, im, torch.from_numpy(pairs), sync.double(), syns.double(),
        bf16=False, with_peaks=with_peaks, max_shift=cfg.max_shift,
        taper_denom=cfg.taper_denom, taper_enabled=cfg.taper_enabled)
    return (out[0] if with_peaks else out).numpy()


@pytest.mark.parametrize("with_peaks", [False, True],
                         ids=["no_peaks", "peaks"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_large_matches_pallas_interpret(rng, case, with_peaks):
    """Correlograms within 1e-5 of scale, integer shifts equal, tdoa within
    1e-5 lags (f32 on both sides; only the order of the sums differs).  The
    auto band needs band-limited frames, whose broad peaks condition the
    parabola worse: 2e-5 of scale and 2e-4 lags there; a static band
    broadens them too (1e-4 lags).  Without a band option each package is
    also held within 1e-5 of scale of a float64 evaluation (measured: at
    most 1.5e-6 on both sides)."""
    m, n, chunk, kw = CASES[case]
    auto = kw.get("band_hz") == "auto"
    tdoa_tol = 2e-4 if auto else 1e-4 if "band_hz" in kw else 1e-5
    frames = _frames(rng, m, n, band_limited=auto)
    pairs = jgeo.mic_pairs(m)
    jcall = jlarge.xcorr_large_peaks if with_peaks else jlarge.xcorr_large
    tcall = tlarge.xcorr_large_peaks if with_peaks else tlarge.xcorr_large
    ref = jcall(jnp.asarray(frames), pairs, jcfg.PipelineConfig(**kw),
                tile_b=2, chunk=chunk, interpret=True)
    got = tcall(torch.from_numpy(frames), torch.from_numpy(pairs),
                tcfg.PipelineConfig(**kw), chunk=chunk)
    if not with_peaks:
        ref, got = (ref,), (got,)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    assert got[0].shape == ref[0].shape == (4, len(pairs),
                                            2 * kw["max_shift_samples"] + 1)
    scale = np.abs(ref[0]).max()
    if "band_hz" not in kw:
        # each package against one float64 evaluation of the same math
        # first, so that a failure names the package that left it (both
        # sit within 1.5e-6 of scale of it on every case here)
        f64 = _float64_correlograms(frames, pairs, tcfg.PipelineConfig(**kw),
                                    with_peaks)
        for name, arr in (("port", got[0]), ("JAX package", ref[0])):
            gap = np.abs(arr - f64).max() / scale
            assert gap <= 1e-5, f"{name}: {gap:.2e} of scale from float64"
    np.testing.assert_allclose(got[0] / scale, ref[0] / scale,
                               atol=2e-5 if auto else 1e-5)
    if with_peaks:
        assert got[1].dtype == np.int32
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[2], ref[2], atol=tdoa_tol)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got[4], ref[4], rtol=1e-4)


def test_large_peaks_equal_external_peak_ops(rng):
    """The peaks variant gives what ``xcorr_large`` followed by the plain
    peak ops gives, and ``taper_enabled=False`` writes the raw rows."""
    from audio_triangulation_tpu_torch.ops import xcorr

    m, n, _, kw = CASES["24mic_phat"]
    frames = torch.from_numpy(_frames(rng, m, n))
    pairs = torch.from_numpy(jgeo.mic_pairs(m))
    cfg = tcfg.PipelineConfig(**kw)
    k = cfg.max_shift
    raw = tlarge.xcorr_large(frames, pairs, cfg)
    tapered, shift, tdoa, peak, psr = tlarge.xcorr_large_peaks(
        frames, pairs, cfg)
    ref_shift = xcorr.best_lag(raw, k)
    ref_tdoa, ref_peak = xcorr.subsample_peak(raw, k)
    assert torch.equal(shift, ref_shift)
    torch.testing.assert_close(tdoa, ref_tdoa, rtol=0, atol=1e-6)
    torch.testing.assert_close(peak, ref_peak, rtol=1e-6, atol=0)
    torch.testing.assert_close(psr, xcorr.peak_confidence(raw, k),
                               rtol=1e-6, atol=0)
    torch.testing.assert_close(
        tapered, xcorr.peak_taper(raw, k, cfg.taper_denom, ref_shift),
        rtol=1e-6, atol=1e-9)
    off = tlarge.xcorr_large_peaks(
        frames, pairs, dataclasses.replace(cfg, taper_enabled=False))
    assert torch.equal(off[0], raw) and torch.equal(off[1], shift)


@pytest.mark.parametrize("with_peaks", [False, True],
                         ids=["no_peaks", "peaks"])
def test_large_bf16_matches_pallas_interpret(with_peaks):
    """``matmul_dtype='bfloat16'`` rounds where the reference does: within
    2e-2 of scale of the reference's bf16 kernel (sums of bf16-exact
    products in another order), equal best lags, and it did round."""
    m, n = 8, 512  # 28 pairs in chunks of 8: a ragged last chunk
    kw = dict(fft_pad_mode="circular", frame_size_bits=9,
              max_shift_samples=30, phat=True)
    mics = jgeo.circular_array(m, 0.25)
    src = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    one = synth.synth_scene(src, mics, n=n, noise_rms=0.01, seed=9)
    frames = np.broadcast_to(one, (4, m, n)).astype(np.float32).copy()
    pairs = jgeo.mic_pairs(m)
    jcall = jlarge.xcorr_large_peaks if with_peaks else jlarge.xcorr_large
    tcall = tlarge.xcorr_large_peaks if with_peaks else tlarge.xcorr_large
    ref = jcall(jnp.asarray(frames), pairs,
                jcfg.PipelineConfig(**kw, matmul_dtype="bfloat16"),
                tile_b=2, chunk=8, interpret=True)
    got = tcall(torch.from_numpy(frames), torch.from_numpy(pairs),
                tcfg.PipelineConfig(**kw, matmul_dtype="bfloat16"), chunk=8)
    f32 = tlarge.xcorr_large(torch.from_numpy(frames),
                             torch.from_numpy(pairs),
                             tcfg.PipelineConfig(**kw))
    if not with_peaks:
        ref, got = (ref,), (got,)
    corr_r, corr_g = np.asarray(ref[0]), got[0].numpy()
    scale = np.abs(corr_r).max()
    np.testing.assert_allclose(corr_g / scale, corr_r / scale, atol=2e-2)
    np.testing.assert_array_equal(corr_g.argmax(-1), corr_r.argmax(-1))
    np.testing.assert_array_equal(corr_g.argmax(-1), f32.numpy().argmax(-1))
    if with_peaks:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    else:
        assert not torch.equal(got[0], f32)


def test_prep_spectra_matches_reference(rng):
    m, n, _, kw = CASES["24mic_auto_band"]
    frames = _frames(rng, m, n, band_limited=True)
    pairs = jgeo.mic_pairs(m)
    ref = jlarge._prep_spectra(jnp.asarray(frames), pairs,
                               jcfg.PipelineConfig(**kw))
    got = tlarge._prep_spectra(torch.from_numpy(frames),
                               torch.from_numpy(pairs),
                               tcfg.PipelineConfig(**kw))
    # unit-modulus bins: a weak bin's fp32 rounding turns into phase
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-3)
    # the band did cut bins out (unit-modulus spectra elsewhere)
    assert float((got[0] ** 2 + got[1] ** 2).min()) == 0.0


PAIRBLOCKED = {
    "phat": dict(SMALL, phat=True),
    "band_crop": dict(SMALL, phat=True, band_hz=(800.0, 6000.0),
                      band_crop=True),
    "auto_band": dict(SMALL, phat=True, band_hz="auto"),
    "bf16": dict(SMALL, phat=True, matmul_dtype="bfloat16"),
    "phat_beta": dict(SMALL, phat=True, phat_beta=0.7),
}


@pytest.mark.parametrize("case", sorted(PAIRBLOCKED))
def test_xcorr_mxu_pairblocked_matches_reference(rng, case):
    kw = PAIRBLOCKED[case]
    m, n = 12, 256
    frames = _frames(rng, m, n, band_limited=kw.get("band_hz") == "auto")
    pairs = jgeo.mic_pairs(m)  # 66 pairs: chunks of 16 leave a ragged one
    mm = kw.get("matmul_dtype", "float32")
    ref = np.asarray(jmxu.xcorr_mxu_pairblocked(
        jnp.asarray(frames), jnp.asarray(pairs), jcfg.PipelineConfig(**kw),
        matmul_dtype=mm, pair_chunk=16))
    got = tmxu.xcorr_mxu_pairblocked(
        torch.from_numpy(frames), torch.from_numpy(pairs),
        tcfg.PipelineConfig(**kw), matmul_dtype=mm, pair_chunk=16)
    whole = tmxu.xcorr_mxu(torch.from_numpy(frames), torch.from_numpy(pairs),
                           tcfg.PipelineConfig(**kw), matmul_dtype=mm)
    scale = np.abs(ref).max()
    tol = 2e-2 if mm == "bfloat16" else 1e-5
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy() / scale, ref / scale, atol=tol)
    # chunking the pair axis changes no value
    torch.testing.assert_close(got, whole, rtol=0, atol=1e-6 * scale)


# ---------------------------------------------------------------------------
# the Localizer at 276 pairs

LOC_KW = dict(frame_size_bits=9, max_shift_samples=40, phat=True,
              fft_pad_mode="circular")
LOC_GRID = dict(half_cells_x=10, half_cells_y=10, cells_per_m=6.0)
BRANCHES = {
    # name: (PipelineConfig extras, create kwargs, expected scoring branch)
    "onehot_big_bf16": (dict(srp_dtype="bfloat16"),
                        dict(srp_form="gather"), "big"),
    "onehot_big_f32": (dict(), dict(srp_form="gather"), "big"),
    "blocked_budget_0": (dict(srp_big_matmul_budget_bytes=0,
                              srp_dtype="bfloat16"),
                         dict(srp_form="gather"), "blocked"),
    "blocked_pair_chunk_50": (dict(srp_big_matmul_budget_bytes=0,
                                   pair_chunk=50),
                              dict(srp_form="gather"), "blocked"),
    "explicit_matmul": (dict(srp_dtype="bfloat16"),
                        dict(srp_form="matmul"), "matmul"),
    "auto_form": (dict(), dict(), "matmul"),
    "auto_band": (dict(band_hz="auto", srp_dtype="bfloat16"),
                  dict(srp_form="gather"), "big"),
    "band_crop_no_taper": (dict(band_hz=(800.0, 6000.0), band_crop=True,
                                taper_enabled=False),
                           dict(srp_form="gather"), "big"),
    "phat_beta": (dict(phat_beta=0.7), dict(srp_form="gather"), "big"),
}


def _scene(rng, mics, n, b=3):
    xy = rng.uniform(-0.9, 0.9, (b, 2))
    v = np.concatenate([xy, np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, n=n, noise_rms=0.01,
                             seed=int(rng.integers(1 << 30))).astype(
                                 np.float32)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_large_localizer_matches_reference(rng, monkeypatch, branch):
    """24 mics, 276 pairs: the port takes the reference's scoring branch and
    its large-array GCC route, and agrees with the JAX Localizer (which runs
    its pair-blocked engine off the TPU): xy within 2e-4 m, equal best
    shifts, tdoa within 1e-3 samples."""
    extra, create_kw, scoring = BRANCHES[branch]
    mics = jgeo.circular_array(24, 0.25)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**LOC_KW, **extra),
                            jcfg.GridConfig(**LOC_GRID), **create_kw)
    port = Localizer.create(mics, tcfg.PipelineConfig(**LOC_KW, **extra),
                            tcfg.GridConfig(**LOC_GRID), device="cpu",
                            **create_kw)
    assert port.srp_form == ref.srp_form
    assert (port.onehot_big is None) == (ref.params.onehot_big is None)
    assert (port.onehot_big is not None) == (scoring == "big")

    calls = []
    for mod, name in ((tlarge, "xcorr_large"), (tlarge, "xcorr_large_peaks"),
                      (tmxu, "xcorr_mxu_pairblocked"),
                      (tloc.srp, "srp_scores_matmul"),
                      (tloc.srp, "srp_scores_matmul_big"),
                      (tloc.srp, "srp_scores_matmul_blocked")):
        def spy(*a, _f=getattr(mod, name), _n=name, **k):
            calls.append(_n)
            return _f(*a, **k)
        monkeypatch.setattr(mod, name, spy)

    frames = _scene(rng, mics, 512)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    gcc = ("xcorr_large_peaks" if port.pipeline.taper_enabled
           else "xcorr_large")
    score = {"big": "srp_scores_matmul_big", "matmul": "srp_scores_matmul",
             "blocked": "srp_scores_matmul_blocked"}[scoring]
    assert calls == [gcc, score]
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].shape == r[k].shape, k
    # Full-band PHAT whitens weak bins to unit size, so two fp32 engines
    # differ by up to ~2e-4 of scale in a correlogram (PERF.md section 6),
    # which can flip a near-tie between two lags: rows whose two best raw
    # values lie closer than 1e-3 of scale are left out of the row checks.
    raw = tlarge.xcorr_large(
        tloc.condition_frames(torch.from_numpy(frames), port.window,
                              port.pipeline), port.pairs, port.pipeline)
    top2 = raw.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1])
             > 1e-3 * float(raw.abs().max())).numpy()
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(g["best_shift"][clear],
                                  r["best_shift"][clear])
    np.testing.assert_allclose(g["tdoa_samples"][clear],
                               r["tdoa_samples"][clear], atol=1e-3)
    scale = np.abs(r["correlograms"]).max()
    np.testing.assert_allclose(g["correlograms"][clear] / scale,
                               r["correlograms"][clear] / scale, atol=3e-4)
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4)
    smax = np.abs(r["scores"]).max()
    np.testing.assert_allclose(g["scores"] / smax, r["scores"] / smax,
                               atol=1e-3)
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=1e-5)
    # a true source scores well clear of the rest of the coarse grid
    np.testing.assert_allclose(g["xy_grid"], r["xy_grid"], atol=1e-6)


def test_large_localizer_from_reference_params(rng):
    """The reference's ``onehot_big`` (bf16, lag axis padded to 8) comes
    across as float32 and scores like the port's own unpadded one."""
    mics = jgeo.circular_array(24, 0.25)
    kw = dict(LOC_KW, srp_dtype="bfloat16")
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**kw),
                            jcfg.GridConfig(**LOC_GRID), srp_form="gather")
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw),
                            tcfg.GridConfig(**LOC_GRID), device="cpu",
                            srp_form="gather")
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in vars(ref.params).items()}
    twin = Localizer.from_reference_params(
        arrays, port.pipeline, port.grid, port.solver, device="cpu",
        srp_form="gather")
    p, l = 276, port.pipeline.num_lags
    assert port.onehot_big.shape == (p * l, port.grid.num_cells)
    assert twin.onehot_big.shape == (p * (-(-l // 8) * 8),
                                     port.grid.num_cells)
    assert twin.onehot_big.dtype == torch.float32
    padded = twin.onehot_big.reshape(p, -1, port.grid.num_cells)
    assert torch.equal(padded[:, :l].reshape(p * l, -1), port.onehot_big)
    assert float(padded[:, l:].abs().max()) == 0.0
    frames = torch.from_numpy(_scene(rng, mics, 512, b=2))
    a, b = port(frames), twin(frames)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-6)
    assert torch.equal(a["best_shift"], b["best_shift"])


def test_large_routes():
    cfg = tcfg.PipelineConfig(phat=True)
    assert tloc.large_route(cfg, 276) and not tloc.large_route(cfg, 256)
    for kw in (dict(xcorr_mode="fft"), dict(weighting="scot")):
        assert not tloc.large_route(tcfg.PipelineConfig(**kw), 2016), kw
    # both precision settings take the kernel (the port is exact fp32), and
    # so does a PHAT exponent: the whitening is outside it
    for kw in (dict(dft_precision="highest"), dict(phat=True, phat_beta=0.5)):
        assert tloc.large_route(tcfg.PipelineConfig(**kw), 2016), kw
    assert tloc._pair_chunk(cfg, 2016) == 128
    assert tloc._pair_chunk(cfg, 6) is None
    assert tloc._pair_chunk(tcfg.PipelineConfig(pair_chunk=7), 2016) == 7


@pytest.mark.parametrize("taper", [True, False], ids=["peaks", "no_peaks"])
def test_frame_too_large_for_the_gcc_kernel_takes_the_large_kernel(
        rng, monkeypatch, taper):
    """Where ``gcc_kernel.fits`` says a frame does not fit the GCC kernel's
    shared memory (on the CPU it always fits, so it is patched here), the
    Localizer takes the large-array kernel in its place, with its peak
    stage or without, and gives what the GCC kernel's route gives: shifts
    equal, TDOAs within 1e-3 samples, xy within 2e-4 m."""
    mics = jgeo.circular_array(8, 0.25)
    cfg = tcfg.PipelineConfig(phat=True, taper_enabled=taper)
    loc = Localizer.create(mics, cfg, device="cpu", init_grid_stride=3)
    frames = torch.from_numpy(_scene(rng, mics, 1024, b=3))
    want = loc(frames)
    calls = []
    for name in ("xcorr_large", "xcorr_large_peaks"):
        real = getattr(tlarge, name)
        monkeypatch.setattr(tlarge, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n) or _r(*a, **k)))
    monkeypatch.setattr(tloc.gcc_kernel, "fits", lambda *a, **k: False)
    monkeypatch.setattr(tloc.gcc_kernel, "fused_gcc", None)
    assert tloc.gcc_routes(frames, cfg, 28, taper) == (False, True)
    got = loc(frames)
    assert calls == ["xcorr_large_peaks" if taper else "xcorr_large"]
    torch.testing.assert_close(got["best_shift"], want["best_shift"],
                               rtol=0, atol=0)
    torch.testing.assert_close(got["tdoa_samples"], want["tdoa_samples"],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(got["xy"], want["xy"], rtol=0, atol=2e-4)


def test_large_cpu_path_counts_no_launch_and_non_cpu_never_falls_back(rng):
    frames = torch.from_numpy(_frames(rng, 12, 256, b=2))
    pairs = torch.from_numpy(jgeo.mic_pairs(12))
    cfg = tcfg.PipelineConfig(**SMALL, phat=True)
    before = tlarge.launches
    tlarge.xcorr_large_peaks(frames, pairs, cfg)
    assert tlarge.launches == before
    re, im, sync, syns, kw = tlarge.operands(frames, pairs, cfg)
    packed = tlarge.packed_synthesis(cfg, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tlarge.launch(re, im, pairs, sync, syns, **kw, packed=packed,
                      with_peaks=True)
    with pytest.raises(ValueError, match="CUDA"):
        tlarge.launch(re.to("meta"), im.to("meta"), pairs, sync, syns, **kw,
                      packed=packed, with_peaks=False)


# ---------------------------------------------------------------------------
# the kernel's split-fp32 arithmetic and its packed synthesis matrices

SPLIT_CASES = {
    # (mics, samples, PipelineConfig kwargs): 149 / 93 / 7 / 201 lags
    "24mic_phat": CASES["24mic_phat"],
    "24mic_band_crop": CASES["24mic_band_crop"],
    "24mic_auto_band": CASES["24mic_auto_band"],
    "12mic_bf16": (12, 512, 24, dict(
        fft_pad_mode="circular", frame_size_bits=9, max_shift_samples=30,
        phat=True, matmul_dtype="bfloat16")),
    "12mic_7_lags": (12, 256, 24, dict(SMALL, phat=True,
                                       max_shift_samples=3)),
    "9mic_201_lags": (9, 512, 24, dict(
        fft_pad_mode="circular", frame_size_bits=9, max_shift_samples=100,
        phat=True)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_large_split_reference_against_float64(rng, case):
    """The plain version that repeats the kernel's arithmetic (split TF32
    operands, three products a step, the accumulator flushed every 64
    steps) against the plain version in float64 on the same operands: raw
    correlograms within 2e-5 of scale (1e-3 in the bf16 mode, where a
    cross-power value one f32 bit apart can round to the next bf16), equal
    shifts and tdoa within 1e-3 lags on rows whose two best values are
    clear of that."""
    m, n, _, kw = SPLIT_CASES[case]
    cfg = tcfg.PipelineConfig(**kw)
    auto = kw.get("band_hz") == "auto"
    frames = torch.from_numpy(_frames(rng, m, n, band_limited=auto))
    pairs = torch.from_numpy(jgeo.mic_pairs(m))
    re, im, sync, syns, okw = tlarge.operands(frames, pairs, cfg)
    assert "packed" not in okw  # the kernel's own copy is launch's alone
    okw["taper_enabled"] = False  # compare raw correlograms
    ref = tlarge.gcc_large_reference(re.double(), im.double(), pairs,
                                     sync.double(), syns.double(), **okw,
                                     with_peaks=True)
    got = tlarge.gcc_large_split_reference(re, im, pairs, sync, syns, **okw,
                                           with_peaks=True)
    tol = 1e-3 if okw["bf16"] else 2e-5
    scale = float(ref[0].abs().max())
    assert got[0].shape == ref[0].shape == (4, len(pairs), cfg.num_lags)
    assert float((got[0].double() - ref[0]).abs().max()) <= tol * scale
    top2 = ref[0].topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > 10 * tol * scale
    assert int(clear.sum()) * 2 > clear.numel()
    assert not bool(((got[1] != ref[1]) & clear).any())
    assert float(((got[2] - ref[2]).abs() * clear).max()) <= 50 * tol


@pytest.mark.parametrize("case", ["24mic_phat", "24mic_band_crop",
                                  "12mic_bf16"])
def test_large_split_reference_matches_pallas_interpret(rng, case):
    """The kernel's arithmetic against the JAX package's kernel in interpret
    mode on the same frames: correlograms within 2e-5 of scale (f32 and
    split-fp32 sums of the same operands; 1e-3 in the bf16 mode), shifts
    equal on clear rows."""
    m, n, chunk, kw = SPLIT_CASES[case]
    frames = _frames(rng, m, n)
    pairs = jgeo.mic_pairs(m)
    ref = jlarge.xcorr_large_peaks(
        jnp.asarray(frames), pairs, jcfg.PipelineConfig(**kw), tile_b=2,
        chunk=chunk, interpret=True)
    cfg = tcfg.PipelineConfig(**kw)
    tp = torch.from_numpy(pairs)
    re, im, sync, syns, okw = tlarge.operands(torch.from_numpy(frames), tp,
                                              cfg)
    got = tlarge.gcc_large_split_reference(re, im, tp, sync, syns, **okw,
                                           with_peaks=True)
    tol = 1e-3 if okw["bf16"] else 2e-5
    ref0 = np.asarray(ref[0])
    scale = np.abs(ref0).max()
    np.testing.assert_allclose(got[0].numpy() / scale, ref0 / scale, atol=tol)
    raw = tlarge.gcc_large_reference(re, im, tp, sync, syns, **okw,
                                     with_peaks=False)
    top2 = raw.topk(2, dim=-1).values
    clear = ((top2[..., 0] - top2[..., 1]) > 10 * tol * scale).numpy()
    assert clear.mean() > 0.5
    assert not ((got[1].numpy() != np.asarray(ref[1])) & clear).any()


@pytest.mark.parametrize("lags,bins", [(149, 2049), (93, 106), (7, 513),
                                       (201, 33)])
def test_packed_synthesis_layout_and_split(rng, lags, bins):
    """hi + lo within 2^-21 of the matrix, both parts TF32 values; K-major:
    a row a lag, the hi parts' rows then the lo parts'; lags padded with
    zero rows to whole lag blocks of 152, bins with zeros to whole chunks
    of 16; along K a step of 8 is the cos rows of 4 bins, then their sin
    rows."""
    sync = torch.from_numpy(rng.standard_normal((bins, lags)).astype(
        np.float32))
    syns = torch.from_numpy(rng.standard_normal((bins, lags)).astype(
        np.float32))
    packed = tlarge.pack_synthesis(sync, syns)
    lp = -(-lags // tlarge.LAG_BLOCK) * tlarge.LAG_BLOCK
    fp = -(-bins // tlarge.CHUNK_BINS) * tlarge.CHUNK_BINS
    assert packed.shape == (2, lp, 2 * fp)
    assert packed.is_contiguous() and packed.dtype == torch.float32
    assert int((packed.view(torch.int32) & 0x1FFF).abs().max()) == 0
    c_hi, s_hi, c_lo, s_lo = tlarge.unpack_synthesis(packed, bins, lags)
    for mat, hi, lo in ((sync, c_hi, c_lo), (syns, s_hi, s_lo)):
        assert torch.equal(hi, tf32_round(mat))
        err = (hi.double() + lo.double() - mat.double()).abs()
        assert bool((err <= 2.0 ** -21 * mat.double().abs()).all())
    # what is past the matrix is zero
    total = packed.double().abs().sum()
    inside = sum(t.double().abs().sum() for t in (c_hi, s_hi, c_lo, s_lo))
    assert float(total) == pytest.approx(float(inside), rel=1e-12)
    for f, l in ((0, 0), (bins - 1, lags - 1), (bins // 2, lags // 3)):
        k = 8 * (f // 4) + f % 4
        assert packed[0, l, k] == c_hi[f, l] and packed[1, l, k] == c_lo[f, l]
        assert packed[0, l, k + 4] == s_hi[f, l]
        assert packed[1, l, k + 4] == s_lo[f, l]


def test_packed_synthesis_has_no_low_part_in_bf16_mode():
    cfg = tcfg.PipelineConfig(**SPLIT_CASES["12mic_bf16"][3])
    sync, syns = tlarge.synthesis(cfg, "cpu")
    packed = tlarge.packed_synthesis(cfg, "cpu")
    assert packed is tlarge.packed_synthesis(cfg, "cpu")  # made once
    c_hi, s_hi, c_lo, s_lo = tlarge.unpack_synthesis(packed, *sync.shape)
    assert int(c_lo.count_nonzero()) == 0 == int(s_lo.count_nonzero())
    assert torch.equal(c_hi, sync) and torch.equal(s_hi, syns)
    f32 = dataclasses.replace(cfg, matmul_dtype="float32")
    assert int(tlarge.unpack_synthesis(
        tlarge.packed_synthesis(f32, "cpu"),
        *sync.shape)[2].count_nonzero()) > 0


def test_large_kernel_source_keeps_the_layout_constants():
    """The packed matrix's layout is stated twice, in the wrapper that
    packs it and in the kernel that reads it."""
    src = (_build.CSRC_DIR / "gcc_large.cu").read_text()
    assert tlarge.LAG_BLOCK % 8 == 0
    assert f"constexpr int kNT = {tlarge.LAG_BLOCK // 8};" in src
    assert "constexpr int kLagBlock = 8 * kNT;" in src
    assert f"constexpr int kChunkBins = {tlarge.CHUNK_BINS};" in src
    assert "constexpr int kStepsPerChunk = kChunkBins / 4;" in src
    flush_chunks = tlarge.FLUSH_STEPS * 4 // tlarge.CHUNK_BINS
    assert f"constexpr int kFlushChunks = {flush_chunks};" in src
    # a refused tensor map comes back under the code the wrapper knows
    shared = (_build.CSRC_DIR / "hopper.cuh").read_text()
    assert (f"constexpr int kErrTensorMap = {tlarge.TENSOR_MAP_ERROR};"
            in shared)
    assert "return hopper::kErrTensorMap;" in src


def test_large_launch_refuses_a_mismatched_packed_matrix(rng):
    re = torch.zeros((1, 4, 33), device="meta")
    pairs = torch.from_numpy(jgeo.mic_pairs(4))
    sync = torch.zeros((33, 41))
    before = tlarge.launches
    with pytest.raises(ValueError, match="CUDA"):
        tlarge.launch(re, re, pairs, sync, sync, bf16=False, with_peaks=True,
                      max_shift=20, taper_denom=1.0,
                      packed=tlarge.pack_synthesis(sync, sync))
    assert tlarge.launches == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_large_kernel_matches_plain_version(rng, cuda_device, case):
    """The kernel against its plain version evaluated in float64."""
    m, n, _, kw = CASES[case]
    cfg = tcfg.PipelineConfig(**kw)
    frames = torch.from_numpy(_frames(rng, m, n, b=16)).to(cuda_device)
    pairs = torch.from_numpy(jgeo.mic_pairs(m)).to(cuda_device)
    re, im, sync, syns, kw = tlarge.operands(frames, pairs, cfg)
    ref = tlarge.gcc_large_reference(re.double(), im.double(), pairs,
                                     sync.double(), syns.double(), **kw,
                                     with_peaks=True)
    before = tlarge.launches
    got = tlarge.launch(re, im, pairs, sync, syns, **kw, with_peaks=True,
                        packed=tlarge.packed_synthesis(cfg, str(re.device)))
    assert tlarge.launches == before + 1
    scale = float(ref[0].abs().max())
    assert float((got[0].double() - ref[0]).abs().max()) / scale < 1e-4
    assert torch.equal(got[1], ref[1])
    assert float((got[2].double() - ref[2]).abs().max()) < 1e-3


@pytest.mark.gpu
def test_cuda_large_localizer_matches_cpu_path(rng, cuda_device):
    mics = jgeo.circular_array(24, 0.25)
    cfg = tcfg.PipelineConfig(**LOC_KW, srp_dtype="bfloat16")
    grid = tcfg.GridConfig(**LOC_GRID)
    cpu = Localizer.create(mics, cfg, grid, device="cpu")
    gpu = Localizer.create(mics, cfg, grid, device="cuda")
    frames = _scene(rng, mics, 512, b=8)
    before = tlarge.launches
    g = gpu(torch.from_numpy(frames).cuda())
    assert tlarge.launches == before + 1
    c = cpu(torch.from_numpy(frames))
    assert torch.equal(g["best_shift"].cpu(), c["best_shift"])
    assert float((g["xy"].cpu() - c["xy"]).abs().max()) < 2e-4


RAGGED = {
    # (mics, samples, PipelineConfig kwargs): pairs no row tile divides, and
    # 7 / 93 / 149 / 201 lags on 33 / 106 / 513 / 2,049 bins
    "9mic_7_lags_33_bins": (9, 64, dict(
        fft_pad_mode="circular", frame_size_bits=6, max_shift_samples=3,
        phat=True)),
    "21mic_93_lags_106_bins": (21, 1024, dict(
        fft_pad_mode="circular", phat=True, band_hz=(800.0, 6000.0),
        band_crop=True)),
    "24mic_149_lags_513_bins": (24, 1024, dict(
        fft_pad_mode="circular", phat=True, max_shift_samples=74)),
    "11mic_201_lags_2049_bins": (11, 4096, dict(
        fft_pad_mode="circular", frame_size_bits=12, phat=True,
        max_shift_samples=100)),
    "11mic_bf16": (11, 1024, dict(fft_pad_mode="circular", phat=True,
                                  matmul_dtype="bfloat16")),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RAGGED))
def test_cuda_large_kernel_ragged_sizes(rng, cuda_device, case):
    """The kernel against float64 (1e-4 of scale; 1e-3 in the bf16 mode)
    and against the plain version in its own arithmetic (2e-5)."""
    m, n, kw = RAGGED[case]
    cfg = tcfg.PipelineConfig(**kw)
    frames = torch.from_numpy(_frames(rng, m, n, b=3)).to(cuda_device)
    pairs = torch.from_numpy(jgeo.mic_pairs(m)).to(cuda_device)
    re, im, sync, syns, okw = tlarge.operands(frames, pairs, cfg)
    ref = tlarge.gcc_large_reference(re.double(), im.double(), pairs,
                                     sync.double(), syns.double(), **okw,
                                     with_peaks=False)
    split = tlarge.gcc_large_split_reference(re, im, pairs, sync, syns,
                                             **okw, with_peaks=False)
    got = tlarge.launch(re, im, pairs, sync, syns, **okw, with_peaks=False,
                        packed=tlarge.pack_synthesis(sync, syns))
    scale = float(ref.abs().max())
    tol = 1e-3 if okw["bf16"] else 1e-4
    assert float((got.double() - ref).abs().max()) <= tol * scale
    assert float((got - split).abs().max()) <= (
        tol if okw["bf16"] else 2e-5) * scale
