"""PyTorch port, GCC kernel module: the port's fused GCC (its plain version
on the CPU) against the JAX package's Pallas GCC kernel in interpret mode,
on the same raw frames, in the base mode, the spectral-stats mode and the
in-kernel SRP mode; plus the wrapper's no-fallback contract."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import window as jwin
from audio_triangulation_tpu.ops.pallas import gcc_kernel as jgcc
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel as tgcc
from audio_triangulation_tpu_torch.ops.cuda.split_fp32 import tf32_split

CASES = {
    "circular_phat": (3, {"fft_pad_mode": "circular", "phat": True}),
    "linear_nophat": (4, {}),
    "band_crop": (4, {"phat": True, "fft_pad_mode": "circular",
                      "band_hz": (800.0, 6000.0), "band_crop": True}),
    "static_band_no_crop": (4, {"phat": True,
                                "band_hz": (800.0, 6000.0)}),
    "2mic_per_pair_phat": (2, {"phat": True, "fft_pad_mode": "circular",
                               "phat_eps": 1e-9}),
    # without PHAT: mean removal leaves the unwindowed DC bin at rounding
    # noise, which whitening would blow up to unit magnitude
    "window_off": (3, {"window_enabled": False}),
    "normalize_none": (3, {"normalize_mode": "none",
                           "fft_pad_mode": "circular"}),
}


def _inputs(rng, m, b=8, n=1024):
    frames = (rng.normal(size=(b, m, n)) * 50 + 128).astype(np.float32)
    return frames, jwin.dpss_window(n), jgeo.mic_pairs(m)


def _port(frames, win, pairs, kw, with_peaks):
    return tgcc.fused_gcc(torch.from_numpy(frames), torch.from_numpy(win),
                          torch.from_numpy(pairs), tcfg.PipelineConfig(**kw),
                          with_peaks=with_peaks)


@pytest.mark.parametrize("with_peaks", [False, True],
                         ids=["no_peaks", "peaks"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_gcc_matches_pallas_interpret(rng, case, with_peaks):
    m, kw = CASES[case]
    frames, win, pairs = _inputs(rng, m)
    cfg = jcfg.PipelineConfig(**kw)
    call = jgcc.fused_gcc_peaks if with_peaks else jgcc.fused_gcc
    ref = call(jnp.asarray(frames), jnp.asarray(win), pairs, cfg,
               tile_b=8, interpret=True)
    got = _port(frames, win, pairs, kw, with_peaks)
    if not with_peaks:
        ref, got = (ref,), (got,)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    assert got[0].shape == ref[0].shape == (8, len(pairs), 93)
    scale = np.abs(ref[0]).max()
    np.testing.assert_allclose(got[0] / scale, ref[0] / scale, atol=1e-5)
    if with_peaks:
        shift, tdoa, peak, psr = got[1:]
        assert shift.dtype == np.int32
        np.testing.assert_array_equal(shift, ref[1])
        np.testing.assert_allclose(tdoa, ref[2], atol=1e-4)
        np.testing.assert_allclose(peak, ref[3], rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(psr, ref[4], rtol=1e-4)


# the stats mode: tests/test_fused_stats.py's configurations (circular,
# square array), plus the linear pad (F = 1,025) and a 2-mic array
STATS_CASES = {
    "auto": (4, dict(phat=True, band_hz="auto")),
    "auto_hybrid": (4, dict(phat=True, band_hz="auto",
                            subsample_method="hybrid")),
    "hybrid_fullband": (4, dict(phat=True, subsample_method="hybrid")),
    "static_band_hybrid": (4, dict(phat=True, band_hz=(800.0, 6000.0),
                                   subsample_method="hybrid")),
    "auto_nophat": (4, dict(band_hz="auto")),
    "auto_phase": (4, dict(phat=True, band_hz="auto",
                           subsample_method="phase")),
    "linear_auto_phase": (4, dict(phat=True, band_hz="auto",
                                  subsample_method="phase",
                                  fft_pad_mode="linear")),
    "2mic_auto_hybrid": (2, dict(phat=True, band_hz="auto",
                                 subsample_method="hybrid")),
}
# without peaks the stats mode runs only for the auto band
STATS_PARAMS = [(c, p) for c in sorted(STATS_CASES) for p in (False, True)
                if p or STATS_CASES[c][1].get("band_hz") == "auto"]


def _chirps(m, b=8):
    """test_fused_stats' chirp scenes (sources from seed 7, noise 0.02,
    seed 1), where the JAX package's fused and unfused paths agree on
    every band and gate decision."""
    rng = np.random.default_rng(7)
    planes = rng.uniform(-1.2, 1.2, (b, 2))
    src = np.stack([np.array([x, y, 1.2]) * (1.2 / np.linalg.norm([x, y, 1.2]))
                    for x, y in planes])
    mics = (jgeo.square_array(0.3) if m == 4
            else np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32))
    frames = jsynth.synth_scene(src, mics, noise_rms=0.02, seed=1)
    return frames.astype(np.float32), jwin.dpss_window(1024), jgeo.mic_pairs(m)


@pytest.mark.parametrize("case,with_peaks", STATS_PARAMS,
                         ids=[f"{c}-{'peaks' if p else 'no_peaks'}"
                              for c, p in STATS_PARAMS])
def test_stats_mode_matches_pallas_interpret(case, with_peaks):
    """Correlograms within 1e-5 of scale and tdoa within 1e-4 samples (f32
    on both sides; the JAX kernel's polynomial atan2 is within ~1e-7 rad
    of atan2), integer shifts exact."""
    m, kw = STATS_CASES[case]
    kw = {"fft_pad_mode": "circular", **kw}
    frames, win, pairs = _chirps(m)
    cfg = tcfg.PipelineConfig(**kw)
    assert tgcc.stats_params(cfg, with_peaks) is not None
    call = jgcc.fused_gcc_peaks if with_peaks else jgcc.fused_gcc
    ref = call(jnp.asarray(frames), jnp.asarray(win), pairs,
               jcfg.PipelineConfig(**kw), tile_b=8, interpret=True)
    got = _port(frames, win, pairs, kw, with_peaks)
    if not with_peaks:
        ref, got = (ref,), (got,)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    assert got[0].shape == ref[0].shape == (8, len(pairs), 93)
    scale = np.abs(ref[0]).max()
    np.testing.assert_allclose(got[0] / scale, ref[0] / scale, atol=1e-5)
    if with_peaks:
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_allclose(got[2], ref[2], atol=1e-4)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-5,
                                   atol=1e-5 * scale)
        np.testing.assert_allclose(got[4], ref[4], rtol=1e-4)


def test_stats_band_weights_and_refusals():
    """The per-frame auto band of the plain version leaves DC and Nyquist
    out; band-crop and odd DFT lengths are not the stats mode's."""
    frames, win, pairs = _chirps(4, b=2)
    cfg = tcfg.PipelineConfig(phat=True, fft_pad_mode="circular",
                              band_hz="auto")
    x = torch.from_numpy(frames)
    ops = tgcc.operands(x, torch.from_numpy(win), cfg)
    sp = tgcc.stats_params(cfg, True)
    corr, band = tgcc.gcc_stats_reference(
        x, *ops, torch.from_numpy(pairs), sp, phat=True, phat_eps=1e-12,
        max_shift=46, taper_denom=36.0, with_peaks=False, with_band=True)
    assert band.shape == (2, 513) and corr.shape == (2, 6, 93)
    assert float(band[:, 0].max()) == 0 and float(band[:, -1].max()) == 0
    assert int(band.sum(dim=-1).min()) >= cfg.auto_band_min_bins
    assert tgcc.stats_params(tcfg.PipelineConfig(), True) is None
    with pytest.raises(ValueError, match="full band"):
        tgcc.stats_params(tcfg.PipelineConfig(
            band_hz=(800.0, 6000.0), band_crop=True,
            subsample_method="phase"), True)
    with pytest.raises(ValueError, match="even"):
        tgcc.stats_params(tcfg.PipelineConfig(fft_size=1025,
                                              band_hz="auto"), False)


# The base mode's arithmetic on the card, gcc_reference(split=True): the DFT
# as a split-fp32 product with its flushes, the synthesis a bin chunk at a
# time.  Bench-scene chirps (800-6000 Hz, noise 0.01), where PHAT lifts the
# DFT's rounding on the weak bins.
SPLIT_CASES = {
    "4mic_fullband": (4, dict(phat=True, fft_pad_mode="circular")),
    "4mic_band_crop": (4, dict(phat=True, fft_pad_mode="circular",
                               band_hz=(800.0, 6000.0), band_crop=True)),
    "3mic_linear_nophat": (3, {}),
    "3mic_band_crop": (3, dict(phat=True, fft_pad_mode="circular",
                               band_hz=(800.0, 6000.0), band_crop=True)),
    "2mic_per_pair_phat": (2, dict(phat=True, fft_pad_mode="circular")),
    "2mic_band_crop": (2, dict(phat=True, fft_pad_mode="circular",
                               band_hz=(800.0, 6000.0), band_crop=True)),
}


def _bench_chirps(m, b, seed=3):
    """Chirp frames of b random sources on the 1.2 m sphere (noise 0.01),
    the DPSS window and the pairs of an m-mic array."""
    mics = {4: jgeo.square_array(0.3), 3: jgeo.reference_array(),
            2: np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32)}[m]
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.uniform(-1.0, 1.0, (b, 2)),
                        np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    frames = jsynth.synth_scene(src, mics, noise_rms=0.01, seed=seed + 1)
    return frames.astype(np.float32), jwin.dpss_window(1024), jgeo.mic_pairs(m)


def _split_case(case, b):
    """(frames, window, pairs, the port's config, the split plain version
    with peaks, the raw split correlograms) of a SPLIT_CASES case."""
    m, kw = SPLIT_CASES[case]
    frames, win, pairs = _bench_chirps(m, b)
    cfg = tcfg.PipelineConfig(**kw)
    x, p = torch.from_numpy(frames), torch.from_numpy(pairs)
    ops = tgcc.operands(x, torch.from_numpy(win), cfg)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                split=True)
    return (frames, win, pairs, cfg,
            tgcc.gcc_reference(x, *ops, p, **args, with_peaks=True),
            tgcc.gcc_reference(x, *ops, p, **args, with_peaks=False))


def _clear(raw, scale, margin=1e-4):
    """Rows whose two best raw values lie more than margin x scale apart."""
    top2 = np.sort(np.asarray(raw), axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin * scale


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_reference_matches_pallas_interpret(case):
    """The plain version in the kernel's arithmetic against the JAX
    package's fused kernel in interpret mode (f32 on both sides, another
    DFT arithmetic): correlograms, raw and tapered, within 3e-5 of scale;
    shifts equal and tdoa within 1e-3 samples on rows clear of near ties."""
    frames, win, pairs, cfg, got, raw = _split_case(case, 8)
    jc = jcfg.PipelineConfig(**SPLIT_CASES[case][1])
    args = (jnp.asarray(frames), jnp.asarray(win), pairs, jc)
    ref = [np.asarray(r) for r in jgcc.fused_gcc_peaks(
        *args, tile_b=8, interpret=True)]
    ref_raw = np.asarray(jgcc.fused_gcc(*args, tile_b=8, interpret=True))
    scale = np.abs(ref_raw).max()
    np.testing.assert_allclose(raw.numpy() / scale, ref_raw / scale,
                               atol=3e-5)
    np.testing.assert_allclose(got[0].numpy() / scale, ref[0] / scale,
                               atol=3e-5)
    clear = _clear(ref_raw, scale)
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got[1].numpy()[clear], ref[1][clear])
    np.testing.assert_allclose(got[2].numpy()[clear], ref[2][clear],
                               atol=1e-3)


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_reference_against_float64(case):
    """The kernel's arithmetic against float64 on the same f32 operands:
    within 3e-5 of scale raw and tapered (the CUDA-core stage it replaces
    was 3.04e-05 on the card), equal shifts on rows clear of near ties."""
    frames, win, pairs, cfg, got, raw = _split_case(case, 16)
    x = torch.from_numpy(frames).double()
    win_gain, mats = tgcc.operands(torch.from_numpy(frames),
                                   torch.from_numpy(win), cfg)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
    ops64 = (x, win_gain.double(), mats.to(torch.float64),
             torch.from_numpy(pairs))
    raw64 = tgcc.gcc_reference(*ops64, **args, with_peaks=False)
    ref64 = tgcc.gcc_reference(*ops64, **args, with_peaks=True)
    scale = float(raw64.abs().max())
    e_raw = float((raw.double() - raw64).abs().max()) / scale
    e_tap = float((got[0].double() - ref64[0]).abs().max()) / scale
    print(f"{case}: split plain version vs float64 {e_raw:.2e} raw, "
          f"{e_tap:.2e} tapered (of scale)")
    assert e_raw <= 3e-5 and e_tap <= 3e-5
    clear = torch.from_numpy(_clear(raw64.numpy(), scale))
    assert bool(clear.float().mean() > 0.5)
    assert torch.equal(got[1][clear], ref64[1][clear])
    assert float((got[2].double() - ref64[2]).abs()[clear].max()) < 1e-3


# The base mode's DFT operand for wgmma: (N, F) of the full band at linear
# and circular padding, a band crop, and sizes that fill no chunk or stage.
SPLIT_PACK_SHAPES = [(1024, 1025), (1024, 513), (1024, 107), (1000, 33)]


@pytest.mark.parametrize("n,f", SPLIT_PACK_SHAPES)
def test_pack_dft_split_layout(n, f):
    """pack_dft_split holds the TF32 hi and lo parts of cos and -sin,
    K-major, padded with zeros to whole chunks and ring stages, and
    unpack_dft_split gives them back."""
    g = torch.Generator().manual_seed(n + f)
    cos, msin = (torch.rand((n, f), generator=g) * 2 - 1 for _ in range(2))
    packed = tgcc.pack_dft_split(cos, msin)
    c, k = tgcc.split_shape(n, f)
    assert packed.shape == (2, c, k)
    assert c % tgcc.CHUNK_COLS == 0 and 0 <= c - 2 * f < tgcc.CHUNK_COLS
    assert k % tgcc.SPLIT_STAGE_SAMPLES == 0 and k >= n
    assert k - n < tgcc.SPLIT_STAGE_SAMPLES
    (ch, sh), (cl, sl) = tgcc.unpack_dft_split(packed, n, f)
    (ch0, cl0), (sh0, sl0) = tf32_split(cos), tf32_split(msin)
    for got, want in ((ch, ch0), (sh, sh0), (cl, cl0), (sl, sl0)):
        assert torch.equal(got, want)
    # padding: columns past 2F and samples past N are zero
    assert not packed[:, 2 * f:].any()
    order = torch.tensor(tgcc.DFT_SLOT_SAMPLE).argsort()
    by_sample = packed.reshape(2, c, k // 8, 8)[..., order].reshape(2, c, k)
    assert not by_sample[..., n:].any()


@pytest.mark.parametrize("n,f", SPLIT_PACK_SHAPES)
def test_pack_dft_split_steps_as_the_kernel_loads_them(n, f):
    """The product as the kernel forms it from the packed operand: a lane
    t of a step holds samples 8 s + 2 t and + 1 in K slots t and t + 4;
    summed over the slots against the packed rows (hi + lo, float64) it is
    the DFT within the split's 2^-21 of the coefficients."""
    g = torch.Generator().manual_seed(7 * n + f)
    cos, msin = (torch.rand((n, f), generator=g) * 2 - 1 for _ in range(2))
    x = torch.rand((3, n), generator=g, dtype=torch.float64) - 0.5
    packed = tgcc.pack_dft_split(cos, msin).double()
    c, k = tgcc.split_shape(n, f)
    xs = torch.nn.functional.pad(x, (0, k - n)).reshape(3, k // 8, 4, 2)
    a = torch.cat([xs[..., 0], xs[..., 1]], dim=-1)  # slots t, then t + 4
    out = a.reshape(3, k) @ (packed[0] + packed[1]).t()
    want = torch.cat([x @ cos.double(), x @ msin.double()], dim=-1)
    got = torch.cat([out[:, 0:2 * f:2], out[:, 1:2 * f:2]], dim=-1)
    scale = float(x.abs().sum(-1).max())
    assert float((got - want).abs().max()) <= 2.0 ** -20 * scale


# the in-kernel SRP mode (the reference's compact Mode B)
SRP_CASES = {
    "3mic_phat_circular": (3, dict(fft_pad_mode="circular", phat=True),
                           dict(half_cells_x=16, half_cells_y=16,
                                cells_per_m=8.0)),
    "3mic_linear_nophat": (3, dict(), dict(half_cells_x=10, half_cells_y=10,
                                           cells_per_m=6.0)),
    "4mic_band_crop": (4, dict(phat=True, fft_pad_mode="circular",
                               band_hz=(800.0, 6000.0), band_crop=True),
                       dict(half_cells_x=16, half_cells_y=16,
                            cells_per_m=8.0)),
    "4mic_fullband": (4, dict(phat=True, fft_pad_mode="circular"),
                                dict(half_cells_x=16, half_cells_y=16,
                                     cells_per_m=8.0)),
}


def _chirp_case(m, grid_kw, cfg):
    """Chirp frames from random sources and the lag LUT of the case."""
    mics = jgeo.reference_array() if m == 3 else jgeo.square_array(0.3)
    rng = np.random.default_rng(11)
    planes = rng.uniform(-1.0, 1.0, (8, 2))
    src = np.stack([np.array([x, y, 1.2]) * (1.2 / np.linalg.norm([x, y, 1.2]))
                    for x, y in planes])
    frames = jsynth.synth_scene(src, mics, noise_rms=0.02,
                                seed=5).astype(np.float32)
    pairs = jgeo.mic_pairs(m)
    lut = jgeo.lag_lut(jcfg.GridConfig(**grid_kw), mics, pairs, cfg)
    return frames, jwin.dpss_window(1024), pairs, lut


@pytest.mark.parametrize("case", sorted(SRP_CASES))
def test_srp_mode_matches_pallas_interpret(case):
    """The first five outputs as in the base mode; the best score within
    1e-4 of the score scale of the reference kernel's (per-pair f32 sums on
    both sides, over bf16-rounded correlograms that differ in the last
    bits), and the cell the same or one whose score ties within that."""
    m, kw, grid_kw = SRP_CASES[case]
    cfg = jcfg.PipelineConfig(**kw)
    frames, win, pairs, lut = _chirp_case(m, grid_kw, cfg)
    oh = jgeo.lag_onehot(lut, cfg.num_lags)  # [P*L, G]
    p, l, g = len(pairs), cfg.num_lags, oh.shape[-1]
    oh3 = np.zeros((p, 128, g), np.float32)  # lag axis padded to 128 lanes
    oh3[:, :l] = oh.reshape(p, l, g)
    ref = [np.asarray(r) for r in jgcc.fused_gcc_peaks(
        jnp.asarray(frames), jnp.asarray(win), pairs, cfg, tile_b=8,
        interpret=True, srp_onehot=jnp.asarray(oh3))]
    got = tgcc.fused_gcc_srp(
        torch.from_numpy(frames), torch.from_numpy(win),
        torch.from_numpy(pairs), torch.from_numpy(lut.reshape(p, -1)),
        tcfg.PipelineConfig(**kw))
    base = _port(frames, win, pairs, kw, True)
    # and the scores [B, G], which the reference kernel does not write
    assert len(got) == 8 and len(ref) == 7
    for a, b in zip(base, got[:5]):
        assert torch.equal(a, b)
    got = [t.numpy() for t in got]
    scale = np.abs(ref[0]).max()
    np.testing.assert_allclose(got[0] / scale, ref[0] / scale, atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    cell, score = got[5], got[6]
    assert cell.dtype == np.int32 and cell.shape == score.shape == (8,)
    scores = tsrp_scores(got[0], oh)
    smax = np.abs(scores).max()
    np.testing.assert_allclose(score, ref[6], atol=1e-4 * smax)
    np.testing.assert_allclose(score, scores.max(-1), atol=1e-4 * smax)
    # the same six fp32 adds as the one-hot product, in pair order
    assert got[7].shape == scores.shape == (8, g)
    np.testing.assert_allclose(got[7], scores, atol=1e-6 * smax)
    np.testing.assert_array_equal(score, got[7][np.arange(8), cell])
    picked_ref = scores[np.arange(8), ref[5]]
    picked = scores[np.arange(8), cell]
    np.testing.assert_allclose(picked, picked_ref, atol=1e-4 * smax)
    assert (cell == ref[5]).mean() >= 0.75


def tsrp_scores(corr_t, onehot):
    """bf16-rounded tapered correlograms times the steering matrix, f32."""
    from audio_triangulation_tpu_torch.ops import srp as tsrp

    return tsrp.srp_scores_matmul(torch.from_numpy(corr_t),
                                  torch.from_numpy(onehot),
                                  "bfloat16").numpy()


def test_srp_first_max_is_first_and_in_pair_order():
    """Ties go to the first cell, and the sum runs over pairs in order."""
    corr = torch.zeros((2, 3, 5))
    corr[0, :, 2] = 1.0
    corr[1, 0, 1], corr[1, 1, 3], corr[1, 2, 0] = 1.0, 1e-8, -1.0
    lut = torch.tensor([[2, 0, 2, 1, 1], [2, 4, 2, 3, 3], [2, 4, 2, 4, 0]],
                       dtype=torch.int32)
    cell, score, scores = tgcc.srp_first_max(corr, lut)
    assert cell.tolist() == [0, 3] and cell.dtype == torch.int32
    assert scores.shape == (2, 5)
    assert torch.equal(scores.gather(-1, cell.long()[:, None])[:, 0], score)
    # (1 + 1e-8) - 1 in pair order; 1e-8 is bf16-rounded first
    want = (torch.tensor(1.0) + torch.tensor(1e-8).bfloat16().float()) - 0.0
    assert float(score[0]) == 3.0 and float(score[1]) == float(want)


def test_srp_mode_refuses_the_stats_mode():
    x = torch.zeros((2, 3, 1024))
    lut = torch.zeros((3, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="stats"):
        tgcc.fused_gcc_srp(x, torch.ones(1024), torch.tensor(jgeo.mic_pairs(3)),
                           lut, tcfg.PipelineConfig(band_hz="auto"))
    with pytest.raises(ValueError, match="CUDA"):  # no plain fallback
        tgcc.fused_gcc_srp(x.to("meta"), torch.ones(1024),
                           torch.tensor(jgeo.mic_pairs(3)), lut,
                           tcfg.PipelineConfig())
    before = tgcc.srp_launches
    out = tgcc.fused_gcc_srp(x, torch.ones(1024),
                             torch.tensor(jgeo.mic_pairs(3)), lut,
                             tcfg.PipelineConfig())
    assert tgcc.srp_launches == before and out[5].tolist() == [0, 0]
    assert tgcc.srp_mode_fits(x, tcfg.PipelineConfig(), 3)  # no CPU limit


def test_cpu_path_does_not_count_launches(rng):
    frames, win, pairs = _inputs(rng, 3, b=2)
    before = (tgcc.launches, tgcc.stats_launches)
    _port(frames, win, pairs, {}, True)
    _port(frames, win, pairs, {"band_hz": "auto"}, True)
    assert (tgcc.launches, tgcc.stats_launches) == before


def test_window_gain_folds_shift8_and_window_off():
    w = torch.linspace(0.1, 1.0, 8)
    np.testing.assert_allclose(
        tgcc.window_gain(w, tcfg.PipelineConfig()).numpy(), w.numpy() * 256)
    np.testing.assert_array_equal(
        tgcc.window_gain(w, tcfg.PipelineConfig(window_enabled=False,
                                                normalize_mode="none")),
        torch.ones(8))


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel launcher, which raises for
    anything that is not CUDA; there is no plain fallback."""
    frames = torch.empty((2, 3, 1024), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgcc.fused_gcc(frames, torch.ones(1024), torch.tensor([[0, 1]]),
                       tcfg.PipelineConfig(), with_peaks=True)
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.zeros((2, 3, 1024))
        tgcc.launch(x, *tgcc.operands(x, torch.ones(1024),
                                      tcfg.PipelineConfig()),
                    torch.tensor([[0, 1]]), phat=False, phat_eps=1e-12,
                    max_shift=46, taper_denom=36.0, with_peaks=False)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(rng, cuda_device, case):
    m, kw = CASES[case]
    frames, win, pairs = _inputs(rng, m, b=64)
    cfg = tcfg.PipelineConfig(**kw)
    x = torch.from_numpy(frames).to(cuda_device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    p = torch.from_numpy(pairs).to(cuda_device)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                with_peaks=True)
    # the plain version in float64: its fp32 evaluation carries cuBLAS's
    # own rounding, which exceeds the kernel's (see chip_smoke.py)
    ref = tgcc.gcc_reference(x.double(), win_gain.double(),
                             mats.to(torch.float64), p, **args)
    got = tgcc.launch(x, win_gain, mats, p, **args)
    scale = float(ref[0].abs().max())
    assert float((got[0].double() - ref[0]).abs().max()) / scale < 1e-4
    assert torch.equal(got[1], ref[1])
    assert float((got[2].double() - ref[2]).abs().max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(STATS_CASES))
def test_cuda_stats_kernel_matches_plain_version(cuda_device, case):
    """The stats kernel against its plain version in float64, on chirp
    scenes whose band and gate decisions are clear of rounding."""
    m, kw = STATS_CASES[case]
    cfg = tcfg.PipelineConfig(**{"fft_pad_mode": "circular", **kw})
    frames, win, pairs = _chirps(m, b=64)
    x = torch.from_numpy(frames).to(cuda_device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    p = torch.from_numpy(pairs).to(cuda_device)
    sp = tgcc.stats_params(cfg, True)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                with_peaks=True, with_band=True)
    ref = tgcc.gcc_stats_reference(x.double(), win_gain.double(),
                                   mats.to(torch.float64), p, sp, **args)
    before = tgcc.stats_launches
    got = tgcc.launch_stats(x, win_gain, mats, p, sp, **args)
    assert tgcc.stats_launches == before + 1
    scale = float(ref[0].abs().max())
    assert float((got[0].double() - ref[0]).abs().max()) / scale < 1e-4
    assert torch.equal(got[1], ref[1])
    assert float((got[2].double() - ref[2]).abs().max()) < 1e-3
    if sp.band_auto:
        assert torch.equal(got[5].double(), ref[5])


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(SRP_CASES))
def test_cuda_srp_mode_matches_plain_version(cuda_device, case):
    """The SRP mode against its plain version in float64: the first five
    outputs as the base mode's, the score within 1e-4 of the score scale."""
    m, kw, grid_kw = SRP_CASES[case]
    cfg = tcfg.PipelineConfig(**kw)
    frames, win, pairs, lut = _chirp_case(m, grid_kw,
                                          jcfg.PipelineConfig(**kw))
    x = torch.from_numpy(frames).to(cuda_device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    p = torch.from_numpy(pairs).to(cuda_device)
    lut_flat = torch.from_numpy(lut.reshape(len(pairs), -1)).to(cuda_device)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
    before = tgcc.srp_launches
    got = tgcc.launch_srp(x, win_gain, mats, p, lut_flat, **args)
    assert tgcc.srp_launches == before + 1
    base = tgcc.launch(x, win_gain, mats, p, **args, with_peaks=True)
    for a, b in zip(base, got[:5]):
        assert torch.equal(a, b)
    ref = tgcc.gcc_srp_reference(x.double(), win_gain.double(),
                                 mats.to(torch.float64), p, lut_flat, **args)
    smax = float(ref[6].abs().max())
    assert float((got[6].double() - ref[6]).abs().max()) < 1e-2 * smax
    # against the scoring of the kernel's own tapered rows: exact cell,
    # every score the same fp32 sum in pair order
    cell, score, scores = tgcc.srp_first_max(got[0], lut_flat)
    assert torch.equal(got[5], cell)
    assert float((got[6] - score).abs().max()) < 1e-5 * smax
    assert float((got[7] - scores).abs().max()) <= 1e-6 * smax


# the base and SRP modes at batches that no frames-a-block divides, at
# 2, 3 and 4 mics, full band and band-crop
RAGGED_CASES = {f"{m}mic_{band}": (m, band) for m in (2, 3, 4)
                for band in ("fullband", "band_crop")}


def _ragged(case, device):
    m, band = RAGGED_CASES[case]
    kw = dict(phat=True, fft_pad_mode="circular")
    if band == "band_crop":
        kw.update(band_hz=(800.0, 6000.0), band_crop=True)
    cfg = tcfg.PipelineConfig(**kw)
    p = len(jgeo.mic_pairs(m))
    tb = tgcc._lib().att_gcc_frames_per_block(m, p, cfg.num_lags)
    assert tb >= 1
    frames, win, pairs = _bench_chirps(m, 2 * tb + 3)
    x = torch.from_numpy(frames).to(device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
    return cfg, x, win_gain, mats, torch.from_numpy(pairs).to(device), args


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_cuda_base_mode_ragged_batches(cuda_device, case):
    """The base mode against float64 (1e-4 of scale, raw and tapered) and
    against the plain version in its own arithmetic (5e-5: the tensor
    cores cut the addends of a step where the plain version rounds, and
    PHAT lifts that on weak bins; 2.7e-05 at the full band on the card),
    equal shifts and tdoa within 1e-3 samples on rows clear of near ties."""
    cfg, x, win_gain, mats, p, args = _ragged(case, cuda_device)
    ops64 = (x.double(), win_gain.double(), mats.to(torch.float64), p)
    raw64 = tgcc.gcc_reference(*ops64, **args, with_peaks=False)
    ref64 = tgcc.gcc_reference(*ops64, **args, with_peaks=True)
    split = tgcc.gcc_reference(x, win_gain, mats, p, **args,
                               with_peaks=False, split=True)
    raw = tgcc.launch(x, win_gain, mats, p, **args, with_peaks=False)
    got = tgcc.launch(x, win_gain, mats, p, **args, with_peaks=True)
    scale = float(raw64.abs().max())
    assert float((raw.double() - raw64).abs().max()) / scale < 1e-4
    assert float((got[0].double() - ref64[0]).abs().max()) / scale < 1e-4
    assert float((raw - split).abs().max()) / scale < 5e-5
    clear = torch.from_numpy(_clear(raw64.cpu().numpy(), scale)).to(
        cuda_device)
    assert torch.equal(got[1][clear], ref64[1][clear])
    assert float((got[2].double() - ref64[2]).abs()[clear].max()) < 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(RAGGED_CASES))
def test_cuda_srp_mode_ragged_batches(cuda_device, case):
    """The SRP mode on a ragged batch: its first five outputs equal to the
    base mode's, its cells and scores [B, G] those of the plain scoring of
    its own tapered rows (scores within 1e-6 of scale)."""
    cfg, x, win_gain, mats, p, args = _ragged(case, cuda_device)
    m = x.shape[1]
    mics = {4: jgeo.square_array(0.3), 3: jgeo.reference_array(),
            2: np.array([[-0.1, 0.0], [0.1, 0.0]], np.float32)}[m]
    lut = jgeo.lag_lut(jcfg.GridConfig(half_cells_x=16, half_cells_y=16,
                                       cells_per_m=8.0), mics,
                       jgeo.mic_pairs(m), jcfg.PipelineConfig())
    lut_flat = torch.from_numpy(lut.reshape(len(jgeo.mic_pairs(m)), -1)).to(
        cuda_device)
    got = tgcc.launch_srp(x, win_gain, mats, p, lut_flat, **args)
    base = tgcc.launch(x, win_gain, mats, p, **args, with_peaks=True)
    for a, b in zip(base, got[:5]):
        assert torch.equal(a, b)
    cell, score, scores = tgcc.srp_first_max(got[0], lut_flat)
    smax = float(scores.abs().max())
    assert got[7].shape == scores.shape == (x.shape[0], lut_flat.shape[1])
    assert torch.equal(got[5], cell)
    assert float((got[6] - score).abs().max()) <= 1e-6 * smax
    assert float((got[7] - scores).abs().max()) <= 1e-6 * smax


# the base mode's wgmma DFT at the benchmark configurations' shapes: the
# firmware's triangle (F = 1,025 at linear padding, no PHAT) and the 4-mic
# square's band crop (PHAT), each on a batch whose last block is not full
WGMMA_CASES = {
    "ref3_linear": (3, dict(fft_pad_mode="linear")),
    "square4_band_crop": (4, dict(phat=True, fft_pad_mode="circular",
                                  band_hz=(800.0, 6000.0), band_crop=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_cuda_wgmma_dft_at_benchmark_shapes(cuda_device, case):
    """The base mode against float64 (1e-4 of scale, raw and tapered) and
    the plain version in its own arithmetic (5e-5), equal shifts and tdoa
    within 1e-3 samples on rows clear of near ties, on 2 blocks and a
    ragged third; every launch counted on the wgmma DFT path."""
    m, kw = WGMMA_CASES[case]
    cfg = tcfg.PipelineConfig(**kw)
    p = len(jgeo.mic_pairs(m))
    tb = tgcc._lib().att_gcc_frames_per_block(m, p, cfg.num_lags)
    frames, win, pairs = _bench_chirps(m, 2 * tb + 5)
    x = torch.from_numpy(frames).to(cuda_device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    pt = torch.from_numpy(pairs).to(cuda_device)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
    ops64 = (x.double(), win_gain.double(), mats.to(torch.float64), pt)
    raw64 = tgcc.gcc_reference(*ops64, **args, with_peaks=False)
    ref64 = tgcc.gcc_reference(*ops64, **args, with_peaks=True)
    split = tgcc.gcc_reference(x, win_gain, mats, pt, **args,
                               with_peaks=False, split=True)
    before = tgcc.dft_path_launches()
    raw = tgcc.launch(x, win_gain, mats, pt, **args, with_peaks=False)
    got = tgcc.launch(x, win_gain, mats, pt, **args, with_peaks=True)
    assert tgcc.dft_path_launches() == {
        "wgmma": before["wgmma"] + 2, "mma_sync": before["mma_sync"]}
    scale = float(raw64.abs().max())
    assert float((raw.double() - raw64).abs().max()) / scale < 1e-4
    assert float((got[0].double() - ref64[0]).abs().max()) / scale < 1e-4
    assert float((raw - split).abs().max()) / scale < 5e-5
    clear = torch.from_numpy(_clear(raw64.cpu().numpy(), scale)).to(
        cuda_device)
    assert bool(clear.float().mean() > 0.9)
    assert torch.equal(got[1][clear], ref64[1][clear])
    assert float((got[2].double() - ref64[2]).abs()[clear].max()) < 1e-3


@pytest.mark.gpu
def test_cuda_dft_launch_counts_by_path(cuda_device):
    """The base, SRP and pipelined launches count on the wgmma DFT path,
    the stats mode's on the mma.sync one; a CPU call counts on neither."""
    frames, win, pairs = _bench_chirps(4, 9)
    x = torch.from_numpy(frames).to(cuda_device)
    pt = torch.from_numpy(pairs).to(cuda_device)
    cfg = tcfg.PipelineConfig(phat=True, fft_pad_mode="circular")
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom)
    lut = torch.zeros((len(pairs), 5), dtype=torch.int32, device=cuda_device)

    def counts():
        c = tgcc.dft_path_launches()
        return c["wgmma"], c["mma_sync"]

    c0 = counts()
    tgcc.launch(x, win_gain, mats, pt, **args, with_peaks=True)
    tgcc.launch_srp(x, win_gain, mats, pt, lut, **args)
    tgcc.launch_pipelined(x, win_gain, mats, pt, **args)
    assert counts() == (c0[0] + 3, c0[1])
    auto = tcfg.PipelineConfig(phat=True, fft_pad_mode="circular",
                               band_hz="auto")
    tgcc.fused_gcc(x, torch.from_numpy(win), pt, auto, with_peaks=True)
    assert counts() == (c0[0] + 3, c0[1] + 1)
    tgcc.fused_gcc(x.cpu(), torch.from_numpy(win), pt.cpu(), cfg,
                   with_peaks=True)
    assert counts() == (c0[0] + 3, c0[1] + 1)
