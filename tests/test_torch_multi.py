"""PyTorch port, simultaneous sources: ``srp.top_k_peaks``,
``multisource.cell_centers_xy`` / ``windowed_subsample_peak`` and
``Localizer.localize_multi`` against the JAX package's, on the same seeded
numpy inputs.

Held exactly: the grid cells, the K peaks' cells and scores on planted
scores (ties included) and the windowed argmax on planted correlograms.
``localize_multi`` on the 8-mic two-source scene (the JAX package's
``tests/test_multisource.py`` scene), through the JAX package's unfused
path and its Pallas GCC kernel in interpret mode: the grid candidates
``xy_grid`` exactly (the scene's top-K decisions are clear), ``xy`` within
1e-4 m, ``tdoa_samples`` within 5e-3 lags (full-band PHAT amplifies the
products' rounding: 3e-3 seen), ``peak_value`` / ``scores`` /
``source_score`` within 2e-3 of the score scale, ``rms_m`` within 1e-5 m
and ``xy_cov`` within 1e-3 relative."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import multisource as jms, srp as jsrp
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch import Localizer
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import multisource, srp
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gcc_large

MICS8 = jgeo.circular_array(8, 0.15)
H = 1.2
XY1, XY2 = (0.5, 0.4), (-0.6, -0.3)


def _place(x, y):
    p = np.array([x, y, H])
    return p * (H / np.linalg.norm(p))


def two_source_frames(mics, xy1, xy2, seed=1, noise=0.005):
    """[1, M, 1024] f32: two simultaneous, spectrally distinct bursts."""
    f1 = jsynth.synth_scene(_place(*xy1), mics, noise_rms=noise, seed=seed)
    sig2 = jsynth.chirp_burst(1024, 50_000.0, f0=2000, f1=9000, center=0.45)
    f2 = jsynth.synth_scene(_place(*xy2), mics, signal=sig2,
                            noise_rms=noise, seed=seed + 1)
    return np.asarray(f1 + f2, np.float32)


def _scene(n_frames, mics=MICS8):
    return np.concatenate([two_source_frames(mics, XY1, XY2, seed=2 * i + 1)
                           for i in range(n_frames)])


@pytest.mark.parametrize("grid", [
    dict(), dict(half_cells_x=7, half_cells_y=5, cells_per_m=10.0)])
def test_cell_centers_equal_reference(grid):
    g = jcfg.GridConfig(**grid)
    np.testing.assert_array_equal(
        multisource.cell_centers_xy(tcfg.GridConfig(**grid)),
        jms.cell_centers_xy(g))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_top_k_peaks_matches_reference(k):
    """Planted peaks, a planted tie (the first index wins) and more rounds
    than separated peaks (later rounds repeat the suppressed floor)."""
    grid = jcfg.GridConfig(half_cells_x=10, half_cells_y=8, cells_per_m=5.0)
    cells = jms.cell_centers_xy(grid)
    rng = np.random.default_rng(k)
    scores = rng.normal(0.0, 0.1, (6, cells.shape[0])).astype(np.float32)
    for b in range(6):
        for i in rng.choice(cells.shape[0], 3, replace=False):
            scores[b, i] += 2.0 + rng.uniform()
    scores[0, 40] = scores[0, 300] = 5.0  # a tie of two separated cells
    scores[1] = 1.0  # all equal: every round takes the first live cell
    ref_xy, ref_val = jsrp.top_k_peaks(jnp.asarray(scores),
                                       jnp.asarray(cells), k, 0.5)
    got_xy, got_val = srp.top_k_peaks(torch.from_numpy(scores),
                                      torch.from_numpy(cells), k, 0.5)
    assert got_xy.shape == (6, k, 2) and got_val.shape == (6, k)
    np.testing.assert_array_equal(got_xy.numpy(), np.asarray(ref_xy))
    np.testing.assert_array_equal(got_val.numpy(), np.asarray(ref_val))
    np.testing.assert_array_equal(got_xy[0, 0].numpy(), cells[40])


def test_windowed_subsample_peak_matches_reference():
    """K hypotheses a frame against one correlogram set, predictions at
    random lags, at the edges and beyond them: the gated argmax exactly,
    the refined lag within 1e-6."""
    rng = np.random.default_rng(5)
    k_max, n_lags = 12, 25
    corr = rng.normal(0.0, 0.05, (4, 6, n_lags)).astype(np.float32)
    for b in range(4):
        for p in range(6):
            for at in rng.choice(n_lags, 2, replace=False):
                corr[b, p, at] += 1.0 + rng.uniform()
    corr[0, 0, 0] = corr[0, 1, -1] = 9.0  # peaks at the edge lags
    pred = rng.uniform(-k_max - 2, k_max + 2, (4, 3, 6)).astype(np.float32)
    pred[0, :, 0], pred[0, :, 1] = -k_max, k_max
    for window in (3.0, 0.3):
        r_t, r_v = jms.windowed_subsample_peak(
            jnp.asarray(corr)[:, None], k_max, jnp.asarray(pred), window)
        g_t, g_v = multisource.windowed_subsample_peak(
            torch.from_numpy(corr)[:, None], k_max, torch.from_numpy(pred),
            window)
        assert g_t.shape == (4, 3, 6)
        np.testing.assert_array_equal(g_v.numpy(), np.asarray(r_v))
        np.testing.assert_allclose(g_t.numpy(), np.asarray(r_t), atol=1e-6)
    assert float(g_t[0, 0, 0]) == -k_max  # an edge peak is not refined


def _compare_multi(r, g, where):
    assert sorted(g) == sorted(r), where
    for k in r:
        assert g[k].shape == r[k].shape, (where, k)
    np.testing.assert_array_equal(g["xy_grid"], r["xy_grid"], err_msg=where)
    np.testing.assert_allclose(g["xy"], r["xy"], atol=1e-4, err_msg=where)
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=5e-3, err_msg=where)
    scale = np.abs(r["scores"]).max()
    for k in ("scores", "source_score", "peak_value"):
        np.testing.assert_allclose(g[k] / scale, r[k] / scale, atol=2e-3,
                                   err_msg=f"{where} {k}")
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=1e-5,
                               err_msg=where)
    np.testing.assert_allclose(g["xy_cov"], r["xy_cov"], rtol=1e-3,
                               atol=1e-10, err_msg=where)


# band_hz='auto' is left out: on two sources its per-bin band decisions
# are not clear of their threshold (the JAX package's own fused and
# unfused paths differ by 11% of the score scale on this scene)
MULTI_CONFIGS = {
    "phat": dict(phat=True),
    "bandcrop_phat": dict(phat=True, band_hz=(800.0, 6000.0),
                          band_crop=True),
    "no_phat": dict(),
}


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("name", sorted(MULTI_CONFIGS))
def test_localize_multi_matches_reference(name, fused, monkeypatch):
    """Eight frames of the two-source scene; both sources found within
    10 cm in every frame, and the port took the GCC kernel without
    peaks (row 2's route)."""
    kw = MULTI_CONFIGS[name]
    frames = _scene(8)
    ref = JLocalizer.create(MICS8, jcfg.PipelineConfig(
        **kw, fused_kernel=fused, fused_tile_b=8))
    port = Localizer.create(MICS8, tcfg.PipelineConfig(**kw), device="cpu")
    calls = []
    real = gcc_kernel.fused_gcc

    def spy(*args, **kwargs):
        calls.append(kwargs["with_peaks"])
        return real(*args, **kwargs)

    monkeypatch.setattr(gcc_kernel, "fused_gcc", spy)
    r = {k: np.asarray(v) for k, v in ref.localize_multi(
        jnp.asarray(frames), 2).items()}
    g = {k: v.numpy() for k, v in port.localize_multi(
        torch.from_numpy(frames), 2).items()}
    assert calls == [False]
    _compare_multi(r, g, name)
    for target in (XY1, XY2):
        err = np.linalg.norm(g["xy"] - np.asarray(target), axis=-1).min(-1)
        assert (err < 0.1).all(), (target, err)


def test_localize_multi_leading_dims_knobs_and_refusals():
    """Leading dims kept, K = 3 with a wider gate and radius against the
    reference, and the refusals: a [M, 3] array (the reference lifts mics to
    z = 0) and frames of the wrong shape."""
    frames = _scene(4).reshape(2, 2, 8, 1024)
    ref = JLocalizer.create(MICS8, jcfg.PipelineConfig(phat=True))
    port = Localizer.create(MICS8, tcfg.PipelineConfig(phat=True),
                            device="cpu")
    kw = dict(min_separation_m=0.6, assoc_window_samples=2.0)
    r = {k: np.asarray(v) for k, v in ref.localize_multi(
        jnp.asarray(frames), 3, **kw).items()}
    g = {k: v.numpy() for k, v in port.localize_multi(
        torch.from_numpy(frames), 3, **kw).items()}
    assert g["xy"].shape == (2, 2, 3, 2) and g["scores"].shape == (2, 2,
                                                                    10201)
    # the third slot is the suppressed floor: held where the first two are
    r2 = {k: v[..., :2, :] if v.ndim > 3 and k != "xy_cov" else v
          for k, v in r.items()}
    g2 = {k: v[..., :2, :] if v.ndim > 3 and k != "xy_cov" else v
          for k, v in g.items()}
    for d in (r2, g2):
        d["source_score"] = d["source_score"][..., :2]
        d["rms_m"] = d["rms_m"][..., :2]
        d["xy_cov"] = d["xy_cov"][..., :2, :, :]
    _compare_multi(r2, g2, "leading dims, K = 3")
    tetra = jgeo.tetrahedral_array(0.3)
    port3 = Localizer.create(tetra, device="cpu")
    with pytest.raises(ValueError, match=r"planar \[M, 2\]"):
        port3.localize_multi(torch.zeros(1, 4, 1024))
    with pytest.raises(ValueError, match="mics"):
        port.localize_multi(torch.zeros(1, 7, 1024))
    with pytest.raises(ValueError, match="samples"):
        port.localize_multi(torch.zeros(1, 8, 512))


def test_localize_multi_large_array_route(monkeypatch):
    """A 64-mic array (2,016 pairs) takes the large-array kernel without
    peaks (row 6's route), and equals the port's unfused pair-blocked
    engine on the same frames."""
    mics = jgeo.grid_array(8, 8, 0.05)
    lags = jgeo.max_lag_for_array(mics, jcfg.PipelineConfig())
    frames = _scene(2, mics)
    grid = tcfg.GridConfig(half_cells_x=20, half_cells_y=20,
                           cells_per_m=16.0)
    port = Localizer.create(
        mics, tcfg.PipelineConfig(phat=True, max_shift_samples=lags), grid,
        device="cpu")
    calls = []
    real = gcc_large.xcorr_large
    monkeypatch.setattr(gcc_large, "xcorr_large",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = port.localize_multi(torch.from_numpy(frames), 2)
    assert calls == [1]
    unfused = Localizer.create(
        mics, tcfg.PipelineConfig(phat=True, max_shift_samples=lags,
                                  xcorr_mode="fft"), grid, device="cpu")
    want = unfused.localize_multi(torch.from_numpy(frames), 2)
    assert calls == [1]
    np.testing.assert_array_equal(got["xy_grid"].numpy(),
                                  want["xy_grid"].numpy())
    np.testing.assert_allclose(got["xy"].numpy(), want["xy"].numpy(),
                               atol=1e-4)
    for target in (XY1, XY2):
        err = np.linalg.norm(got["xy"].numpy() - np.asarray(target),
                             axis=-1).min(-1)
        assert (err < 0.1).all(), (target, err)
