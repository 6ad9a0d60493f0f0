"""PyTorch port, delay-Doppler (``ops/caf``) and
``Localizer.localize_moving`` against the JAX package's, on the same
seeded numpy inputs.

Held exactly: the resampling matrices and the speed grid.  The spectral
fold within 1e-6 of its scale (both packages fold it in numpy).  The CAF,
in both operator forms and under ``band_hz='auto'``, within 1e-4 of its
scale (PHAT whitening amplifies the products' rounding, as on the main
path).  The joint (scale, lag) peak on planted CAFs exactly in its integer
choice, its refined lag and alpha within 1e-6; on real frames
``tdoa_samples`` within 1e-3 lags, ``alpha`` within 1e-6 and
``pair_rel_speed`` within 1e-3 m/s.  ``solve_velocity`` within 1e-4 of its
scale, and ``localize_moving``'s velocity within 1e-3 m/s on the moving
scene of the JAX package's ``examples/advanced.py``."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import caf as jcaf, window as jwin
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch import Localizer
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import caf

MICS6 = jgeo.circular_array(6, 0.35)
V_TRUE = np.array([2.5, -1.5, 0.0])


def _kw(mics, **extra):
    return dict(phat=True, window_enabled=False, band_hz=(700.0, 9500.0),
                max_shift_samples=jgeo.max_lag_for_array(
                    mics, jcfg.PipelineConfig()), **extra)


def moving_frames(mics, n_frames, seed=3, velocity=V_TRUE):
    """[B, M, 1024] f32 of one moving source at (0.3, 0.2, 1.2)."""
    return np.concatenate([jsynth.synth_moving_scene(
        np.array([0.3, 0.2, 1.2]), velocity, mics, noise_rms=0.005,
        seed=seed + i) for i in range(n_frames)]).astype(np.float32)


def _pairs(mics):
    return jgeo.mic_pairs(mics.shape[0])


@pytest.mark.parametrize("n,scales", [
    (1024, (1.002,)), (256, tuple(jcaf.speed_grid(8.0, 5) / 343.0 + 1.0)),
    (300, (0.99, 1.0, 1.013))])
def test_resample_matrices_equal_reference(n, scales):
    np.testing.assert_array_equal(caf.resample_matrices(n, scales),
                                  jcaf.resample_matrices(n, scales))
    np.testing.assert_array_equal(caf.speed_grid(6.0, 7),
                                  jcaf.speed_grid(6.0, 7))


def test_precompute_resample_both_forms_match_reference():
    cfg = jcfg.PipelineConfig(**_kw(MICS6, band_crop=True))
    r_time = jcaf.precompute_resample(1024, 8.0, 5, 343.0)
    g_time = caf.precompute_resample(1024, 8.0, 5, 343.0, device="cpu")
    np.testing.assert_array_equal(g_time.numpy(), np.asarray(r_time))
    r_spec = jcaf.precompute_resample(1024, 8.0, 5, 343.0, cfg=cfg)
    g_spec = caf.precompute_resample(1024, 8.0, 5, 343.0,
                                     cfg=tcfg.PipelineConfig(
                                         **_kw(MICS6, band_crop=True)),
                                     device="cpu")
    assert isinstance(g_spec, tuple) and g_spec[0].shape == r_spec[0].shape
    for g, r in zip(g_spec, r_spec):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy() / np.abs(r).max(),
                                   r / np.abs(r).max(), atol=1e-6)


# name -> (pipeline kw, operator form)
CAF_CASES = {
    "time_domain": (_kw(MICS6), "time"),
    "time_domain_bandcrop": (_kw(MICS6, band_crop=True), "time"),
    "spectral_fold": (_kw(MICS6, band_crop=True), "spectral"),
    "band_auto": (dict(phat=True, window_enabled=False, band_hz="auto",
                       max_shift_samples=_kw(MICS6)["max_shift_samples"]),
                  None),
    "no_phat_window": (dict(max_shift_samples=_kw(MICS6)[
        "max_shift_samples"]), None),
}


@pytest.mark.parametrize("name", sorted(CAF_CASES))
def test_caf_and_delay_doppler_match_reference(name):
    kw, form = CAF_CASES[name]
    jc, tc = jcfg.PipelineConfig(**kw), tcfg.PipelineConfig(**kw)
    frames = moving_frames(MICS6, 2)
    pairs = _pairs(MICS6)
    n_scales = 7
    r_op = g_op = None
    if form is not None:
        r_op = jcaf.precompute_resample(1024, 8.0, n_scales, 343.0,
                                        cfg=jc if form == "spectral" else None)
        g_op = caf.precompute_resample(1024, 8.0, n_scales, 343.0,
                                       cfg=tc if form == "spectral" else None,
                                       device="cpu")
    window = jwin.window_for(jc)
    r = jcaf.estimate_delay_doppler(
        jnp.asarray(frames), jnp.asarray(window), pairs, jc, v_max=8.0,
        n_scales=n_scales, resample=r_op)
    g = caf.estimate_delay_doppler(
        torch.from_numpy(frames), torch.from_numpy(window),
        torch.from_numpy(pairs), tc, v_max=8.0, n_scales=n_scales,
        resample=g_op)
    r = {k: np.asarray(v) for k, v in r.items()}
    assert sorted(g) == sorted(r)
    assert g["caf"].shape == r["caf"].shape == (2, 15, n_scales,
                                                tc.num_lags)
    scale = np.abs(r["caf"]).max()
    np.testing.assert_allclose(g["caf"].numpy() / scale, r["caf"] / scale,
                               atol=1e-4)
    np.testing.assert_allclose(g["tdoa_samples"].numpy(), r["tdoa_samples"],
                               atol=1e-3)
    np.testing.assert_allclose(g["alpha"].numpy(), r["alpha"], atol=1e-6)
    np.testing.assert_allclose(g["pair_rel_speed"].numpy(),
                               r["pair_rel_speed"], atol=1e-3)
    np.testing.assert_allclose(g["peak"].numpy() / scale, r["peak"] / scale,
                               atol=1e-4)


def test_delay_doppler_peak_on_planted_cafs():
    """Planted joint peaks, at the scale and lag edges too: the same cell
    and refinement as the reference's."""
    rng = np.random.default_rng(7)
    c = rng.normal(0.0, 0.05, (3, 4, 9, 31)).astype(np.float32)
    for b in range(3):
        for p in range(4):
            si, li = rng.integers(0, 9), rng.integers(0, 31)
            c[b, p, si, li] += 3.0
            c[b, p, max(si - 1, 0), li] += 1.0
            c[b, p, si, min(li + 1, 30)] += 1.5
    c[0, 0, 0, 0] = c[0, 1, 8, 30] = 9.0  # corners
    scales = 1.0 + jcaf.speed_grid(8.0, 9) / 343.0
    r = jcaf.delay_doppler_peak(jnp.asarray(c), 15, scales)
    g = caf.delay_doppler_peak(torch.from_numpy(c), 15, scales)
    for gv, rv in zip(g, r):
        np.testing.assert_allclose(gv.numpy(), np.asarray(rv), atol=1e-6)
    np.testing.assert_array_equal(g[2].numpy(), np.asarray(r[2]))


@pytest.mark.parametrize("in_plane", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_solve_velocity_matches_reference(dim, in_plane):
    rng = np.random.default_rng(dim + 2 * in_plane)
    mics = rng.uniform(-0.4, 0.4, (6, dim)).astype(np.float32)
    pairs = _pairs(mics)
    pos = np.concatenate([rng.uniform(-1, 1, (5, 2)),
                          rng.uniform(0.8, 1.5, (5, dim - 2))],
                         axis=1).astype(np.float32)
    speed = rng.normal(0.0, 2.0, (5, pairs.shape[0])).astype(np.float32)
    r = np.asarray(jcaf.solve_velocity(
        jnp.asarray(pos), jnp.asarray(speed), jnp.asarray(mics),
        jnp.asarray(pairs), in_plane=in_plane))
    g = caf.solve_velocity(torch.from_numpy(pos), torch.from_numpy(speed),
                           torch.from_numpy(mics), torch.from_numpy(pairs),
                           in_plane=in_plane).numpy()
    assert g.shape == r.shape == (5, 2 if in_plane else dim)
    np.testing.assert_allclose(g, r, atol=1e-4 * np.abs(r).max())


@pytest.mark.parametrize("n_scales", [5, 9])
@pytest.mark.parametrize("band_crop", [True, False])
def test_localize_moving_matches_reference(n_scales, band_crop):
    """Two frames of the moving scene (``examples/advanced.py``'s): every
    output against the reference, and at 9 scales the velocity near the
    truth."""
    kw = _kw(MICS6, band_crop=band_crop)
    frames = moving_frames(MICS6, 2)
    ref = JLocalizer.create(MICS6, jcfg.PipelineConfig(**kw))
    port = Localizer.create(MICS6, tcfg.PipelineConfig(**kw), device="cpu")
    r = {k: np.asarray(v) for k, v in ref.localize_moving(
        jnp.asarray(frames), n_scales=n_scales).items()}
    g = {k: v.numpy() for k, v in port.localize_moving(
        torch.from_numpy(frames), n_scales=n_scales).items()}
    assert sorted(g) == sorted(r)
    assert g["velocity"].shape == (2, 2)  # a coplanar array: in the plane
    np.testing.assert_allclose(g["velocity"], r["velocity"], atol=1e-3)
    np.testing.assert_allclose(g["pair_rel_speed"], r["pair_rel_speed"],
                               atol=1e-3)
    np.testing.assert_allclose(g["alpha"], r["alpha"], atol=1e-6)
    np.testing.assert_allclose(g["tdoa_doppler"], r["tdoa_doppler"],
                               atol=1e-3)
    np.testing.assert_allclose(g["xy"], r["xy"], atol=1e-4)
    if n_scales == 9:  # 2 m/s steps; 5 scales are too coarse to resolve it
        assert (np.linalg.norm(g["velocity"] - V_TRUE[:2], axis=-1)
                < 1.5).all()


def test_localize_moving_operator_once_and_refusals():
    """The resampling operator is built once per (v_max, n_scales); a
    non-coplanar array solves the 3-D velocity; the reference's refusals."""
    kw = _kw(MICS6, band_crop=True)
    port = Localizer.create(MICS6, tcfg.PipelineConfig(**kw), device="cpu")
    frames = torch.from_numpy(moving_frames(MICS6, 1))
    port.localize_moving(frames, n_scales=5)
    op = port._moving_operator(8.0, 5)
    port.localize_moving(frames, n_scales=5)
    assert port._moving_operator(8.0, 5) is op and isinstance(op[0], tuple)
    assert port._moving_operator(8.0, 7) is not op
    tetra = jgeo.tetrahedral_array(0.3)
    kw3 = _kw(tetra)
    ref3 = JLocalizer.create(tetra, jcfg.PipelineConfig(**kw3))
    port3 = Localizer.create(tetra, tcfg.PipelineConfig(**kw3), device="cpu")
    f3 = moving_frames(tetra, 1)
    r3 = np.asarray(ref3.localize_moving(jnp.asarray(f3),
                                         n_scales=5)["velocity"])
    g3 = port3.localize_moving(torch.from_numpy(f3), n_scales=5)["velocity"]
    assert g3.shape == r3.shape == (1, 3)
    np.testing.assert_allclose(g3.numpy(), r3, atol=1e-3 * np.abs(r3).max())
    no_solver = Localizer.create(MICS6, tcfg.PipelineConfig(**kw),
                                 device="cpu", with_solver=False)
    with pytest.raises(ValueError, match="with_solver"):
        no_solver.localize_moving(frames)
    with pytest.raises(ValueError, match="band-cropping"):
        caf.caf_correlograms(
            frames, port.window, port.pairs,
            dataclasses.replace(port.pipeline, band_crop=False),
            caf.scale_grid(8.0, 5, 343.0), resample=op[0])
