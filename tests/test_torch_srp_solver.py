"""PyTorch port, SRP scoring, grid peak and solver against the JAX package
on the same numpy inputs."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import solver as jsolver, srp as jsrp
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import solver as tsolver, srp as tsrp
from audio_triangulation_tpu_torch.ops._device import true_div

C, H = 343.0, 1.2


def _steering(mics, grid_kw):
    pairs = jgeo.mic_pairs(mics.shape[0])
    cfg = jcfg.PipelineConfig()
    lut = jgeo.lag_lut(jcfg.GridConfig(**grid_kw), mics, pairs, cfg)
    return pairs, lut, jgeo.lag_onehot(lut, cfg.num_lags)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_srp_scores_matmul_matches(rng, dtype):
    mics = jgeo.square_array(0.3)
    pairs, _, oh = _steering(mics, {"half_cells_x": 16, "half_cells_y": 16,
                                    "cells_per_m": 8.0})
    corr = rng.normal(size=(5, len(pairs), 93)).astype(np.float32)
    ref = np.asarray(jsrp.srp_scores_matmul(jnp.asarray(corr),
                                            jnp.asarray(oh), dtype))
    got = tsrp.srp_scores_matmul(torch.from_numpy(corr),
                                 torch.from_numpy(oh), dtype)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    # the f32 sums of the same (exact) products differ only in order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if dtype == "bfloat16":
        f32 = tsrp.srp_scores_matmul(torch.from_numpy(corr),
                                     torch.from_numpy(oh), "float32")
        assert not torch.equal(got, f32)  # the operands were rounded


def test_srp_scores_gather_matches_matmul(rng):
    mics = jgeo.reference_array()
    pairs, lut, oh = _steering(mics, {"half_cells_x": 10,
                                      "half_cells_y": 10})
    lut_flat = lut.reshape(len(pairs), -1)
    corr = rng.normal(size=(2, 3, len(pairs), 93)).astype(np.float32)
    ref = np.asarray(jsrp.srp_scores_gather(jnp.asarray(corr),
                                            jnp.asarray(lut_flat)))
    got = tsrp.srp_scores_gather(torch.from_numpy(corr),
                                 torch.from_numpy(lut_flat))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-5)
    mm = tsrp.srp_scores_matmul(torch.from_numpy(corr), torch.from_numpy(oh))
    np.testing.assert_allclose(got.numpy(), mm.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("refine", [True, False], ids=["refine", "plain"])
def test_grid_peak_xy_matches(rng, refine):
    h, w, half, cpm = 21, 25, (12, 10), 8.0
    scores = rng.normal(size=(6, h * w)).astype(np.float32)
    scores[0, 7 * w + 3] = scores[0, 9 * w + 20] = 50.0  # tie: first wins
    scores[1, 0] = 60.0          # corner cell: no refinement there
    scores[2, h * w - 1] = 60.0
    scores[3, 5 * w + w - 1] = 60.0  # right edge, interior row
    ref = np.asarray(jsrp.grid_peak_xy(jnp.asarray(scores), (h, w), half,
                                       cpm, refine=refine))
    got = tsrp.grid_peak_xy(torch.from_numpy(scores), (h, w), half, cpm,
                            refine=refine).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got[0], [(3 - 12) / cpm, (10 - 7) / cpm],
                               atol=0.5 / cpm)


def test_quantize_heatmap_and_cell_to_xy_match(rng):
    s = rng.normal(size=(4, 99)).astype(np.float32) ** 2
    np.testing.assert_array_equal(
        tsrp.quantize_heatmap(torch.from_numpy(s)).numpy(),
        np.asarray(jsrp.quantize_heatmap(jnp.asarray(s))))
    si = (s * 1000).astype(np.int64)
    np.testing.assert_array_equal(
        tsrp.quantize_heatmap(torch.from_numpy(si)).numpy(),
        np.asarray(jsrp.quantize_heatmap(jnp.asarray(si))))
    cells = np.array([0, 17, 440], np.int32)
    np.testing.assert_allclose(
        tsrp.cell_to_xy(torch.from_numpy(cells), 21, (10, 10), 24.0).numpy(),
        np.asarray(jsrp.cell_to_xy(jnp.asarray(cells), 21, (10, 10), 24.0)),
        atol=1e-7)
    for p, l, g in ((6, 93, 1089), (253, 93, 10201)):
        assert tsrp.auto_srp_form(p, l, g) == jsrp.auto_srp_form(p, l, g)


@pytest.mark.gpu
def test_cuda_cell_to_xy_and_tdoa_seconds_equal_the_cpu(rng):
    """Grid cell coordinates and TDOAs in seconds come out of the card bit
    for bit as out of the CPU: CUDA divides by a host scalar as a product
    with its reciprocal, an ulp off at some cells, and a Gauss-Newton solve
    from a far cell carries that ulp to 1e-4 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cells = torch.arange(101 * 101)
    for cpm in (24.0, 12.0, 10.0):
        cpu = tsrp.cell_to_xy(cells, 101, (50, 50), cpm)
        card = tsrp.cell_to_xy(cells.cuda(), 101, (50, 50), cpm).cpu()
        assert torch.equal(card, cpu)
    tdoa = torch.from_numpy(rng.normal(0.0, 30.0, 4096).astype(np.float32))
    assert torch.equal(true_div(tdoa.cuda(), 16000.0).cpu(), tdoa / 16000.0)


def _problem(rng, mics, sphere, b=24, outliers=False):
    pairs = jgeo.mic_pairs(mics.shape[0])
    mic3 = jnp.zeros((mics.shape[0], 3), jnp.float32).at[:, :2].set(
        jnp.asarray(mics))
    xys = rng.uniform(-1.0, 1.0, (b, 2)).astype(np.float32)
    taus = np.asarray(jax.vmap(lambda q: jsolver.predicted_tdoas(
        q, mic3, jnp.asarray(pairs), C, H, sphere))(jnp.asarray(xys)),
        np.float32)
    taus = taus + rng.normal(0, 1e-6, taus.shape).astype(np.float32)
    if outliers:
        taus[:, 0] += 8e-5  # one multipath-corrupted pair per frame
    init = (xys * 0.9 + 0.02).astype(np.float32)
    return pairs, taus, init


@pytest.mark.parametrize("robust", ["none", "huber", "cauchy"])
@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
def test_solve_tdoa_batched_matches(rng, robust, sphere):
    mics = jgeo.circular_array(6, 0.25)
    pairs, taus, init = _problem(rng, mics, sphere,
                                 outliers=robust != "none")
    kw = dict(iterations=6, constrain_to_sphere=sphere, robust=robust)
    weights = np.linspace(0.5, 1.5, len(pairs)).astype(np.float32)
    for w in (None, weights):
        ref_xy, ref_rms = jsolver.solve_tdoa_batched(
            jnp.asarray(taus), jnp.asarray(mics), jnp.asarray(pairs),
            speed_of_sound=C, height=H, init_xy=jnp.asarray(init),
            weights=None if w is None else jnp.asarray(w),
            cfg=jcfg.SolverConfig(**kw))
        got_xy, got_rms = tsolver.solve_tdoa_batched(
            torch.from_numpy(taus), torch.from_numpy(mics),
            torch.from_numpy(pairs), speed_of_sound=C, height=H,
            init_xy=torch.from_numpy(init),
            weights=None if w is None else torch.from_numpy(w),
            cfg=tcfg.SolverConfig(**kw))
        # f32 rounding of the ~1 m distances (1e-7 m) is amplified by the
        # small array's geometric dilution; the reference's own batched-
        # solver test allows 2e-4 m
        np.testing.assert_allclose(got_xy.numpy(), np.asarray(ref_xy),
                                   atol=5e-5)
        np.testing.assert_allclose(got_rms.numpy(), np.asarray(ref_rms),
                                   atol=1e-6)


@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
def test_solution_covariance_and_prediction_match(rng, sphere):
    mics = jgeo.square_array(0.3)
    pairs = jgeo.mic_pairs(4)
    xy = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    rms = rng.uniform(0, 1e-3, 7).astype(np.float32)
    cfg = dict(constrain_to_sphere=sphere)
    ref = np.asarray(jsolver.solution_covariance(
        jnp.asarray(xy), jnp.asarray(rms), jnp.asarray(mics),
        jnp.asarray(pairs), height=H, cfg=jcfg.SolverConfig(**cfg)))
    got = tsolver.solution_covariance(
        torch.from_numpy(xy), torch.from_numpy(rms), torch.from_numpy(mics),
        torch.from_numpy(pairs), height=H, cfg=tcfg.SolverConfig(**cfg))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-6 * np.abs(ref).max())
    mic3 = np.zeros((4, 3), np.float32)
    mic3[:, :2] = mics
    ref_t = np.asarray(jsolver.predicted_tdoas(
        jnp.asarray(xy), jnp.asarray(mic3), jnp.asarray(pairs), C, H, sphere))
    got_t = tsolver.predicted_tdoas(
        torch.from_numpy(xy), torch.from_numpy(mic3), torch.from_numpy(pairs),
        C, H, sphere)
    np.testing.assert_allclose(got_t.numpy(), ref_t, atol=1e-9)
