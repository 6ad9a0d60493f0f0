"""PyTorch port, ``core/design`` against the JAX package's, on the same
seeded numpy inputs (``tests/test_design.py``'s 9 x 9 coverage points over
+-1.5 m; square arrays of 0.3 and 0.1 m).

Tolerances, from the measured gaps (both packages float32):
- ``tdoa_jacobian`` within 1e-6 of its largest entry of the reference's
  (plane and sphere models; measured 3.8e-7), and within 1e-3 of it of a
  float64 central difference of the port's own model;
- ``crlb`` and ``crlb_rms_m`` within 1e-4 relative (1.2e-5 at the 0.1 m
  square, where G^T G is near singular), and within 1e-3 of a numpy
  finite-difference Fisher information (the reference test's probe);
- ``optimize_array`` over 30 steps from the same start: the objective
  history within 1e-4 relative step by step (1.4e-6), positions within
  1e-5 m (3.0e-8);
  over 300 steps the reference test's gates.  The placement gradient is
  ``torch.autograd`` through the forward-mode Jacobian (second order).
"""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, design as jdes
from audio_triangulation_tpu.core import geometry as jgeo
from audio_triangulation_tpu_torch.core import config as tcfg, design as tdes
from audio_triangulation_tpu_torch.ops import solver as tsolver

PTS = np.stack(
    np.meshgrid(np.linspace(-1.5, 1.5, 9), np.linspace(-1.5, 1.5, 9)),
    -1).reshape(-1, 2).astype(np.float32)
C = 343.0


@pytest.mark.parametrize("sphere", [False, True], ids=["plane", "sphere"])
def test_tdoa_jacobian_matches_reference_and_finite_differences(sphere):
    mics = jgeo.circular_array(5, 0.2)
    pairs = jgeo.mic_pairs(5)
    pts = PTS.reshape(9, 9, 2)  # leading dims kept
    kw = dict(speed_of_sound=C, height=1.2, constrain_sphere=sphere)
    ref = np.asarray(jdes.tdoa_jacobian(jnp.asarray(pts), jnp.asarray(mics),
                                        jnp.asarray(pairs), **kw))
    got = tdes.tdoa_jacobian(torch.from_numpy(pts), torch.from_numpy(mics),
                             torch.from_numpy(pairs), **kw).numpy()
    assert got.shape == (9, 9, 10, 2)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, atol=1e-6 * scale)

    mic3 = torch.zeros((5, 3), dtype=torch.float64)
    mic3[:, :2] = torch.from_numpy(mics)
    eps = 1e-6
    p64 = torch.from_numpy(PTS).double()
    fd = torch.stack([
        (tsolver.predicted_tdoas(p64 + d, mic3, torch.from_numpy(pairs), C,
                                 1.2, sphere)
         - tsolver.predicted_tdoas(p64 - d, mic3, torch.from_numpy(pairs),
                                   C, 1.2, sphere)) / (2 * eps)
        for d in (torch.tensor([eps, 0.0], dtype=torch.float64),
                  torch.tensor([0.0, eps], dtype=torch.float64))], -1)
    np.testing.assert_allclose(got.reshape(-1, 10, 2), fd.numpy(),
                               atol=1e-3 * scale)


def test_tdoa_jacobian_differentiates_in_the_mics():
    """The mic gradient of a Jacobian functional (second order) against
    the reference's."""
    import jax

    mics = jgeo.square_array(0.3)
    pairs = jgeo.mic_pairs(4)

    def jfun(m):
        return jnp.sum(jdes.tdoa_jacobian(
            jnp.asarray(PTS), m, jnp.asarray(pairs), speed_of_sound=C,
            height=1.2) ** 2)

    ref = np.asarray(jax.grad(jfun)(jnp.asarray(mics)))
    m = torch.tensor(mics, requires_grad=True)
    (tdes.tdoa_jacobian(torch.from_numpy(PTS), m, torch.from_numpy(pairs),
                        speed_of_sound=C, height=1.2) ** 2).sum().backward()
    np.testing.assert_allclose(m.grad.numpy(), ref,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("aperture", [0.3, 0.1])
def test_crlb_matches_reference(aperture):
    mics = jgeo.square_array(aperture)
    cfg_kw = dict(sigma_tau_s=2e-6, height=1.2)
    ref = np.asarray(jdes.crlb(jnp.asarray(mics), jnp.asarray(PTS),
                               pipeline=jcfg.PipelineConfig(), **cfg_kw))
    got = tdes.crlb(torch.from_numpy(mics), torch.from_numpy(PTS),
                    pipeline=tcfg.PipelineConfig(), **cfg_kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())
    rms_ref = np.asarray(jdes.crlb_rms_m(jnp.asarray(mics), jnp.asarray(PTS),
                                         sigma_tau_s=2e-6))
    rms = tdes.crlb_rms_m(torch.from_numpy(mics), torch.from_numpy(PTS),
                          sigma_tau_s=2e-6).numpy()
    np.testing.assert_allclose(rms, rms_ref, rtol=1e-4)


def test_crlb_matches_finite_difference_fisher():
    """tests/test_design.py's probe: the closed form against a numpy
    finite-difference Fisher information."""
    mics = jgeo.square_array(0.3)
    pairs = jgeo.mic_pairs(4)
    pt = np.array([0.6, 0.4], np.float32)
    sigma = 2e-6

    def tau_np(p):
        src = np.array([[p[0], p[1], 1.2]], np.float64)
        return jgeo.expected_tdoas(src, mics.astype(np.float64), pairs, C)[0]

    eps = 1e-5
    g = np.stack([
        (tau_np(pt + np.array([eps, 0])) - tau_np(pt - np.array([eps, 0])))
        / (2 * eps),
        (tau_np(pt + np.array([0, eps])) - tau_np(pt - np.array([0, eps])))
        / (2 * eps)], axis=-1)
    ref = sigma ** 2 * np.linalg.inv(g.T @ g)
    got = tdes.crlb(torch.from_numpy(mics), torch.from_numpy(pt)[None],
                    sigma_tau_s=sigma, height=1.2).numpy()[0]
    np.testing.assert_allclose(got, ref, rtol=1e-3)


def test_optimize_array_matches_reference():
    rng = np.random.default_rng(0)
    init = rng.uniform(-0.05, 0.05, (4, 2)).astype(np.float32)
    kw = dict(aperture_m=0.15, min_separation_m=0.05, steps=30)
    ref_pos, ref_hist = jdes.optimize_array(init, PTS, **kw)
    pos, hist = tdes.optimize_array(init, PTS, device="cpu", **kw)
    assert hist.dtype == np.float32 and hist.shape == (30,)
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-4)
    np.testing.assert_allclose(pos, ref_pos, atol=1e-5)


def test_optimize_array_improves_and_respects_constraints():
    """tests/test_design.py's gates on the port, 300 steps."""
    rng = np.random.default_rng(0)
    init = rng.uniform(-0.05, 0.05, (4, 2)).astype(np.float32)
    opt, hist = tdes.optimize_array(init, PTS, aperture_m=0.15,
                                    min_separation_m=0.05, steps=300,
                                    device="cpu")
    assert hist[-1] < 0.35 * hist[0], (hist[0], hist[-1])
    radii = np.linalg.norm(opt, axis=-1)
    assert np.all(radii <= 0.15 + 1e-3), radii
    i, j = np.triu_indices(4, k=1)
    sep = np.linalg.norm(opt[i] - opt[j], axis=-1)
    assert np.all(sep >= 0.05 - 1e-3), sep
    sq = float(tdes.crlb_rms_m(
        torch.from_numpy(jgeo.square_array(0.15 * np.sqrt(2))),
        torch.from_numpy(PTS), sigma_tau_s=2e-6).mean())
    assert hist[-1] < 1.5 * sq, (hist[-1], sq)


def test_optimize_array_defaults_to_the_card():
    import inspect

    assert inspect.signature(tdes.optimize_array).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tdes.optimize_array(np.zeros((3, 2)), PTS, steps=1)


@pytest.mark.gpu
def test_card_matches_cpu_path():
    """``optimize_array`` on the card: 30 steps' history within 1e-4
    relative and positions within 1e-5 m of the CPU path's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(0)
    init = rng.uniform(-0.05, 0.05, (4, 2)).astype(np.float32)
    kw = dict(aperture_m=0.15, min_separation_m=0.05, steps=30)
    pos_c, hist_c = tdes.optimize_array(init, PTS, device="cpu", **kw)
    pos_g, hist_g = tdes.optimize_array(init, PTS, device="cuda", **kw)
    np.testing.assert_allclose(hist_g, hist_c, rtol=1e-4)
    np.testing.assert_allclose(pos_g, pos_c, atol=1e-5)
