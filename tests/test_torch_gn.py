"""PyTorch port, GN kernel module: the plain version of the CUDA
Gauss-Newton kernel (solve and position covariance in one pass) against the
JAX package's Pallas GN kernel in interpret mode followed by its
``solution_covariance``, the wrapper's limits and no-fallback contract, and
the Localizer's choice of solver route.

Tolerances: xy 1e-5 m and rms 1e-6 m (f32 on both sides, the same
formulas; XLA may contract or reorder some of them).  The covariance is
held, rtol 1e-4 and atol 1e-6 of its largest entry, to the JAX package's
``solution_covariance`` evaluated at the port's own solution (the
reference forms J^T J through the pair-selection product, the kernel pair
by pair).  Against the covariance of the reference's own solution it would
also carry the rms difference: sigma^2 scales with rms^2 wherever rms is
above the 1e-4 m floor, and an rms 9e-8 m apart (inside its 1e-6 m
tolerance) moves sigma^2 by 1.6e-3 of itself at rms 1.1e-4 m (3-mic array,
source 1.4 m off axis)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.core.config import SolverConfig as JSolver
from audio_triangulation_tpu.ops import solver as jsolver
from audio_triangulation_tpu.ops.pallas import gn_kernel as jgn
from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.core.config import SolverConfig
from audio_triangulation_tpu_torch.ops.cuda import gn_kernel as tgn
from audio_triangulation_tpu_torch.utils import synth

C, H = 343.0, 1.2
ARRAYS = {"3mic": jgeo.reference_array, "4mic": lambda: jgeo.square_array(0.3),
          # 55 pairs, the largest array the kernel takes
          "11mic_circle": lambda: jgeo.circular_array(11, 0.25)}


def _problem(rng, mics, sphere, b=37):
    pairs = jgeo.mic_pairs(mics.shape[0])
    mic3 = jnp.zeros((mics.shape[0], 3), jnp.float32).at[:, :2].set(
        jnp.asarray(mics))
    xys = jnp.asarray(rng.uniform(-1.2, 1.2, (b, 2)).astype(np.float32))
    taus = jax.vmap(lambda q: jsolver.predicted_tdoas(
        q, mic3, jnp.asarray(pairs), C, H, sphere))(xys)
    taus = np.asarray(taus, np.float32) + rng.normal(
        0.0, 2e-7, taus.shape).astype(np.float32)
    init = (np.asarray(xys) * 0.9 + 0.02).astype(np.float32)
    return pairs, taus, init


def _check(mics, pairs, taus, init, cfg, got):
    """``got`` (xy, rms, cov) against the JAX package's solver tail: the
    Pallas kernel in interpret mode, then ``solution_covariance``."""
    xy, rms = jgn.solve_tdoa_pallas(
        jnp.asarray(taus), mics, pairs, speed_of_sound=C, height=H,
        init_xy=jnp.asarray(init), cfg=JSolver(**cfg), interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(xy), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(rms), atol=1e-6)
    cov = np.asarray(jsolver.solution_covariance(
        jnp.asarray(got[0].numpy()), jnp.asarray(got[1].numpy()),
        jnp.asarray(mics), jnp.asarray(pairs), height=H, cfg=JSolver(**cfg)))
    np.testing.assert_allclose(got[2].numpy(), cov, rtol=1e-4,
                               atol=1e-6 * np.abs(cov).max())


@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_plain_gn_matches_pallas_interpret(rng, name, sphere):
    mics = ARRAYS[name]()
    pairs, taus, init = _problem(rng, mics, sphere)
    cfg = dict(iterations=5, constrain_to_sphere=sphere)
    gn = tgn.GnSolver.create(mics, pairs, speed_of_sound=C, height=H,
                             cfg=SolverConfig(**cfg))
    got = gn(torch.from_numpy(taus), torch.from_numpy(init))
    assert [g.shape for g in got] == [(37, 2), (37,), (37, 2, 2)]
    _check(mics, pairs, taus, init, cfg, got)


@pytest.mark.parametrize("b", [1, 65, 130])
def test_plain_gn_ragged_batches(rng, b):
    """Batches that fill no block (the kernel's 64 threads, the Pallas
    kernel's 128 lanes, which it pads with init 0.01)."""
    mics = jgeo.square_array(0.3)
    pairs, taus, init = _problem(rng, mics, True, b=b)
    gn = tgn.GnSolver.create(mics, pairs, speed_of_sound=C, height=H)
    _check(mics, pairs, taus, init, {},
           gn(torch.from_numpy(taus), torch.from_numpy(init)))


def test_gn_wrapper_limits():
    pairs4 = jgeo.mic_pairs(4)
    mics4 = jgeo.square_array(0.3)
    kw = dict(speed_of_sound=C, height=H)
    cases = [
        (np.zeros((12, 2), np.float32), jgeo.mic_pairs(12), {}, "64 pairs"),
        (np.concatenate([mics4, [[0.1], [0], [0], [0]]], axis=1), pairs4,
         {}, "z = 0"),
        (mics4, pairs4[::-1].copy(), {}, "canonical pair list"),
        (mics4, pairs4, dict(robust="huber"), "batched solver"),
    ]
    for mics, pairs, cfg, word in cases:
        assert word in tgn.refusal(mics, pairs, SolverConfig(**cfg))
        with pytest.raises(ValueError, match=word):
            tgn.GnSolver.create(mics, pairs, cfg=SolverConfig(**cfg), **kw)
    # a coplanar [M, 3] array is taken
    mics3d = np.concatenate([mics4, np.zeros((4, 1), np.float32)], axis=1)
    assert tgn.refusal(mics3d, pairs4, SolverConfig()) is None


def test_non_cpu_tensor_never_falls_back():
    gn = tgn.GnSolver.create(jgeo.square_array(0.3), jgeo.mic_pairs(4),
                             speed_of_sound=C, height=H)
    before = tgn.launches
    with pytest.raises(ValueError, match="CUDA"):
        gn(torch.empty((4, 6), device="meta"),
           torch.empty((4, 2), device="meta"))
    assert tgn.launches == before


def _tetra_frames(rng, mics, b):
    xy = rng.uniform(-0.9, 0.9, (b, 2))
    v = np.concatenate([xy, np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, noise_rms=0.01,
                             seed=int(rng.integers(1 << 30))).astype(
                                 np.float32)


def test_localizer_solver_route():
    """The kernel's route is decided once, from the array: coplanar arrays
    of at most 11 mics without robust reweighting take it."""
    assert Localizer.create(geometry.square_array(0.3),
                            device="cpu").gn is not None
    mics3d = np.concatenate([jgeo.square_array(0.3),
                             np.zeros((4, 1), np.float32)], axis=1)
    assert Localizer.create(mics3d, device="cpu").gn is not None
    assert Localizer.create(geometry.tetrahedral_array(0.3),
                            device="cpu").gn is None
    assert Localizer.create(geometry.square_array(0.3),
                            solver=tcfg.SolverConfig(robust="huber"),
                            device="cpu").gn is None


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
def test_non_coplanar_localizer_matches_reference(rng, fused):
    """tetrahedral_array(0.3) through both Localizers: the port takes the
    batched solver (as the JAX package's CPU route does) instead of
    refusing; xy, rms_m and xy_cov at the solver tests' tolerances."""
    mics = geometry.tetrahedral_array(0.3)
    np.testing.assert_array_equal(mics, jgeo.tetrahedral_array(0.3))
    kw = dict(phat=True)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(
        **kw, fused_kernel=fused, fused_tile_b=8))
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw), device="cpu")
    frames = _tetra_frames(rng, mics, 8)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    assert sorted(g) == sorted(r)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"])
    np.testing.assert_allclose(g["xy"], r["xy"], atol=5e-5)
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=1e-6)
    np.testing.assert_allclose(g["xy_cov"], r["xy_cov"], rtol=1e-4,
                               atol=1e-6 * np.abs(r["xy_cov"]).max())


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1000, 1, 65, 16411])
@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_cuda_kernel_matches_plain_version(rng, cuda_device, name, sphere,
                                           b):
    mics = ARRAYS[name]()
    pairs, taus, init = _problem(rng, mics, sphere, b=b)
    gn = tgn.GnSolver.create(mics, pairs, speed_of_sound=C, height=H,
                             cfg=SolverConfig(iterations=5,
                                              constrain_to_sphere=sphere))
    tau, xy0 = (torch.from_numpy(a).to(cuda_device) for a in (taus, init))
    with pytest.raises(ValueError, match="float32 contiguous"):
        gn(tau.double(), xy0)
    with pytest.raises(ValueError, match="float32 contiguous"):
        gn(tau[:, :-1], xy0)
    before = tgn.launches
    got = gn(tau, xy0)
    assert tgn.launches == before + 1
    ref = gn.reference(tau, xy0)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-5
    assert float((got[1] - ref[1]).abs().max()) <= 1e-6
    scale = float(ref[2].abs().max())
    assert bool(((got[2] - ref[2]).abs()
                 <= 1e-4 * ref[2].abs() + 1e-6 * scale).all())
