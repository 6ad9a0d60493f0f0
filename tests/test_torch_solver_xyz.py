"""PyTorch port, the rest of the solver layer: ``solve_tdoa`` (one frame,
forward-mode Jacobian), the free 3-D ``solve_tdoa_xyz`` and its multi-start,
and ``farfield_bearing``, against the JAX package's functions on the same
numpy inputs.

Tolerances: ``solve_tdoa`` in f32 on both sides, positions 5e-5 m as the
batched solver's test (f32 rounding of the ~1 m distances, amplified by a
small array's geometric dilution) and rms 1e-6 m; unit bearings 1e-5.
The free 3-D solve of a 30 cm array is far worse conditioned in range
(range enters only through the wavefronts' curvature), and it works on
the normal equations' M-space statistics, whose f32 rounding (about 5e-7 m
on sums of ~6 m) its conditioning amplifies.  So it is held twice: in
float64 on both sides, positions within 1e-8 m and rms within 1e-10 m (the
same algorithm); and the port's float32 solve against the float64
solution in measurement space, its predicted TDOAs within 2e-7 s and its
rms within 5e-5 m.  On these inputs the JAX package's own float32 solve is
7.4e-8 s and 1.2e-5 m from that solution, and up to 7 cm from it in
position."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import solver as jsolver
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops import solver as tsolver

C, H = 343.0, 1.2
TETRA = jgeo.tetrahedral_array(0.3)


def _tdoas(mics, src, rng, noise=1e-7):
    """Exact TDOAs [B, P] (seconds) of sources [B, 3] at mics [M, 2|3],
    plus Gaussian noise."""
    pairs = jgeo.mic_pairs(mics.shape[0])
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, :mics.shape[1]] = mics
    d = np.linalg.norm(src[:, None, :] - mic3, axis=-1)
    tau = (d[:, pairs[:, 1]] - d[:, pairs[:, 0]]) / C
    return pairs, (tau + rng.normal(0, noise, tau.shape)).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weights"])
@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
def test_solve_tdoa_matches(rng, sphere, weighted):
    mics = jgeo.circular_array(6, 0.25)
    xy = rng.uniform(-1, 1, (4, 2))
    v = np.concatenate([xy, np.full((4, 1), H)], axis=1)
    src = v * (H / np.linalg.norm(v, axis=1, keepdims=True)) if sphere else v
    pairs, taus = _tdoas(mics, src, rng)
    init = (xy * 0.9 + 0.02).astype(np.float32)
    w = (np.linspace(0.5, 1.5, len(pairs)).astype(np.float32)
         if weighted else None)
    kw = dict(iterations=8, constrain_to_sphere=sphere)
    for i in range(len(xy)):
        ref_xy, ref_rms = jsolver.solve_tdoa(
            jnp.asarray(taus[i]), jnp.asarray(mics), jnp.asarray(pairs),
            speed_of_sound=C, height=H, init_xy=jnp.asarray(init[i]),
            weights=None if w is None else jnp.asarray(w),
            cfg=jcfg.SolverConfig(**kw))
        got_xy, got_rms = tsolver.solve_tdoa(
            torch.from_numpy(taus[i]), torch.from_numpy(mics),
            torch.from_numpy(pairs), speed_of_sound=C, height=H,
            init_xy=torch.from_numpy(init[i]),
            weights=None if w is None else torch.from_numpy(w),
            cfg=tcfg.SolverConfig(**kw))
        assert got_xy.shape == (2,) and got_rms.shape == ()
        np.testing.assert_allclose(got_xy.numpy(), np.asarray(ref_xy),
                                   atol=5e-5)
        np.testing.assert_allclose(got_rms.numpy(), np.asarray(ref_rms),
                                   atol=1e-6)
        # and it found the source
        np.testing.assert_allclose(got_xy.numpy(), xy[i], atol=2e-3)


# sources [B, 3]: around the array, one nearly overhead, one low
SOURCES = np.array([[0.8, 0.3, 1.1], [-0.6, 0.9, 0.7], [0.02, -0.03, 1.5],
                    [1.2, -1.0, 0.3], [-0.4, -0.5, 2.2]])


def _predicted(xyz, mics, pairs):
    """float64 TDOAs [B, P] of positions [B, 3]."""
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, :mics.shape[1]] = mics
    d = np.linalg.norm(np.asarray(xyz, np.float64)[:, None, :] - mic3,
                       axis=-1)
    return (d[:, pairs[:, 1]] - d[:, pairs[:, 0]]) / C


def _hold_xyz(jfn, tfn, mics, pairs, taus, init):
    """The port's ``tfn`` against the JAX package's ``jfn`` in float64, and
    its float32 solve against that float64 solution (module docstring)."""
    def run(fn, lib, dt):
        return [np.asarray(o) if lib is jnp else o.numpy() for o in fn(
            *(lib.asarray(a.astype(dt)) if lib is jnp
              else torch.from_numpy(a.astype(dt))
              for a in (taus, mics, pairs.astype(np.int32), init)))]

    ref = run(jfn, jnp, np.float64)
    assert ref[0].dtype == np.float64  # the tests run JAX with x64 on
    got64 = run(tfn, torch, np.float64)
    np.testing.assert_allclose(got64[0], ref[0], atol=1e-8)
    np.testing.assert_allclose(got64[1], ref[1], atol=1e-10)
    got = run(tfn, torch, np.float32)
    assert got[0].shape == (len(taus), 3) and got[0].dtype == np.float32
    np.testing.assert_allclose(_predicted(got[0], mics, pairs),
                               _predicted(ref[0], mics, pairs), atol=2e-7)
    np.testing.assert_allclose(got[1], ref[1], atol=5e-5)
    return got


@pytest.mark.parametrize("name", ["tetra", "square"])
def test_solve_tdoa_xyz_matches(rng, name):
    mics = TETRA if name == "tetra" else jgeo.square_array(0.3)
    pairs, taus = _tdoas(mics, SOURCES, rng)
    init = (SOURCES + rng.normal(0, 0.1, SOURCES.shape)).astype(np.float32)
    init[:, 2] = np.abs(init[:, 2])
    got = _hold_xyz(
        lambda t, m, p, i: jsolver.solve_tdoa_xyz(
            t, m, p, speed_of_sound=C, init_xyz=i),
        lambda t, m, p, i: tsolver.solve_tdoa_xyz(
            t, m, p, speed_of_sound=C, init_xyz=i),
        mics, pairs, taus, init)
    assert float(got[0][:, 2].min()) >= 0.05  # the clamp


@pytest.mark.parametrize("name", ["tetra", "square"])
def test_solve_tdoa_xyz_multistart_matches(rng, name):
    """Three starting heights from the planar position; the overhead source
    (index 2) is where one start alone stalls."""
    mics = TETRA if name == "tetra" else jgeo.square_array(0.3)
    pairs, taus = _tdoas(mics, SOURCES, rng)
    init_xy = (SOURCES[:, :2] + 0.05).astype(np.float32)
    got = _hold_xyz(
        lambda t, m, p, i: jsolver.solve_tdoa_xyz_multistart(
            t, m, p, speed_of_sound=C, init_xy=i),
        lambda t, m, p, i: tsolver.solve_tdoa_xyz_multistart(
            t, m, p, speed_of_sound=C, init_xy=i),
        mics, pairs, taus, init_xy)
    if name == "tetra":  # a non-coplanar array finds the near sources
        np.testing.assert_allclose(got[0][:4], SOURCES[:4], atol=0.02)


@pytest.mark.parametrize("name", ["planar_2d", "tetra_3d", "coplanar_3d"])
def test_farfield_bearing_matches(rng, name):
    mics = {"planar_2d": jgeo.circular_array(6, 0.25), "tetra_3d": TETRA,
            "coplanar_3d": np.concatenate(
                [jgeo.square_array(0.3), np.zeros((4, 1), np.float32)],
                axis=1)}[name]
    dim = mics.shape[1]
    u = rng.normal(size=(2, 3, 3))
    u[..., 2] = np.abs(u[..., 2])
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    pairs = jgeo.mic_pairs(mics.shape[0])
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, :dim] = mics
    dm = mic3[pairs[:, 1]] - mic3[pairs[:, 0]]
    taus = (-(u @ dm.T) / C).astype(np.float32)  # [2, 3, P], far field
    ref = np.asarray(jsolver.farfield_bearing(
        jnp.asarray(taus), jnp.asarray(mics), jnp.asarray(pairs), C))
    got = tsolver.farfield_bearing(torch.from_numpy(taus),
                                   torch.from_numpy(mics),
                                   torch.from_numpy(pairs), C)
    assert got.shape == (2, 3, dim)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    if name == "tetra_3d":
        np.testing.assert_allclose(got.numpy(), u, atol=1e-5)
    elif name == "coplanar_3d":  # z collapses to ~0, x and y the direction
        assert float(got[..., 2].abs().max()) < 1e-3
        want = u[..., :2] / np.linalg.norm(u[..., :2], axis=-1,
                                           keepdims=True)
        np.testing.assert_allclose(got[..., :2].numpy(), want, atol=1e-5)
