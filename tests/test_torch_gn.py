"""PyTorch port, GN kernel module: the plain version of the CUDA
Gauss-Newton kernel against the JAX package's Pallas GN kernel in
interpret mode, and the wrapper's limits and no-fallback contract."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.core import geometry as jgeo
from audio_triangulation_tpu.core.config import SolverConfig as JSolver
from audio_triangulation_tpu.ops import solver as jsolver
from audio_triangulation_tpu.ops.pallas import gn_kernel as jgn
from audio_triangulation_tpu_torch.core.config import SolverConfig
from audio_triangulation_tpu_torch.ops.cuda import gn_kernel as tgn

C, H = 343.0, 1.2
ARRAYS = {"3mic": jgeo.reference_array, "4mic": lambda: jgeo.square_array(0.3)}


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


@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_plain_gn_matches_pallas_interpret(rng, name, sphere):
    mics = ARRAYS[name]()
    pairs, taus, init = _problem(rng, mics, sphere)
    cfg = dict(iterations=5, constrain_to_sphere=sphere)
    ref_xy, ref_rms = jgn.solve_tdoa_pallas(
        jnp.asarray(taus), mics, pairs, speed_of_sound=C, height=H,
        init_xy=jnp.asarray(init), cfg=JSolver(**cfg), interpret=True)
    got_xy, got_rms = tgn.solve_tdoa_gn(
        torch.from_numpy(taus), torch.from_numpy(mics),
        torch.from_numpy(pairs), speed_of_sound=C, height=H,
        init_xy=torch.from_numpy(init), cfg=SolverConfig(**cfg))
    np.testing.assert_allclose(got_xy.numpy(), np.asarray(ref_xy), atol=1e-5)
    np.testing.assert_allclose(got_rms.numpy(), np.asarray(ref_rms),
                               atol=1e-6)


def test_gn_wrapper_limits():
    tau = torch.zeros((3, 66))
    init = torch.zeros((3, 2))
    pairs12 = torch.as_tensor(jgeo.mic_pairs(12))
    with pytest.raises(ValueError, match="at most 64"):
        tgn.solve_tdoa_gn(tau, torch.zeros((12, 2)), pairs12,
                          speed_of_sound=C, height=H, init_xy=init)
    mics3d = torch.tensor([[0.0, 0.0, 0.1], [0.2, 0.0, 0.0]])
    with pytest.raises(ValueError, match="z = 0"):
        tgn.solve_tdoa_gn(torch.zeros((3, 1)), mics3d,
                          torch.tensor([[0, 1]]), speed_of_sound=C,
                          height=H, init_xy=init)


def test_non_cpu_tensor_never_falls_back():
    before = tgn.launches
    with pytest.raises(ValueError, match="CUDA"):
        tgn.solve_tdoa_gn(torch.empty((4, 1), device="meta"),
                          torch.zeros((2, 2)), torch.tensor([[0, 1]]),
                          speed_of_sound=C, height=H,
                          init_xy=torch.empty((4, 2), device="meta"))
    assert tgn.launches == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("sphere", [True, False], ids=["sphere", "plane"])
def test_cuda_kernel_matches_plain_version(rng, cuda_device, sphere):
    mics = jgeo.square_array(0.3)
    pairs, taus, init = _problem(rng, mics, sphere, b=1000)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (taus, init, mics, pairs)]
    kw = dict(c=C, h=H, iters=5, damping=1e-3, sphere=sphere)
    ref = tgn.gn_reference(*args, **kw)
    got = tgn.launch(*args, **kw)
    assert float((got[0] - ref[0]).abs().max()) < 1e-5
    assert float((got[1] - ref[1]).abs().max()) < 1e-6
