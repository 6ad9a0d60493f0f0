"""PyTorch port, ``utils/room`` against the JAX package's, on the same
numpy inputs.

Held exactly (the numpy code is copied): ``ShoeboxRoom``'s reflections,
volume and areas, ``rt60_sabine``, ``absorption_for_rt60``,
``image_sources`` (positions, gains and their order) and ``simulate``.
``simulate_batch`` (torch float32) is held to the JAX package's jitted
float32 ``simulate_batch`` within 3e-5 of the frames' scale (its cos / sin
of phases up to 2 pi x 0.5 x ~700 samples lose ~1e-5 of scale in either
package's float32; measured 7.5e-6) and to the float64 ``simulate`` within
the JAX test's 2e-4; cut into batch slices it is equal to one slice.  The
same validation errors are raised."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch

from audio_triangulation_tpu.core import geometry as jgeo
from audio_triangulation_tpu.utils import room as jroom
from audio_triangulation_tpu_torch.utils import room as troom

SIZE = (4.0, 4.0, 2.5)
SHIFT = np.array([2.0, 2.0, 1.0])
SOURCES = np.array([[0.3, 0.2, 1.2], [-0.4, 0.5, 1.0], [0.1, -0.6, 0.4]])
ROOMS = {
    "order0": dict(size=SIZE, absorption=0.4, max_order=0),
    "order1_walls": dict(size=(6.0, 5.0, 3.0),
                         absorption=(0.99, 0.02, 0.02, 0.99, 0.99, 0.99),
                         max_order=1),
    "order2": dict(size=SIZE, absorption=0.4, max_order=2),
    "order2_mixed": dict(size=(5.0, 4.0, 3.0),
                         absorption=(0.2, 0.3, 0.4, 0.5, 0.6, 0.7),
                         max_order=2),
}


def _mics3():
    mics = jgeo.square_array(0.3)
    return np.concatenate([mics, np.zeros((mics.shape[0], 1))], -1) + SHIFT


@pytest.mark.parametrize("name", sorted(ROOMS))
def test_room_geometry_equal(name):
    jr, tr = jroom.ShoeboxRoom(**ROOMS[name]), troom.ShoeboxRoom(**ROOMS[name])
    np.testing.assert_array_equal(tr.wall_reflections(), jr.wall_reflections())
    assert tr.volume == jr.volume
    np.testing.assert_array_equal(tr.surface_areas, jr.surface_areas)
    assert troom.rt60_sabine(tr) == jroom.rt60_sabine(jr)
    for src in SOURCES + SHIFT:
        jp, jg = jroom.image_sources(src, jr)
        tp, tg = troom.image_sources(src, tr)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tg, jg)
    sign, offset, gain = troom.image_affine(tr)
    probe = np.asarray(tr.size) / 2
    np.testing.assert_allclose(sign * probe + offset,
                               troom.image_sources(probe, tr)[0], atol=1e-12)
    np.testing.assert_array_equal(gain, troom.image_sources(probe, tr)[1])


@pytest.mark.parametrize("rt60", [0.3, 0.45, 0.8])
def test_absorption_for_rt60_equal(rt60):
    size = (6.0, 5.0, 3.0)
    assert (troom.absorption_for_rt60(size, rt60)
            == jroom.absorption_for_rt60(size, rt60))


@pytest.mark.parametrize("case", ["chirp", "impulse_noise"])
def test_simulate_equal(case):
    r = dict(size=SIZE, absorption=0.4, max_order=2)
    kw = dict(n=512)
    if case == "impulse_noise":
        sig = np.zeros(16)
        sig[0] = 1.0
        kw.update(signal=sig, amplitude=1.0, noise_rms=0.01, seed=3,
                  fs=16_000.0)
    for src in SOURCES + SHIFT:
        np.testing.assert_array_equal(
            troom.simulate(src, _mics3(), troom.ShoeboxRoom(**r), **kw),
            jroom.simulate(src, _mics3(), jroom.ShoeboxRoom(**r), **kw))


@pytest.mark.parametrize("name,n", [("order1_walls", 256), ("order2", 512),
                                    ("order2_mixed", 256)])
def test_simulate_batch_matches_reference(name, n):
    src = SOURCES + SHIFT
    mics = _mics3()
    ref = np.asarray(jroom.simulate_batch(src, mics,
                                          jroom.ShoeboxRoom(**ROOMS[name]),
                                          n=n))
    got = troom.simulate_batch(src, mics, troom.ShoeboxRoom(**ROOMS[name]),
                               n=n, device="cpu")
    assert got.dtype == torch.float32 and got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= 3e-5 * scale
    f64 = np.concatenate([troom.simulate(s, mics,
                                         troom.ShoeboxRoom(**ROOMS[name]),
                                         n=n) for s in src])
    assert np.abs(got.numpy() - f64).max() < 2e-4


def test_simulate_batch_slices_equal_one_slice(monkeypatch):
    """A batch cut into slices (a budget of one source's bytes) gives the
    frames of the uncut batch."""
    room = troom.ShoeboxRoom(**ROOMS["order2"])
    src = np.concatenate([SOURCES, SOURCES[::-1] * 0.5]) + SHIFT
    whole = troom.simulate_batch(src, _mics3(), room, n=256, device="cpu")
    k = troom.image_sources(SHIFT, room)[0].shape[0]
    assert troom.slice_sources(4, k, 129) > len(src)
    one = 3 * 4 * 4 * k * 129  # one source's phase, cos and sin bytes
    assert troom.slice_sources(4, k, 129, budget=2 * one) == 2
    monkeypatch.setattr(troom, "slice_sources", lambda m, kk, f: 2)
    cut = troom.simulate_batch(src, _mics3(), room, n=256, device="cpu")
    torch.testing.assert_close(cut, whole, rtol=0, atol=1e-7)


def test_validation_errors_and_device_required():
    for mod in (jroom, troom):
        with pytest.raises(ValueError):
            mod.ShoeboxRoom(absorption=0.0).wall_reflections()
        with pytest.raises(ValueError):
            mod.ShoeboxRoom(absorption=(0.5, 0.5)).wall_reflections()
        with pytest.raises(ValueError):
            mod.image_sources([10.0, 1.0, 1.0], mod.ShoeboxRoom())
        with pytest.raises(ValueError):
            mod.absorption_for_rt60((2.0, 2.0, 2.0), 0.05)
    with pytest.raises(TypeError):
        troom.simulate_batch(SOURCES + SHIFT, _mics3(),
                             troom.ShoeboxRoom(**ROOMS["order2"]))


@pytest.mark.gpu
def test_simulate_batch_card_matches_cpu():
    """At ``max_order=6`` the card's frames within the JAX test's 2e-4 of
    the float64 ``simulate``, as the CPU path's are, and within 1e-4 of
    scale of the CPU path's: each device rounds the image distances (up to
    ~10 m) to its own last bit, which moves phases of up to ~1,600 rad by
    ~2e-4 rad (measured 3.2e-5 of scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    room = troom.ShoeboxRoom(size=(6.0, 5.0, 3.0), absorption=0.3,
                             max_order=6)
    src = SOURCES + SHIFT
    cpu = troom.simulate_batch(src, _mics3(), room, device="cpu")
    gpu = troom.simulate_batch(src, _mics3(), room, device="cuda")
    assert gpu.is_cuda and not torch.backends.cuda.matmul.allow_tf32
    f64 = np.concatenate([troom.simulate(s, _mics3(), room) for s in src])
    assert np.abs(gpu.cpu().numpy() - f64).max() < 2e-4
    assert np.abs(cpu.numpy() - f64).max() < 2e-4
    scale = float(cpu.abs().max())
    assert float((gpu.cpu() - cpu).abs().max()) <= 1e-4 * scale
