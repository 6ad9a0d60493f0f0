"""PyTorch port, ``models/fusion`` and ``ops.solver.solve_tdoa_sync``
against the JAX package's, on the same seeded numpy inputs.

``ArrayFusionLocalizer`` on ``examples/advanced.py``'s two square arrays
2 m apart (``tests/test_fusion.py``'s scene, with per-array weights),
through the JAX package's unfused path and its Pallas GCC kernel in
interpret mode, built by ``create`` and from the JAX package's
``FusionParams``: best shifts equal, TDOAs within 1e-3 samples, fused
scores within 1e-4 of their scale (bf16 scoring as well), the grid peak
within 1e-6 m, xy within 2e-4 m, rms within 1e-5 m, the covariance
within 1e-3 relative, the per-array confidence within 1e-4 relative.
``localize_sync`` on ``tests/test_sync_fusion.py``'s three unsynchronised
arrays, offset only and with event times (drift): cross-array TDOAs
within 1e-3 samples, clock offsets within 1e-3 samples (2e-8 s), drifts
within 1e-9 s/s (over the 30 s scene, 3e-8 s: 1.5e-3 samples at most),
sync positions within 2e-4 m.  ``solve_tdoa_sync`` on exact TDOAs in
float32 (offsets 1e-3 samples, xy 2e-4 m) and float64 (1e-9 m, 1e-12 s).
``register_arrays`` (2-D with a zero-weighted outlier, a reflection, 3-D):
rot and trans within 1e-5, rms within 1e-5; ``registered_arrays``
equal."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import fusion as jfus
from audio_triangulation_tpu.ops import solver as jsolver
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import fusion
from audio_triangulation_tpu_torch.models.fusion import ArrayFusionLocalizer
from audio_triangulation_tpu_torch.ops import solver
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

ARR_A = jgeo.square_array(0.25) + np.array([-1.0, 0.0], np.float32)
ARR_B = jgeo.square_array(0.25) + np.array([1.0, 0.0], np.float32)
GRID = dict(half_cells_x=25, half_cells_y=25, cells_per_m=12.0,
            projection="plane")
FS, C, H = 50_000.0, 343.0, 1.2
# tests/test_sync_fusion.py's scene
SYNC_ARRAYS = [jgeo.square_array(0.3),
               jgeo.square_array(0.3) + np.array([3.0, 0.5], np.float32),
               jgeo.square_array(0.3) + np.array([-1.0, 3.0], np.float32)]
CAT = np.concatenate(SYNC_ARRAYS, 0)
AID = np.repeat(np.arange(3), 4)
TRUE_OFF = np.array([0.0, 3.7, -2.2]) / FS
TRUE_DRIFT = np.array([0.0, 25e-6, -40e-6])
SYNC_SRC = np.array([[0.8, 0.9], [-0.6, 1.6], [1.8, -0.4], [0.2, 2.2],
                     [-1.2, -0.8], [2.4, 1.2], [0.5, 0.2], [-1.8, 1.0]])
SYNC_CFG = dict(phat=True, band_hz=(700.0, 7000.0))


def _world_frames(xy, arrays, noise=0.01, seed=3):
    """[B, K, M, N] f32 of sources at plane points xy (height 1.2 m)."""
    xy = np.atleast_2d(np.asarray(xy, np.float32))
    src = np.concatenate([xy, np.full((xy.shape[0], 1), H)], axis=-1)
    fr = jsynth.synth_scene(src, np.concatenate(arrays, axis=0),
                            noise_rms=noise, seed=seed)
    return fr.reshape(xy.shape[0], len(arrays), arrays[0].shape[0],
                      -1).astype(np.float32)


def _sync_frames(times=None, n_events=6, seed=7):
    """[E, 3, 4, 1024] f32 with the arrays' clock offsets (and drifts at
    ``times``) applied."""
    mic3 = np.concatenate([CAT, np.zeros((12, 1))], -1)
    src3 = np.concatenate([SYNC_SRC[:n_events],
                           np.full((n_events, 1), H)], -1)
    fr = jsynth.synth_scene(src3, mic3, noise_rms=0.004, seed=seed)
    off = (TRUE_OFF[None] if times is None else
           TRUE_OFF[None] + TRUE_DRIFT[None] * np.asarray(times)[:, None])
    fr = jsynth.fractional_delay(
        fr, np.broadcast_to(off[:, AID] * FS, fr.shape[:-1]))
    return fr.reshape(n_events, 3, 4, -1).astype(np.float32)


def _fusion_arrays(fus):
    return {k: np.asarray(v) for k, v in vars(fus.params).items()}


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _converted(ref, port):
    """The port's localizer built from the reference's constants."""
    return ArrayFusionLocalizer.from_reference_params(
        _fusion_arrays(ref), port.pipeline, port.grid, port.solver,
        device="cpu", with_solver=port.with_solver,
        sync_max_shift=ref.sync_max_shift)


def _same_outputs(g2, g):
    assert sorted(g2) == sorted(g)
    for k in g:
        scale = max(float(g[k].abs().max()), 1e-30)
        assert float((g2[k] - g[k]).abs().max()) <= 1e-6 * scale, k


def _compare(r, g, where):
    assert sorted(g) == sorted(r), where
    g = {k: v.numpy() for k, v in g.items()}
    for k in r:
        assert g[k].shape == np.shape(r[k]), (where, k)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"],
                                  err_msg=where)
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=1e-3, err_msg=where)
    scale = np.abs(r["scores"]).max()
    np.testing.assert_allclose(g["scores"] / scale, r["scores"] / scale,
                               atol=1e-4, err_msg=where)
    np.testing.assert_allclose(g["xy_grid"], r["xy_grid"], atol=1e-6,
                               err_msg=where)
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4, err_msg=where)
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=1e-5,
                               err_msg=where)
    np.testing.assert_allclose(g["confidence"], r["confidence"], rtol=1e-4,
                               err_msg=where)
    if "xy_cov" in r:
        np.testing.assert_allclose(g["xy_cov"], r["xy_cov"], rtol=1e-3,
                                   atol=1e-12, err_msg=where)
    if "tdoa_cross" in r:
        np.testing.assert_allclose(g["tdoa_cross"], r["tdoa_cross"],
                                   atol=1e-3, err_msg=where)
        np.testing.assert_allclose(g["clock_offsets_s"] * FS,
                                   r["clock_offsets_s"] * FS, atol=1e-3,
                                   err_msg=where)
        np.testing.assert_allclose(g["xy_sync"], r["xy_sync"], atol=2e-4,
                                   err_msg=where)
        np.testing.assert_allclose(g["sync_rms_m"], r["sync_rms_m"],
                                   atol=1e-5, err_msg=where)
    if "clock_drift" in r:
        np.testing.assert_allclose(g["clock_drift"], r["clock_drift"],
                                   atol=1e-9, err_msg=where)


# ----------------------------------------------------------------------
# ArrayFusionLocalizer
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("weights", [None, (1.0, 0.4)])
def test_fusion_matches_reference(weights, fused, monkeypatch):
    """Four events; the port takes row 2 for the 2 x 4 frames a call."""
    xy = np.array([[0.6, 0.9], [-0.8, -0.5], [1.3, 0.4], [0.1, -1.2]],
                  np.float32)
    frames = _world_frames(xy, [ARR_A, ARR_B])
    ref = jfus.ArrayFusionLocalizer.create(
        [ARR_A, ARR_B], jcfg.PipelineConfig(phat=True, fused_kernel=fused,
                                            fused_tile_b=4),
        jcfg.GridConfig(**GRID))
    port = ArrayFusionLocalizer.create(
        [ARR_A, ARR_B], tcfg.PipelineConfig(phat=True),
        tcfg.GridConfig(**GRID), device="cpu")
    conv = _converted(ref, port)
    assert port.sync_max_shift == ref.sync_max_shift
    calls = []
    real = gcc_kernel.fused_gcc
    monkeypatch.setattr(gcc_kernel, "fused_gcc", lambda *a, **k: (
        calls.append((a[0].shape[0], k["with_peaks"])) or real(*a, **k)))
    w = None if weights is None else np.asarray(weights, np.float32)
    r = _np(ref(jnp.asarray(frames), None if w is None else jnp.asarray(w)))
    g = port(torch.from_numpy(frames), w)
    g2 = conv(torch.from_numpy(frames), w)
    assert calls == [(8, False), (8, False)]
    _compare(r, g, f"weights={weights}")
    _same_outputs(g2, g)
    err = np.linalg.norm(g["xy"].numpy() - xy, axis=-1)
    assert (err < 0.06).all(), err


def test_fusion_bf16_scores_and_no_solver_match_reference():
    xy = np.array([[0.3, 1.5], [-0.4, 0.6]], np.float32)
    frames = _world_frames(xy, [ARR_A, ARR_B], seed=13)
    kw = dict(phat=True, srp_dtype="bfloat16")
    ref = jfus.ArrayFusionLocalizer.create(
        [ARR_A, ARR_B], jcfg.PipelineConfig(**kw), jcfg.GridConfig(**GRID),
        with_solver=False)
    port = ArrayFusionLocalizer.create(
        [ARR_A, ARR_B], tcfg.PipelineConfig(**kw), tcfg.GridConfig(**GRID),
        with_solver=False, device="cpu")
    r = _np(ref(jnp.asarray(frames)))
    g = port(torch.from_numpy(frames.reshape(1, 2, 2, 4, 1024)))
    assert g["scores"].shape == (1, 2, 51 * 51)
    _compare(r, {k: v[0] for k, v in g.items()}, "bf16, no solver")
    np.testing.assert_array_equal(g["rms_m"].numpy(), 0.0)
    _same_outputs(_converted(ref, port)(
        torch.from_numpy(frames.reshape(1, 2, 2, 4, 1024))), g)


def test_fusion_refusals_match_reference():
    for mod, cfg, kw in ((jfus.ArrayFusionLocalizer, jcfg, {}),
                         (ArrayFusionLocalizer, tcfg, {"device": "cpu"})):
        with pytest.raises(ValueError, match="plane"):
            mod.create([ARR_A, ARR_B], cfg.PipelineConfig(),
                       cfg.GridConfig(projection="sphere"), **kw)
        with pytest.raises(ValueError, match="constrain_to_sphere"):
            mod.create([ARR_A, ARR_B], cfg.PipelineConfig(),
                       solver=cfg.SolverConfig(), **kw)
        with pytest.raises(ValueError, match="shape"):
            mod.create([ARR_A, jgeo.reference_array()], cfg.PipelineConfig(),
                       **kw)
    port = ArrayFusionLocalizer.create([ARR_A, ARR_B], device="cpu")
    with pytest.raises(ValueError, match="arrays"):
        port(torch.zeros((2, 3, 4, 1024)))
    with pytest.raises(ValueError, match="arrays"):
        port.localize_sync(torch.zeros((2, 2, 4, 1024)).reshape(
            1, 2, 2, 4, 1024))
    with pytest.raises(ValueError, match=">= 2 arrays"):
        solver.solve_tdoa_sync(
            torch.zeros((1, 6)), torch.from_numpy(ARR_A),
            torch.from_numpy(jgeo.mic_pairs(4)), torch.zeros(4,
                                                             dtype=torch.int32),
            1, speed_of_sound=C, height=H, init_xy=torch.zeros((1, 2)))


# ----------------------------------------------------------------------
# clock-synchronised fusion
# ----------------------------------------------------------------------

@pytest.mark.parametrize("drift", [False, True], ids=["offset", "drift"])
def test_localize_sync_matches_reference(drift):
    times = np.linspace(0.0, 30.0, 8).astype(np.float32) if drift else None
    frames = _sync_frames(times, n_events=8 if drift else 6,
                          seed=11 if drift else 7)
    ref = jfus.ArrayFusionLocalizer.create(SYNC_ARRAYS,
                                           jcfg.PipelineConfig(**SYNC_CFG))
    port = ArrayFusionLocalizer.create(SYNC_ARRAYS,
                                       tcfg.PipelineConfig(**SYNC_CFG),
                                       device="cpu")
    r = _np(ref.localize_sync(jnp.asarray(frames), event_times_s=times))
    g = port.localize_sync(torch.from_numpy(frames), event_times_s=times)
    assert g["tdoa_cross"].shape == (frames.shape[0], 48)
    _compare(r, g, f"drift={drift}")
    _same_outputs(_converted(ref, port).localize_sync(
        torch.from_numpy(frames), event_times_s=times), g)
    off = g["clock_offsets_s"].numpy()
    if drift:
        assert np.abs(g["clock_drift"].numpy() - TRUE_DRIFT[1:]).max() < 3e-6
    else:
        assert np.abs(off - TRUE_OFF[1:]).max() * FS < 0.6
    err = np.linalg.norm(g["xy_sync"].numpy() - SYNC_SRC[:len(frames)],
                         axis=-1)
    assert err.max() < 0.08, err


@pytest.mark.parametrize("pad", [dict(fft_pad_mode="circular"),
                                 dict(fft_size=1024)])
def test_cross_array_tdoas_grow_their_own_transform(pad):
    """A circular pad mode or a pinned transform length must not alias the
    cross-array delays of hundreds of samples."""
    frames = _sync_frames(n_events=2, seed=11)
    jc, tc = (jcfg.PipelineConfig(**SYNC_CFG, **pad),
              tcfg.PipelineConfig(**SYNC_CFG, **pad))
    ref = jfus.ArrayFusionLocalizer.create(SYNC_ARRAYS, jc)
    port = ArrayFusionLocalizer.create(SYNC_ARRAYS, tc, device="cpu")
    r = np.asarray(jfus.cross_array_tdoas(ref.params, jnp.asarray(frames),
                                          jc, ref.sync_max_shift))
    g = fusion.cross_array_tdoas(port.params, torch.from_numpy(frames), tc,
                                 port.sync_max_shift).numpy()
    assert np.abs(r).max() > 300
    np.testing.assert_allclose(g, r, atol=1e-3)


def _exact_sync_tdoas(src_xy, pairs, times=None):
    src3 = np.concatenate([src_xy, np.full((len(src_xy), 1), H)], -1)
    mic3 = np.concatenate([CAT, np.zeros((12, 1))], -1)
    d = np.linalg.norm(src3[:, None] - mic3[None], axis=-1)
    tau = (d[:, pairs[:, 1]] - d[:, pairs[:, 0]]) / C
    off = (TRUE_OFF[None] if times is None else
           TRUE_OFF[None] + TRUE_DRIFT[None] * times[:, None])
    return tau + off[:, AID[pairs[:, 1]]] - off[:, AID[pairs[:, 0]]]


@pytest.mark.parametrize("drift", [False, True], ids=["offset", "drift"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_solve_tdoa_sync_matches_reference(drift, dtype):
    """Exact TDOAs of every pair of the 12 mics, inits 0.2-0.3 m off, with
    per-pair weights; array 0 the time reference."""
    rng = np.random.default_rng(3 if drift else 0)
    pairs = jgeo.mic_pairs(12)
    src = rng.uniform(-2, 2, (8, 2))
    times = np.linspace(0.0, 40.0, 8) if drift else None
    tdoa = _exact_sync_tdoas(src, pairs, times).astype(dtype)
    init = (src + rng.normal(0, 0.25, src.shape)).astype(dtype)
    w = rng.uniform(0.5, 1.0, len(pairs)).astype(dtype)
    kw = dict(speed_of_sound=C, height=H, iterations=12, damping=1e-3)
    jt = None if times is None else jnp.asarray(times.astype(dtype))
    tt = None if times is None else torch.from_numpy(times.astype(dtype))
    ref = jsolver.solve_tdoa_sync(
        jnp.asarray(tdoa), jnp.asarray(CAT.astype(dtype)),
        jnp.asarray(pairs), jnp.asarray(AID), 3, init_xy=jnp.asarray(init),
        weights=jnp.asarray(w), event_times_s=jt, **kw)
    got = solver.solve_tdoa_sync(
        torch.from_numpy(tdoa), torch.from_numpy(CAT.astype(dtype)),
        torch.from_numpy(pairs), torch.from_numpy(AID), 3,
        init_xy=torch.from_numpy(init), weights=torch.from_numpy(w),
        event_times_s=tt, **kw)
    assert len(got) == len(ref) == (4 if drift else 3)
    ref = [np.asarray(v) for v in ref]
    got = [v.numpy() for v in got]
    f64 = dtype == "float64"
    np.testing.assert_allclose(got[0], ref[0], atol=1e-9 if f64 else 2e-4)
    np.testing.assert_allclose(got[1], ref[1],
                               atol=1e-12 if f64 else 1e-3 / FS)
    if drift:
        np.testing.assert_allclose(got[2], ref[2],
                                   atol=1e-14 if f64 else 1e-9)
    np.testing.assert_allclose(got[-1], ref[-1], atol=1e-9 if f64 else 1e-5)
    assert np.abs(got[0] - src).max() < 2e-3
    if drift:  # the offsets are those at the mean event time
        assert np.abs(got[2] - TRUE_DRIFT[1:]).max() < 1e-7
    else:
        assert np.abs(got[1] - TRUE_OFF[1:]).max() * FS < 0.02


def test_solve_tdoa_sync_init_offsets_match_reference():
    rng = np.random.default_rng(5)
    pairs = jgeo.mic_pairs(12)
    src = rng.uniform(-2, 2, (4, 2))
    tdoa = _exact_sync_tdoas(src, pairs).astype(np.float32)
    init = (src + 0.1).astype(np.float32)
    off0 = np.float32(TRUE_OFF[1:] * 0.5)
    kw = dict(speed_of_sound=C, height=H, iterations=3)
    ref = jsolver.solve_tdoa_sync(
        jnp.asarray(tdoa), jnp.asarray(CAT), jnp.asarray(pairs),
        jnp.asarray(AID), 3, init_xy=jnp.asarray(init),
        init_offsets_s=jnp.asarray(off0), **kw)
    got = solver.solve_tdoa_sync(
        torch.from_numpy(tdoa), torch.from_numpy(CAT),
        torch.from_numpy(pairs), torch.from_numpy(AID), 3,
        init_xy=torch.from_numpy(init),
        init_offsets_s=torch.from_numpy(off0), **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=2e-4)
    np.testing.assert_allclose(got[1].numpy() * FS, np.asarray(ref[1]) * FS,
                               atol=1e-3)


# ----------------------------------------------------------------------
# registration
# ----------------------------------------------------------------------

def _rot(a):
    return np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]],
                    np.float32)


def _registration_case(name):
    rng = np.random.default_rng({"2d": 0, "mirror": 1, "3d": 2}[name])
    if name == "2d":
        trs = np.array([[0.0, 0.0], [2.0, 1.0], [-1.5, 0.8]])
        world = rng.uniform(-2, 2, size=(7, 2))
        local = np.stack([(world - t) @ _rot(a)
                          for a, t in zip([0.0, 0.7, -2.1], trs)])
        local += rng.normal(0, 0.01, local.shape)
        local[2, 3] = [9.0, -9.0]  # an outlier, weighted 0
        w = np.ones((3, 7), np.float32)
        w[2, 3] = 0.0
        return local.astype(np.float32), w
    if name == "mirror":
        pts = rng.uniform(-1, 1, size=(6, 2)).astype(np.float32)
        return np.stack([pts, pts * np.array([1.0, -1.0], np.float32)]), None
    cz, sz, cx, sx = np.cos(0.5), np.sin(0.5), np.cos(0.2), np.sin(0.2)
    r = (np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
         @ np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]))
    world = rng.uniform(-2, 2, size=(8, 3))
    return np.stack([world, (world - [0.5, -1.0, 0.3]) @ r]).astype(
        np.float32), None


@pytest.mark.parametrize("name", ["2d", "mirror", "3d"])
def test_register_arrays_matches_reference(name):
    local, w = _registration_case(name)
    ref = jfus.register_arrays(
        jnp.asarray(local), weights=None if w is None else jnp.asarray(w))
    got = fusion.register_arrays(
        torch.from_numpy(local), weights=None if w is None else
        torch.from_numpy(w))
    for k in ("rot", "trans", "rms"):
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    det = np.linalg.det(got["rot"].numpy())
    np.testing.assert_allclose(det, 1.0, atol=1e-5)
    np.testing.assert_allclose(got["rot"][0].numpy(),
                               np.eye(local.shape[-1]), atol=1e-5)
    mics = [ARR_A] * local.shape[0] if local.shape[-1] == 2 else None
    if mics is not None:
        for a, b in zip(fusion.registered_arrays(mics, got),
                        jfus.registered_arrays(mics, ref)):
            np.testing.assert_allclose(a, b, atol=1e-5)
    # a numpy input runs on the CPU as well
    np_in = fusion.register_arrays(local, weights=w)
    for k in got:
        assert torch.equal(np_in[k], got[k]), k


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["fusion", "sync_offset", "sync_drift",
                                  "register"])
def test_fusion_card_matches_cpu(cuda_device, what):
    if what == "register":
        local, w = _registration_case("2d")
        cpu = fusion.register_arrays(torch.from_numpy(local),
                                     weights=torch.from_numpy(w))
        card = fusion.register_arrays(torch.from_numpy(local).to(cuda_device),
                                      weights=torch.from_numpy(w).to(
                                          cuda_device))
        for k in cpu:
            assert card[k].is_cuda
            np.testing.assert_allclose(card[k].cpu().numpy(),
                                       cpu[k].numpy(), atol=1e-5)
        return
    if what == "fusion":
        arrays, cfg = [ARR_A, ARR_B], tcfg.PipelineConfig(phat=True)
        frames = _world_frames([[0.6, 0.9], [-0.8, -0.5]], arrays)
    else:
        arrays, cfg = SYNC_ARRAYS, tcfg.PipelineConfig(**SYNC_CFG)
        frames = _sync_frames()
    times = (np.linspace(0.0, 30.0, len(frames)).astype(np.float32)
             if what == "sync_drift" else None)
    outs = []
    for dev in ("cpu", cuda_device):
        port = ArrayFusionLocalizer.create(arrays, cfg, device=dev)
        f = torch.from_numpy(frames).to(dev)
        out = (port(f) if what == "fusion"
               else port.localize_sync(f, event_times_s=times))
        outs.append({k: v.cpu() for k, v in out.items()})
    _compare({k: v.numpy() for k, v in outs[0].items()}, outs[1], what)
