"""PyTorch port, ``models/volume`` (with ``VolumeConfig`` and
``geometry.volume_points`` / ``volume_lag_lut``) against the JAX
package's, on the same seeded numpy inputs.

Held exactly: the configuration's derived sizes, the volume points and
lag LUT, the best shifts; the grid peak 'xyz_grid' and the refined peak
of ``volume_peak_xyz`` within 1e-6 m (an ulp of the cell-to-metre
arithmetic).  ``VolumeLocalizer`` on the
tetrahedron (matmul and gather forms) and on the 8-mic planar circle of
``examples/advanced.py`` (gather form), through the JAX package's unfused
path and its Pallas GCC kernel in interpret mode, built by ``create`` and
from the JAX package's ``LocalizerParams``: TDOAs within 1e-3 samples,
scores within 1e-4 of their scale.  The free 3-D
solve is ill-conditioned in range (the JAX package's own unfused and
kernel paths put the 8-mic scene's sources 6.8e-4 m apart from TDOAs
8e-6 samples apart), so 'xyz' is held as ``tests/test_torch_solver_xyz.py``
holds that solve: in measurement space, the TDOAs it predicts within
2e-7 s (0.01 samples) of those the reference's 'xyz' predicts, and in
position within 2e-3 m (worst measured 4.7e-4), its rms within 5e-5 m
(worst measured 1.0e-5); the volume's own call of
the solve (``iterations`` + 3 steps, the z floor) in float64 within 1e-8
m of the reference's.  The batched gather equals the whole gather."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import volume as jvol
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch import VolumeConfig, VolumeLocalizer
from audio_triangulation_tpu_torch.core import config as tcfg, geometry
from audio_triangulation_tpu_torch.models import volume
from audio_triangulation_tpu_torch.ops import srp
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gcc_large

TETRA = jgeo.tetrahedral_array(0.3)
MICS8 = jgeo.circular_array(8, 0.5)
FS, C = 50_000.0, 343.0
# tests/test_volume.py's accuracy configuration and box
CFG_T = dict(phat=True, band_hz=(700.0, 7000.0), window_enabled=False)
VOL_T = dict(half_cells_x=16, half_cells_y=16, cells_per_m=10.0, z_min_m=0.3,
             z_max_m=2.1, z_cells=19)
# examples/advanced.py's volumetric box
VOL8 = dict(half_cells_x=24, half_cells_y=24, cells_per_m=16.0, z_min_m=0.4,
            z_max_m=1.2, z_cells=5)


def _predicted(xyz, mics):
    """TDOAs in samples [B, P] of sources xyz [B, 3] (float64)."""
    m3 = np.zeros((mics.shape[0], 3))
    m3[:, :mics.shape[1]] = mics
    d = np.linalg.norm(np.asarray(xyz, np.float64)[:, None] - m3, axis=-1)
    pairs = jgeo.mic_pairs(mics.shape[0])
    return (d[:, pairs[:, 1]] - d[:, pairs[:, 0]]) / C * FS


def _compare(r, g, mics, where):
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
    np.testing.assert_allclose(g["correlograms"] / scale,
                               r["correlograms"] / scale, atol=1e-4,
                               err_msg=where)
    np.testing.assert_allclose(g["xyz_grid"], r["xyz_grid"], atol=1e-6,
                               err_msg=where)
    lead = g["xyz"].shape[:-1]
    np.testing.assert_allclose(
        _predicted(g["xyz"].reshape(-1, 3), mics),
        _predicted(np.asarray(r["xyz"]).reshape(-1, 3), mics), atol=1e-2,
        err_msg=where)
    np.testing.assert_allclose(g["xyz"], r["xyz"], atol=2e-3, err_msg=where)
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=5e-5,
                               err_msg=where)
    assert lead == np.shape(r["rms_m"])


# ----------------------------------------------------------------------
# configuration and constants
# ----------------------------------------------------------------------

@pytest.mark.parametrize("vol", [VOL_T, VOL8, dict(z_cells=1, z_min_m=1.1,
                                                   z_max_m=1.1)])
def test_volume_config_and_lut_equal_reference(vol):
    j, t = jcfg.VolumeConfig(**vol), tcfg.VolumeConfig(**vol)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for k in ("width", "height", "depth", "num_cells", "z_step_m"):
        assert getattr(t, k) == getattr(j, k), k
    np.testing.assert_array_equal(geometry.volume_points(t),
                                  jgeo.volume_points(j))
    for mics in (TETRA, MICS8):
        pairs = jgeo.mic_pairs(mics.shape[0])
        cfg = dict(max_shift_samples=jgeo.max_lag_for_array(
            mics, jcfg.PipelineConfig()))
        np.testing.assert_array_equal(
            geometry.volume_lag_lut(t, mics, pairs,
                                    tcfg.PipelineConfig(**cfg)),
            jgeo.volume_lag_lut(j, mics, pairs, jcfg.PipelineConfig(**cfg)))


def test_volume_config_refusals():
    for kw, match in ((dict(z_cells=0), "z_cells"),
                      (dict(z_min_m=2.0, z_max_m=1.0), "z_max_m")):
        with pytest.raises(ValueError, match=match):
            tcfg.VolumeConfig(**kw)
        with pytest.raises(ValueError, match=match):
            jcfg.VolumeConfig(**kw)


@pytest.mark.parametrize("vol", [
    dict(half_cells_x=8, half_cells_y=8, cells_per_m=10.0, z_min_m=0.5,
         z_max_m=1.5, z_cells=11),
    dict(half_cells_x=6, half_cells_y=5, cells_per_m=8.0, z_min_m=0.5,
         z_max_m=0.9, z_cells=2)])
def test_volume_peak_xyz_matches_reference(vol):
    """Smooth bumps (one inside the box, one on its edge, one at the
    bottom), refined and not; an axis of 2 cells is never refined."""
    v = tcfg.VolumeConfig(**vol)
    pts = jgeo.volume_points(jcfg.VolumeConfig(**vol)).astype(np.float64)
    scores = np.stack([np.exp(-((pts - c) ** 2).sum(-1) / 0.08).reshape(-1)
                       for c in ([0.234, -0.158, 0.973], [0.8, 0.1, 1.0],
                                 [-0.1, 0.2, 0.5])]).astype(np.float32)
    for refine in (True, False):
        ref = np.asarray(jvol.volume_peak_xyz(
            jnp.asarray(scores), jcfg.VolumeConfig(**vol), refine=refine))
        got = volume.volume_peak_xyz(torch.from_numpy(scores), v,
                                     refine=refine)
        assert got.shape == (3, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)


# ----------------------------------------------------------------------
# VolumeLocalizer
# ----------------------------------------------------------------------

def _tetra_frames():
    """tests/test_volume.py's two sources anywhere in the box."""
    src = np.array([[0.5, -0.3, 1.4], [-0.8, 0.6, 0.7]])
    return src, jsynth.synth_scene(src, TETRA, noise_rms=0.005,
                                   seed=4).astype(np.float32)


def _arrays(loc):
    return {k: np.asarray(v) for k, v in vars(loc.params).items()
            if v is not None}


def _converted(ref, port):
    """The port's localizer built from the reference's constants."""
    return VolumeLocalizer.from_reference_params(
        _arrays(ref), port.pipeline, port.volume, port.solver,
        srp_form=port.srp_form, with_solver=port.with_solver, device="cpu")


def _same_outputs(g2, g):
    for k in g:
        scale = max(float(g[k].abs().max()), 1e-30)
        assert float((g2[k] - g[k]).abs().max()) <= 1e-6 * scale, k


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("form", ["matmul", "gather"])
def test_volume_tetra_matches_reference(form, fused, monkeypatch):
    src, frames = _tetra_frames()
    ref = jvol.VolumeLocalizer.create(
        TETRA, jcfg.PipelineConfig(**CFG_T, fused_kernel=fused,
                                   fused_tile_b=2),
        jcfg.VolumeConfig(**VOL_T), srp_form=form)
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), srp_form=form,
                                  device="cpu")
    assert port.pipeline.max_shift == ref.pipeline.max_shift == 73
    conv = _converted(ref, port)
    calls = []
    real = gcc_kernel.fused_gcc
    monkeypatch.setattr(gcc_kernel, "fused_gcc", lambda *a, **k: (
        calls.append(k["with_peaks"]) or real(*a, **k)))
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = port(torch.from_numpy(frames))
    g2 = conv(torch.from_numpy(frames))
    assert calls == [False, False]
    _compare(r, g, TETRA, f"{form} {fused}")
    _same_outputs(g2, g)
    assert (np.linalg.norm(g["xyz"].numpy() - src, axis=-1) < 0.1).all()


def test_volume_without_solver_matches_reference():
    """Without the solver 'xyz' is the per-axis refined grid peak."""
    _, frames = _tetra_frames()
    ref = jvol.VolumeLocalizer.create(
        TETRA, jcfg.PipelineConfig(**CFG_T), jcfg.VolumeConfig(**VOL_T),
        with_solver=False)
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), with_solver=False,
                                  device="cpu")
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = port(torch.from_numpy(frames).reshape(1, 2, 4, 1024))
    assert g["xyz"].shape == (1, 2, 3) and g["rms_m"].shape == (1, 2)
    np.testing.assert_allclose(g["xyz"].numpy()[0], r["xyz"], atol=1e-6)
    np.testing.assert_array_equal(g["rms_m"].numpy(), 0.0)
    _same_outputs(_converted(ref, port)(
        torch.from_numpy(frames).reshape(1, 2, 4, 1024)), g)


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
def test_volume_planar_8mic_matches_reference(fused):
    """``examples/advanced.py``'s box on the 0.5 m circle: 12,005 cells,
    147 lags, the gather form (its one-hot would take 397 MB)."""
    src = np.array([[0.3, 0.2, 0.6], [-0.3, 0.4, 1.0], [0.5, -0.3, 0.8]])
    frames = jsynth.synth_scene(src, MICS8, noise_rms=0.01,
                                seed=61).astype(np.float32)
    ref = jvol.VolumeLocalizer.create(
        MICS8, jcfg.PipelineConfig(fused_kernel=fused, fused_tile_b=2),
        jcfg.VolumeConfig(**VOL8))
    port = VolumeLocalizer.create(MICS8, tcfg.PipelineConfig(),
                                  VolumeConfig(**VOL8), device="cpu")
    assert port.srp_form == ref.srp_form == "gather"
    assert port.pipeline.num_lags == 295 and port.volume.num_cells == 12005
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = port(torch.from_numpy(frames))
    _compare(r, g, MICS8, f"8mic {fused}")
    _same_outputs(_converted(ref, port)(torch.from_numpy(frames)), g)
    assert (np.linalg.norm(g["xyz"].numpy() - src, axis=-1) < 0.05).all()


def test_volume_solve_call_float64_matches_reference(monkeypatch):
    """The volume's solve, as each package calls it, in float64 from the
    same TDOAs and grid peaks: 1e-8 m."""
    from audio_triangulation_tpu.ops import solver as jsolver
    from audio_triangulation_tpu_torch.ops import solver

    src, frames = _tetra_frames()
    vol = jcfg.VolumeConfig(**VOL_T)
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), device="cpu")
    out = port(torch.from_numpy(frames))
    seen = {}
    real = solver.solve_tdoa_xyz

    def spy(tdoas, mics, pairs, **kw):
        seen.update(kw)
        return real(tdoas, mics, pairs, **kw)

    monkeypatch.setattr(solver, "solve_tdoa_xyz", spy)
    port(torch.from_numpy(frames))
    assert seen["iterations"] == port.solver.iterations + 3 == 8
    assert seen["z_min"] == min(vol.z_min_m, 0.05)
    tdoa = out["tdoa_samples"].double().numpy() / FS
    init = out["xyz_grid"].double().numpy()
    pairs = jgeo.mic_pairs(4)
    ref = jvol.solver_ops.solve_tdoa_xyz(
        jnp.asarray(tdoa), jnp.asarray(TETRA, jnp.float64),
        jnp.asarray(pairs), speed_of_sound=C, init_xyz=jnp.asarray(init),
        iterations=8, z_min=min(vol.z_min_m, 0.05))
    assert jvol.solver_ops is jsolver
    got = real(torch.from_numpy(tdoa), torch.from_numpy(
        TETRA.astype(np.float64)), torch.from_numpy(pairs),
        speed_of_sound=C, init_xyz=torch.from_numpy(init),
        iterations=seen["iterations"], z_min=seen["z_min"])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), atol=1e-8)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=1e-10)
    assert (np.linalg.norm(got[0].numpy() - src, axis=-1) < 0.1).all()


def test_batched_gather_equals_whole(monkeypatch):
    """Slices of the batch (here 3 frames at a time) give the whole
    gather's scores exactly."""
    rng = np.random.default_rng(7)
    corr = torch.from_numpy(rng.normal(size=(10, 28, 31)).astype(np.float32))
    lut = torch.from_numpy(rng.integers(0, 31, (28, 500)).astype(np.int32))
    whole = srp.srp_scores_gather(corr, lut)
    per_frame = 28 * 500 * 4
    for slice_bytes in (3 * per_frame, per_frame - 1, 1 << 30):
        got = srp.srp_scores_gather_batched(corr, lut, slice_bytes)
        assert torch.equal(got, whole), slice_bytes
    _, frames = _tetra_frames()
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), srp_form="gather",
                                  device="cpu")
    full = port(torch.from_numpy(frames))
    monkeypatch.setattr(volume, "GATHER_SLICE_BYTES",
                        6 * VolumeConfig(**VOL_T).num_cells * 4)
    sliced = port(torch.from_numpy(frames))
    assert torch.equal(sliced["scores"], full["scores"])


def test_volume_frame_too_large_for_the_gcc_kernel_takes_the_large_kernel(
        monkeypatch):
    """Where ``gcc_kernel.fits`` says a frame does not fit the GCC kernel's
    shared memory (on the CPU it always fits, so it is patched here), the
    volume's raw correlograms come from the large-array kernel, as on the
    card at 20 mics, and the outputs equal the GCC kernel's route's
    (TDOAs within 1e-3 samples, scores within 1e-4 of scale, the grid
    peak within 1e-6 m, 'xyz' as the reference comparison holds it)."""
    _, frames = _tetra_frames()
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), device="cpu")
    want = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    calls = []
    real = gcc_large.xcorr_large
    monkeypatch.setattr(gcc_large, "xcorr_large", lambda *a, **k: (
        calls.append(1) or real(*a, **k)))
    monkeypatch.setattr(gcc_kernel, "fits", lambda *a, **k: False)
    monkeypatch.setattr(gcc_kernel, "fused_gcc", None)
    got = port(torch.from_numpy(frames))
    assert calls == [1]
    _compare(want, got, TETRA, "large-array kernel route")


def test_volume_refusals():
    port = VolumeLocalizer.create(TETRA, tcfg.PipelineConfig(**CFG_T),
                                  VolumeConfig(**VOL_T), device="cpu")
    with pytest.raises(ValueError, match="mics"):
        port(torch.zeros((2, 3, 1024)))
    with pytest.raises(ValueError, match="samples"):
        port(torch.zeros((2, 4, 512)))
    with pytest.raises(ValueError, match="srp_form"):
        VolumeLocalizer.create(TETRA, srp_form="dense", device="cpu")


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("mics", ["tetra", "circle8"])
def test_volume_card_matches_cpu(cuda_device, mics):
    if mics == "tetra":
        m, cfg, vol = TETRA, tcfg.PipelineConfig(**CFG_T), VOL_T
        frames = _tetra_frames()[1]
    else:
        m, cfg, vol = MICS8, tcfg.PipelineConfig(), VOL8
        frames = jsynth.synth_scene(
            np.array([[0.3, 0.2, 0.6], [-0.3, 0.4, 1.0]]), MICS8,
            noise_rms=0.01, seed=61).astype(np.float32)
    cpu = VolumeLocalizer.create(m, cfg, VolumeConfig(**vol), device="cpu")
    card = VolumeLocalizer.create(m, cfg, VolumeConfig(**vol),
                                  device=cuda_device)
    r = {k: v.numpy() for k, v in cpu(torch.from_numpy(frames)).items()}
    g = card(torch.from_numpy(frames).to(cuda_device))
    _compare(r, {k: v.cpu() for k, v in g.items()}, m, mics)


@pytest.mark.gpu
def test_volume_route_past_the_kernels_shared_memory(cuda_device):
    """20 mics on the 0.5 m circle: 190 pairs of 295 lags do not fit the
    GCC kernel's shared memory, so the localizer takes the large-array
    kernel (decided from the shape, ``gcc_kernel.fits``) and equals the
    CPU path."""
    mics = jgeo.circular_array(20, 0.5)
    vol = VolumeConfig(half_cells_x=6, half_cells_y=6, cells_per_m=8.0,
                       z_min_m=0.4, z_max_m=1.2, z_cells=3)
    card = VolumeLocalizer.create(mics, tcfg.PipelineConfig(), vol,
                                  device=cuda_device)
    cpu = VolumeLocalizer.create(mics, tcfg.PipelineConfig(), vol,
                                 device="cpu")
    frames = jsynth.synth_scene(np.array([[0.3, 0.2, 0.8]]), mics,
                                noise_rms=0.01, seed=3).astype(np.float32)
    x = torch.from_numpy(frames).to(cuda_device)
    assert not gcc_kernel.fits(x, card.pipeline, 190, with_peaks=False)
    before = gcc_kernel.launches, gcc_large.launches
    g = card(x)
    assert (gcc_kernel.launches, gcc_large.launches) == (
        before[0], before[1] + 1)
    r = {k: v.numpy() for k, v in cpu(torch.from_numpy(frames)).items()}
    _compare(r, {k: v.cpu() for k, v in g.items()}, mics, "20 mics")
