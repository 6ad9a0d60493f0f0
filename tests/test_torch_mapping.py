"""PyTorch port, reflector mapping against the JAX package's on the same
numpy inputs: ``ops/echo`` (``echo_profile``, ``top_delays``) and
``models/mapping`` (``solve_image_from_ranges``, ``wall_from_image``,
``cluster_walls``, ``_hough_associate``, ``ReflectorMapper``).

Held exactly: ``top_delays``' integer lags (the sub-sample delays within
1e-3 samples, amplitudes within 1e-5), the copied host code's outputs on
the same inputs (walls, Hough groups), and in ``ReflectorMapper.map`` the
number of walls, their order and support and every event's image count.
Float tolerances: the echo profile within 1e-5 of scale; image positions
within 1e-4 m and residuals within 1e-5 m (the JAX package's solve, jitted
with x64 on in these tests, takes its bearing scan in float64); in
``map`` the source positions within 1e-4 m and wall distances and normals
within 1e-4.  The JAX tests' scenes are used as they are: one and two
reflective walls of a 6 x 5 x 3 m room (``max_order=1``) heard by a 6-mic
0.25 m circle, three events each; the walls are also found within the JAX
tests' 0.15 / 0.2 m."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import mapping as jmap
from audio_triangulation_tpu.ops import echo as jecho
from audio_triangulation_tpu.utils import room as jroom
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import mapping as tmap
from audio_triangulation_tpu_torch.models.localizer import Localizer
from audio_triangulation_tpu_torch.ops import echo as techo

M = 6
MICS = jgeo.circular_array(M, 0.25)
FS = 50_000.0
BAND = (700.0, 7000.0)


def _broadband_burst(n=1024, start=50, length=400, f0=800.0, f1=7000.0):
    """tests/test_mapping.py's full-sweep chirp in a short window."""
    sig = np.zeros(n)
    sweep = f0 + (f1 - f0) * np.arange(length) / length
    phase = 2 * np.pi * np.cumsum(sweep) / FS
    sig[start:start + length] = np.hanning(length) * np.sin(phase)
    return sig


def _echo_frames(seed=0):
    """[3, 1, 1024]: the burst with echoes at 180 and 420 samples, at 300,
    and at 95 and 97 (closer than the suppression window), noise 0.003."""
    rng = np.random.default_rng(seed)
    s = _broadband_burst()
    out = []
    for lags, amps in (((180, 420), (0.4, 0.25)), ((300,), (0.5,)),
                       ((95, 97), (0.3, 0.3))):
        x = s.copy()
        for q, a in zip(lags, amps):
            x += a * np.roll(s, q)
        out.append(x + rng.normal(0, 0.003, s.shape))
    return np.asarray(out, np.float32)[:, None, :]


@pytest.mark.parametrize("band", [BAND, None])
def test_echo_profile_and_top_delays_match_reference(band):
    frames = _echo_frames()
    prof_j = jecho.echo_profile(jnp.asarray(frames), jcfg.PipelineConfig(),
                                band_hz=band)
    prof_t = techo.echo_profile(torch.from_numpy(frames),
                                tcfg.PipelineConfig(), band_hz=band)
    scale = float(np.abs(np.asarray(prof_j)).max())
    assert float(np.abs(prof_t.numpy() - np.asarray(prof_j)).max()) <= (
        1e-5 * scale)
    prof = np.array(prof_j)  # both on the reference's profile
    for kw in (dict(q_min=40, q_max=600, n_echoes=2),
               dict(q_min=10, q_max=900, n_echoes=4, min_separation=8)):
        dj, aj = jecho.top_delays(jnp.asarray(prof), **kw)
        dt, at = techo.top_delays(torch.from_numpy(prof), **kw)
        np.testing.assert_array_equal(np.round(dt.numpy()).astype(int),
                                      np.round(np.asarray(dj)).astype(int))
        np.testing.assert_array_equal(
            np.floor(dt.numpy() + 0.5), np.floor(np.asarray(dj) + 0.5))
        np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-3)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-5)
    # the JAX test's truth on the port's own profile
    d, _ = techo.top_delays(prof_t, q_min=40, q_max=600, n_echoes=2)
    first = np.sort(d.numpy()[0, 0])
    if band is not None:
        assert abs(first[0] - 180) < 1.0 and abs(first[1] - 420) < 1.0


def test_top_delays_ties_take_the_first_lag():
    prof = np.zeros((2, 64), np.float32)
    prof[:, 20] = prof[:, 30] = 1.0  # equal peaks: the first lag wins
    prof[1, 40] = 0.5
    for mod, arr in ((techo, torch.from_numpy(prof)),
                     (jecho, jnp.asarray(prof))):
        d, a = mod.top_delays(arr, q_min=5, q_max=60, n_echoes=3,
                              min_separation=4)
        np.testing.assert_array_equal(np.asarray(d)[:, :2], [[20, 30]] * 2)
        assert float(np.asarray(d)[1, 2]) == 40.0


def test_solve_image_from_ranges_matches_reference():
    rng = np.random.default_rng(1)
    truth = np.array([[2.6, -1.1], [-1.8, 2.2], [0.4, 3.1], [-2.5, -0.7]])
    for dz in (0.0, 1.2):
        d = np.sqrt(((truth[:, None, :] - MICS) ** 2).sum(-1) + dz * dz)
        d = d + rng.normal(0, 0.002, d.shape)
        w = np.ones_like(d)
        w[1, 2], d[1, 2] = 0.0, 99.0  # a missing mic, its range garbage
        w[3, :2] = 0.0
        args = [np.asarray(a, np.float32) for a in (MICS, d, w)]
        pj, rj = jmap.solve_image_from_ranges(
            *[jnp.asarray(a) for a in args], dz)
        pt, rt = tmap.solve_image_from_ranges(
            *[torch.from_numpy(a) for a in args], dz)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-4)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-5)
        # 2 mm range noise over four mics of a 0.25 m circle: a few cm
        assert np.abs(pt.numpy() - truth).max() < 5e-2
        # one row alone gives that row's image
        p1, _ = tmap.solve_image_from_ranges(
            torch.from_numpy(args[0]), torch.from_numpy(args[1][0]),
            torch.from_numpy(args[2][0]), dz)
        np.testing.assert_allclose(p1.numpy(), pt.numpy()[0], atol=1e-6)


def test_host_geometry_equal():
    n, d = tmap.wall_from_image([0.5, 0.0], [3.5, 0.0])
    assert np.allclose(n, [1.0, 0.0]) and abs(d - 2.0) < 1e-12
    rng = np.random.default_rng(2)
    hyps = []
    for base, dist in (([1.0, 0.0], 1.2), ([0.0, -1.0], 1.5),
                       ([0.7, 0.7], 2.0)):
        for _ in range(3):
            v = np.asarray(base) + rng.normal(0, 0.05, 2)
            hyps.append((v / np.linalg.norm(v), dist + rng.normal(0, 0.05),
                         abs(rng.normal(0, 0.01))))
    for kw in ({}, dict(min_support=3, dist_tol_m=0.1)):
        wt, wj = tmap.cluster_walls(hyps, **kw), jmap.cluster_walls(hyps, **kw)
        assert len(wt) == len(wj)
        for a, b in zip(wt, wj):
            np.testing.assert_array_equal(a.normal, b.normal)
            assert (a.distance, a.support, a.rms_m) == (
                b.distance, b.support, b.rms_m)
    img = np.array([2.2, 0.9])
    cand = [(mi, float(np.hypot(*(img - MICS[mi]))) + rng.normal(0, 0.01),
             0.3) for mi in range(M)] + [(2, 3.9, 0.2), (4, 1.1, 0.1)]
    for dz in (0.0, 1.2):
        kw = dict(n_angles=72, r_bin=0.1, min_mics=4)
        groups = tmap._hough_associate(cand, MICS, dz, **kw)
        assert groups and groups == jmap._hough_associate(cand, MICS, dz,
                                                          **kw)


def _room_scene(center_xy, absorption, sources, seed=0):
    """tests/test_mapping.py's scene: frames [E, M, N] and the plane grid
    (81 x 81 at 24 cells/m), 700-7,000 Hz, window off, a lag window of the
    array's aperture, the solver off the sphere; both packages'
    configurations."""
    center = np.array([center_xy[0], center_xy[1], 1.2])
    mics_room = np.zeros((M, 3))
    mics_room[:, :2] = MICS + center[:2]
    mics_room[:, 2] = center[2]
    rm = jroom.ShoeboxRoom(size=(6.0, 5.0, 3.0), absorption=absorption,
                           max_order=1)
    frames = np.concatenate([jroom.simulate(
        np.array([sx + center[0], sy + center[1], center[2]]), mics_room, rm,
        noise_rms=0.003, seed=seed + i, signal=_broadband_burst())
        for i, (sx, sy) in enumerate(sources)], axis=0).astype(np.float32)
    k = jgeo.max_lag_for_array(MICS, jcfg.PipelineConfig())
    out = []
    for cfg in (jcfg, tcfg):
        out.append(dict(
            pipeline=cfg.PipelineConfig(phat=True, band_hz=BAND,
                                        window_enabled=False,
                                        max_shift_samples=k),
            grid=cfg.GridConfig(projection="plane", height_m=0.0,
                                cells_per_m=24.0, half_cells_x=40,
                                half_cells_y=40),
            solver=cfg.SolverConfig(constrain_to_sphere=False)))
    return frames, out


WALLS = {
    "one_wall": ((4.8, 2.5), (0.99, 0.02, 0.99, 0.99, 0.99, 0.99),
                 [(0.3, 0.2), (0.1, -0.5), (0.5, 0.45)], 1,
                 [((1.0, 0.0), 1.2, 0.15)]),
    "two_walls": ((4.8, 1.5), (0.99, 0.02, 0.02, 0.99, 0.99, 0.99),
                  [(0.3, 0.2), (0.1, -0.4), (-0.4, 0.35)], 2,
                  [((1.0, 0.0), 1.2, 0.2), ((0.0, -1.0), 1.5, 0.2)]),
}


@pytest.mark.parametrize("name", sorted(WALLS))
def test_reflector_mapper_matches_reference(name):
    center, absorption, sources, n_echoes, truth = WALLS[name]
    frames, (jc, tc) = _room_scene(center, absorption, sources)
    jloc = JLocalizer.create(MICS, jc["pipeline"], jc["grid"], jc["solver"])
    tloc = Localizer.create(MICS, tc["pipeline"], tc["grid"], tc["solver"],
                            device="cpu")
    ref = jmap.ReflectorMapper(jloc, n_echoes=n_echoes, q_max=900).map(
        jnp.asarray(frames))
    got = tmap.ReflectorMapper(tloc, n_echoes=n_echoes, q_max=900).map(
        torch.from_numpy(frames))
    np.testing.assert_allclose(got["source_xy"], ref["source_xy"], atol=1e-4)
    assert [len(i) for i in got["images"]] == [len(i) for i in ref["images"]]
    for a, b in zip(got["images"], ref["images"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    assert len(got["walls"]) == len(ref["walls"]) >= len(truth)
    for a, b in zip(got["walls"], ref["walls"]):
        assert a.support == b.support
        np.testing.assert_allclose(a.normal, b.normal, atol=1e-4)
        assert abs(a.distance - b.distance) <= 1e-4
        assert abs(a.rms_m - b.rms_m) <= 1e-4
    for normal, dist, tol in truth:  # the JAX tests' bounds
        hits = [w for w in got["walls"]
                if w.normal @ np.asarray(normal) > 0.95]
        assert hits and abs(hits[0].distance - dist) < tol, name
    assert got["walls"][0].support >= 2
    # echo_delays on the card's path shapes: [E, M, K]
    d, a = tmap.ReflectorMapper(tloc, n_echoes=n_echoes).echo_delays(
        torch.from_numpy(frames))
    assert d.shape == a.shape == (len(sources), M, n_echoes)


@pytest.mark.gpu
def test_reflector_mapper_card_matches_cpu():
    """The two-wall scene on the card: the same walls (count, support)
    within 1e-4 m of the CPU path, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    center, absorption, sources, n_echoes, _ = WALLS["two_walls"]
    frames, (_, tc) = _room_scene(center, absorption, sources)
    res = []
    for dev in ("cpu", "cuda"):
        loc = Localizer.create(MICS, tc["pipeline"], tc["grid"],
                               tc["solver"], device=dev)
        res.append(tmap.ReflectorMapper(loc, n_echoes=n_echoes,
                                        q_max=900).map(
            torch.from_numpy(frames).to(dev)))
    assert not torch.backends.cuda.matmul.allow_tf32
    assert len(res[0]["walls"]) == len(res[1]["walls"])
    for a, b in zip(res[1]["walls"], res[0]["walls"]):
        assert a.support == b.support
        assert abs(a.distance - b.distance) <= 1e-4
