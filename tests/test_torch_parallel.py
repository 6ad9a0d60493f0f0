"""PyTorch port, multi-device execution (``parallel.mesh``,
``parallel.distributed``, ``parallel.sharded``, ``parallel.spmd``,
``parallel.dryrun``) in 2- and 4-rank gloo worlds, held to the JAX
package's ``parallel`` functions on ``conftest.py``'s 8 virtual devices
with the same numpy inputs and seeds: the counterparts of
``test_sharding.py``, ``test_sharded_streaming.py``, ``test_spmd.py`` and
``test_neural.py::test_data_parallel_training_matches_single_device``,
with the fusion path, a grid peak whose fit reads the other shard, the
divisibility errors, the steering choice and the dry run.

Each world is spawned once per module (``torch_parallel_worker``); every
scenario runs there and each test asserts its part.  Waits are bounded:
each collective by the worker's ``TIMEOUT_S``, each world by
``WORLD_TIMEOUT_S``.

Tolerances, from the measured gaps:
- integers equal: best cells, shifts, event flags and counts;
- positions within 1e-4 m and TDOAs within 1e-4 samples of the JAX
  package's sharded outputs (the Localizer tests' 2e-4 m and 1e-3 samples
  hold the CPU paths; sharding adds only its own sums), scores within 1e-4
  of their scale (PHAT's fp32 rounding is 1.4e-4 of scale);
- the grid peak fit across a shard edge within 1e-5 m of one device's;
- data-parallel training: losses within 1e-5 relative a step (5e-5 over
  30 steps), mics within 2e-5 m, MLP weights within 1e-4 (the
  single-device tests' tolerances);
- each test states its own where it differs, with the measured gap.
"""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import os
import pickle
import tempfile
import time

import numpy as np
import pytest
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

from audio_triangulation_tpu import GridConfig as JGrid
from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu import PipelineConfig as JCfg
from audio_triangulation_tpu.core import geometry
from audio_triangulation_tpu.parallel import mesh as jmesh
from audio_triangulation_tpu.utils import synth

WORLD_TIMEOUT_S = 300
MICS = geometry.reference_array()


def _place(x, y, h=1.2):
    p = np.array([x, y, h], np.float64)
    return np.array([x, y]), p * (h / np.linalg.norm(p))


def _stream_inputs(n_streams, t_len=4096, seed=0):
    """[S, M, T] uint8-scale streams; stream s gets an event iff s is even,
    at a distinct position (the JAX test's scene)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(127, 130, size=(n_streams, 3, t_len)).astype(
        np.float64)
    planes = []
    for s in range(n_streams):
        if s % 2 == 0:
            x, y = 0.3 + 0.05 * s, 0.4 - 0.03 * s
            _, src = _place(x, y)
            fr = synth.synth_scene(src, MICS, noise_rms=0.0, seed=s)[0]
            out[s, :, 1500:1500 + 1024] += 110.0 * fr
            planes.append((x, y))
        else:
            planes.append(None)
    return np.clip(np.round(out), 0, 255).astype(np.float32), planes


def build_inputs():
    """Every scenario's numpy inputs, made from the JAX tests' seeds."""
    inp = {}
    _, sources = zip(*[_place(0.1 * i - 0.3, 0.12 * i - 0.4)
                       for i in range(8)])
    inp["dp_frames"] = synth.synth_scene(
        np.stack(sources), MICS, noise_rms=0.01, seed=11).astype(np.float32)
    _, src = _place(0.5, -0.2)
    inp["grid_frames"] = np.repeat(synth.synth_scene(src, MICS, seed=12), 8,
                                   axis=0).astype(np.float32)
    # y = 0: the winner sits on the grid's middle row, whose up and down
    # neighbours lie on either side of a 2-way model split
    edge = [synth.synth_scene(_place(x, 0.0)[1], MICS, seed=20 + i)
            for i, x in enumerate((0.5, -0.3, 0.05, 0.8))]
    inp["edge_frames"] = np.concatenate(edge).astype(np.float32)
    rng = np.random.default_rng(21)
    planes, srcs = zip(*[_place(float(x), float(y))
                         for x, y in rng.uniform(-1.0, 1.0, (32, 2))])
    inp["calib30"] = dict(
        mics=MICS, steps=30, frames=synth.synth_scene(
            np.stack(srcs), MICS, noise_rms=0.005, seed=13).astype(
                np.float32),
        xy=np.stack(planes).astype(np.float32),
        guess=(MICS + rng.normal(0, 0.01, MICS.shape)).astype(np.float32))
    rng = np.random.default_rng(22)
    planes, srcs = zip(*[_place(float(x), float(y))
                         for x, y in rng.uniform(-1.0, 1.0, (16, 2))])
    inp["calib1"] = dict(
        mics=MICS, steps=1, frames=synth.synth_scene(
            np.stack(srcs), MICS, seed=14).astype(np.float32),
        xy=np.stack(planes).astype(np.float32), guess=MICS)
    mics8 = geometry.circular_array(8, 0.2)
    rng = np.random.default_rng(33)
    srcs = np.stack([_place(x, y)[1]
                     for x, y in rng.uniform(-1.0, 1.0, (32, 2))])
    inp["em"] = dict(
        rounds=2, steps=25, mics=mics8, frames=synth.synth_scene(
            srcs, mics8, noise_rms=0.003, seed=34).astype(np.float32),
        guess=(mics8 + rng.normal(0, 0.012, mics8.shape)).astype(
            np.float32))
    sq = geometry.square_array(0.3)
    rng = np.random.default_rng(7)
    xy = rng.uniform(-0.9, 0.9, (64, 2)).astype(np.float32)
    src = np.concatenate([xy, np.full((64, 1), 1.2)], axis=-1)
    from audio_triangulation_tpu.models import neural

    init, _ = neural.NeuralLocalizer.create(
        sq, JCfg(frame_size_bits=9, phat=True), hidden=(32,)).init(seed=2)
    inp["neural"] = dict(mics=sq, xy=xy, frames=synth.synth_scene(
        src, sq, n=512, noise_rms=0.02, seed=7).astype(np.float32),
        init={k: {kk: np.asarray(vv) for kk, vv in v.items()}
              for k, v in init.items()})
    streams, planes = _stream_inputs(16)
    inp["stream"] = dict(chunk=1024, streams=streams, planes=planes)
    inp["velocity"] = dict(streams=_stream_inputs(8, seed=3)[0])
    frames = synth.synth_scene(
        np.stack([_place(x, y)[1] for x, y in
                  [(0.9, 0.4), (-0.6, -0.8), (0.2, 1.0), (0.5, -0.5)]]),
        MICS, noise_rms=0.01, seed=41)
    inp["spmd_frames"] = np.repeat(frames, 2, axis=0).astype(np.float32)
    mics36 = geometry.grid_array(6, 6, 0.05)
    cfg36 = dict(frame_size_bits=10, phat=True, fft_pad_mode="circular",
                 max_shift_samples=geometry.max_lag_for_array(mics36,
                                                              JCfg()))
    src = _place(0.5, 0.3)[1]
    inp["pairs36"] = dict(
        mics=mics36, cfg=cfg36,
        grid=dict(half_cells_x=10, half_cells_y=10, cells_per_m=8.0),
        frames=np.repeat(synth.synth_scene(src, mics36, n=1024, seed=51), 4,
                         axis=0).astype(np.float32))
    mics24 = geometry.circular_array(24, 0.4)
    src = np.array([0.4, 0.2, 1.2]) * (1.2 / np.linalg.norm([0.4, 0.2, 1.2]))
    inp["pairs24"] = dict(
        mics=mics24, cfg=dict(frame_size_bits=9, max_shift_samples=16,
                              phat=True),
        grid=dict(half_cells_x=6, half_cells_y=6, cells_per_m=6.0),
        frames=np.repeat(synth.synth_scene(src, mics24, n=512, seed=7), 4,
                         axis=0).astype(np.float32))
    arrays = np.stack([geometry.square_array(0.5) + np.array([-1.0, 0.0]),
                       geometry.square_array(0.5) + np.array([1.0, 0.0])]
                      ).astype(np.float32)
    fsrc = np.array([0.3, 1.5, 0.0])
    ff = synth.synth_scene(fsrc, arrays.reshape(-1, 2), noise_rms=0.01,
                           seed=61)
    ff = np.repeat(ff.reshape(1, 2, 4, 1024), 4, axis=0)
    inp["fusion"] = dict(
        arrays=arrays, frames=ff.astype(np.float32),
        grid=dict(half_cells_x=40, half_cells_y=40, cells_per_m=16.0,
                  projection="plane"))
    return inp


def _spawn_world(world: int, inp: dict) -> dict:
    import torch_parallel_worker

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "inputs.pkl"), "wb") as f:
            pickle.dump(inp, f)
        ctx = mp.start_processes(torch_parallel_worker.run,
                                 args=(world, tmp), nprocs=world,
                                 join=False, start_method="spawn")
        deadline = time.time() + WORLD_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"the {world}-rank world did not end "
                                   f"within {WORLD_TIMEOUT_S} s")
        with open(os.path.join(tmp, "results.pkl"), "rb") as f:
            return pickle.load(f)


@pytest.fixture(scope="module")
def worlds():
    inp = build_inputs()
    return {"inputs": inp, 2: _spawn_world(2, inp), 4: _spawn_world(4, inp)}


def part(worlds, world, name):
    res = worlds[world][name]
    assert "error" not in res, res.get("error")
    return res


@pytest.fixture(scope="module")
def jax_mesh():
    return jmesh.make_mesh((4, 2))


# ----------------------------------------------------------------------
# test_sharding.py
# ----------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 4])
def test_mesh_construction(worlds, world):
    r = part(worlds, world, "mesh_construction")
    assert r["default"] == (world, 1)
    assert r["names"] == ("data", "model")
    assert r["shape2"] == {"data": world // 2, "model": 2}
    assert "ranks" in r["bad"]
    assert jmesh.make_mesh().devices.shape == (8, 1)
    # each rank's grid and pair range: the reference's model-axis slices
    # of the padded axes (11 cells -> 12, 5 pairs -> 6, over 2)
    spec = jax.sharding.NamedSharding(jmesh.make_mesh((4, 2)),
                                      jax.sharding.PartitionSpec("model"))
    for n, k in ((12, 0), (6, 1)):
        ref = {(s[0].start, s[0].stop)
               for s in spec.devices_indices_map((n,)).values()}
        assert {rg[k] for rg in r["ranges"]} == ref


def test_data_parallel_matches_single_device(worlds):
    from audio_triangulation_tpu.parallel import sharded

    r = part(worlds, 4, "data_parallel")
    frames = jnp.asarray(worlds["inputs"]["dp_frames"])
    loc = JLocalizer.create(MICS)
    fn, params = sharded.make_sharded_localize(loc, jmesh.make_mesh())
    ref = fn(params, frames)
    assert r["rows"] == 2  # each rank localized its own quarter
    np.testing.assert_allclose(r["out"]["xy"], np.asarray(ref["xy"]),
                               atol=1e-4)
    np.testing.assert_allclose(r["out"]["tdoa_samples"],
                               np.asarray(ref["tdoa_samples"]), atol=1e-4)
    np.testing.assert_array_equal(r["out"]["best_shift"],
                                  np.asarray(ref["best_shift"]))
    # the gathered shards are the unsharded call
    for k in ("xy", "tdoa_samples", "best_shift", "xy_cov"):
        np.testing.assert_array_equal(r["out"][k], r["single"][k])


def test_grid_parallel_matches(worlds, jax_mesh):
    from audio_triangulation_tpu.parallel import sharded

    r = part(worlds, 4, "grid_parallel")
    frames = jnp.asarray(worlds["inputs"]["grid_frames"])
    loc = JLocalizer.create(MICS, srp_form="matmul")
    fn, params = sharded.make_sharded_localize(loc, jax_mesh,
                                               grid_parallel=True)
    ref = fn(params, frames)
    np.testing.assert_allclose(r["out"]["xy"], np.asarray(ref["xy"]),
                               atol=1e-4)
    np.testing.assert_array_equal(
        r["out"]["best_cell"], np.asarray(ref["scores"]).argmax(axis=-1))
    np.testing.assert_array_equal(r["out"]["best_cell"],
                                  r["single"]["scores"].argmax(axis=-1))
    np.testing.assert_allclose(r["out"]["best_score"],
                               r["single"]["scores"].max(axis=-1),
                               rtol=1e-6)
    # 10,201 cells in two shards of 5,101: one padding cell, never the max
    assert r["shard_cols"] == 5101 and r["bias_min"] == np.float32(-3e38)


@pytest.mark.parametrize("world", [2, 4])
def test_grid_parallel_refine_reads_the_other_shard(worlds, world):
    """The refined grid peak of a winner whose fit reads cells on the
    other model shard (gathered by one SUM) equals one device's, and the
    JAX package's."""
    r = part(worlds, world, "grid_edge_refine")
    nb = r["neighbours"]
    shard = r["shard_cells"]
    # every frame's fit reads cells of both shards
    assert ((nb < shard).any(axis=-1) & (nb >= shard).any(axis=-1)).all()
    np.testing.assert_array_equal(r["out"]["best_cell"],
                                  r["single"]["scores"].argmax(axis=-1))
    np.testing.assert_allclose(r["out"]["xy_grid"], r["single"]["xy_grid"],
                               atol=1e-5)
    loc = JLocalizer.create(MICS, srp_form="matmul", with_solver=False)
    ref = loc(jnp.asarray(worlds["inputs"]["edge_frames"]))
    np.testing.assert_allclose(r["out"]["xy_grid"],
                               np.asarray(ref["xy_grid"]), atol=1e-4)


def _jax_calib(d, mesh=None):
    from audio_triangulation_tpu.models import calibration

    calib = calibration.Calibrator.create(d["mics"].shape[0])
    frames = jnp.asarray(d["frames"])
    xy = jnp.asarray(d["xy"])
    if mesh is not None:
        frames = jax.device_put(frames, jmesh.frames_sharding(mesh))
        xy = jax.device_put(xy, jmesh.batch_sharding(mesh, 2))
    batch = calibration.CalibBatch(frames=frames, source_xy=xy)
    params, opt = calib.init(d["guess"])
    losses = []
    for _ in range(d["steps"]):
        params, opt, loss = calib.train_step(params, opt, batch)
        losses.append(float(loss))
    return np.asarray(params.mic_xy), losses


def test_calibration_train_step_runs_and_improves(worlds):
    """30 data-parallel steps: the loss falls and the geometry improves;
    the same as the port's single-process steps (the gradient average sums
    in another order: losses 5e-5 relative, measured 1.2e-5; mics 1e-6 m)
    and the JAX package's (losses 5e-5 relative over the 30 steps,
    measured 2.0e-5; mics 2e-5 m)."""
    res = part(worlds, 4, "calib_steps")
    r, single = res["calib30_dp"], res["calib30_single"]
    d = worlds["inputs"]["calib30"]
    assert r["losses"][-1] < r["losses"][0]
    assert np.abs(r["mic_xy"] - MICS).mean() < np.abs(d["guess"]
                                                      - MICS).mean()
    np.testing.assert_allclose(r["losses"], single["losses"], rtol=5e-5)
    np.testing.assert_allclose(r["mic_xy"], single["mic_xy"], atol=1e-6)
    mic_xy, losses = _jax_calib(d)
    np.testing.assert_allclose(r["losses"], losses, rtol=5e-5)
    np.testing.assert_allclose(r["mic_xy"], mic_xy, atol=2e-5)


def test_calibration_sharded_train_step(worlds):
    res = part(worlds, 4, "calib_steps")
    r = res["calib1_dp"]
    mic_xy, losses = _jax_calib(worlds["inputs"]["calib1"],
                                jmesh.make_mesh())
    assert np.isfinite(r["losses"][0])
    np.testing.assert_allclose(r["losses"], res["calib1_single"]["losses"],
                               rtol=1e-6)
    np.testing.assert_allclose(r["losses"], losses, rtol=1e-5)
    np.testing.assert_allclose(r["mic_xy"], mic_xy, atol=2e-5)
    assert "unequal batch shards" in res["unequal"]


def test_unsupervised_em_calibration_8mic(worlds):
    """EM over the mesh (data-parallel E-step localize and M-step steps)
    ends where the JAX package's ``fit_em`` does, and improves the
    guess."""
    from audio_triangulation_tpu.models import calibration

    r = part(worlds, 4, "calib_em")
    d = worlds["inputs"]["em"]
    calib = calibration.Calibrator.create(8)
    mic_est, _ = calib.fit_em(d["guess"], jnp.asarray(d["frames"]),
                              em_rounds=d["rounds"], inner_steps=d["steps"])
    np.testing.assert_allclose(r["mic_xy"], mic_est, atol=2e-5)
    err0 = np.abs(d["guess"] - d["mics"]).mean()
    assert np.abs(r["mic_xy"] - d["mics"]).mean() < err0


def test_hybrid_mesh_single_host(worlds):
    from audio_triangulation_tpu.parallel import distributed

    r = part(worlds, 4, "hybrid_mesh")
    assert r["shape"] == (2, 2)
    assert "must divide" in r["bad"]
    assert distributed.make_hybrid_mesh(model_parallel=2).shape == {
        "data": 4, "model": 2}


# ----------------------------------------------------------------------
# test_sharded_streaming.py
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_streams():
    from audio_triangulation_tpu.core.config import StreamConfig
    from audio_triangulation_tpu.models.streaming import StreamingLocalizer
    from audio_triangulation_tpu.models.tracked import (
        TrackedStreamingLocalizer)
    from audio_triangulation_tpu.parallel import sharded

    d = _stream_inputs(16)[0]
    out = {}
    sl = StreamingLocalizer.create(MICS, stream=StreamConfig(chunk_size=1024))
    fn, init_states = sharded.make_sharded_stream_step(sl, jmesh.make_mesh())
    st = init_states(16)
    outs = []
    for i in range(0, 4096, 1024):
        st, o = fn(st, jnp.asarray(d[:, :, i:i + 1024]))
        outs.append({k: np.asarray(v) for k, v in o.items()})
    out["plain"] = outs
    tsl = TrackedStreamingLocalizer.create(
        MICS, stream=StreamConfig(chunk_size=1024))
    st = tsl.init_states(16)
    outs = []
    for i in range(0, 4096, 1024):
        st, o = tsl.step_many(st, jnp.asarray(d[:, :, i:i + 1024]))
        outs.append({k: np.asarray(v) for k, v in o.items()})
    out["tracked"] = outs
    return out


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_stream_step_matches_vmapped(worlds, jax_streams, world):
    r = part(worlds, world, "streams")
    for kind in ("plain", "tracked"):
        for got, ref in zip(r[kind]["outs"], jax_streams[kind]):
            for key in ("event", "best_shift", "trigger_abs"):
                np.testing.assert_array_equal(got[key], ref[key], key)
            for key in ("xy", "xy_grid"):
                np.testing.assert_allclose(got[key], ref[key], atol=1e-4,
                                           err_msg=key)
        if kind == "tracked":
            for key in ("track_active", "track_id"):
                np.testing.assert_array_equal(got[key], ref[key], key)
            np.testing.assert_allclose(got["track_xy"], ref["track_xy"],
                                       atol=1e-4)
    counts = r["plain"]["counts"]
    assert (counts[::2] >= 1).all() and (counts[1::2] == 0).all(), counts


def test_sharded_stream_events_localized(worlds):
    r = part(worlds, 4, "streams")
    got = {}
    for out in r["plain"]["outs"]:
        for s in np.nonzero(out["event"])[0]:
            got.setdefault(int(s), out["xy"][s])
    for s, plane in enumerate(worlds["inputs"]["stream"]["planes"]):
        if plane is None:
            assert s not in got
        else:
            assert s in got, f"stream {s} missed its event"
            assert np.linalg.norm(got[s] - np.asarray(plane)) < 0.15


@pytest.mark.parametrize("world", [2, 4])
def test_init_states_divisibility_check(worlds, world):
    r = part(worlds, world, "streams")
    # 18 streams: not divisible by the 4-way data axis; 2-way takes them
    if world == 4:
        assert "not divisible" in r["bad"]
    else:
        assert r["bad"] == "no error"


def test_sharded_stream_step_solve_velocity_threads_resample(worlds):
    r = part(worlds, 4, "streams")["velocity"]
    assert r["velocity"].shape == (8, 2)
    assert np.isfinite(r["velocity"]).all()
    assert r["shared"]  # built once on the rank, shared by its streams


# ----------------------------------------------------------------------
# test_spmd.py, fusion, dry run
# ----------------------------------------------------------------------

def test_spmd_grid_matches_reference(worlds, jax_mesh):
    from audio_triangulation_tpu.parallel import spmd

    r = part(worlds, 4, "spmd_grid")
    loc = JLocalizer.create(MICS, JCfg(phat=True), srp_form="matmul")
    frames = jax.device_put(jnp.asarray(worlds["inputs"]["spmd_frames"]),
                            jmesh.frames_sharding(jax_mesh))
    ref = spmd.make_spmd_grid_localizer(loc, jax_mesh)(frames)
    np.testing.assert_array_equal(r["out"]["best_cell"],
                                  np.asarray(ref["best_cell"]))
    np.testing.assert_array_equal(r["out"]["best_cell"],
                                  r["single"]["scores"].argmax(axis=-1))
    np.testing.assert_allclose(r["out"]["best_score"],
                               np.asarray(ref["best_score"]), rtol=1e-4)
    np.testing.assert_allclose(r["out"]["tdoa_samples"],
                               np.asarray(ref["tdoa_samples"]), atol=1e-4)
    np.testing.assert_allclose(r["out"]["xy_grid"],
                               np.asarray(ref["xy_grid"]), atol=1e-6)


def _jax_pairs(d, mesh, budget_zero=False):
    import dataclasses

    from audio_triangulation_tpu.parallel import spmd

    cfg = JCfg(**d["cfg"])
    if budget_zero:
        cfg = dataclasses.replace(cfg, srp_big_matmul_budget_bytes=0)
    loc = JLocalizer.create(d["mics"], cfg, JGrid(**d["grid"]),
                            srp_form="gather", with_solver=False)
    fn = spmd.make_spmd_pair_localizer(loc, mesh)
    frames = jax.device_put(jnp.asarray(d["frames"]),
                            jmesh.frames_sharding(mesh))
    return fn, fn(frames)


def test_spmd_pair_sharded_large_array(worlds):
    """630 pairs of a 6 x 6 grid array over a 4-way model axis: the
    precomputed steering shards; the summed scores equal the port's own
    unsharded call within 1e-5 of scale (measured 0).  Against the JAX
    package 2e-3 of scale: one of the 630 pairs sits on a near-tie of two
    lags that fp32 PHAT flips between the packages (PERF.md section 6),
    which moves its taper (measured 1.02e-3, as the unsharded Localizers
    differ; ``test_torch_large`` leaves such rows out); the grid peak is
    the same cell, its fit within 1e-4 m (measured 1.9e-5)."""
    r = part(worlds, 4, "spmd_pairs")["large"]
    fn, ref = _jax_pairs(worlds["inputs"]["pairs36"], jmesh.make_mesh((2, 4)))
    assert r["big"] and fn.big_steering
    s_ref = np.asarray(ref["scores"])
    scale = np.abs(s_ref).max()
    np.testing.assert_allclose(r["out"]["scores"] / scale,
                               r["single"]["scores"] / scale, atol=1e-5)
    np.testing.assert_allclose(r["out"]["scores"] / scale, s_ref / scale,
                               atol=2e-3)
    np.testing.assert_allclose(r["out"]["xy_grid"],
                               np.asarray(ref["xy_grid"]), atol=1e-4)
    np.testing.assert_array_equal(r["out"]["scores"].argmax(axis=-1),
                                  s_ref.argmax(axis=-1))


def test_spmd_pair_blocked_fallback_matches_big(worlds):
    r = part(worlds, 4, "spmd_pairs")
    assert r["big"]["big"] and not r["blocked"]["big"]
    mesh = jmesh.make_mesh((2, 4))
    fn, ref = _jax_pairs(worlds["inputs"]["pairs24"], mesh)
    fn0, _ = _jax_pairs(worlds["inputs"]["pairs24"], mesh, budget_zero=True)
    assert fn.big_steering and not fn0.big_steering  # the same choices
    s = r["big"]["out"]["scores"]
    scale = np.abs(s).max()
    np.testing.assert_allclose(r["blocked"]["out"]["scores"] / scale,
                               s / scale, atol=1e-4)
    np.testing.assert_allclose(r["blocked"]["out"]["xy_grid"],
                               r["big"]["out"]["xy_grid"], atol=1e-5)
    np.testing.assert_allclose(s / scale, np.asarray(ref["scores"]) / scale,
                               atol=1e-4)


@pytest.mark.parametrize("band", ["auto", "crop"])
def test_spmd_pair_band_follows_reference(worlds, band):
    """The pair-sharded path ignores ``band_hz``, ``band_crop`` and
    ``phat_beta`` as the reference's does: with the auto band and partial
    PHAT, or a cropped band, its scores are bit-equal to its own at full
    band, and within 1e-4 of scale of the JAX package's pair path under the
    same settings (the full-band case's tolerance)."""
    r = part(worlds, 4, "spmd_pairs")
    np.testing.assert_array_equal(r[band]["out"]["scores"],
                                  r["big"]["out"]["scores"])
    kw = (dict(band_hz="auto", phat_beta=0.8) if band == "auto"
          else dict(band_hz=(500.0, 4000.0), band_crop=True))
    inputs = dict(worlds["inputs"]["pairs24"])
    inputs["cfg"] = dict(inputs["cfg"], **kw)
    _, ref = _jax_pairs(inputs, jmesh.make_mesh((2, 4)))
    s_ref = np.asarray(ref["scores"])
    scale = np.abs(s_ref).max()
    np.testing.assert_allclose(r[band]["out"]["scores"] / scale,
                               s_ref / scale, atol=1e-4)
    np.testing.assert_allclose(r[band]["out"]["xy_grid"],
                               np.asarray(ref["xy_grid"]), atol=1e-4)


def test_pad_helpers_match_reference():
    """``srp.pad_grid_axis`` / ``pad_scores_bias`` equal the reference's
    numpy helpers (zero or ``fill`` columns, a -3e38 bias on padding)."""
    import torch

    from audio_triangulation_tpu.ops import srp as jsrp
    from audio_triangulation_tpu_torch.ops import srp as tsrp

    lut = np.random.default_rng(5).integers(0, 9, (3, 11)).astype(np.int32)
    for multiple, fill in ((4, 0.0), (11, 0.0), (3, 7)):
        got = tsrp.pad_grid_axis(torch.from_numpy(lut), multiple, fill=fill)
        np.testing.assert_array_equal(
            got.numpy(), jsrp.pad_grid_axis(lut, multiple, fill=fill))
    np.testing.assert_array_equal(tsrp.pad_scores_bias(11, 12).numpy(),
                                  jsrp.pad_scores_bias(11, 12))


def test_fusion_spmd_matches_single_device(worlds, jax_mesh):
    from audio_triangulation_tpu.models.fusion import ArrayFusionLocalizer
    from audio_triangulation_tpu.parallel import spmd

    r = part(worlds, 4, "fusion")
    d = worlds["inputs"]["fusion"]
    fus = ArrayFusionLocalizer.create(list(d["arrays"]), JCfg(phat=True),
                                      JGrid(**d["grid"]))
    frames = jax.device_put(
        jnp.asarray(d["frames"]), jax.sharding.NamedSharding(
            jax_mesh, jax.sharding.PartitionSpec("data", "model")))
    ref = spmd.make_fusion_spmd(fus, jax_mesh)(frames)
    out = r["out"]
    scale = np.abs(np.asarray(ref["scores"])).max()
    np.testing.assert_allclose(out["scores"] / scale,
                               np.asarray(ref["scores"]) / scale, atol=1e-4)
    np.testing.assert_allclose(out["xy_grid"], np.asarray(ref["xy_grid"]),
                               atol=1e-6)
    np.testing.assert_allclose(out["tdoa_samples"],
                               np.asarray(ref["tdoa_samples"]), atol=1e-3)
    np.testing.assert_allclose(out["xy"], np.asarray(ref["xy"]), atol=1e-4)
    # the joint solve from sums taken in another order: measured 1.1e-5 m
    np.testing.assert_allclose(out["xy"], r["single"]["xy"], atol=5e-5)
    assert "not divisible by model axis" in r["bad"]


@pytest.mark.parametrize("world", [2, 4])
def test_data_parallel_training_matches_single_device(worlds, world):
    """The neural localizer's step with its batch split over the data
    axis is the JAX package's step on its 8-device mesh."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from audio_triangulation_tpu.models import neural

    res = part(worlds, world, "neural_dp")
    r = res["dp"]
    d = worlds["inputs"]["neural"]
    net = neural.NeuralLocalizer.create(
        d["mics"], JCfg(frame_size_bits=9, phat=True), hidden=(32,))
    params, opt = net.init(seed=2)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(8), ("dp",))
    fr = jax.device_put(jnp.asarray(d["frames"]),
                        NamedSharding(mesh, P("dp", None, None)))
    xy = jax.device_put(jnp.asarray(d["xy"]), NamedSharding(mesh,
                                                            P("dp", None)))
    for _ in range(3):
        params, opt, loss = net.train_step(params, opt, fr, xy)
    assert np.isclose(r["loss"], float(loss), rtol=1e-4)
    assert np.isclose(r["loss"], res["single"]["loss"], rtol=1e-5)
    # nn.Linear keeps each weight as [out, in], the reference's w [in, out]
    ref = [v.T if k == "w" else v for i in range(len(params))
           for k, v in ((k, np.asarray(params[f"layer_{i}"][k]))
                        for k in ("w", "b"))]
    assert len(r["weights"]) == len(ref)
    for a, b, s in zip(r["weights"], ref, res["single"]["weights"]):
        np.testing.assert_allclose(a, b, atol=1e-4)
        np.testing.assert_allclose(a, s, atol=1e-6)


def test_dryrun_multichip_steps(worlds):
    """The dry run's seven steps pass in a 4-rank world (rank 0's lines)."""
    lines = part(worlds, 4, "dryrun")["lines"]
    assert [ln.split()[0] for ln in lines] == [
        f"dryrun[{i}/7]" for i in range(1, 8)]
    assert "mesh 2x2" in lines[0] and "big-matmul" in lines[4]


def test_dryrun_multichip_spawns_its_world(capfd):
    """``dryrun_multichip(2, device='cpu')``: the entry point spawns its
    own gloo world and every step passes."""
    from audio_triangulation_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(2, device="cpu")
    out = capfd.readouterr().out
    assert [ln.split()[0] for ln in out.splitlines()
            if ln.startswith("dryrun[")] == [
        f"dryrun[{i}/7]" for i in range(1, 8)]
