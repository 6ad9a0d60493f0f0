"""The ranks of the gloo worlds that ``tests/test_torch_parallel.py`` spawns.

Each rank joins a world through a ``file://`` store, runs every scenario
of its world on the numpy inputs the test saved (the same arrays the JAX
package's functions get), and rank 0 saves each scenario's results as
numpy arrays, or the traceback of its failure.  Imports torch and the port
only (no JAX)."""

from __future__ import annotations

import datetime
import os
import pickle
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120  # a collective waits this long on the other ranks


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _t(a):
    return torch.as_tensor(np.ascontiguousarray(a))


# ----------------------------------------------------------------------
# scenarios: fn(inputs) -> dict of results (rank 0's are kept)
# ----------------------------------------------------------------------

def mesh_construction(inp):
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib

    n = dist.get_world_size()
    m = mesh_lib.make_mesh(device="cpu")
    m2 = mesh_lib.make_mesh((n // 2, 2), device="cpu")
    try:
        mesh_lib.make_mesh((n + 1, 1), device="cpu")
        bad = "no error"
    except ValueError as e:
        bad = str(e)
    ranges = [None] * n
    dist.all_gather_object(ranges, (mesh_lib.grid_range(m2, 11),
                                    mesh_lib.pair_range(m2, 5)))
    return {"default": tuple(m.mesh.shape), "names": m.mesh_dim_names,
            "shape2": {k: mesh_lib.axis_size(m2, k) for k in
                       ("data", "model")}, "bad": bad, "ranges": ranges}


def hybrid_mesh(inp):
    from audio_triangulation_tpu_torch.parallel import distributed

    distributed.initialize(device="cpu")  # a group exists: a no-op
    m = distributed.make_hybrid_mesh(model_parallel=2, device="cpu")
    try:
        distributed.make_hybrid_mesh(model_parallel=3, device="cpu")
        bad = "no error"
    except ValueError as e:
        bad = str(e)
    return {"shape": tuple(m.mesh.shape), "bad": bad}


def data_parallel(inp):
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    loc = Localizer.create(geometry.reference_array(), device="cpu")
    m = mesh_lib.make_mesh(device="cpu")
    fn, params = sharded.make_sharded_localize(loc, m)
    frames = _t(inp["dp_frames"])
    out = fn(params, mesh_lib.frames_shard(m, frames))
    rows = out["xy"].shape[0]
    out = mesh_lib.gather_batch(m, out)
    return {"out": _np(out), "rows": rows, "single": _np(loc(frames))}


def grid_parallel(inp):
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    loc = Localizer.create(geometry.reference_array(), srp_form="matmul",
                           device="cpu")
    n = dist.get_world_size()
    m = mesh_lib.make_mesh((n // 2, 2), device="cpu")
    fn, params = sharded.make_sharded_localize(loc, m, grid_parallel=True)
    frames = _t(inp["grid_frames"])
    out = mesh_lib.gather_batch(m, fn(params, mesh_lib.frames_shard(
        m, frames)))
    # the padding's bias, on the last model shard
    bias_min = params.score_bias.min().reshape(1)
    dist.all_reduce(bias_min, op=dist.ReduceOp.MIN,
                    group=m.get_group("model"))
    return {"out": _np(out), "single": _np(loc(frames)),
            "shard_cols": params.onehot.shape[1],
            "bias_min": float(bias_min)}


def grid_edge_refine(inp):
    """A winner whose peak fit reads cells of the other model shard: the
    refined grid peak of the sharded forward equals one device's."""
    from audio_triangulation_tpu_torch import Localizer, geometry
    from audio_triangulation_tpu_torch.ops import srp
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    loc = Localizer.create(geometry.reference_array(), srp_form="matmul",
                           with_solver=False, device="cpu")
    n = dist.get_world_size()
    m = mesh_lib.make_mesh((n // 2, 2), device="cpu")
    fn, params = sharded.make_sharded_localize(loc, m, grid_parallel=True)
    frames = _t(inp["edge_frames"])
    out = mesh_lib.gather_batch(m, fn(params, mesh_lib.frames_shard(
        m, frames)))
    single = loc(frames)
    cell = single["scores"].argmax(dim=-1)
    nb = srp.peak_neighbours(cell, (loc.grid.height, loc.grid.width))
    # the fit without the neighbours' all-reduce: each rank's own cells only
    return {"out": _np(out), "single": _np(single),
            "neighbours": _np(nb), "shard_cells": params.onehot.shape[1]}


def calib_steps(inp):
    from audio_triangulation_tpu_torch.models import calibration
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    m = mesh_lib.make_mesh(device="cpu")
    res = {}
    for name in ("calib1", "calib30"):
        d = inp[name]
        calib = calibration.Calibrator.create(d["mics"].shape[0],
                                              device="cpu")
        step = sharded.data_parallel_step(calib.train_step, m)
        batch = calibration.CalibBatch(
            frames=mesh_lib.frames_shard(m, _t(d["frames"])),
            source_xy=mesh_lib.frames_shard(m, _t(d["xy"])))
        whole = calibration.CalibBatch(frames=_t(d["frames"]),
                                       source_xy=_t(d["xy"]))
        for run, (fn, b) in (("dp", (step, batch)),
                             ("single", (calib.train_step, whole))):
            params, opt = calib.init(d["guess"])
            losses = []
            for _ in range(d["steps"]):
                params, opt, loss = fn(params, opt, b)
                losses.append(float(loss))
            res[f"{name}_{run}"] = {"mic_xy": _np(params.mic_xy),
                                    "losses": losses}
    # unequal shards are refused
    calib = calibration.Calibrator.create(3, device="cpu")
    d = inp["calib1"]
    rows = 4 + dist.get_rank()
    try:
        params, opt = calib.init(d["guess"])
        sharded.data_parallel_step(calib.train_step, m)(
            params, opt, calibration.CalibBatch(
                frames=_t(d["frames"][:rows]), source_xy=_t(d["xy"][:rows])))
        res["unequal"] = "no error"
    except ValueError as e:
        res["unequal"] = str(e)
    return res


def calib_em(inp):
    """EM self-calibration over the mesh: the E-step a data-parallel
    localize of each rank's events, the M-step data-parallel steps."""
    from audio_triangulation_tpu_torch import Localizer
    from audio_triangulation_tpu_torch.models import calibration
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    d = inp["em"]
    m = mesh_lib.make_mesh(device="cpu")
    calib = calibration.Calibrator.create(8, device="cpu")
    frames = mesh_lib.frames_shard(m, _t(d["frames"]))
    mic_est = d["guess"].astype(np.float32)
    step = sharded.data_parallel_step(calib.train_step, m)
    for _ in range(d["rounds"]):
        loc = Localizer.create(mic_est, calib.pipeline, device="cpu")
        fn, params = sharded.make_sharded_localize(loc, m)
        batch = calibration.CalibBatch(frames=frames,
                                       source_xy=fn(params, frames)["xy"])
        params_c, opt = calib.init(mic_est)
        for _ in range(d["steps"]):
            params_c, opt, _ = step(params_c, opt, batch)
        mic_est = params_c.mic_xy.detach().numpy()
    return {"mic_xy": mic_est}


def neural_dp(inp):
    from audio_triangulation_tpu_torch.core.config import PipelineConfig
    from audio_triangulation_tpu_torch.models import neural
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded
    from audio_triangulation_tpu_torch.utils import convert

    d = inp["neural"]
    m = mesh_lib.make_mesh(device="cpu")
    net = neural.NeuralLocalizer.create(
        d["mics"], PipelineConfig(frame_size_bits=9, phat=True),
        hidden=(32,), device="cpu")
    res = {}
    for run, fn, fr, xy in (
            ("dp", sharded.data_parallel_step(net.train_step, m),
             mesh_lib.frames_shard(m, _t(d["frames"])),
             mesh_lib.frames_shard(m, _t(d["xy"]))),
            ("single", net.train_step, _t(d["frames"]), _t(d["xy"]))):
        # the JAX package's initial weights, so both train the same net
        params = convert.mlp_params_from_reference(d["init"], "cpu")
        opt = net.optimizer(params)
        for _ in range(3):
            params, opt, loss = fn(params, opt, fr, xy)
        res[run] = {"loss": float(loss),
                    "weights": [_np(p) for p in params.parameters()]}
    return res


def streams(inp):
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.core.config import (PipelineConfig,
                                                           StreamConfig)
    from audio_triangulation_tpu_torch.models.streaming import (
        StreamingLocalizer)
    from audio_triangulation_tpu_torch.models.tracked import (
        TrackedStreamingLocalizer)
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import sharded

    mics = geometry.reference_array()
    m = mesh_lib.make_mesh(device="cpu")
    res = {}
    d = inp["stream"]
    for name, sl in (
            ("plain", StreamingLocalizer.create(
                mics, stream=StreamConfig(chunk_size=d["chunk"]),
                device="cpu")),
            ("tracked", TrackedStreamingLocalizer.create(
                mics, stream=StreamConfig(chunk_size=d["chunk"]),
                device="cpu"))):
        fn, init_states = sharded.make_sharded_stream_step(sl, m)
        st = init_states(d["streams"].shape[0])
        outs = []
        x = mesh_lib.frames_shard(m, _t(d["streams"]).float())
        for i in range(0, x.shape[-1], d["chunk"]):
            st, out = fn(st, x[..., i:i + d["chunk"]])
            outs.append(_np(mesh_lib.gather_batch(m, out)))
        counts = (st.stream if name == "tracked" else st).event_count
        res[name] = {"outs": outs,
                     "counts": _np(mesh_lib.gather_batch(m, counts))}
    try:
        init_states(d["streams"].shape[0] + 2)
        res["bad"] = "no error"
    except ValueError as e:
        res["bad"] = str(e)
    # solve_velocity: the resampling matrices built once, shared
    v = inp["velocity"]
    cfg = PipelineConfig(phat=True, window_enabled=False,
                         band_hz=(700.0, 9500.0))
    sl = StreamingLocalizer.create(
        mics, cfg, stream=StreamConfig(chunk_size=2048, solve_velocity=True,
                                       velocity_n_scales=5), device="cpu")
    fn, init_states = sharded.make_sharded_stream_step(sl, m)
    st = init_states(v["streams"].shape[0])
    x = mesh_lib.frames_shard(m, _t(v["streams"]).float())
    resample = sl.caf_resample
    for i in range(0, 4096, 2048):
        st, out = fn(st, x[..., i:i + 2048])
    res["velocity"] = {
        "velocity": _np(mesh_lib.gather_batch(m, out["velocity"])),
        "shared": sl.caf_resample is resample and resample is not None}
    return res


def spmd_grid(inp):
    from audio_triangulation_tpu_torch import (Localizer, PipelineConfig,
                                               geometry)
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import spmd

    loc = Localizer.create(geometry.reference_array(),
                           PipelineConfig(phat=True), srp_form="matmul",
                           device="cpu")
    n = dist.get_world_size()
    m = mesh_lib.make_mesh((n // 2, 2), device="cpu")
    fn = spmd.make_spmd_grid_localizer(loc, m)
    frames = _t(inp["spmd_frames"])
    out = mesh_lib.gather_batch(m, fn(mesh_lib.frames_shard(m, frames)))
    return {"out": _np(out), "single": _np(loc(frames))}


def _pair_case(inp, key, mesh_shape, budget_zero=False, **cfg_kw):
    import dataclasses

    from audio_triangulation_tpu_torch import (GridConfig, Localizer,
                                               PipelineConfig)
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import spmd

    d = inp[key]
    cfg = PipelineConfig(**d["cfg"], **cfg_kw)
    if budget_zero:
        cfg = dataclasses.replace(cfg, srp_big_matmul_budget_bytes=0)
    loc = Localizer.create(d["mics"], cfg, GridConfig(**d["grid"]),
                           srp_form="gather", with_solver=False,
                           device="cpu")
    m = mesh_lib.make_mesh(mesh_shape, device="cpu")
    fn = spmd.make_spmd_pair_localizer(loc, m)
    frames = _t(d["frames"])
    out = mesh_lib.gather_batch(m, fn(mesh_lib.frames_shard(m, frames)))
    res = {"out": _np(out), "big": fn.big_steering}
    if not (budget_zero or cfg_kw):
        res["single"] = _np(loc(frames))
    return res


def spmd_pairs(inp):
    n = dist.get_world_size()
    return {"large": _pair_case(inp, "pairs36", (n // 4, 4)),
            "big": _pair_case(inp, "pairs24", (n // 4, 4)),
            "blocked": _pair_case(inp, "pairs24", (n // 4, 4),
                                  budget_zero=True),
            "auto": _pair_case(inp, "pairs24", (n // 4, 4),
                               band_hz="auto", phat_beta=0.8),
            "crop": _pair_case(inp, "pairs24", (n // 4, 4),
                               band_hz=(500.0, 4000.0), band_crop=True)}


def fusion(inp):
    from audio_triangulation_tpu_torch import GridConfig, PipelineConfig
    from audio_triangulation_tpu_torch.models.fusion import (
        ArrayFusionLocalizer)
    from audio_triangulation_tpu_torch.parallel import mesh as mesh_lib
    from audio_triangulation_tpu_torch.parallel import spmd

    d = inp["fusion"]
    n = dist.get_world_size()
    m = mesh_lib.make_mesh((n // 2, 2), device="cpu")
    fus = ArrayFusionLocalizer.create(
        list(d["arrays"]), PipelineConfig(phat=True), GridConfig(
            **d["grid"]), device="cpu")
    frames = _t(d["frames"])
    fn = spmd.make_fusion_spmd(fus, m)
    out = mesh_lib.gather_batch(m, fn(mesh_lib.frames_shard(m, frames)))
    fus3 = ArrayFusionLocalizer.create(
        list(d["arrays"]) + [d["arrays"][0] + 1.0],
        PipelineConfig(phat=True), GridConfig(**d["grid"]), device="cpu")
    try:
        spmd.make_fusion_spmd(fus3, m)
        bad = "no error"
    except ValueError as e:
        bad = str(e)
    return {"out": _np(out), "single": _np(fus(frames)), "bad": bad}


def dryrun(inp):
    """The dry run's seven steps in this world (rank 0 prints)."""
    import contextlib
    import io

    from audio_triangulation_tpu_torch.parallel import dryrun as dr

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dr._steps(dist.get_world_size(), "cpu")
    return {"lines": buf.getvalue().splitlines()}


WORLDS = {
    2: ("mesh_construction", "grid_edge_refine", "neural_dp", "streams"),
    4: ("mesh_construction", "hybrid_mesh", "data_parallel",
        "grid_parallel", "grid_edge_refine", "calib_steps", "calib_em",
        "neural_dp", "streams", "spmd_grid", "spmd_pairs", "fusion",
        "dryrun"),
}


def run(rank: int, world: int, tmp: str) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (2 * world)))
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    with open(os.path.join(tmp, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    results = {}
    try:
        for name in WORLDS[world]:
            try:
                results[name] = globals()[name](inp)
            except Exception:  # recorded; the test of it fails
                results[name] = {"error": traceback.format_exc()}
            dist.barrier()
    finally:
        if rank == 0:
            with open(os.path.join(tmp, "results.pkl"), "wb") as f:
                pickle.dump(results, f)
        dist.destroy_process_group()
