"""Multi-device dry run: every parallel path once, on tiny shapes.

Counterpart of the reference's ``dryrun_multichip``: ``n_devices`` ranks
(gloo on the CPU, NCCL on cards where there are that many) run seven steps
and rank 0 prints one ``dryrun[i/7]`` line each:

1. a grid-parallel forward;
2. a data-parallel calibration step;
3. fusion over the model axis;
4. sharded streaming;
5. pair sharding at 24 mics and 276 pairs;
6. a batch-sharded volume solve;
7. tracked streaming with health weights and CAF velocity.

    python -m audio_triangulation_tpu_torch.parallel.dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a rank waits on the others before its collective fails
TIMEOUT_S = 300


def _steps(n_devices: int, device) -> None:
    from .. import GridConfig, Localizer, PipelineConfig, geometry
    from ..core.config import StreamConfig, VolumeConfig
    from ..models import calibration
    from ..models.fusion import ArrayFusionLocalizer
    from ..models.tracked import TrackedStreamingLocalizer
    from ..models.streaming import StreamingLocalizer
    from ..models.volume import VolumeLocalizer
    from ..utils import synth
    from . import mesh as mesh_lib
    from . import sharded, spmd

    rank = dist.get_rank()

    def say(msg):
        if rank == 0:
            print(msg, flush=True)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32,
                               device=device)

    # tiny shapes: 256-sample frames, +-16 lags, 17x17 grid
    cfg = PipelineConfig(frame_size_bits=8, max_shift_samples=16, phat=True)
    grid = GridConfig(half_cells_x=8, half_cells_y=8, cells_per_m=8.0)
    mics = geometry.square_array(0.3)
    model_n = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = mesh_lib.make_mesh((n_devices // model_n, model_n), device=device)
    data_n = n_devices // model_n

    batch = 2 * n_devices
    src = np.array([0.4, 0.3, 1.2]) * (1.2 / np.linalg.norm([0.4, 0.3, 1.2]))
    frame = synth.synth_scene(src, mics, n=cfg.frame_size, noise_rms=0.01,
                              seed=0)
    frames = np.broadcast_to(frame, (batch, 4, cfg.frame_size)).copy()
    fr = mesh_lib.frames_shard(mesh, t(frames))

    # 1) grid-parallel (data x model) localization forward
    loc = Localizer.create(mics, cfg, grid, srp_form="matmul", device=device)
    fwd, params = sharded.make_sharded_localize(loc, mesh, grid_parallel=True)
    out = mesh_lib.gather_batch(mesh, fwd(params, fr))
    assert out["xy"].shape == (batch, 2)
    assert bool(torch.isfinite(out["xy"]).all())
    say(f"dryrun[1/7] grid-parallel forward ok: mesh {data_n}x{model_n}, "
        f"xy {tuple(out['xy'].shape)}")

    # 2) a training step, data parallel over the mesh
    calib = calibration.Calibrator.create(4, cfg, device=device)
    cal_batch = calibration.CalibBatch(
        frames=fr, source_xy=mesh_lib.frames_shard(
            mesh, t(np.broadcast_to(src[:2], (batch, 2)))))
    params_c, opt = calib.init(mics)
    step = sharded.data_parallel_step(calib.train_step, mesh)
    params_c, opt, loss = step(params_c, opt, cal_batch)
    assert np.isfinite(float(loss))
    say(f"dryrun[2/7] data-parallel train step ok: loss {float(loss):.4g}")

    # 3) multi-array fusion: the array axis over model
    arrays = [np.asarray(geometry.square_array(0.3), np.float32)
              + np.array([0.6 * i - 0.3 * (model_n - 1), 0.0], np.float32)
              for i in range(model_n)]
    fus = ArrayFusionLocalizer.create(
        arrays, cfg, GridConfig(half_cells_x=8, half_cells_y=8,
                                cells_per_m=8.0, projection="plane"),
        device=device)
    ffr = synth.synth_scene(src, np.concatenate(arrays, axis=0),
                            n=cfg.frame_size, noise_rms=0.01, seed=1)
    ffr = np.broadcast_to(ffr.reshape(1, model_n, 4, cfg.frame_size),
                          (batch, model_n, 4, cfg.frame_size)).copy()
    fout = spmd.make_fusion_spmd(fus, mesh)(mesh_lib.frames_shard(mesh,
                                                                  t(ffr)))
    assert fout["xy"].shape == (batch // data_n, 2)
    assert bool(torch.isfinite(fout["xy"]).all())
    say(f"dryrun[3/7] model-axis fusion SPMD ok: {model_n} arrays, "
        "sum + all-gather")

    # 4) streaming serving: the stream axis over data
    chunks = t(np.broadcast_to(frame, (batch, 4, cfg.frame_size)).copy()
               * 100 + 128)
    sl = StreamingLocalizer.create(
        mics, cfg, grid, stream=StreamConfig(chunk_size=cfg.frame_size),
        device=device)
    sstep, init_states = sharded.make_sharded_stream_step(sl, mesh)
    states, sout = sstep(init_states(batch),
                         mesh_lib.frames_shard(mesh, chunks))
    assert sout["xy_grid"].shape == (batch // data_n, 2)
    say(f"dryrun[4/7] sharded streaming ok: {batch} streams over "
        f"{n_devices} ranks")

    # 5) pair-axis sharding (large arrays): 24 mics / 276 pairs
    mics24 = geometry.circular_array(24, 0.5)
    loc24 = Localizer.create(mics24, cfg, grid, srp_form="matmul",
                             device=device)
    fr24 = synth.synth_scene(src, mics24, n=cfg.frame_size, noise_rms=0.01,
                             seed=2)
    fr24 = np.broadcast_to(fr24, (batch, 24, cfg.frame_size)).copy()
    pfn = spmd.make_spmd_pair_localizer(loc24, mesh)
    pout = pfn(mesh_lib.frames_shard(mesh, t(fr24)))
    assert pout["xy_grid"].shape == (batch // data_n, 2)
    assert bool(torch.isfinite(pout["scores"]).all())
    say(f"dryrun[5/7] pair-sharded SPMD ok: 276 pairs / {model_n} shards, "
        f"steering={'big-matmul' if pfn.big_steering else 'blocked'}")

    # 6) volumetric (free 3-D) localization, batch-sharded
    mics_t = geometry.tetrahedral_array(0.3)
    vol = VolumeLocalizer.create(
        mics_t, cfg, VolumeConfig(half_cells_x=6, half_cells_y=6, z_cells=4,
                                  cells_per_m=6.0, z_min_m=0.6, z_max_m=1.6),
        device=device)
    frv = synth.synth_scene(np.array([0.3, 0.2, 1.1]), mics_t,
                            n=cfg.frame_size, noise_rms=0.01, seed=3)
    frv = np.broadcast_to(frv, (batch, 4, cfg.frame_size)).copy()
    vout = mesh_lib.gather_batch(mesh, vol(mesh_lib.frames_shard(mesh,
                                                                 t(frv))))
    assert vout["xyz"].shape == (batch, 3)
    assert bool(torch.isfinite(vout["xyz"]).all())
    say(f"dryrun[6/7] sharded volumetric 3-D solve ok: xyz "
        f"{tuple(vout['xyz'].shape)}")

    # 7) tracked streaming + health weighting + CAF velocity, stream axis
    # over data
    tsl = TrackedStreamingLocalizer.create(
        mics, cfg, grid,
        stream=StreamConfig(chunk_size=cfg.frame_size, health_weighting=True,
                            solve_velocity=True, velocity_v_max=4.0,
                            velocity_n_scales=5),
        fuse_velocity=True, device=device)
    tstep, t_init = sharded.make_sharded_stream_step(tsl, mesh)
    _, t_out = tstep(t_init(batch), mesh_lib.frames_shard(mesh, chunks))
    t_out = mesh_lib.gather_batch(mesh, {
        k: t_out[k] for k in ("track_xy", "pair_weight", "velocity")})
    assert t_out["track_xy"].shape[0] == batch
    assert t_out["pair_weight"].shape == (batch, 6)
    assert t_out["velocity"].shape == (batch, 2)
    say(f"dryrun[7/7] fused tracked streaming SPMD ok: {batch} streams, "
        "health + CAF velocity + Kalman bank in one step")


def _worker(rank: int, n_devices: int, device_type: str,
            init_file: str) -> None:
    import datetime

    from . import mesh as mesh_lib

    device = "cpu"
    if device_type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_devices))
    else:
        torch.cuda.set_device(rank)
        device = f"cuda:{rank}"
    dist.init_process_group(
        mesh_lib.backend_for(device_type), init_method=f"file://{init_file}",
        world_size=n_devices, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        _steps(n_devices, device)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """Spawn ``n_devices`` ranks on ``device``'s type and run the seven
    steps; raises when a rank fails.  On the card it needs that many
    cards."""
    device_type = torch.device(device).type
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"need {n_devices} CUDA devices, have "
                           f"{torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_worker, args=(n_devices, device_type,
                                os.path.join(tmp, "store")),
                 nprocs=n_devices, join=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device)


if __name__ == "__main__":
    main()
