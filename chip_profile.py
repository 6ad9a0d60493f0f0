#!/usr/bin/env python3
"""Where one Localizer call's time goes on the GPU (torch.profiler).

For each of ``chip_smoke.py``'s Localizer paths at its full size (the three
4-mic bench configurations and the ``fused_srp`` line on 16,384 frames of
4 x 1,024 samples; the three 64-mic configurations on 256 frames of
64 x 4,096 samples), prints:

- the median wall time of 7 unprofiled calls and the device-busy time of
  one profiled call (the sum of its kernels' device time), hence the
  card's idle share;
- the kernels by device time;
- host-side ops that took over 0.3 ms, and the count of device-to-host
  scalar reads: a blocking copy or ``.item()`` in the middle of a call
  makes the card wait for the host.  The first op of the profiled call also
  carries the profiler's own set-up ("Activity Buffer Request"), and the
  closing ``cudaDeviceSynchronize`` is the profiler window's own.

    python3 chip_profile.py          # one CUDA card

Imports no JAX.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
WALL_TRIALS = 7
TOP_KERNELS = 14
SLOW_HOST_OP_US = 300.0


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is False", flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import chip_smoke
    from audio_triangulation_tpu_torch import Localizer, geometry

    cpu = torch.autograd.DeviceType.CPU
    src = (*chip_smoke.SOURCE_XY, 1.2)
    rng = np.random.default_rng(chip_smoke.SEED)
    print(torch.cuda.get_device_name(0), flush=True)
    mics = geometry.square_array(0.3)
    frames = torch.from_numpy(chip_smoke.scene_frames(
        mics, chip_smoke.FRAMES, rng, fixed_source=src)).cuda()
    for name, cfg in (chip_smoke.main_configs()
                      + [chip_smoke.fused_srp_config()]):
        profile_path(name, Localizer.create(
            mics, cfg, device="cuda", init_grid_stride=3), frames)
    del frames
    mics64, grid64, configs64 = chip_smoke.large_configs()
    large = torch.from_numpy(chip_smoke.scene_frames(
        mics64, chip_smoke.LARGE_FRAMES, rng, fixed_source=src,
        n=chip_smoke.LARGE_SAMPLES)).cuda()
    for name, cfg in configs64:
        profile_path(name, Localizer.create(
            mics64, cfg, grid64, device="cuda",
            init_grid_stride=chip_smoke.LARGE_STRIDE), large)


def profile_path(name, loc, frames):
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu = torch.autograd.DeviceType.CPU
    for _ in range(3):
        loc(frames)
    walls = []
    for _ in range(WALL_TRIALS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loc(frames)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loc(frames)
        torch.cuda.synchronize()
    stats = prof.key_averages()
    # CPU ops repeat their kernels' device time: count kernels only
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in stats if e.device_type != cpu
                      and e.self_device_time_total > 0), reverse=True)
    busy = sum(k[0] for k in kernels)
    wall = float(np.median(walls))
    reads = sum(e.count for e in stats
                if e.key == "aten::_local_scalar_dense")
    print(f"[{name}] wall median {wall:.4f} ms, device busy {busy:.4f} "
          f"ms, idle share {1 - busy / wall:.4f}, device-to-host scalar "
          f"reads {reads}", flush=True)
    for ms, count, key in kernels[:TOP_KERNELS]:
        print(f"    {ms:9.4f} ms  x{count:<3d} {key[:90]}", flush=True)
    for e in prof.events():
        if e.device_type == cpu and e.cpu_time_total > SLOW_HOST_OP_US:
            print(f"    host op {e.name}: {e.cpu_time_total:.0f} us",
                  flush=True)


if __name__ == "__main__":
    main()
