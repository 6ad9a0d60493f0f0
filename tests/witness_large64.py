#!/usr/bin/env python3
"""CPU witness for the 64-mic bounds of ``chip_smoke.py``: the JAX package's
own Localizer and the port's CPU path on a few frames of the smoke test's
64-mic scene, in its three large-array configurations.

    JAX_PLATFORMS=cpu python tests/witness_large64.py [frames]

Prints, per configuration, the median and largest |xy - source| of both
packages and their largest difference.  Not a test: a 64 x 4,096 frame takes
seconds on a CPU, so the default is 8 frames.
"""

import dataclasses
import os
import sys

import numpy as np
import torch
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
import chip_smoke  # noqa: E402
from audio_triangulation_tpu import Localizer as JLocalizer  # noqa: E402
from audio_triangulation_tpu.core import config as jcfg  # noqa: E402
from audio_triangulation_tpu_torch import Localizer  # noqa: E402
from audio_triangulation_tpu_torch.core import config as tcfg  # noqa: E402


def main():
    n_frames = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    mics, grid, configs = chip_smoke.large_configs()
    rng = np.random.default_rng(chip_smoke.SEED)
    frames = chip_smoke.scene_frames(
        mics, n_frames, rng, fixed_source=(*chip_smoke.SOURCE_XY, 1.2),
        n=chip_smoke.LARGE_SAMPLES)
    truth = np.asarray(chip_smoke.SOURCE_XY)
    for name, cfg in configs:
        ref = JLocalizer.create(
            mics, jcfg.PipelineConfig(**dataclasses.asdict(cfg)),
            jcfg.GridConfig(**dataclasses.asdict(grid)),
            init_grid_stride=chip_smoke.LARGE_STRIDE)
        r = np.asarray(ref(jnp.asarray(frames))["xy"])
        del ref
        port = Localizer.create(mics, cfg, grid, device="cpu",
                                init_grid_stride=chip_smoke.LARGE_STRIDE)
        g = port(torch.from_numpy(frames))["xy"].numpy()
        del port
        er = np.linalg.norm(r - truth, axis=-1) * 100
        eg = np.linalg.norm(g - truth, axis=-1) * 100
        print(f"{name}: {n_frames} frames, |xy - source| in cm: JAX package "
              f"median {np.median(er):.4f} max {er.max():.4f}; port CPU "
              f"path median {np.median(eg):.4f} max {eg.max():.4f}; largest "
              f"|xy difference| {np.abs(r - g).max():.2e} m", flush=True)


if __name__ == "__main__":
    main()
