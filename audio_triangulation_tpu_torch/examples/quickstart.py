"""Quickstart: batched localization, streaming, and calibration.

Counterpart of the JAX package's ``examples/quickstart.py`` on the port.

    python -m audio_triangulation_tpu_torch.examples.quickstart
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
from audio_triangulation_tpu_torch.core.config import StreamConfig
from audio_triangulation_tpu_torch.models import calibration
from audio_triangulation_tpu_torch.models.streaming import StreamingLocalizer
from audio_triangulation_tpu_torch.tools.bench import require_device
from audio_triangulation_tpu_torch.utils import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device)

    # --- 1. batched frame localization -------------------------------
    mics = geometry.reference_array()  # the firmware's 3-mic triangle
    loc = Localizer.create(mics, PipelineConfig(phat=True), device=dev)

    plane = np.array([0.8, 0.5])
    p3 = np.array([*plane, 1.2])
    source = p3 * (1.2 / np.linalg.norm(p3))  # on the 1.2 m sphere cap
    frames = synth.synth_scene(source, mics, noise_rms=0.01, seed=0)

    out = loc(torch.as_tensor(frames, dtype=torch.float32, device=dev))
    print("true:", plane, " estimated:", out["xy"][0].cpu().numpy(),
          " tdoas:", np.round(out["tdoa_samples"][0].cpu().numpy(), 2))

    # --- 2. streaming with event detection ----------------------------
    sl = StreamingLocalizer.create(mics, stream=StreamConfig(chunk_size=512),
                                   device=dev)
    rng = np.random.default_rng(1)
    stream = rng.integers(127, 130, (3, 12000)).astype(np.float64)
    stream[:, 4000:5024] += 110.0 * frames[0]
    state, outs = sl.run(np.clip(np.round(stream), 0, 255))
    events = [o for o in outs if o["event"]]
    print(f"streaming: {int(state.event_count)} event(s); "
          f"xy={events[-1]['xy_grid'] if events else None}")

    # --- 3. self-calibration (learn the geometry) ----------------------
    planes = rng.uniform(-1, 1, (24, 2))
    sources = np.stack([
        np.array([x, y, 1.2]) * (1.2 / np.linalg.norm([x, y, 1.2]))
        for x, y in planes])
    cal_frames = synth.synth_scene(sources, mics, noise_rms=0.005, seed=2)
    batch = calibration.CalibBatch(
        frames=torch.as_tensor(cal_frames, dtype=torch.float32, device=dev),
        source_xy=torch.as_tensor(planes, dtype=torch.float32, device=dev))
    calib = calibration.Calibrator.create(3, device=dev)
    guess = mics + rng.normal(0, 0.008, mics.shape).astype(np.float32)
    params, opt_state = calib.init(guess)
    for _ in range(40):
        params, opt_state, loss = calib.train_step(params, opt_state, batch)
    print(f"calibration: geometry error "
          f"{np.abs(guess - mics).mean() * 1e3:.2f} mm -> "
          f"{np.abs(params.mic_xy.detach().cpu().numpy() - mics).mean() * 1e3:.2f}"
          " mm")


if __name__ == "__main__":
    main()
