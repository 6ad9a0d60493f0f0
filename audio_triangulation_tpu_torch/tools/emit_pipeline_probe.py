"""Measure the persistent, self-pipelined GCC kernel against the shipping
one.

Counterpart of ``tools/emit_pipeline_probe.py`` in the JAX package.  The
shipping GCC kernel takes one tile of frames per block and leaves the
overlap of a tile's tail with the next tile's loads to the hardware
scheduler.  ``fused_gcc_pipelined`` runs the SAME body as persistent blocks
that walk the tiles themselves and stage the next tile's frames under the
current tile's synthesis and peak stage.  If the scheduler were leaving
overlap on the table, the pipelined kernel would be faster.

Scene and configuration are the reference tool's: the 0.3 m square array,
PHAT on the 800-6000 Hz band-cropped circular DFT, one frame of a source at
(0.5, 0.4, 1.2) scaled to 1.2 m with noise 0.01 (seed 0), broadcast to the
batch.  The outputs are asserted equal, then both kernels are timed in
turns with CUDA events.

    python -m audio_triangulation_tpu_torch.tools.emit_pipeline_probe
        [--batch 16384] [--iters 30] [--device cuda]

``--device cpu`` runs both through the plain PyTorch version (for tests).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..ops import window as window_ops
from ..ops.cuda import gcc_kernel
from ..utils import synth


def scene(batch: int, device):
    """(frames [batch, 4, 1024] f32, window, pairs, cfg) of the probe."""
    cfg = PipelineConfig(phat=True, fft_pad_mode="circular",
                         band_hz=(800.0, 6000.0), band_crop=True)
    mics = geometry.square_array(0.3)
    src = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    frame = synth.synth_scene(src, mics, noise_rms=0.01, seed=0)
    frames = torch.from_numpy(frame.astype(np.float32)).to(device)
    frames = frames.expand(batch, -1, -1).contiguous()
    window = torch.as_tensor(window_ops.window_for(cfg), device=device)
    pairs = torch.as_tensor(geometry.mic_pairs(4), device=device)
    return frames, window, pairs, cfg


def _time(fn, iters: int, device) -> float:
    """Seconds per call."""
    fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    frames, window, pairs, cfg = scene(args.batch, args.device)
    print(f"batch={args.batch} pairs={pairs.shape[0]}", flush=True)

    def shipping():
        return gcc_kernel.fused_gcc(frames, window, pairs, cfg,
                                    with_peaks=True)

    def pipelined():
        return gcc_kernel.fused_gcc_pipelined(frames, window, pairs, cfg)

    # correctness: the same arithmetic in the same order, so equal bits
    for name, a, b in zip(("correlograms", "shifts", "tdoa", "peak", "psr"),
                          shipping(), pipelined()):
        if not torch.equal(a, b):
            raise SystemExit(f"outputs differ: {name}")
    print("outputs equal (correlograms, shifts, TDOAs, peaks, PSR)",
          flush=True)

    half = max(1, args.iters // 2)
    times = {"shipping (a tile a block)": [], "pipelined (persistent)": []}
    for fn, name in ((shipping, "shipping (a tile a block)"),
                     (pipelined, "pipelined (persistent)"),
                     (pipelined, "pipelined (persistent)"),
                     (shipping, "shipping (a tile a block)")):
        times[name].append(_time(fn, half, args.device))
    for name, ts in times.items():
        dt = sum(ts) / len(ts)
        print(f"{name:28s} {dt * 1e3:8.3f} ms/iter "
              f"({args.batch / dt / 1e6:7.2f} Mframes/s)", flush=True)


if __name__ == "__main__":
    main()
