"""Streaming benchmark: real-time capacity of the stateful chunked pipeline.

Counterpart of ``bench_streaming.py`` in the JAX package.  Measures the
single-stream step and the batched ``step_many`` of a 3-mic 50 kHz array in
512-sample chunks, in three pipelines (default, band-cropped PHAT, PHAT
with the auto band) at 256 to 4,096 streams, and the tracked step (the
Kalman tracker bank on the default pipeline, ``TrackedStreamingLocalizer``):
``tracked_fused`` at 1,024 to 4,096 streams, one chunk a step, and
``tracked_fused_scan4`` at 1,024 and 2,048 streams, four chunks a call
(``step_many_scan``; its ``step_ms`` is per chunk step and its
``reporting_latency_ms`` the four chunks' span).  It derives how many
real-time streams one card sustains: a chunk lasts 10.24 ms, so
``capacity = 10.24 ms / step_ms * streams``.  Every point is ``--trials``
trials of ``--steps`` calls (host clock around a device synchronise), and
prints one JSON line with the median and the quartiles.  ``--graph`` (CUDA
only) adds, for every batched point, the same step replayed as a CUDA graph
(``graph_step_many`` / ``graph_step_many_scan``; lines with ``"graphed":
true``).  ``--streams`` replaces every mode's stream counts.

    python -m audio_triangulation_tpu_torch.tools.bench_streaming
        [--trials 5] [--steps 20] [--device cuda] [--graph]
        [--modes default band_crop_phat band_auto_phat tracked_fused
         tracked_fused_scan4] [--streams 256 1024 2048 4096]

The three untracked pipelines run unless ``--modes`` names others.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig, StreamConfig
from ..models.streaming import StreamingLocalizer
from ..models.tracked import TrackedStreamingLocalizer

CHUNK = 512
PIPELINES = {
    "default": PipelineConfig(),
    "band_crop_phat": PipelineConfig(phat=True, band_hz=(800.0, 6000.0),
                                     band_crop=True),
    "band_auto_phat": PipelineConfig(phat=True, band_hz="auto"),
}
# the tracked modes: chunks a call, stream counts (the reference bench's)
TRACKED = {"tracked_fused": (1, (1024, 2048, 4096)),
           "tracked_fused_scan4": (4, (1024, 2048))}
STREAMS = (256, 1024, 2048, 4096)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def time_steps(step, state, chunks, trials: int, steps: int, device):
    """Seconds per step of ``step(state, chunks)``: (median, q1, q3) over
    ``trials`` trials of ``steps`` chained steps, after two warm-up steps."""
    for _ in range(2):
        state, _ = step(state, chunks)
    per_step = []
    for _ in range(trials):
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, chunks)
        _sync(device)
        per_step.append((time.perf_counter() - t0) / steps)
    q1, med, q3 = np.percentile(per_step, [25, 50, 75])
    return float(med), float(q1), float(q3)


def time_graphed_steps(sl, n_streams: int, chunks, trials: int, steps: int):
    """:func:`time_steps` of ``sl``'s batched step captured as a CUDA graph
    (the capture and its warm-up are not timed); for chunks [S, K, M, C] of
    a tracked localizer, its K-step graph."""
    if chunks.ndim == 4:
        graphed = sl.graph_step_many_scan(sl.init_states(n_streams), chunks)
    else:
        graphed = sl.graph_step_many(sl.init_states(n_streams), chunks)
    return time_steps(lambda state, ch: (state, graphed(ch)), None, chunks,
                      trials, steps, chunks.device)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", nargs="+", default=list(PIPELINES),
                    choices=[*PIPELINES, *TRACKED])
    ap.add_argument("--streams", type=int, nargs="+",
                    help="stream counts of every mode (default: each "
                    "mode's own)")
    ap.add_argument("--graph", action="store_true",
                    help="also time the step replayed as a CUDA graph")
    args = ap.parse_args(argv)
    dev = args.device
    chunk_s = CHUNK / 50_000.0
    rng = np.random.default_rng(0)
    results = []

    def emit(rec):
        # a CPU run's times say nothing about a card: the line names it
        rec["device"] = (torch.cuda.get_device_name(dev)
                         if torch.device(dev).type == "cuda" else "cpu")
        results.append(rec)
        print(json.dumps(rec), flush=True)

    def quiet(*shape):  # the ADC's idle level, +- 1 count
        return torch.from_numpy(
            rng.integers(127, 130, shape).astype(np.float32)).to(dev)

    for mode in args.modes:
        k, counts = TRACKED.get(mode, (1, STREAMS))
        if mode in TRACKED:
            sl = TrackedStreamingLocalizer.create(
                geometry.reference_array(),
                stream=StreamConfig(chunk_size=CHUNK), device=dev)
            step = sl.step_many if k == 1 else sl.step_many_scan
        else:
            sl = StreamingLocalizer.create(
                geometry.reference_array(), PIPELINES[mode],
                stream=StreamConfig(chunk_size=CHUNK), device=dev)
            step = sl.step_many
        if mode == "default":
            med, q1, q3 = time_steps(sl, sl.init_state(), quiet(3, CHUNK),
                                     args.trials, args.steps, dev)
            emit({"mode": mode, "streams": 1, "step_ms": med * 1e3,
                  "step_ms_iqr": [q1 * 1e3, q3 * 1e3],
                  "realtime_margin": chunk_s / med})
        for s_count in args.streams or counts:
            chunks = (quiet(s_count, 3, CHUNK) if k == 1
                      else quiet(s_count, k, 3, CHUNK))
            timed = [(False, time_steps(step, sl.init_states(s_count),
                                        chunks, args.trials, args.steps,
                                        dev))]
            if args.graph:
                timed.append((True, time_graphed_steps(
                    sl, s_count, chunks, args.trials, args.steps)))
            for graphed, (med, q1, q3) in timed:
                med, q1, q3 = med / k, q1 / k, q3 / k  # per chunk step
                rec = {"mode": mode, "streams": s_count, "graphed": graphed,
                       "step_ms": med * 1e3,
                       "step_ms_iqr": [q1 * 1e3, q3 * 1e3],
                       "realtime_capacity_streams": int(
                           chunk_s / med * s_count),
                       "realtime_ok": med < chunk_s}
                if k > 1:
                    rec["reporting_latency_ms"] = k * chunk_s * 1e3
                emit(rec)
    return results


if __name__ == "__main__":
    main()
