"""Endurance soak of the batched streaming step, optionally with the whole
system in the loop: the tracker bank, health weighting, a dead channel
half-way and two-source chunks.

Counterpart of the JAX package's ``tools/soak_streaming.py``, with its
scene: ``reference_array()`` for the plain soak; with ``--track``
``circular_array(6, 0.25)`` (mic redundancy absorbs a dead channel) under
``TrackedStreamingLocalizer`` with ``health_weighting``.  A ring of eight
chunks is staged on the device: idle ADC noise, one source in chunk 4, two
overlapping sources in chunk 6; its faulted twin has channel 1 flat at
128.  On a card the step is served as one CUDA graph replay a chunk
(``graph_step_many``: the production loop; the eager step is
host-bound), on the CPU eagerly.  After every step the host reads the
triggers, as a server does.  The gates, as the reference's:

- events keep being localized: at least steps / 8 - 2;
- the single-source events' xy within 0.15 m of the source, before and
  after the fault;
- the current resident set (VmRSS) grows less than 256 MB after warm-up;
- the second half's median step is under 1.5 x the first half's;
- with ``--track --fault-at``: the confirmed track ids after the fault are
  among those before it.

Beside VmRSS it records the growth of ``torch.cuda.memory_allocated``,
ungated.  It prints one JSON line, with the card's name and power limit,
at the end; every ``PROGRESS_S`` seconds of the run it prints a progress
line to standard error (steps, events, errors, VmRSS, the last step's ms),
so that a run killed before its end still reports how far it got.

    python -m audio_triangulation_tpu_torch.tools.soak_streaming
        [--streams 2048] [--steps 500 | --minutes 60] [--chunk 512]
        [--track] [--fault-at 0.5] [--device cuda] [--out PATH]

It writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import array
import json
import sys
import time

import numpy as np
import torch

from ..core import geometry
from ..core.config import StreamConfig
from ..models.streaming import StreamingLocalizer
from ..models.tracked import TrackedStreamingLocalizer
from ..utils import synth
from .bench import card_fields

WARMUP_STEPS = 20  # steps before the step-time and memory baselines
RSS_EVERY = 25  # steps between VmRSS samples
PROGRESS_S = 300.0  # seconds between progress lines on standard error
PLANE_XY = (0.5, 0.4)


def vm_rss_mb() -> float:
    """The CURRENT resident set (ru_maxrss is only the high-water mark: it
    cannot tell a steady leak from one spike)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    raise RuntimeError("no VmRSS in /proc/self/status")


def chunk_ring(n: int, mics: np.ndarray, c: int, device):
    """(ring, faulted ring): eight chunks [n, M, c] each, float32 on
    ``device``; the faulted twin has channel 1 flat at the ADC's midscale."""
    rng = np.random.default_rng(0)
    p = np.array([*PLANE_XY, 1.2])
    frame = synth.synth_scene(p * (1.2 / np.linalg.norm(p)), mics,
                              noise_rms=0.0, seed=7)[0]
    # a second, weaker simultaneous source
    p2 = np.array([-0.7, -0.5, 1.2])
    sig2 = synth.chirp_burst(1024, 50_000.0, f0=2000, f1=9000, center=0.45)
    frame2 = synth.synth_scene(p2 * (1.2 / np.linalg.norm(p2)), mics,
                               signal=sig2, noise_rms=0.0, seed=8)[0]
    ring, ring_fault = [], []
    for i in range(8):
        s = rng.integers(127, 130, (n, mics.shape[0], c)).astype(np.float64)
        if i == 4:
            s += 110.0 * frame[:, :c]
        elif i == 6:
            s += 110.0 * frame[:, :c] + 70.0 * frame2[:, :c]
        s = np.clip(np.round(s), 0, 255)
        ring.append(torch.from_numpy(s.astype(np.float32)).to(device))
        s[:, 1, :] = 128.0  # dead channel
        ring_fault.append(torch.from_numpy(s.astype(np.float32)).to(device))
    return ring, ring_fault


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--streams", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--minutes", type=float, default=None,
                    help="run by wall clock instead of --steps")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--track", action="store_true",
                    help="tracked streaming with health weighting on a "
                    "6-mic array instead of the plain 3-mic step")
    ap.add_argument("--fault-at", type=float, default=None,
                    help="fraction of the soak (0-1) after which channel 1 "
                    "goes flat on every stream")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    n, c = args.streams, args.chunk
    mics = (geometry.circular_array(6, 0.25) if args.track
            else geometry.reference_array())
    stream_cfg = StreamConfig(chunk_size=c, health_weighting=args.track)
    cls = TrackedStreamingLocalizer if args.track else StreamingLocalizer
    stepper = cls.create(mics, stream=stream_cfg, device=dev)
    ring, ring_fault = chunk_ring(n, mics, c, dev)

    if cuda:
        step = stepper.graph_step_many(stepper.init_states(n), ring[0])
    else:
        held = [stepper.init_states(n)]

        def step(chunk):
            held[0], out = stepper.step_many(held[0], chunk)
            return out

    budget_s = None if args.minutes is None else args.minutes * 60.0
    fault_s = (budget_s * args.fault_at
               if budget_s is not None and args.fault_at is not None
               else None)
    fault_step = (int(args.steps * args.fault_at)
                  if budget_s is None and args.fault_at is not None
                  else None)
    plane = np.asarray(PLANE_XY)
    walls = array.array("d")
    events = 0
    xy_err, xy_err_fault = 0.0, 0.0  # single-source events
    ids_pre, ids_post = set(), set()
    rss_curve = []  # (step, VmRSS MB)
    dev_mem0 = None
    t_start = time.perf_counter()
    next_progress = PROGRESS_S
    i = 0
    while True:
        elapsed = time.perf_counter() - t_start
        if (i >= args.steps if budget_s is None else elapsed >= budget_s):
            break
        if elapsed >= next_progress:
            next_progress += PROGRESS_S
            print(json.dumps({"progress": {
                "steps": i, "wall_s": elapsed, "events_detected": events,
                "xy_err_max_m": xy_err, "xy_err_max_post_fault_m":
                xy_err_fault, "vm_rss_mb": round(vm_rss_mb(), 1),
                "step_ms_last": walls[-1] if walls else None}}),
                  file=sys.stderr, flush=True)
        faulted = ((fault_s is not None and elapsed >= fault_s)
                   or (fault_step is not None and i >= fault_step))
        t0 = time.perf_counter()
        out = step((ring_fault if faulted else ring)[i % 8])
        hit = out["trigger_abs"].cpu().numpy() >= 0
        walls.append((time.perf_counter() - t0) * 1e3)
        if hit.any():
            events += int(hit.sum())
            # single-source events (the trigger may land in the chunk after
            # the burst's onset)
            if i % 8 in (4, 5):
                err = float(np.abs(out["xy"].cpu().numpy()[hit]
                                   - plane).max())
                if faulted:
                    xy_err_fault = max(xy_err_fault, err)
                else:
                    xy_err = max(xy_err, err)
            if args.track:
                confirmed = out["track_confirmed"].cpu().numpy()[hit]
                ids = out["track_id"].cpu().numpy()[hit][confirmed]
                (ids_post if faulted else ids_pre).update(
                    int(v) for v in np.unique(ids))
        if i % RSS_EVERY == 0:
            rss_curve.append([i, round(vm_rss_mb(), 1)])
        if i == WARMUP_STEPS and cuda:
            dev_mem0 = torch.cuda.memory_allocated(dev)
        i += 1

    w = np.asarray(walls[WARMUP_STEPS:] if len(walls) > WARMUP_STEPS
                   else walls)
    half = len(w) // 2

    def pct(a, q):
        return float(np.percentile(a, q)) if len(a) else None

    # VmRSS growth from the first sample after warm-up to the last
    after = [mb for s, mb in rss_curve if s >= WARMUP_STEPS]
    rss_growth = after[-1] - after[0] if len(after) >= 2 else 0.0
    gates = {
        "events": events >= i // 8 - 2,
        "xy_err": xy_err < 0.15,
        "rss": rss_growth < 256,
        "step_time": half < 10 or pct(w[half:], 50) < 1.5 * pct(w[:half], 50),
    }
    if args.fault_at is not None:
        gates["xy_err_post_fault"] = xy_err_fault < 0.15
    if args.track and args.fault_at is not None:
        gates["track_ids"] = ids_post <= ids_pre or not ids_post
    result = {
        "metric": "streaming_soak", "streams": n, "steps": i, "chunk": c,
        "tracked": bool(args.track), "fault_at": args.fault_at,
        "graphed": cuda, "events_detected": events, "xy_err_max_m": xy_err,
        "step_ms_p50": pct(w, 50), "step_ms_p99": pct(w, 99),
        "step_ms_p50_first_half": pct(w[:half], 50),
        "step_ms_p50_second_half": pct(w[half:], 50),
        "rss_growth_mb": rss_growth,
        "rss_curve_mb": rss_curve[::max(1, len(rss_curve) // 24)],
        "device_mem_growth_mb": (
            (torch.cuda.memory_allocated(dev) - dev_mem0) / 2 ** 20
            if dev_mem0 is not None else None),
        "wall_s": time.perf_counter() - t_start,
        **card_fields(dev),
    }
    if args.fault_at is not None:
        result["xy_err_max_post_fault_m"] = xy_err_fault
    if args.track:
        result["track_ids_pre_fault"] = sorted(ids_pre)[:8]
        result["track_ids_post_fault"] = sorted(ids_post)[:8]
    result["gates"] = gates
    result["ok"] = all(gates.values())
    print(json.dumps(result), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    main()
