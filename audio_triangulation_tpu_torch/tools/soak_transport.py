"""Transport soak: a long live-ingest endurance run of the port.

Counterpart of the JAX package's ``tools/soak_transport.py``, on the
port's native runtime (its own ``libatrt`` library, ``runtime.native_rt``)
and transports (``runtime.transport``):

    synthetic 3-mic PCM with one event a block
      -> FIFO writer thread (a new writer session every block, so every
         block takes the reader's hang-up and reconnect path)
      -> native C++ reader thread -> ingest ring
      -> int64 detector -> event queue -> Localizer on the device
         (the GCC and GN kernels on the card) -> (x, y)

Checks a block: the event is detected, and no second one within 0.5 s.
Checks at the end: every block's event found, none spurious, the median
error under 0.08 m and the largest under 0.3 m (3-mic plain GCC on 8-bit
input), the peak resident set grown by less than 512 MB.

Every wait is bounded: a writer that cannot open the FIFO within 60 s (the
reader not back in ``open()``) ends the run not ok, after its own
``open()`` is released by a read end opened here; a block's event is
awaited 20 s at most.

    python -m audio_triangulation_tpu_torch.tools.soak_transport
        [--minutes 30] [--device cuda] [--out PATH]

It prints a progress line every 20 blocks and one JSON line at the end, and
writes a file only when given ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import tempfile
import time

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..models.localizer import Localizer
from ..runtime import native_rt, transport
from ..utils import synth
from .bench import card_fields, require_device

BLOCK_SAMPLES = 30_000
WRITER_TIMEOUT_S = 60.0
EVENT_TIMEOUT_S = 20.0
SPURIOUS_WINDOW_S = 0.5
PRODUCER_GAP_S = 0.3  # lets the reader re-enter open() between sessions
RSS_GROWTH_MB = 512.0


def rss_mb() -> float:
    """Peak resident set of this process (MB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def block_pcm(rng, mics, block: int):
    """(source xyz on the 1.2 m sphere, [T, 3] int16 PCM): ADC noise with
    one event at a random time, as the reference draws them."""
    xy = rng.uniform(-0.6, 0.6, 2)
    s3 = np.array([xy[0], xy[1], 1.2])
    s3 = s3 * 1.2 / np.linalg.norm(s3)
    event_at = int(rng.integers(6_000, BLOCK_SAMPLES - 8_000))
    streams = rng.integers(127, 130, size=(3, BLOCK_SAMPLES)).astype(
        np.float64)
    frame = synth.synth_scene(s3, mics, noise_rms=0.0, seed=block)[0]
    streams[:, event_at: event_at + 1024] += 110.0 * frame
    return s3, np.clip(np.round(streams), 0, 255).astype(np.int16).T.copy()


def release_writer(path: str, writer) -> None:
    """Unblock a writer stuck in ``open()`` of the FIFO: open and close its
    read end (the writer then fails on its first write), then join it."""
    try:
        fd = os.open(path, os.O_RDONLY | os.O_NONBLOCK)
        os.close(fd)
    except OSError:
        pass
    writer.join(timeout=5.0)


def drain(rt):
    """(the block's first event or None, spurious events after it): poll up
    to ``EVENT_TIMEOUT_S`` for an event, then ``SPURIOUS_WINDOW_S`` more."""
    got, spurious = None, 0
    t0 = time.time()
    while time.time() - t0 < EVENT_TIMEOUT_S:
        ev = rt.poll()
        if ev is None:
            if got is not None and time.time() - t0 > SPURIOUS_WINDOW_S:
                break
            time.sleep(0.01)
            continue
        if got is None:
            got = ev
            t0 = time.time()  # restart the spurious window
        else:
            spurious += 1
    return got, spurious


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--minutes", type=float, default=30.0)
    ap.add_argument("--median-tolerance-m", type=float, default=0.08)
    ap.add_argument("--max-tolerance-m", type=float, default=0.3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if not native_rt.native_available():
        raise SystemExit("the soak needs the native runtime (g++ to build "
                         "runtime/native/atrt.cpp)")

    mics = geometry.reference_array()
    loc = Localizer.create(mics, PipelineConfig(phat=False), device=dev)
    loc(torch.zeros((1, 3, 1024), device=dev))  # build the kernels first

    tmp = tempfile.mkdtemp(prefix="soak_")
    path = os.path.join(tmp, "soak.fifo")
    os.mkfifo(path)
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"fifo://{path}", reconnect=True)

    rng = np.random.default_rng(0)
    deadline = time.time() + args.minutes * 60.0
    rss0 = rss_mb()
    errors, blocks, events, spurious, stalled = [], 0, 0, 0, False
    try:
        while time.time() < deadline:
            s3, pcm = block_pcm(rng, mics, blocks)
            writer = transport.stream_pcm_to_fifo(path, pcm)
            writer.join(timeout=WRITER_TIMEOUT_S)
            if writer.is_alive():
                stalled = True
                print(json.dumps({"block": blocks,
                                  "status": "WRITER STALLED"}), flush=True)
                release_writer(path, writer)
                break
            got, extra = drain(rt)
            spurious += extra
            blocks += 1
            if got is None:
                print(json.dumps({"block": blocks, "status": "MISSED EVENT",
                                  "xy": s3[:2].tolist()}), flush=True)
                continue
            events += 1
            frames, _stamp = got
            out = loc(torch.as_tensor(frames, dtype=torch.float32,
                                      device=dev)[None])
            errors.append(float(np.linalg.norm(
                out["xy"][0].cpu().numpy() - s3[:2])))
            if blocks % 20 == 0:
                print(json.dumps({
                    "block": blocks, "events": events,
                    "median_err_m": float(np.median(errors)),
                    "reconnects": src.reconnects,
                    "rss_mb": rss_mb()}), flush=True)
            time.sleep(PRODUCER_GAP_S)
    finally:
        src.stop()
        rt.close()
        os.unlink(path)
        os.rmdir(tmp)

    result = {
        "blocks": blocks, "events": events, "spurious": spurious,
        "median_err_m": float(np.median(errors)) if errors else None,
        "max_err_m": float(np.max(errors)) if errors else None,
        "reconnects": src.reconnects,
        "rss_start_mb": rss0, "rss_end_mb": rss_mb(),
        "minutes": args.minutes, "stalled": stalled,
        "ok": (blocks > 0 and not stalled and events == blocks
               and spurious == 0 and bool(errors)
               and float(np.median(errors)) < args.median_tolerance_m
               and float(np.max(errors)) < args.max_tolerance_m
               and rss_mb() < rss0 + RSS_GROWTH_MB),
        **card_fields(dev)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
