"""Frame-batch throughput of the port: 4-mic 1,024-sample frames a second
on one card, through ``Localizer.forward`` (condition -> GCC kernel ->
peaks -> SRP -> grid peak -> Gauss-Newton kernel).

Counterpart of the JAX package's ``bench.py``, in its format: three JSON
lines, the untuned full band, the hands-free configuration
(``band_hz='auto'``, ``subsample_method='hybrid'``) and the band-cropped
800-6,000 Hz configuration last.  Each line holds the median frames/s over
``--trials`` trials (7 by default; quote none of fewer than 5) and its
quartiles, the card's name and its power limit.  There is no
``vs_baseline``: the reference's 50,000 frames/s is a TPU v5e target.

The shape is the reference's: ``square_array(0.3)``, one synthetic event
replicated over a batch of 16,384 frames, resident on the card, a coarse
init grid (stride 3).  The reference runs 32 resident
batches a dispatch (``--resident-batches``, a ``lax.map``) to hide the
TPU's dispatch latency; here a trial is one call timed on the host clock
around ``torch.cuda.synchronize()``, and trials follow each other back to
back.  ``chip_smoke.py`` times its paths with :func:`frames_per_s`, so
both report the same measure.

    python -m audio_triangulation_tpu_torch.tools.bench [--batch 16384]
        [--trials 7] [--device cuda]

It writes no file.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..models.localizer import Localizer
from ..utils import synth

METRIC = "4mic_1024pt_frames_per_sec_per_chip_gccphat_srp_solve"
# (metric suffix, band_hz, subsample_method), printed in this order
CONFIGS = (("_fullband", None, "parabolic"),
           ("_handsfree_auto_hybrid", "auto", "hybrid"),
           ("", (800.0, 6000.0), "parabolic"))
INIT_GRID_STRIDE = 3  # the coarse SRP init grid; the solver refines


def require_device(device: str) -> str:
    """``device`` for a tool's ``--device``: the card unless "cpu"; asked for
    the card without one, the tool stops with the reason, as the command
    line does."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            "no CUDA device is available: this tool runs on the card unless "
            "given --device cpu")
    return device


def smi_line(index: int = 0) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` prints them (e.g. "NVIDIA H100
    80GB HBM3, 700.00 W"); raises if ``nvidia-smi`` fails."""
    smi = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0].strip()


def card_fields(device) -> dict:
    """``device`` and ``power_limit_w`` of a result line: the card's name
    and power limit (``nvidia-smi``), or "cpu" and None."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    limit = None
    try:
        limit = float(smi_line(index).rsplit(",", 1)[1].split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass  # no nvidia-smi: the line says so with None
    return {"device": torch.cuda.get_device_name(device),
            "power_limit_w": limit}


def frames_per_s(fn, n_frames: int, trials: int, device,
                 warmup: int = 2) -> tuple[float, float, float]:
    """(median, q1, q3) frames/s of ``fn()``, which processes ``n_frames``
    frames: ``trials`` calls, each timed on the host clock from a
    synchronised device to the end of its work, after ``warmup`` calls."""
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    for _ in range(warmup):
        fn()
    rates = []
    for _ in range(trials):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        rates.append(n_frames / (time.perf_counter() - t0))
    q1, med, q3 = np.percentile(rates, [25, 50, 75])
    return float(med), float(q1), float(q3)


def bench_frames(n_frames: int, device) -> torch.Tensor:
    """One synthetic chirp event of the 4-mic array replicated over
    ``n_frames`` frames, on ``device`` (content does not change the time,
    shapes do)."""
    mics = geometry.square_array(0.3)
    src = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    frame = synth.synth_scene(src, mics, noise_rms=0.01, seed=0)
    # C order, as the reference's arrays are on its device: numpy's astype
    # of the broadcast view keeps the batch axis fastest, and each call
    # then paid a transposing copy of the frames
    return torch.from_numpy(np.ascontiguousarray(np.broadcast_to(
        frame, (n_frames, *frame.shape[1:])), dtype=np.float32)).to(device)


def make_localizer(band, subsample, device) -> Localizer:
    """The benched configuration: PHAT, circular GCC, bf16 scoring."""
    cfg = PipelineConfig(phat=True, fft_pad_mode="circular",
                         srp_dtype="bfloat16", band_hz=band,
                         band_crop=isinstance(band, tuple),
                         subsample_method=subsample)
    return Localizer.create(geometry.square_array(0.3), cfg, device=device,
                            init_grid_stride=INIT_GRID_STRIDE)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--trials", type=int, default=7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.trials < 1:
        raise ValueError("--trials must be at least 1")
    frames = bench_frames(args.batch, args.device)
    card = card_fields(args.device)
    lines = []
    for suffix, band, subsample in CONFIGS:
        loc = make_localizer(band, subsample, args.device)
        med, q1, q3 = frames_per_s(lambda: loc(frames), args.batch,
                                   args.trials, args.device)
        rec = {"metric": METRIC + suffix,
               "value": med, "unit": "frames/s", "iqr": [q1, q3],
               "trials": args.trials, "batch": args.batch, **card}
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    return lines


if __name__ == "__main__":
    main()
