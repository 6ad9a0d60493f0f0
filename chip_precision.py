#!/usr/bin/env python3
"""Where the card's MUSIC spectra part from the CPU's, stage by stage.

MUSIC's spectrum sum_f w_f / (M - ||P_sig a||^2) divides by a number that
nears its 1e-6 floor at the source cells, so fp32 rounding anywhere
before it shows there many times over.  This script computes the
spectrum of two snapshot scenes (the two-source scene of
``tests/test_torch_srp_freq.py``: 8 mics on the 0.25 m circle, 16
snapshots, 2,500 Hz tilt, 25 x 25 cells, over its 800-6,000 Hz band and
over the full band; and ``chip_smoke.py``'s ``music_8mic`` scene:
``examples/advanced.py``'s sources on the 0.15 m circle, 12 snapshots,
81 x 81 cells, full band), with 2 sources, in float64 on the CPU as the
reference, and then in the port's fp32 on each device:

- ``port``: the port's path (fp32 spectra, complex64 covariance and
  eigh) on that device;
- ``spectra_only``: that device's fp32 spectra, everything after them in
  float64 (the rounding of the conditioning and the matmul DFT alone);
- ``after_spectra_only``: the float64 spectra rounded to fp32, then the
  port's covariance, eigh and projection on that device (their rounding
  alone);
- ``covariance_only``: those rounded spectra's complex64 covariance on
  that device, its eigh and projection in float64;
- ``eigh_only``: the float64 covariance rounded to complex64 and its
  complex64 eigh on that device, the projection in float64.

For each it prints the largest relative error per cell against float64,
the cell where it falls and the reference's value there, and the largest
error of the reciprocal (the weighted noise-subspace power); then the
port's card-against-CPU gap by the same two measures.

    python3 chip_precision.py          # one CUDA card

Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
N_SOURCES = 2


def band_limited_scene():
    """tests/test_torch_srp_freq.py's ``_scene('two')``: (frames, mics,
    grid kwargs)."""
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.utils import synth

    mics = geometry.circular_array(8, 0.25)

    def place(x, y):
        p = np.array([x, y, 1.2])
        return p * (1.2 / np.linalg.norm(p))

    sources = [place(0.6, 0.3), place(-0.5, -0.4)]
    rng = np.random.default_rng(5)
    out = []
    for s in range(16):
        acc = np.zeros((8, 1024))
        for k, src in enumerate(sources):
            sig = synth.colored_burst(1024, 50_000.0, cutoff_hz=2500.0,
                                      seed=5 + 100 * s + k)
            acc = acc + synth.synth_scene(src, mics, signal=sig,
                                          noise_rms=0.0, seed=0)[0]
        out.append(acc + rng.normal(0, 0.02, acc.shape))
    return (np.stack(out).astype(np.float32), mics,
            dict(half_cells_x=12, half_cells_y=12, cells_per_m=10.0))


def cov64(re, im, bins):
    """Per-bin covariance [Fk, M, M] of spectra (re, im) [S, M, F] in
    complex128 on the CPU."""
    import torch

    idx = torch.as_tensor(bins, dtype=torch.long)
    x = torch.complex(re.double().cpu(), im.double().cpu())
    x = x.index_select(-1, idx).permute(2, 0, 1)  # [Fk, S, M]
    return torch.matmul(x.transpose(-1, -2), x.conj()) / x.shape[1]


def music64(r, steer, w, m, eigh=None):
    """The spectrum of covariances r [Fk, M, M] with every step after them
    in float64 / complex128 on the CPU; ``eigh`` gives the eigenvectors
    instead (another precision or device)."""
    import torch

    r = r.to(torch.complex128).cpu()
    v = torch.linalg.eigh(r)[1] if eigh is None else eigh(r)
    u = v.to(torch.complex128).cpu()[..., -N_SOURCES:]
    a = torch.as_tensor(steer).to(torch.complex128)
    proj = torch.matmul(u.conj().transpose(-1, -2), a)
    sig = (proj.real ** 2 + proj.imag ** 2).sum(dim=-2)
    den = (m - sig).clamp_min(1e-6)
    return (torch.as_tensor(w, dtype=torch.float64)[:, None] / den).sum(0)


def gap(got, ref) -> dict:
    """Largest relative error per cell, where, the reference there, and the
    largest error of the reciprocal."""
    got, ref = got.double().cpu().numpy(), ref.double().cpu().numpy()
    rel = np.abs(got - ref) / np.abs(ref)
    at = int(rel.argmax())
    return {"max_rel": float(rel.max()), "at_cell": at,
            "ref_there": float(ref[at]), "ref_peak": float(ref.max()),
            "peak_cell": int(ref.argmax()),
            "reciprocal_abs": float(np.abs(1 / got - 1 / ref).max())}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_precision: torch.cuda.is_available() is False",
              flush=True)
        sys.exit(2)
    sys.path.insert(0, HERE)
    import chip_smoke
    from audio_triangulation_tpu_torch import geometry
    from audio_triangulation_tpu_torch.core.config import (
        GridConfig, PipelineConfig)
    from audio_triangulation_tpu_torch.models import localizer
    from audio_triangulation_tpu_torch.ops import srp_freq, window

    localizer.pin_fp32()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    full, band = PipelineConfig(), PipelineConfig(band_hz=(800.0, 6000.0))
    mics15 = geometry.circular_array(8, 0.15)
    scenes = {
        "two_800_6000hz": (*band_limited_scene(), band),
        "two_full_band": (*band_limited_scene(), full),
        "music_8mic": (chip_smoke.subspace_snapshots(mics15), mics15,
                       dict(half_cells_x=40, half_cells_y=40,
                            cells_per_m=20.0), full),
    }
    for name, (frames, mics, grid_kw, cfg) in scenes.items():
        steer, bins, w = srp_freq._mic_steering_cached(
            GridConfig(**grid_kw), srp_freq._mics_key(mics), cfg, 8)
        m = mics.shape[0]
        x64 = localizer.condition_frames(
            torch.from_numpy(frames).double(),
            torch.as_tensor(window.window_for(cfg), dtype=torch.float64),
            cfg)
        spec64 = torch.fft.rfft(x64, n=cfg.fft_length, dim=-1)
        r64 = cov64(spec64.real, spec64.imag, bins)
        ref = music64(r64, steer, w, m)
        port = {}
        for dev in ("cpu", "cuda"):
            f = torch.from_numpy(frames).to(dev)
            re, im = srp_freq._spectra(f, cfg)
            port[dev] = srp_freq.music_spectrum(
                re, im, steer, bins, w, n_sources=N_SOURCES)
            re64, im64 = (t.float().to(dev) for t in (spec64.real,
                                                      spec64.imag))

            def eigh32(r, dev=dev):
                return torch.linalg.eigh(r.to(torch.complex64).to(dev))[1]

            rows = {
                "port": gap(port[dev], ref),
                "spectra_only": gap(music64(
                    cov64(re, im, bins), steer, w, m), ref),
                "after_spectra_only": gap(srp_freq.music_spectrum(
                    re64, im64, steer, bins, w, n_sources=N_SOURCES), ref),
                "covariance_only": gap(music64(srp_freq.spatial_covariance(
                    re64, im64, bins, 0.0), steer, w, m), ref),
                "eigh_only": gap(music64(r64, steer, w, m, eigh=eigh32),
                                 ref),
                "spectra_rel_err": float(
                    (torch.complex(re.double().cpu(), im.double().cpu())
                     - spec64).abs().max() / spec64.abs().max()),
            }
            print(f"[{name}] {dev} against float64: {json.dumps(rows)}",
                  flush=True)
        print(f"[{name}] the port, card against CPU: "
              f"{json.dumps(gap(port['cuda'], port['cpu']))}", flush=True)


if __name__ == "__main__":
    main()
