"""Estimator-robustness tour: GCC weightings, band-limited / partial PHAT,
phase-slope sub-sample TDOA, and the Huber IRLS solver.

Counterpart of the JAX package's ``examples/robustness.py`` on the port.

    python -m audio_triangulation_tpu_torch.examples.robustness
        [--device cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
from audio_triangulation_tpu_torch.core.config import SolverConfig
from audio_triangulation_tpu_torch.ops import solver
from audio_triangulation_tpu_torch.tools.bench import require_device
from audio_triangulation_tpu_torch.utils import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device)

    mics = geometry.reference_array()
    plane = np.array([0.8, 0.5])
    src3 = np.array([0.8, 0.5, 1.2])
    src3 = src3 * 1.2 / np.linalg.norm(src3)
    frames = torch.as_tensor(
        synth.synth_scene(src3, mics, noise_rms=0.01, seed=2),
        dtype=torch.float32, device=dev)

    def err_cm(**cfg_kwargs):
        loc = Localizer.create(mics, PipelineConfig(**cfg_kwargs), device=dev)
        xy = loc(frames)["xy"][0].cpu().numpy()
        return 100 * np.linalg.norm(xy - plane)

    # --- 1. band-limited PHAT ----------------------------------------
    # Full PHAT equalizes out-of-band noise bins up to the signal's level:
    # on this band-limited chirp scene it drifts tens of cm.  A band on
    # the cross-power or partial whitening (phat_beta) restores cm-level.
    print(f"plain               : {err_cm():6.2f} cm")
    print(f"PHAT (full band)    : {err_cm(phat=True):6.2f} cm")
    print(f"PHAT + band 800:6000: "
          f"{err_cm(phat=True, band_hz=(800.0, 6000.0)):6.2f} cm")
    # hands-free form: the band is read off each event's pair coherence
    print(f"PHAT + band 'auto'  : "
          f"{err_cm(phat=True, band_hz='auto'):6.2f} cm")
    print(f"PHAT-beta 0.5       : {err_cm(phat=True, phat_beta=0.5):6.2f} cm")

    # --- 2. GCC weighting family (Knapp & Carter) -----------------------
    # SCOT / Roth / Hannan-Thomson ML on the FFT engine with
    # frequency-smoothed spectral estimates
    for w in ("scot", "ml"):
        print(f"weighting={w:4s}      : {err_cm(weighting=w):6.2f} cm")

    # --- 3. phase-slope sub-sample TDOA ---------------------------------
    print(f"subsample='phase'   : {err_cm(subsample_method='phase'):6.2f} cm")
    # 'hybrid' takes the phase slope only where a pair's in-band coherence
    # clears the gate (PipelineConfig.hybrid_coherence_min)
    print(f"auto-band + hybrid  : "
          f"{err_cm(phat=True, band_hz='auto', subsample_method='hybrid'):6.2f}"
          " cm")

    # --- 4. robust (Huber IRLS) solving ---------------------------------
    # One of the pair TDOAs carries a +2 ms multipath error: plain least
    # squares is dragged off, Huber IRLS down-weights the outlier pair (an
    # 8-mic array, for redundancy).
    mics8 = geometry.circular_array(8, 0.25)
    pairs8 = torch.as_tensor(geometry.mic_pairs(8), device=dev)
    mic3 = torch.zeros((8, 3), device=dev)
    mic3[:, :2] = torch.as_tensor(mics8, device=dev)
    true_xy = torch.tensor([[0.6, 0.4]], device=dev)
    tdoas = solver.predicted_tdoas(true_xy, mic3, pairs8, 343.0, 1.2, True)
    bad = tdoas.clone()
    bad[0, 5] += 2.0e-3  # 69 cm of path-length error on one pair

    for name, cfg in (("plain LS", SolverConfig()),
                      ("huber", SolverConfig(robust="huber"))):
        xy, rms = solver.solve_tdoa_batched(
            bad, torch.as_tensor(mics8, device=dev), pairs8,
            speed_of_sound=343.0, height=1.2,
            init_xy=torch.tensor([[0.3, 0.2]], device=dev), cfg=cfg)
        e = 100 * np.linalg.norm(xy[0].cpu().numpy() - [0.6, 0.4])
        print(f"outlier solve {name:9s}: {e:6.2f} cm")

    print("robustness tour done")


if __name__ == "__main__":
    main()
