"""Float frame conditioning: DC removal and the shift8 gain.
Counterpart of the float half of ``audio_triangulation_tpu.ops.conditioning``."""

from __future__ import annotations

import torch


def dc_remove(frames: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Subtract the per-frame mean."""
    return frames - frames.mean(dim=dim, keepdim=True)


def normalize(frames: torch.Tensor, mode: str = "shift8",
              dim: int = -1) -> torch.Tensor:
    """'shift8' multiplies by 256 (the firmware's fixed gain); 'full_range'
    scales each frame's peak |value| to 32767; 'none' is the identity."""
    if mode == "shift8":
        return frames * 256.0
    if mode == "full_range":
        peak = frames.abs().amax(dim=dim, keepdim=True)
        return frames * (32767.0 / peak.clamp_min(1e-20))
    if mode == "none":
        return frames
    raise ValueError(f"unknown normalize mode: {mode}")
