"""Frame conditioning: DC removal, the shift8 gain, full-range
normalization and frame power.  Counterpart of
``audio_triangulation_tpu.ops.conditioning``: float versions for the hot
path, integer versions for the bit-exact validation path (the firmware's
``rolling_buffer.c`` write-out and ``buffer.c`` gain)."""

from __future__ import annotations

import torch


# ----------------------------------------------------------------------
# Float path
# ----------------------------------------------------------------------

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


def frame_power(frames: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Sum of squares per frame."""
    return (frames * frames).sum(dim=dim)


# ----------------------------------------------------------------------
# Bit-exact integer path
# ----------------------------------------------------------------------

def dc_remove_int(frames: torch.Tensor, frame_size_bits: int,
                  dim: int = -1) -> torch.Tensor:
    """DC removal in the firmware's integers: offset = int16(sum >> bits)
    (an arithmetic shift, so a floor), subtracted from the int16 samples
    with int16 wraparound (``rolling_buffer.c:57-66``)."""
    total = frames.to(torch.int64).sum(dim=dim, keepdim=True)
    offset = (total >> frame_size_bits).to(torch.int16)
    return frames.to(torch.int16) - offset


def normalize_shift8_int(frames: torch.Tensor) -> torch.Tensor:
    """int16 <<= 8 with wraparound (``buffer.c:15-16``): the int32 shift
    narrowed to int16 keeps its low 16 bits on every device."""
    return (frames.to(torch.int32) << 8).to(torch.int16)


def normalize_full_range_int(frames: torch.Tensor,
                             dim: int = -1) -> torch.Tensor:
    """The firmware's dead peak normalizer (``buffer.c:20-48``) in
    integers: scale = (32767 << 15) // max|x| (0 for a silent frame),
    x = clamp(int64(x * scale) >> 15) to int16."""
    m = frames.to(torch.int32).abs().amax(dim=dim, keepdim=True)
    scale = torch.where(
        m > 0, torch.div(32767 << 15, m.clamp_min(1), rounding_mode="floor"),
        0).to(torch.int64)
    tmp = (frames.to(torch.int64) * scale) >> 15
    return tmp.clamp(-32768, 32767).to(torch.int16)


def frame_power_int(frames: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int64 sum of squares (``rolling_buffer.c:68-70``)."""
    x = frames.to(torch.int64)
    return (x * x).sum(dim=dim)
