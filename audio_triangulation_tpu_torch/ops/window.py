"""Analysis windows: the unit-peak DPSS window (scipy), its float
application, and the firmware's Q15 integer form for the bit-exact
validation path.  Counterpart of ``audio_triangulation_tpu.ops.window``."""

from __future__ import annotations

import numpy as np
import torch


def dpss_window(length: int, nw: float = 2.0, dtype=np.float32) -> np.ndarray:
    """Unit-peak DPSS (Slepian) window [length]."""
    from scipy.signal import windows

    w = windows.dpss(length, nw)
    w = w / np.max(w)
    return w.astype(dtype)


def dpss_window_strided(length: int, nw: float = 2.0,
                        table_bits: int = 10,
                        dtype=np.float32) -> np.ndarray:
    """The fixed ``2**table_bits``-entry DPSS table strided down to
    ``length`` (firmware-exact below the table length)."""
    table_len = 1 << table_bits
    if length > table_len:
        raise ValueError(
            f"length {length} exceeds the {table_len}-entry window table")
    if table_len % length != 0:
        raise ValueError(
            f"length {length} must divide the table length {table_len}")
    table = dpss_window(table_len, nw, dtype)
    return table[:: table_len // length]


def window_for(cfg, dtype=np.float32) -> np.ndarray:
    """The pipeline's analysis window per ``cfg.window_mode``."""
    if getattr(cfg, "window_mode", "direct") == "strided":
        return dpss_window_strided(cfg.frame_size, cfg.window_nw, dtype=dtype)
    return dpss_window(cfg.frame_size, cfg.window_nw, dtype=dtype)


def apply_window(frames: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """Float windowing of frames [..., N] by window [N]."""
    return frames * window


def q15_quantize(window: np.ndarray) -> np.ndarray:
    """Round a unit-peak window to Q15 int32 (window.ipynb ``to_int16``)."""
    w = window / np.max(np.abs(window))
    return np.round(w * 32767).astype(np.int32)


def apply_window_q15(frames: torch.Tensor,
                     window_q15: torch.Tensor) -> torch.Tensor:
    """Bit-exact integer windowing, ``buffer.c:8-9``:
    int16((int32(x) * w) >> 15), an arithmetic shift (a floor on negative
    products) and a narrowing that keeps the low 16 bits."""
    tmp = frames.to(torch.int32) * window_q15.to(torch.int32)
    return (tmp >> 15).to(torch.int16)
