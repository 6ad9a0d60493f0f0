"""The golden model's outputs of one 8-bit event, in the layout of the
integer path's ``localize_frames_int``: the oracle that the tests and
``chip_smoke.py`` hold that path to, frame by frame."""

from __future__ import annotations

import numpy as np

from . import golden

PAIRS = ((0, 1), (0, 2), (1, 2))


def golden_event(frame_u8: np.ndarray, luts: np.ndarray,
                 size_bits: int = 10) -> dict:
    """The seven outputs of ``localize_frames_int`` for one event [3, N]
    (N = 2**size_bits uint8 samples) by the golden model: each mic's ring
    written out with its DC removed, shifted left by 8 and Q15-windowed
    (the window strides the 1,024-entry table), the raw and tapered
    correlograms of the three pairs, their best shifts, the gate, the SRP
    scores over the LUT [3, H, W] (flattened) and their colour levels."""
    table = golden.window_table_q15()
    x = []
    for m in range(3):
        ring = golden.RollingBuffer(size_bits=size_bits)
        ring.buffer[:] = frame_u8[m]
        x.append(golden.apply_window(
            golden.normalize_shift8(ring.write_out()[0]), table))
    raw = [golden.xcorr_init(x[i], x[j], taper=False)[0] for i, j in PAIRS]
    tapered, best = zip(*[golden.xcorr_init(x[i], x[j]) for i, j in PAIRS])
    scores = golden.srp_scores(luts, *tapered).reshape(-1)
    return {"frames_conditioned": np.stack(x),
            "correlograms": np.stack(tapered),
            "correlograms_raw": np.stack(raw),
            "best_shift": np.asarray(best, np.int32),
            "gate": np.bool_(sum(int(v) * int(v) for v in best) > 4),
            "scores": scores,
            "heat_levels": golden.heatmap_colors(scores)}
