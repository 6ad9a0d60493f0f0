"""Live terminal rendering: ANSI heatmap + status (the 'plugged-in monitor').

Counterpart of ``audio_triangulation_tpu.viz.terminal``, copied (numpy only;
the port imports nothing of the JAX package).

The reference's observability is its always-on VGA panel; for headless TPU
hosts the closest equivalent is an ANSI half-block heatmap refreshed in
place in the terminal, with the same 4-level color scheme (blue/red/green/
white over black, vga_heatmap.h:116-126) or a continuous ramp.
"""

from __future__ import annotations

import sys

import numpy as np

# 4-level scheme -> ANSI 256-color codes (black, blue, red, green, white)
LEVEL_ANSI = [16, 19, 160, 40, 231]

RAMP_ANSI = [16, 17, 18, 19, 20, 21, 57, 93, 129, 165, 201, 207, 213, 219,
             225, 231]


def heatmap_ansi(
    levels_or_scores: np.ndarray,
    width: int,
    height: int,
    *,
    mode: str = "levels",
    max_cols: int = 64,
) -> str:
    """Render a flat heatmap as ANSI half-block art (2 rows per text line)."""
    a = np.asarray(levels_or_scores).reshape(height, width)
    step = max(1, width // max_cols)
    a = a[::step, ::step]
    if mode == "levels":
        idx = np.clip(a, 0, 4).astype(np.int64)
        colors = np.asarray(LEVEL_ANSI)[idx]
    else:
        lo, hi = float(a.min()), float(a.max())
        t = (a - lo) / (hi - lo + 1e-30)
        colors = np.asarray(RAMP_ANSI)[
            np.clip((t * (len(RAMP_ANSI) - 1)).astype(np.int64), 0,
                    len(RAMP_ANSI) - 1)]
    h, w = colors.shape
    if h % 2:
        colors = np.concatenate([colors, colors[-1:]], axis=0)
        h += 1
    lines = []
    for y in range(0, h, 2):
        row = []
        for x in range(w):
            top, bot = colors[y, x], colors[y + 1, x]
            row.append(f"\x1b[38;5;{top}m\x1b[48;5;{bot}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


class LiveView:
    """In-place terminal refresh with delta redraw.

    Between frames of the same height, only CHANGED lines are rewritten
    (cursor repositioning + per-line clear) — the terminal analogue of the
    reference's changed-cells-only heatmap redraw (vga_heatmap.h:128-133),
    which matters over slow links (SSH) exactly like it mattered on the
    firmware's pixel bus.  Frames of a different height fall back to a
    full block rewrite."""

    def __init__(self, out=None):
        self.out = out or sys.stdout
        self._last: list[str] | None = None

    def update(self, text: str) -> None:
        lines = text.split("\n")
        if self._last is not None and len(lines) == len(self._last):
            # delta redraw: reposition to the block top, rewrite only
            # lines that differ, skip over unchanged ones
            self.out.write(f"\x1b[{len(self._last)}F")
            for new, old in zip(lines, self._last):
                if new != old:
                    self.out.write(f"\x1b[2K{new}")
                self.out.write("\n")
        else:
            if self._last is not None:
                self.out.write(f"\x1b[{len(self._last)}F\x1b[J")
            self.out.write(text + "\n")
        self.out.flush()
        self._last = lines
