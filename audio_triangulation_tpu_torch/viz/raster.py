"""Host-side raster canvas: the drawing-primitive layer.

Counterpart of ``audio_triangulation_tpu.viz.raster``, copied (numpy only;
the port imports nothing of the JAX package).

Capability parity with the reference's VGA graphics library
(``src/lib/vga/vga16_graphics.{h,c}``: 640x480, 16 colors, pixel/line/circle/
rect/char primitives over a framebuffer) — re-expressed as NumPy operations
on an RGB uint8 array.  Where the firmware streams its framebuffer out by
DMA+PIO, here frames are returned as arrays (and serialized by viz.png).

Pure NumPy, no dependencies; this is presentation code, not a device path.
"""

from __future__ import annotations

import numpy as np

# The classic 16-color VGA palette (index -> RGB), used by the level-quantized
# heatmap for parity with the reference's color scheme.
VGA16 = np.array([
    (0, 0, 0),        # 0 BLACK
    (0, 0, 170),      # 1 BLUE
    (0, 170, 0),      # 2 GREEN
    (0, 170, 170),    # 3 CYAN
    (170, 0, 0),      # 4 RED
    (170, 0, 170),    # 5 MAGENTA
    (170, 85, 0),     # 6 BROWN
    (170, 170, 170),  # 7 LIGHT GRAY
    (85, 85, 85),     # 8 DARK GRAY
    (85, 85, 255),    # 9 LIGHT BLUE
    (85, 255, 85),    # 10 LIGHT GREEN
    (85, 255, 255),   # 11 LIGHT CYAN
    (255, 85, 85),    # 12 LIGHT RED
    (255, 85, 255),   # 13 LIGHT MAGENTA
    (255, 255, 85),   # 14 YELLOW
    (255, 255, 255),  # 15 WHITE
], dtype=np.uint8)

BLACK, BLUE, GREEN, CYAN, RED = 0, 1, 2, 3, 4
MAGENTA, BROWN, LIGHT_GRAY, DARK_GRAY = 5, 6, 7, 8
LIGHT_BLUE, LIGHT_GREEN, LIGHT_CYAN, LIGHT_RED = 9, 10, 11, 12
LIGHT_MAGENTA, YELLOW, WHITE = 13, 14, 15


class Canvas:
    """An RGB uint8 drawing surface [height, width, 3]."""

    def __init__(self, width: int = 640, height: int = 480,
                 background=(0, 0, 0)):
        self.width = width
        self.height = height
        self.rgb = np.zeros((height, width, 3), dtype=np.uint8)
        self.rgb[:] = np.asarray(background, dtype=np.uint8)

    # ------------------------------------------------------------------
    @staticmethod
    def _color(c) -> np.ndarray:
        if np.isscalar(c):
            return VGA16[int(c)]
        return np.asarray(c, dtype=np.uint8)

    def pixel(self, x: int, y: int, color) -> None:
        if 0 <= x < self.width and 0 <= y < self.height:
            self.rgb[y, x] = self._color(color)

    def fill_rect(self, x: int, y: int, w: int, h: int, color) -> None:
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.width, x + w), min(self.height, y + h)
        if x1 > x0 and y1 > y0:
            self.rgb[y0:y1, x0:x1] = self._color(color)

    def line(self, x0: int, y0: int, x1: int, y1: int, color) -> None:
        """Bresenham line (the same algorithm family as drawLine)."""
        col = self._color(color)
        x0, y0, x1, y1 = int(x0), int(y0), int(x1), int(y1)
        dx = abs(x1 - x0)
        dy = -abs(y1 - y0)
        sx = 1 if x0 < x1 else -1
        sy = 1 if y0 < y1 else -1
        err = dx + dy
        while True:
            if 0 <= x0 < self.width and 0 <= y0 < self.height:
                self.rgb[y0, x0] = col
            if x0 == x1 and y0 == y1:
                break
            e2 = 2 * err
            if e2 >= dy:
                err += dy
                x0 += sx
            if e2 <= dx:
                err += dx
                y0 += sy

    def circle(self, cx: int, cy: int, r: int, color) -> None:
        """Midpoint circle outline (drawCircle parity)."""
        col = self._color(color)
        x, y, err = r, 0, 1 - r
        while x >= y:
            for px, py in ((x, y), (y, x), (-y, x), (-x, y),
                           (-x, -y), (-y, -x), (y, -x), (x, -y)):
                xx, yy = cx + px, cy + py
                if 0 <= xx < self.width and 0 <= yy < self.height:
                    self.rgb[yy, xx] = col
            y += 1
            if err < 0:
                err += 2 * y + 1
            else:
                x -= 1
                err += 2 * (y - x) + 1

    def ellipse(self, cx: int, cy: int, rx: float, ry: float,
                angle_rad: float = 0.0, color=15, segments: int = 48
                ) -> None:
        """Rotated ellipse outline (plotted as a closed polyline; the
        reference's midpoint primitives stop at circles — this serves the
        uncertainty-ellipse overlay)."""
        t = np.linspace(0.0, 2.0 * np.pi, segments + 1)
        ca, sa = np.cos(angle_rad), np.sin(angle_rad)
        ex = rx * np.cos(t)
        ey = ry * np.sin(t)
        xs = np.round(cx + ca * ex - sa * ey).astype(np.int64)
        ys = np.round(cy + sa * ex + ca * ey).astype(np.int64)
        self.polyline(xs, ys, color)

    def polyline(self, xs: np.ndarray, ys: np.ndarray, color) -> None:
        for i in range(1, len(xs)):
            self.line(xs[i - 1], ys[i - 1], xs[i], ys[i], color)

    def blit(self, img: np.ndarray, x: int, y: int) -> None:
        """Paste an RGB array at (x, y), clipped."""
        h, w = img.shape[:2]
        x0, y0 = max(0, x), max(0, y)
        x1, y1 = min(self.width, x + w), min(self.height, y + h)
        if x1 > x0 and y1 > y0:
            self.rgb[y0:y1, x0:x1] = img[y0 - y: y1 - y, x0 - x: x1 - x]

    def text(self, s: str, x: int, y: int, color, size: int = 10) -> None:
        """Status text from the embedded 5x7 bitmap font (the analogue of
        vga_text.h / drawChar rendering from the firmware's font ROM) —
        dependency-free, never a silent no-op.  ``size`` maps to an integer
        pixel scale (10 -> 1x, like the firmware's textsize=1)."""
        from . import font5x7

        scale = max(1, int(size) // 10)
        for line_no, line in enumerate(s.split("\n")):
            mask = font5x7.render_text(line, scale)
            if mask.size == 0:
                continue
            h, w = mask.shape
            ty = y + line_no * (font5x7.GLYPH_H + 2) * scale
            x0, y0 = max(0, x), max(0, ty)
            x1 = min(self.width, x + w)
            y1 = min(self.height, ty + h)
            if x1 <= x0 or y1 <= y0:
                continue
            sub = mask[y0 - ty: y1 - ty, x0 - x: x1 - x]
            region = self.rgb[y0:y1, x0:x1]
            region[sub] = self._color(color)
