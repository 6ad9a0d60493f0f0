"""Panel renderers: heatmap, waveforms, correlograms, status text, dashboard.

Counterpart of ``audio_triangulation_tpu.viz.render``, copied (numpy only;
the port imports nothing of the JAX package).

Capability parity with the reference's VGA presentation stack:

- heatmap with 4-level fractional-of-max colors, mic markers and axes
  (``src/components/vga/vga_heatmap.h``) plus a continuous-colormap mode
- waveform lanes with traces shifted by the estimated TDOAs so aligned
  transients overlap (``src/components/vga/vga_waveforms.h:45-48``)
- autoscaled correlogram lanes (``src/components/vga/vga_correlations.h``)
- textual status page (``src/components/vga/vga_text.h``)
- a 640x480 dashboard composing all panels in the reference's screen layout
  (``src/vga_debug.h`` + plot geometry from ``src/components/vga/vga.h``)

All functions take NumPy arrays (host side) and return RGB uint8 images.
"""

from __future__ import annotations

import numpy as np

from ..core.config import GridConfig
from .raster import (
    BLACK, BLUE, GREEN, RED, VGA16, WHITE, Canvas,
)

# 4-level heatmap palette: level index -> VGA color
# (vga_draw_heatmap:116-126: white/green/red/blue/black)
LEVEL_COLORS = np.array(
    [VGA16[BLACK], VGA16[BLUE], VGA16[RED], VGA16[GREEN], VGA16[WHITE]],
    dtype=np.uint8)


def heatmap_rgb(
    levels_or_scores: np.ndarray,
    grid: GridConfig,
    *,
    mode: str = "levels",
    cell_px: int = 4,
    mic_positions: np.ndarray | None = None,
    axes: bool = True,
) -> np.ndarray:
    """Render a heatmap to RGB.

    levels_or_scores: flat [G] (or [H, W]) — uint8 levels 0..4 for 'levels'
    mode (reference parity), float scores for 'continuous'.
    cell_px: upscale factor (reference: 1 << MAP_SCALE_BITS = 4)."""
    h, w = grid.height, grid.width
    a = np.asarray(levels_or_scores).reshape(h, w)

    if mode == "levels":
        img = LEVEL_COLORS[np.clip(a, 0, 4).astype(np.int64)]
    elif mode == "continuous":
        # float64: in float32 the clip bound 4 - 1e-9 rounds to 4.0 and
        # the max cell would index past the last ramp stop
        a = a.astype(np.float64)
        lo, hi = float(a.min()), float(a.max())
        t = (a - lo) / (hi - lo + 1e-30)
        # black -> blue -> red -> yellow -> white ramp
        stops = np.array([
            (0, 0, 0), (0, 0, 170), (200, 30, 30), (255, 220, 60),
            (255, 255, 255)], dtype=np.float64)
        idx = np.clip(t * (len(stops) - 1), 0, len(stops) - 1 - 1e-9)
        i0 = idx.astype(np.int64)
        frac = (idx - i0)[..., None]
        img = (stops[i0] * (1 - frac) + stops[i0 + 1] * frac).astype(np.uint8)
    else:
        raise ValueError(f"unknown heatmap mode {mode}")

    img = np.repeat(np.repeat(img, cell_px, axis=0), cell_px, axis=1)
    canvas = Canvas(img.shape[1], img.shape[0])
    canvas.rgb[:] = img

    cx = grid.half_cells_x * cell_px + cell_px // 2
    cy = grid.half_cells_y * cell_px + cell_px // 2
    if axes:
        canvas.line(cx, 0, cx, canvas.height - 1, WHITE)
        canvas.line(0, cy, canvas.width - 1, cy, WHITE)
        ticks = int(grid.half_cells_x / grid.cells_per_m)
        space = int(grid.cells_per_m * cell_px)
        for t in range(-ticks, ticks + 1):
            canvas.line(cx + t * space, cy - 2, cx + t * space, cy + 2, WHITE)
            canvas.line(cx - 2, cy - t * space, cx + 2, cy - t * space, WHITE)

    if mic_positions is not None:
        # mic markers: red/blue/white for the first three (vga_heatmap.h:137-157),
        # yellow beyond
        marker_cols = [RED, BLUE, WHITE]
        for i, (mx, my) in enumerate(np.asarray(mic_positions)):
            px = int(round(cx + mx * grid.cells_per_m * cell_px))
            py = int(round(cy - my * grid.cells_per_m * cell_px))
            canvas.circle(px, py, 3, marker_cols[i] if i < 3 else 14)
    return canvas.rgb


def overlay_uncertainty(
    img: np.ndarray,
    grid: GridConfig,
    xy: np.ndarray,
    xy_cov: np.ndarray,
    *,
    cell_px: int = 4,
    n_sigma: float = 2.0,
    color=14,
    cross_px: int = 3,
) -> np.ndarray:
    """Draw the n-sigma covariance ellipse (+ center cross) of a position
    estimate onto a heatmap image rendered by :func:`heatmap_rgb`.

    xy [2] meters; xy_cov [2, 2] meters^2 (the localizer's ``xy_cov``).
    Mutates and returns ``img``.  The ellipse axes are
    n_sigma * sqrt(eigenvalues), rotated to the eigenvector frame — the
    standard confidence-region rendering (2 sigma ~ 86% for 2 dof)."""
    canvas = Canvas(img.shape[1], img.shape[0])
    canvas.rgb = img
    cx = grid.half_cells_x * cell_px + cell_px // 2
    cy = grid.half_cells_y * cell_px + cell_px // 2
    px = cx + float(xy[0]) * grid.cells_per_m * cell_px
    py = cy - float(xy[1]) * grid.cells_per_m * cell_px

    cov = np.asarray(xy_cov, np.float64)
    w, v = np.linalg.eigh(cov)
    w = np.maximum(w, 0.0)
    rx = n_sigma * np.sqrt(w[1]) * grid.cells_per_m * cell_px  # major
    ry = n_sigma * np.sqrt(w[0]) * grid.cells_per_m * cell_px
    # screen y is flipped relative to world y
    ang = -np.arctan2(v[1, 1], v[0, 1])
    canvas.ellipse(int(round(px)), int(round(py)),
                   max(rx, 1.0), max(ry, 1.0), ang, color)
    canvas.line(int(px) - cross_px, int(py), int(px) + cross_px, int(py),
                color)
    canvas.line(int(px), int(py) - cross_px, int(px), int(py) + cross_px,
                color)
    return img


def waveform_panel(
    frames: np.ndarray,
    shifts: np.ndarray | None = None,
    *,
    width: int = 160,
    lane_height: int = 27,
    colors=(RED, BLUE, WHITE, GREEN, 14, 11, 12, 13),
) -> np.ndarray:
    """Waveform lanes [M]: trace m drawn shifted left by its estimated shift
    relative to mic 0, so aligned transients visually overlap
    (vga_waveforms.h:45-48; shifts[0] is 0)."""
    frames = np.asarray(frames)
    m, n = frames.shape
    if shifts is None:
        shifts = np.zeros(m)
    canvas = Canvas(width, lane_height * m)
    peak = np.abs(frames).max() + 1e-30
    dx = width / (n - 1)
    for i in range(m):
        base = i * lane_height + lane_height // 2
        xs = ((np.arange(n) - shifts[i]) * dx + 0.5).astype(np.int64)
        ys = base - (frames[i] / peak * (lane_height // 2 - 1)).astype(np.int64)
        canvas.polyline(xs, ys, colors[i % len(colors)])
    return canvas.rgb


def correlogram_panel(
    correlograms: np.ndarray,
    *,
    width: int = 160,
    lane_height: int = 27,
    colors=(RED, BLUE, WHITE, GREEN, 14, 11, 12, 13),
) -> np.ndarray:
    """Correlogram lanes [P], jointly autoscaled to max |value|
    (vga_correlations.h:36-55)."""
    c = np.asarray(correlograms, dtype=np.float64)
    p, l = c.shape
    canvas = Canvas(width, lane_height * p)
    vmax = np.abs(c).max() + 1e-30
    dx = width / (l - 1)
    for i in range(p):
        base = i * lane_height + lane_height // 2
        xs = (np.arange(l) * dx + 0.5).astype(np.int64)
        ys = base - (c[i] / vmax * (lane_height // 2 - 1)).astype(np.int64)
        canvas.polyline(xs, ys, colors[i % len(colors)])
    return canvas.rgb


def status_text(
    *,
    frame_powers: np.ndarray | None = None,
    incoming_powers: np.ndarray | None = None,
    outgoing_powers: np.ndarray | None = None,
    best_shifts: np.ndarray | None = None,
    mic_positions: np.ndarray | None = None,
    pair_names: list[str] | None = None,
) -> str:
    """The textual status page (vga_text.h:3-52 format, generalized to N)."""
    lines = []
    if frame_powers is not None:
        lines.append("--= Mic Power Levels =--")
        for i, p in enumerate(np.atleast_1d(frame_powers)):
            extra = ""
            if outgoing_powers is not None and incoming_powers is not None:
                extra = (f" - Outgoing: {int(outgoing_powers[i]):10d}"
                         f" - Incoming: {int(incoming_powers[i]):10d}")
            lines.append(f"Mic {chr(65 + i)} - Total: {int(p):10d}{extra}")
        lines.append("")
    if best_shifts is not None:
        lines.append("--= Sample Shifts =--")
        shifts = np.atleast_1d(best_shifts)
        names = pair_names or [f"P{i}" for i in range(len(shifts))]
        for name, s in zip(names, shifts):
            lines.append(f"Shift {name}:{int(s):+4d}")
        lines.append("")
    if mic_positions is not None:
        lines.append("--= Mic Positions =--")
        for i, (x, y) in enumerate(np.asarray(mic_positions)):
            lines.append(f"Mic {chr(65 + i)}: ({x:+5.3f}, {y:+5.3f})")
    return "\n".join(lines)


def _continuous_rgb(a: np.ndarray) -> np.ndarray:
    """Map a 2-D score array to the continuous black->blue->red->yellow->
    white ramp (shared with heatmap_rgb's 'continuous' mode)."""
    a = np.asarray(a, np.float64)
    lo, hi = float(a.min()), float(a.max())
    t = (a - lo) / (hi - lo + 1e-30)
    stops = np.array([
        (0, 0, 0), (0, 0, 170), (200, 30, 30), (255, 220, 60),
        (255, 255, 255)], dtype=np.float64)
    idx = np.clip(t * (len(stops) - 1), 0, len(stops) - 1 - 1e-9)
    i0 = idx.astype(np.int64)
    frac = (idx - i0)[..., None]
    return (stops[i0] * (1 - frac) + stops[i0 + 1] * frac).astype(np.uint8)


def volume_panels(
    scores: np.ndarray,
    volume,
    *,
    mic_positions: np.ndarray | None = None,
    xyz: np.ndarray | None = None,
    cell_px: int = 4,
) -> np.ndarray:
    """Two maximum-intensity projections of a volumetric SRP score field
    (models.volume): top view (x-y, max over z) and side view (x-z, max
    over y), side by side.  The 2-D heatmap has no reference analogue for
    the z axis, so the side view is the new capability's visualization.

    scores: flat [G3] or [D, H, W]; volume: VolumeConfig;
    xyz: optional [3] estimate to mark on both views."""
    d, h, w = volume.depth, volume.height, volume.width
    vol = np.asarray(scores, np.float64).reshape(d, h, w)
    gap = 12

    # top view: VolumeConfig duck-types GridConfig's fields used by
    # heatmap_rgb (width/height/half_cells_x/half_cells_y/cells_per_m)
    top = heatmap_rgb(
        vol.max(axis=0), volume, mode="continuous", cell_px=cell_px,
        mic_positions=(None if mic_positions is None
                       else np.asarray(mic_positions)[:, :2]))

    # side view: x horizontal (same mapping as the top view), z vertical
    # with z increasing UP the image
    side_img = _continuous_rgb(vol.max(axis=1)[::-1])  # [D, W] flipped
    side_img = np.repeat(np.repeat(side_img, cell_px, axis=0),
                         cell_px, axis=1)
    side = Canvas(side_img.shape[1], side_img.shape[0])
    side.rgb[:] = side_img

    def side_px(x_m, z_m):
        px = int(round((volume.half_cells_x + x_m * volume.cells_per_m)
                       * cell_px + cell_px / 2))
        zi = 0.0 if volume.depth == 1 else (
            (z_m - volume.z_min_m) / max(volume.z_step_m, 1e-12))
        py = int(round((d - 1 - zi) * cell_px + cell_px / 2))
        return px, py

    if mic_positions is not None:
        marker_cols = [RED, BLUE, WHITE]
        m3 = np.asarray(mic_positions, np.float64)
        if m3.shape[1] < 3:
            m3 = np.concatenate(
                [m3, np.zeros((m3.shape[0], 1))], axis=1)
        for i, (mx, _, mz) in enumerate(m3):
            px, py = side_px(mx, mz)
            side.circle(px, py, 3, marker_cols[i] if i < 3 else 14)

    canvas = Canvas(top.shape[1] + gap + side.rgb.shape[1],
                    max(top.shape[0], side.rgb.shape[0]) + 12)
    canvas.blit(top, 0, 12)
    canvas.blit(side.rgb, top.shape[1] + gap, 12)
    canvas.text("top (x-y)", 2, 2, GREEN)
    canvas.text("side (x-z)", top.shape[1] + gap + 2, 2, GREEN)

    if xyz is not None:
        x, y, z = (float(v) for v in np.asarray(xyz)[:3])
        cx = volume.half_cells_x * cell_px + cell_px // 2
        cy = volume.half_cells_y * cell_px + cell_px // 2
        tx = int(round(cx + x * volume.cells_per_m * cell_px))
        ty = int(round(cy - y * volume.cells_per_m * cell_px)) + 12
        canvas.line(tx - 3, ty, tx + 3, ty, GREEN)
        canvas.line(tx, ty - 3, tx, ty + 3, GREEN)
        sx, sy = side_px(x, z)
        sx += top.shape[1] + gap
        sy += 12
        canvas.line(sx - 3, sy, sx + 3, sy, GREEN)
        canvas.line(sx, sy - 3, sx, sy + 3, GREEN)
    return canvas.rgb


def dashboard(
    *,
    frames: np.ndarray,
    correlograms: np.ndarray,
    heat_levels_or_scores: np.ndarray,
    grid: GridConfig,
    mic_positions: np.ndarray,
    best_shifts: np.ndarray | None = None,
    heat_mode: str = "levels",
    status: str | None = None,
    xy: np.ndarray | None = None,
    xy_cov: np.ndarray | None = None,
) -> np.ndarray:
    """Compose the full 640x480 live view in the reference's screen layout:
    waveforms at (20, 200), correlograms at (20, 300), heatmap centered at
    (420, 240) (vga.h:19-33), status text top-left (vga_debug.h)."""
    canvas = Canvas(640, 480)

    shifts0 = None
    if best_shifts is not None and frames.shape[0] >= 3:
        # lanes shift by the pair-(0,m) estimate, lane 0 unshifted
        shifts0 = np.zeros(frames.shape[0])
        shifts0[1:] = -np.asarray(best_shifts)[: frames.shape[0] - 1]

    canvas.blit(waveform_panel(frames, shifts0), 20, 200)
    canvas.blit(correlogram_panel(correlograms), 20, 300)

    heat = heatmap_rgb(
        heat_levels_or_scores, grid, mode=heat_mode,
        mic_positions=mic_positions, cell_px=4)
    if xy is not None and xy_cov is not None:
        overlay_uncertainty(heat, grid, np.asarray(xy),
                            np.asarray(xy_cov), cell_px=4)
    canvas.blit(heat, 420 - heat.shape[1] // 2, 240 - heat.shape[0] // 2)

    if status:
        canvas.text(status, 4, 4, GREEN)
    return canvas.rgb
