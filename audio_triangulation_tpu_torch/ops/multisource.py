"""Simultaneous multi-source localization primitives.

Counterpart of ``audio_triangulation_tpu.ops.multisource``.  The reference
firmware is single-source (one heatmap argmax, one peak taper per
capture); these pieces lift the same SRP machinery to K simultaneous
sources:

1. ``srp.top_k_peaks`` finds K spatially separated SRP peaks (candidate
   positions);
2. for each candidate, each pair's TDOA is re-measured as the raw
   correlogram's local maximum near the lag that candidate predicts
   (:func:`windowed_subsample_peak`), so the spatial hypothesis decides
   which correlogram peak belongs to which source;
3. a Gauss-Newton solve batched over the source axis refines each
   candidate.

K is fixed per call, so every shape is static and nothing waits for the
host.
"""

from __future__ import annotations

import numpy as np
import torch


def cell_centers_xy(grid) -> np.ndarray:
    """Planar (x, y) meters of every grid cell, flat row-major [G, 2]: the
    cell-to-meters mapping of ``srp.grid_peak_xy`` (col 0 is half_cells_x
    cells left of center, row 0 is half_cells_y cells above).  These are the
    plane coordinates of the cells whatever the grid's sphere or plane
    projection, which changes only each cell's expected lags."""
    xs = (np.arange(grid.width) - grid.half_cells_x) / grid.cells_per_m
    ys = (grid.half_cells_y - np.arange(grid.height)) / grid.cells_per_m
    gx, gy = np.meshgrid(xs, ys)  # [H, W] each; flat index = row*W + col
    return np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)


def windowed_subsample_peak(correlograms: torch.Tensor, max_shift: int,
                            pred_lags: torch.Tensor, window: float):
    """Local correlogram peak near a predicted lag, refined parabolically.

    correlograms [..., P, L] (raw, untapered); pred_lags [..., P] predicted
    fractional lags (samples, signed); ``window`` the half-width of the
    association gate in samples.  Returns (tdoa_samples [..., P],
    peak_value [..., P]): the argmax (first maximum) is restricted to
    ``|lag - pred| <= window``, while the parabola's neighbours are read
    from the raw correlogram, as ``xcorr.subsample_peak`` reads them; a
    peak at an edge lag is not refined.  To hold K hypotheses against one
    correlogram set, pass ``correlograms[..., None, :, :]`` with pred_lags
    [..., K, P]."""
    n_lags = correlograms.shape[-1]
    lane = torch.arange(n_lags, dtype=torch.float32,
                        device=correlograms.device) - max_shift
    mask = (lane - pred_lags[..., None]).abs() <= window  # [..., P, L]
    c = torch.broadcast_to(correlograms, mask.shape)
    neg = torch.full((), -3.0e38, dtype=c.dtype, device=c.device)
    masked = torch.where(mask, c, neg)
    p = masked.argmax(dim=-1)
    peak = masked.amax(dim=-1)

    pc = p.clamp(1, n_lags - 2)
    cm = c.gather(-1, (pc - 1)[..., None])[..., 0]
    c0 = c.gather(-1, pc[..., None])[..., 0]
    cp = c.gather(-1, (pc + 1)[..., None])[..., 0]
    den = cm - 2.0 * c0 + cp
    delta = torch.where(den.abs() > 1e-20, 0.5 * (cm - cp) / den,
                        torch.zeros_like(den))
    delta = torch.where((p >= 1) & (p <= n_lags - 2), delta,
                        torch.zeros_like(delta))
    delta = delta.clamp(-0.5, 0.5)
    return (p - max_shift).to(c.dtype) + delta, peak
