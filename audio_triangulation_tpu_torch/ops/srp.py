"""Steered-response-power (SRP) grid scoring and peak extraction.

Counterpart of ``audio_triangulation_tpu.ops.srp`` (main-path subset):

- matmul form: scores[B, G] = corr[B, P*L] @ onehot[P*L, G]
- gather form: sum over pairs of corr[..., p, lut[p, g]]
- grid peak: first-max argmax, optional separable quadratic refinement
"""

from __future__ import annotations

import torch


def srp_scores_matmul(correlograms: torch.Tensor, onehot: torch.Tensor,
                      dtype: str = "float32") -> torch.Tensor:
    """scores [..., G] from correlograms [..., P, L] and onehot [P*L, G].

    ``dtype='bfloat16'`` rounds the correlograms to bf16 and accumulates
    in f32, as the reference's bf16 x bf16 -> f32 product does (a bf16
    torch matmul would also round the output).  ``onehot`` is used as it
    is, so it must hold bf16-exact values: a 0/1 steering matrix does, and
    ``Localizer`` stores any other one rounded."""
    *lead, p, l = correlograms.shape
    flat = correlograms.reshape(*lead, p * l)
    if dtype == "bfloat16":
        flat = flat.to(torch.bfloat16).float()
    return torch.matmul(flat, onehot)


def srp_scores_gather(correlograms: torch.Tensor,
                      lut_flat: torch.Tensor) -> torch.Tensor:
    """scores [..., G] via a per-pair gather; lut_flat is int [P, G]."""
    idx = lut_flat.long().expand(*correlograms.shape[:-2], *lut_flat.shape)
    return correlograms.gather(-1, idx).sum(dim=-2)


def auto_srp_form(num_pairs: int, num_lags: int, num_cells: int,
                  onehot_budget_bytes: int = 256 * 1024 * 1024) -> str:
    """'matmul' when the f32 one-hot steering matrix fits the budget, else
    'gather'."""
    onehot_bytes = num_pairs * num_lags * num_cells * 4
    return "matmul" if onehot_bytes <= onehot_budget_bytes else "gather"


def quantize_heatmap(scores: torch.Tensor) -> torch.Tensor:
    """4-level fraction-of-max quantization (uint8): thresholds 63/64,
    31/32, 15/16 and 7/8 of the max; integer scores use arithmetic shifts."""
    m = scores.amax(dim=-1, keepdim=True)
    if not scores.is_floating_point():
        t = [(m * 63) >> 6, (m * 31) >> 5, (m * 15) >> 4, (m * 7) >> 3]
    else:
        t = [m * (63.0 / 64.0), m * (31.0 / 32.0), m * (15.0 / 16.0),
             m * (7.0 / 8.0)]
    level = torch.zeros(scores.shape, dtype=torch.uint8, device=scores.device)
    for thr in t:
        level += (scores >= thr).to(torch.uint8)
    return level


def cell_to_xy(cell: torch.Tensor, width: int, half_cells: tuple[int, int],
               cells_per_m: float, dx=0.0, dy=0.0) -> torch.Tensor:
    """Flat grid cell index -> (x, y) meters, with optional sub-cell
    offsets ``dx``/``dy``."""
    half_x, half_y = half_cells
    row = torch.div(cell, width, rounding_mode="floor")
    col = cell % width
    x_m = (col.float() + dx - half_x) / cells_per_m
    y_m = (half_y - (row.float() + dy)) / cells_per_m
    return torch.stack([x_m, y_m], dim=-1)


def grid_peak_xy(scores: torch.Tensor, grid_shape: tuple[int, int],
                 half_cells: tuple[int, int], cells_per_m: float,
                 refine: bool = True) -> torch.Tensor:
    """Peak position [..., 2] in meters from flat scores [..., G]; the first
    maximum wins.  ``refine`` adds a 3-point quadratic fit along each axis
    (interior cells only, clipped to +-0.5 cell)."""
    h, w = grid_shape
    flat_idx = scores.argmax(dim=-1)
    row = torch.div(flat_idx, w, rounding_mode="floor")
    col = flat_idx % w

    def take(idx):
        return scores.gather(-1, idx[..., None])[..., 0]

    def frac(center, axis_len, stride):
        c = center.clamp(1, axis_len - 2)
        base = flat_idx + (c - center) * stride
        vm, v0, vp = take(base - stride), take(base), take(base + stride)
        den = vm - 2.0 * v0 + vp
        d = torch.where(den.abs() > 1e-20, 0.5 * (vm - vp) / den,
                        torch.zeros_like(den))
        d = torch.where((center >= 1) & (center <= axis_len - 2), d,
                        torch.zeros_like(d))
        return d.clamp(-0.5, 0.5)

    if refine:
        dx, dy = frac(col, w, 1), frac(row, h, w)
    else:
        dx = dy = torch.zeros(flat_idx.shape, dtype=scores.dtype,
                              device=scores.device)
    return cell_to_xy(flat_idx, w, half_cells, cells_per_m, dx, dy)
