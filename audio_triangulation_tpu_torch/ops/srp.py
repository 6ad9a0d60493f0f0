"""Steered-response-power (SRP) grid scoring and peak extraction.

Counterpart of ``audio_triangulation_tpu.ops.srp`` (main-path subset):

- matmul form: scores[B, G] = corr[B, P*L] @ onehot[P*L, G]
- gather form: sum over pairs of corr[..., p, lut[p, g]] (a slice of the
  batch at a time: ``srp_scores_gather_batched``), and in int64
  for the bit-exact heatmap path (``srp_scores_int``, whose 4-level
  colours ``quantize_heatmap`` gives)
- large arrays: one product against a steering matrix built on the device
  (``big_onehot_device`` / ``srp_scores_matmul_big``), or the pair axis a
  chunk at a time (``srp_scores_matmul_blocked`` / ``_gather_blocked``)
- grid peak: first-max argmax, optional separable quadratic refinement
- K separated peaks for simultaneous sources (``top_k_peaks``)
- the grid axis padded to a multiple of a mesh axis, with a bias that
  keeps the padding from ever winning (``pad_grid_axis``,
  ``pad_scores_bias``)

The reference pads the lag axis of its large-array one-hots to a multiple
of 8 for its memory layout; the zero rows add nothing to a score, so the
port builds them unpadded and takes a padded matrix when it is given one.
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
    return torch.matmul(_round(correlograms.reshape(*lead, p * l), dtype),
                        onehot)


def srp_scores_gather(correlograms: torch.Tensor,
                      lut_flat: torch.Tensor) -> torch.Tensor:
    """scores [..., G] via a per-pair gather; lut_flat is int [P, G]."""
    idx = lut_flat.long().expand(*correlograms.shape[:-2], *lut_flat.shape)
    return correlograms.gather(-1, idx).sum(dim=-2)


def srp_scores_gather_batched(correlograms: torch.Tensor,
                              lut_flat: torch.Tensor,
                              slice_bytes: int) -> torch.Tensor:
    """:func:`srp_scores_gather` of correlograms [B, P, L] a slice of the
    batch at a time, so that no slice's [b, P, G] gather holds more than
    ``slice_bytes`` (16,384 frames of 28 pairs and 12,005 cells would take
    22 GB at once).  Each score sums its pairs in the same order."""
    b = correlograms.shape[0]
    per_frame = lut_flat.numel() * correlograms.element_size()
    step = max(1, slice_bytes // max(per_frame, 1))
    if step >= b:
        return srp_scores_gather(correlograms, lut_flat)
    out = correlograms.new_empty((b, lut_flat.shape[-1]))
    for i in range(0, b, step):
        out[i:i + step] = srp_scores_gather(correlograms[i:i + step],
                                            lut_flat)
    return out


def srp_scores_int(correlograms: torch.Tensor,
                   lut_flat: torch.Tensor) -> torch.Tensor:
    """int64 scores [..., G] of the bit-exact heatmap path."""
    return srp_scores_gather(correlograms.to(torch.int64), lut_flat)


def _round(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """``x`` rounded to bf16 and carried as f32 when ``dtype`` says so (a
    bf16 torch matmul would round its output too), else as it is."""
    return x.to(torch.bfloat16).float() if dtype == "bfloat16" else x


def srp_scores_gather_blocked(correlograms: torch.Tensor,
                              lut_flat: torch.Tensor,
                              pair_chunk: int = 128) -> torch.Tensor:
    """:func:`srp_scores_gather` summed over ``pair_chunk``-sized slices of
    the pair axis, so the [..., P, G] gather is never whole in memory."""
    out = torch.zeros((*correlograms.shape[:-2], lut_flat.shape[-1]),
                      dtype=correlograms.dtype, device=correlograms.device)
    for p0 in range(0, lut_flat.shape[0], pair_chunk):
        out = out + srp_scores_gather(
            correlograms[..., p0:p0 + pair_chunk, :],
            lut_flat[p0:p0 + pair_chunk])
    return out


def srp_scores_matmul_blocked(correlograms: torch.Tensor,
                              lut_flat: torch.Tensor, num_lags: int,
                              pair_chunk: int = 128,
                              dtype: str = "float32") -> torch.Tensor:
    """Pair-blocked matmul scoring for large arrays: each chunk's one-hot
    block [chunk * L, G] is built from ``lut_flat`` (a compare against the
    lag index) and multiplied, the chunks summed in order.  ``dtype``
    'bfloat16' rounds the correlograms and sums in f32."""
    lags = torch.arange(num_lags, dtype=lut_flat.dtype,
                        device=lut_flat.device)
    out = torch.zeros((*correlograms.shape[:-2], lut_flat.shape[-1]),
                      dtype=correlograms.dtype, device=correlograms.device)
    for p0 in range(0, lut_flat.shape[0], pair_chunk):
        lut = lut_flat[p0:p0 + pair_chunk]
        onehot = (lut[:, None, :] == lags[None, :, None]).to(
            correlograms.dtype)
        c = _round(correlograms[..., p0:p0 + pair_chunk, :], dtype)
        out = out + torch.matmul(c.reshape(*c.shape[:-2], -1),
                                 onehot.reshape(-1, lut.shape[-1]))
    return out


def sublane_pad_lags(num_lags: int) -> int:
    """Lag count rounded up to a multiple of 8: the row count per pair of
    the reference's large-array steering matrix, which sizes the budget
    rule of ``Localizer.create`` in both packages."""
    return -(-num_lags // 8) * 8


def big_onehot_device(lut_flat: torch.Tensor, num_lags: int,
                      dtype: str = "bfloat16") -> torch.Tensor:
    """The large-array steering matrix [P * L, G], built on ``lut_flat``'s
    device.  Its 0/1 entries are exact in bf16, so it is stored as f32 for
    either ``dtype`` (an f32 product of bf16-exact operands is what the
    reference's bf16 product with f32 accumulation computes)."""
    p, g = lut_flat.shape
    lags = torch.arange(num_lags, dtype=lut_flat.dtype,
                        device=lut_flat.device)
    return (lut_flat[:, None, :] == lags[None, :, None]).float().reshape(
        p * num_lags, g)


def srp_scores_matmul_big(correlograms: torch.Tensor,
                          onehot_big: torch.Tensor,
                          dtype: str = "float32") -> torch.Tensor:
    """scores [..., G] in one product against a precomputed [P * L', G]
    steering matrix (:func:`big_onehot_device`, or the reference's with its
    lag axis zero-padded to L' >= L)."""
    *lead, p, l = correlograms.shape
    lp = onehot_big.shape[0] // p
    corr = correlograms
    if lp != l:
        corr = torch.nn.functional.pad(corr, (0, lp - l))
    flat = _round(corr.reshape(*lead, p * lp), dtype)
    return torch.matmul(flat, onehot_big.to(flat.dtype))


def grid_argmax(scores: torch.Tensor, grid_shape: tuple[int, int]):
    """(row, col) int32 of the first maximum of flat scores [..., G]."""
    _, w = grid_shape
    flat_idx = scores.argmax(dim=-1).to(torch.int32)
    return torch.div(flat_idx, w, rounding_mode="floor"), flat_idx % w


def top_k_peaks(scores: torch.Tensor, cell_xy: torch.Tensor, k: int,
                min_separation_m: float):
    """K spatially separated SRP peaks by greedy non-maximum suppression:
    k rounds of (argmax, suppress the ``min_separation_m``-radius disc
    around it).  scores [..., G], cell_xy [G, 2] meters.  Returns (peak_xy
    [..., k, 2], peak_score [..., k]); the first maximum wins a tie, and
    when fewer than k distinct sources exist later peaks repeat cells at
    the suppressed floor (rank by peak_score)."""
    neg = torch.full((), -3e38, dtype=scores.dtype, device=scores.device)
    r2 = min_separation_m * min_separation_m
    xys, vals = [], []
    s = scores
    for _ in range(k):
        idx = s.argmax(dim=-1)
        vals.append(s.gather(-1, idx[..., None])[..., 0])
        xy = cell_xy[idx]  # [..., 2]
        d2 = ((cell_xy - xy[..., None, :]) ** 2).sum(dim=-1)  # [..., G]
        s = torch.where(d2 <= r2, neg, s)
        xys.append(xy)
    return torch.stack(xys, dim=-2), torch.stack(vals, dim=-1)


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


def peak_neighbours(flat_idx: torch.Tensor,
                    grid_shape: tuple[int, int]) -> torch.Tensor:
    """The cells [..., 6] a quadratic peak fit at ``flat_idx`` reads: left,
    centre, right, then up, centre, down, each axis's centre clamped off the
    grid's edge (the fit is zeroed there)."""
    h, w = grid_shape
    row = torch.div(flat_idx, w, rounding_mode="floor")
    col = flat_idx % w
    out = []
    for center, axis_len, stride in ((col, w, 1), (row, h, w)):
        base = flat_idx + (center.clamp(1, axis_len - 2) - center) * stride
        out += [base - stride, base, base + stride]
    return torch.stack(out, dim=-1)


def peak_offsets(flat_idx: torch.Tensor, values: torch.Tensor,
                 grid_shape: tuple[int, int]):
    """(dx, dy) sub-cell offsets of the 3-point quadratic fit along each
    axis from the scores ``values`` [..., 6] at :func:`peak_neighbours`;
    zero on the grid's edge, clipped to +-0.5 cell."""
    h, w = grid_shape
    row = torch.div(flat_idx, w, rounding_mode="floor")
    col = flat_idx % w

    def frac(center, axis_len, vm, v0, vp):
        den = vm - 2.0 * v0 + vp
        d = torch.where(den.abs() > 1e-20, 0.5 * (vm - vp) / den,
                        torch.zeros_like(den))
        d = torch.where((center >= 1) & (center <= axis_len - 2), d,
                        torch.zeros_like(d))
        return d.clamp(-0.5, 0.5)

    v = values.unbind(dim=-1)
    return frac(col, w, *v[:3]), frac(row, h, *v[3:])


def grid_peak_xy(scores: torch.Tensor, grid_shape: tuple[int, int],
                 half_cells: tuple[int, int], cells_per_m: float,
                 refine: bool = True) -> torch.Tensor:
    """Peak position [..., 2] in meters from flat scores [..., G]; the first
    maximum wins.  ``refine`` adds a 3-point quadratic fit along each axis
    (interior cells only, clipped to +-0.5 cell)."""
    h, w = grid_shape
    flat_idx = scores.argmax(dim=-1)
    if refine:
        values = scores.gather(-1, peak_neighbours(flat_idx, grid_shape))
        dx, dy = peak_offsets(flat_idx, values, grid_shape)
    else:
        dx = dy = torch.zeros(flat_idx.shape, dtype=scores.dtype,
                              device=scores.device)
    return cell_to_xy(flat_idx, w, half_cells, cells_per_m, dx, dy)


def pad_grid_axis(x: torch.Tensor, multiple: int,
                  fill=0.0) -> torch.Tensor:
    """The last (grid) axis of ``x`` padded with ``fill`` up to a multiple
    (for sharding G over a mesh axis), on ``x``'s device."""
    pad = (-x.shape[-1]) % multiple
    return torch.nn.functional.pad(x, (0, pad), value=fill) if pad else x


def pad_scores_bias(num_cells: int, padded: int,
                    device=None) -> torch.Tensor:
    """Additive bias [padded] f32: 0 on valid cells, -3e38 on pad cells so
    they can never win the argmax."""
    b = torch.zeros(padded, dtype=torch.float32, device=device)
    b[num_cells:] = -3e38
    return b
