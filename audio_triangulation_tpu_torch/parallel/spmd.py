"""Explicit SPMD with hand-placed collectives on ``torch.distributed``.

Counterpart of ``audio_triangulation_tpu.parallel.spmd``.  Every rank runs
the same program on its own shard; the collectives are written out:

- **grid axis** (:func:`make_spmd_grid_localizer`): each rank scores only
  its slice of the steering matrix with the SRP-argmax kernel
  (``ops/cuda/srp_kernel``: the best score and its first cell, [B, G] never
  stored), then a cross-rank argmax (MAX of the score, MIN of the winning
  rank, SUM of the winner's global cell) picks the lowest cell of the
  global maximum, as one device would;
- **pair axis** (:func:`make_spmd_pair_localizer`): each rank correlates
  its slice of a large array's pairs with the large-array kernel
  (``ops/cuda/gcc_large``), scores the whole grid from them, and a SUM
  completes the sum over pairs;
- **array axis** (:func:`make_fusion_spmd`): each rank correlates and
  scores its arrays (``fusion_correlograms``: the GCC kernel without
  peaks), a SUM fuses the maps, an all-gather assembles the joint TDOAs and
  weights, and the joint solve runs on every rank.

Each per-rank body is a plain function of the shard's inputs and the
shard's index, and each combine a plain function of the bodies' outputs
(``*_body`` and ``*_combine``); the collective forms (``*_allreduce``,
``sum_allreduce``) give the same results across ranks.  So a model axis
can also run shard by shard on one device: the bodies in turn, then the
combines.  Frames ride the data axis: ``fn`` takes the rank's data shard
(``mesh.frames_shard``) and returns the rank's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..models import fusion as fusion_mod
from ..models import localizer as localizer_mod
from ..ops import solver as solver_ops, srp, xcorr
from ..ops.cuda import gcc_large, srp_kernel
from . import mesh as mesh_lib

# bytes of the [b, 6, K] steering columns the peak fit reads at a time
NEIGHBOUR_SLICE_BYTES = 256 * 1024 * 1024


# ----------------------------------------------------------------------
# Grid axis
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GridShard:
    """One model-axis slice of the steering matrix: its columns [K, gs] of
    the grid padded to a multiple of the axis (padding columns zero), the
    global index of its first cell and how many of its cells are real."""

    onehot: torch.Tensor
    start: int
    num_cells: int


def steering_columns(params: localizer_mod.LocalizerParams, num_lags: int,
                     start: int, stop: int) -> torch.Tensor:
    """Columns [start, stop) of the [P*L, G] steering matrix: the stored
    one-hot's (matmul form), else built from ``lut_flat``."""
    if params.onehot is not None:
        return params.onehot[:, start:stop]
    lut = params.lut_flat[:, start:stop]
    return srp.big_onehot_device(lut, num_lags)


def grid_shard(params: localizer_mod.LocalizerParams, cfg, num_cells: int,
               parts: int, index: int) -> GridShard:
    """Shard ``index`` of ``parts`` of the grid's steering matrix."""
    start, stop = mesh_lib.shard_range(num_cells, parts, index)
    real = max(0, min(stop, num_cells) - start)
    cols = steering_columns(params, cfg.num_lags, min(start, num_cells),
                            min(stop, num_cells))
    if real < stop - start:
        cols = torch.nn.functional.pad(cols, (0, stop - start - real))
    return GridShard(cols.contiguous(), start, real)


def grid_argmax_body(corr_t: torch.Tensor, shard: GridShard, *,
                     bf16: bool = False):
    """The rank's part of the grid argmax: (best score [B], its global
    cell [B] int64) of tapered correlograms [B, P, L] over the shard's real
    cells, by the SRP-argmax kernel (the first maximum wins).  A shard of
    padding only answers -inf."""
    b = corr_t.shape[0]
    if shard.num_cells == 0:
        return (torch.full((b,), float("-inf"), device=corr_t.device),
                torch.full((b,), shard.start, dtype=torch.int64,
                           device=corr_t.device))
    val, cell = srp_kernel.srp_argmax(corr_t, shard.onehot, shard.num_cells,
                                      bf16=bf16)
    return val.float(), cell.long() + shard.start


def argmax_combine(vals: Sequence[torch.Tensor],
                   cells: Sequence[torch.Tensor]):
    """The global (best score, cell) from every shard's, in model-axis
    order: the maximum score, and the lowest shard holding it wins a tie
    (its cells precede the later shards')."""
    v = torch.stack(list(vals))
    c = torch.stack(list(cells))
    best = v.max(dim=0).values
    winner = (v == best).to(torch.int8).argmax(dim=0)  # first shard
    return best, c.gather(0, winner[None])[0]


def argmax_allreduce(val: torch.Tensor, cell: torch.Tensor, group,
                     index: int, parts: int):
    """:func:`argmax_combine` across the ranks of ``group`` (this rank the
    ``index``-th of ``parts``): MAX of the score, MIN of the ranks that
    hold it, SUM of the winner's cell."""
    best = val.clone()
    dist.all_reduce(best, op=dist.ReduceOp.MAX, group=group)
    rank = torch.where(val == best, index, parts).to(torch.int64)
    dist.all_reduce(rank, op=dist.ReduceOp.MIN, group=group)
    mine = torch.where(rank == index, cell, torch.zeros_like(cell))
    dist.all_reduce(mine, op=dist.ReduceOp.SUM, group=group)
    return best, mine


def neighbour_body(corr_t: torch.Tensor, shard: GridShard,
                   idx: torch.Tensor, *, bf16: bool = False) -> torch.Tensor:
    """The rank's part of the scores [B, 6] at the cells ``idx`` [B, 6]
    that the quadratic peak fit reads (``srp.peak_neighbours``): each
    owned cell's score, zero elsewhere, so the parts sum to the scores."""
    b = corr_t.shape[0]
    flat = corr_t.reshape(b, -1)
    if bf16:
        flat = flat.to(torch.bfloat16).float()
    gs = shard.onehot.shape[1]
    local = idx - shard.start
    own = (local >= 0) & (local < shard.num_cells)
    cols_t = shard.onehot.t()
    out = torch.zeros(idx.shape, dtype=flat.dtype, device=flat.device)
    step = max(1, NEIGHBOUR_SLICE_BYTES // max(1, 6 * flat.shape[1] * 4))
    for i in range(0, b, step):
        cols = cols_t[local[i:i + step].clamp(0, max(gs - 1, 0))]
        out[i:i + step] = torch.einsum("bk,bjk->bj", flat[i:i + step],
                                       cols.to(flat.dtype))
    return torch.where(own, out, torch.zeros_like(out))


def sum_combine(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The shards' partial sums added in model-axis order."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def sum_allreduce(part: torch.Tensor, group) -> torch.Tensor:
    """:func:`sum_combine` across the ranks of ``group``."""
    out = part.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def refined_xy(cell: torch.Tensor, neighbours: Optional[torch.Tensor],
               grid_cfg) -> torch.Tensor:
    """The grid peak in meters [B, 2] of the global cell, with the
    quadratic fit from its neighbours' scores [B, 6] when given."""
    dx = dy = 0.0
    if neighbours is not None:
        dx, dy = srp.peak_offsets(cell, neighbours,
                                  (grid_cfg.height, grid_cfg.width))
    return srp.cell_to_xy(cell, grid_cfg.width,
                          (grid_cfg.half_cells_x, grid_cfg.half_cells_y),
                          grid_cfg.cells_per_m, dx, dy)


def model_group(mesh):
    """(group, this rank's index, size) of the mesh's model axis."""
    return (mesh.get_group(mesh_lib.MODEL_AXIS),
            mesh_lib.axis_index(mesh, mesh_lib.MODEL_AXIS),
            mesh_lib.axis_size(mesh, mesh_lib.MODEL_AXIS))


def grid_peak_allreduce(corr_t: torch.Tensor, shard: GridShard, mesh,
                        grid_cfg, *, refine: bool, bf16: bool):
    """(best score [B], global cell [B], xy_grid [B, 2]) of this rank's
    correlograms over the whole grid: the rank's argmax body, the
    cross-rank argmax, and with ``refine`` one SUM of the fit's six scores
    (each rank adds the ones it owns, so a peak on a shard's edge reads its
    neighbours from the next shard)."""
    group, index, parts = model_group(mesh)
    val, cell = grid_argmax_body(corr_t, shard, bf16=bf16)
    best, cell = argmax_allreduce(val, cell, group, index, parts)
    neighbours = None
    if refine:
        idx = srp.peak_neighbours(cell, (grid_cfg.height, grid_cfg.width))
        neighbours = sum_allreduce(
            neighbour_body(corr_t, shard, idx, bf16=bf16), group)
    return best, cell, refined_xy(cell, neighbours, grid_cfg)


def check_grid_parallel(loc) -> None:
    """Refuse what the SRP-argmax kernel does not take: an additive score
    bias (its padding is handled by the real-cell count) and a heatmap
    (the [B, G] scores are never stored)."""
    if loc.params.score_bias is not None:
        raise ValueError("grid-parallel scoring takes no score_bias (the "
                         "SRP-argmax kernel adds none)")
    if loc.with_heatmap:
        raise ValueError("grid-parallel scoring never stores the [B, G] "
                         "scores, so it gives no heatmap")


def make_spmd_grid_localizer(loc: localizer_mod.Localizer, mesh):
    """``fn(frames_shard) -> {'xy_grid', 'best_cell', 'best_score',
    'tdoa_samples'}`` with the grid sharded over the model axis (the
    un-refined grid peak of the global argmax; no solver).

    Each rank holds only its slice of the steering matrix (the grid padded
    to a multiple of the axis; padding never wins), correlates its data
    shard with its peaks (``localizer.gcc_peaks``), takes its local argmax
    with the SRP-argmax kernel and joins the cross-rank argmax."""
    check_grid_parallel(loc)
    group, index, parts = model_group(mesh)
    shard = grid_shard(loc.params, loc.pipeline, loc.grid.num_cells, parts,
                       index)
    bf16 = loc.pipeline.srp_dtype == "bfloat16"
    params = loc.params

    def fn(frames: torch.Tensor) -> dict:
        loc._check_frames(frames)
        flat = localizer_mod._flat_frames(frames, loc.pipeline)
        corr_t, _, tdoa, _, _ = localizer_mod.gcc_peaks(flat, params,
                                                        loc.pipeline)
        best, cell, xy = grid_peak_allreduce(corr_t, shard, mesh, loc.grid,
                                             refine=False, bf16=bf16)
        return {"xy_grid": xy, "best_cell": cell, "best_score": best,
                "tdoa_samples": tdoa}

    fn.shard = shard
    return fn


# ----------------------------------------------------------------------
# Pair axis (large arrays)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class PairShard:
    """One model-axis slice of a large array's pairs: the pairs [ps, 2]
    (padding pairs (0, 0)), their 0/1 validity [ps], their lag LUT rows
    [ps, G] (padding rows 0), and the precomputed steering rows [ps*L, G]
    when ``big_steering`` chose them, else None (the pair-blocked
    product builds them a chunk at a time)."""

    pairs: torch.Tensor
    valid: torch.Tensor
    lut: torch.Tensor
    steer: Optional[torch.Tensor]


def big_steering(cfg, p: int, g: int, parts: int) -> bool:
    """The reference's choice of a precomputed steering shard over the
    pair-blocked product: more than 256 pairs, and the shard of the padded
    [P, L8, G] matrix (counted per rank) within
    ``srp_big_matmul_budget_bytes``."""
    pad = (-p) % parts
    itemsize = 2 if cfg.srp_dtype == "bfloat16" else 4
    shard_bytes = ((p + pad) * srp.sublane_pad_lags(cfg.num_lags) * g
                   * itemsize // parts)
    return (p > 256 and cfg.srp_big_matmul_budget_bytes > 0
            and shard_bytes <= cfg.srp_big_matmul_budget_bytes)


def pair_shard(params: localizer_mod.LocalizerParams, cfg, parts: int,
               index: int, *, steer: bool) -> PairShard:
    """Shard ``index`` of ``parts`` of the pair axis, padded as the
    reference pads it."""
    p = params.pairs.shape[0]
    start, stop = mesh_lib.shard_range(p, parts, index)
    real = max(0, min(stop, p) - start)
    pad = stop - start - real
    dev = params.pairs.device
    pairs = torch.cat([params.pairs[start:start + real],
                       torch.zeros((pad, 2), dtype=params.pairs.dtype,
                                   device=dev)])
    valid = torch.cat([torch.ones(real, device=dev),
                       torch.zeros(pad, device=dev)])
    lut = params.lut_flat[start:start + real]
    lut = torch.cat([lut, torch.zeros((pad, lut.shape[1]), dtype=lut.dtype,
                                      device=dev)])
    # padded pairs select lag 0, but their correlograms are zeroed by the
    # valid mask, so scores are exact
    rows = srp.big_onehot_device(lut, cfg.num_lags) if steer else None
    return PairShard(pairs, valid, lut, rows)


def pair_path_cfg(cfg):
    """The settings the pair-sharded path correlates with, as the
    reference's does: the full band (its cross-power and lag synthesis
    take no ``band_hz`` / ``band_crop``) and full PHAT (no
    ``phat_beta``)."""
    return dataclasses.replace(cfg, band_hz=None, band_crop=False,
                               phat_beta=1.0)


def pair_scores_body(frames: torch.Tensor, window: torch.Tensor,
                     shard: PairShard, cfg) -> torch.Tensor:
    """The rank's partial scores [B, G] from its pairs: the frames
    conditioned, the large-array kernel on the shard's pairs with
    :func:`pair_path_cfg`'s settings, the reference's peak taper (whatever
    ``taper_enabled`` says, as the reference), padded pairs zeroed, then
    the shard's steering product."""
    x = localizer_mod.condition_frames(frames, window, cfg)
    corr = gcc_large.xcorr_large(x, shard.pairs, pair_path_cfg(cfg))
    k = cfg.max_shift
    corr_t = xcorr.peak_taper(corr, k, cfg.taper_denom,
                              xcorr.best_lag(corr, k))
    corr_t = corr_t * shard.valid[:, None]
    if shard.steer is not None:
        return srp.srp_scores_matmul_big(corr_t, shard.steer,
                                         dtype=cfg.srp_dtype)
    return srp.srp_scores_matmul_blocked(
        corr_t, shard.lut, cfg.num_lags,
        pair_chunk=min(128, corr_t.shape[-2]), dtype=cfg.srp_dtype)


def pair_finish(scores: torch.Tensor, grid_cfg) -> dict:
    """{'scores', 'xy_grid'} from the whole scores: the refined grid
    peak."""
    xy = srp.grid_peak_xy(
        scores, (grid_cfg.height, grid_cfg.width),
        (grid_cfg.half_cells_x, grid_cfg.half_cells_y),
        grid_cfg.cells_per_m)
    return {"scores": scores, "xy_grid": xy}


def make_spmd_pair_localizer(loc: localizer_mod.Localizer, mesh):
    """``fn(frames_shard) -> {'scores', 'xy_grid'}`` with the pair axis of
    a large array sharded over the model axis and frames over data: each
    rank correlates its pairs and scores the whole grid from them, and one
    SUM over the model axis completes the sum over pairs (SRP's pair sum is
    associative).  ``fn.big_steering`` says whether each rank holds a
    precomputed steering shard or builds it a pair chunk at a time.  As
    the reference's, it ignores ``band_hz``, ``band_crop`` and
    ``phat_beta`` (:func:`pair_path_cfg`) and always tapers: with any of
    them set it differs from ``loc(frames)``, and without it equals it."""
    cfg = loc.pipeline
    group, index, parts = model_group(mesh)
    p, g = loc.params.lut_flat.shape
    steer = big_steering(cfg, p, g, parts)
    shard = pair_shard(loc.params, cfg, parts, index, steer=steer)
    window = loc.params.window

    def fn(frames: torch.Tensor) -> dict:
        loc._check_frames(frames)
        flat = localizer_mod._flat_frames(frames, cfg)
        part = pair_scores_body(flat, window, shard, cfg)
        return pair_finish(sum_allreduce(part, group), loc.grid)

    fn.big_steering = steer
    fn.shard = shard
    return fn


# ----------------------------------------------------------------------
# Array axis (multi-array fusion)
# ----------------------------------------------------------------------

def array_range(k: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of shard ``index``'s arrays; ``k`` must divide."""
    if k % parts:
        raise ValueError(f"{k} arrays not divisible by model axis {parts}")
    return index * (k // parts), (index + 1) * (k // parts)


def fusion_body(fus, frames: torch.Tensor, arrays: tuple[int, int],
                weights: torch.Tensor):
    """The rank's part of the fusion: frames [B, Ks, M, N] of its arrays
    ``arrays`` = [start, stop) -> (partial fused scores [B, G], TDOAs
    [B, Ks, P] in samples), by ``fusion_correlograms`` (the GCC kernel
    without peaks) and the weighted steering product of its arrays."""
    a0, a1 = arrays
    corr_t, _, tdoa, _ = fusion_mod.fusion_correlograms(
        fus.params, frames, fus.pipeline)
    partial = fusion_mod.fused_scores(corr_t, fus.onehot[a0:a1],
                                      weights[a0:a1], fus.pipeline.srp_dtype)
    return partial, tdoa


def fusion_finish(fus, scores: torch.Tensor, tdoa_all: torch.Tensor,
                  weights: torch.Tensor) -> dict:
    """The replicated tail: the fused map's grid peak (no fit) and the
    joint Gauss-Newton solve over every array's TDOAs [B, K, P]."""
    cfg, grid_cfg = fus.pipeline, fus.grid
    xy_grid = srp.grid_peak_xy(
        scores, (grid_cfg.height, grid_cfg.width),
        (grid_cfg.half_cells_x, grid_cfg.half_cells_y),
        grid_cfg.cells_per_m, refine=False)
    b, k, p = tdoa_all.shape
    xy, rms = solver_ops.solve_tdoa_batched(
        tdoa_all.reshape(b, k * p) / cfg.sample_rate_hz, fus.cat_mics,
        fus.cat_pairs, speed_of_sound=cfg.speed_of_sound_mps,
        height=grid_cfg.height_m, init_xy=xy_grid,
        weights=weights.repeat_interleave(p), cfg=fus.solver)
    return {"scores": scores, "xy_grid": xy_grid, "xy": xy, "rms_m": rms,
            "tdoa_samples": tdoa_all}


def make_fusion_spmd(fus, mesh):
    """``fn(frames_shard, weights=None)`` for multi-array fusion with the
    array axis sharded over the model axis and frames over data: each rank
    correlates and scores its arrays, a SUM fuses the score maps, an
    all-gather assembles the joint TDOAs and weights, and the joint solve
    runs on every rank.  ``frames_shard`` is the rank's data shard [B, K,
    M, N] (its arrays are taken from it) or already its arrays [B, K/n, M,
    N].  Returns {'scores', 'xy_grid', 'xy', 'rms_m', 'tdoa_samples'}.  K
    must divide by the model-axis size, or ``ValueError``."""
    group, index, parts = model_group(mesh)
    k = fus.n_arrays
    a0, a1 = array_range(k, parts, index)

    def fn(frames: torch.Tensor, weights=None) -> dict:
        w = fus._weights(weights)
        if frames.shape[-3] == k and parts > 1:
            frames = frames[..., a0:a1, :, :]
        partial, tdoa = fusion_body(fus, frames, (a0, a1), w)
        scores = sum_allreduce(partial, group)
        tdoa_all = torch.cat(mesh_lib.all_gather(tdoa, group, parts),
                             dim=1)
        return fusion_finish(fus, scores, tdoa_all, w)

    return fn

