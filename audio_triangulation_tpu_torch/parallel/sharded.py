"""Sharded (multi-device) execution of the localization pipeline.

Counterpart of ``audio_triangulation_tpu.parallel.sharded``.  The reference
annotates shardings and lets XLA insert the collectives; here every rank of
a ``parallel.mesh`` mesh runs the same code on its own shard:

- **Data parallel**: each rank localizes its slice of the frames
  (``mesh.frames_shard``) with the replicated constants; no communication
  (``mesh.gather_batch`` assembles the global result when a caller wants
  it).
- **Grid parallel** (large grids): the steering matrix is additionally
  split over the ``model`` axis; each rank takes its local argmax with the
  SRP-argmax kernel and the ranks take a cross-rank argmax
  (``parallel.spmd``), with one more SUM for the peak fit's neighbours
  when the grid peak is refined.
- **Streaming**: S streams split over the data axis, each rank stepping
  its own (:func:`make_sharded_stream_step`).
- **Training**: :func:`data_parallel_step` averages the gradients of a
  ``Calibrator`` or ``NeuralLocalizer`` step over the data axis before its
  optimiser step (the reference's inserted psum).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models import localizer as localizer_mod
from ..ops import srp
from . import mesh as mesh_lib
from . import spmd


def shard_params(params: localizer_mod.LocalizerParams, mesh,
                 grid_parallel: bool = False,
                 cfg=None) -> localizer_mod.LocalizerParams:
    """This rank's constants: all of them, except with ``grid_parallel``
    the steering matrix, lag LUT and score bias, which keep only the
    rank's model-axis slice of the grid padded up to a multiple of the axis
    (zero steering columns, a -3e38 bias on padding: it never wins).  The
    steering slice is built from ``lut_flat`` where the localizer holds no
    one-hot, so grid parallel needs ``cfg`` (its lag count)."""
    if not grid_parallel:
        return params
    if cfg is None:
        raise ValueError("grid-parallel sharding needs the pipeline "
                         "config (its lag count)")
    _, index, parts = spmd.model_group(mesh)
    g = params.lut_flat.shape[-1]
    start, stop = mesh_lib.grid_range(mesh, g)
    shard = spmd.grid_shard(params, cfg, g, parts, index)
    lut = srp.pad_grid_axis(params.lut_flat, parts)[:, start:stop]
    bias = srp.pad_scores_bias(g, -(-g // parts) * parts,
                               params.lut_flat.device)[start:stop]
    return dataclasses.replace(params, lut_flat=lut, onehot=shard.onehot,
                               score_bias=bias, onehot_big=None)


def make_sharded_localize(loc: localizer_mod.Localizer, mesh,
                          grid_parallel: bool = False):
    """Returns ``(fn, params)``: ``fn(params, frames_shard)`` gives this
    rank's part of ``loc(frames)`` for its data shard of the frames, and
    ``mesh.gather_batch`` of it equals ``loc(frames)``.

    Data parallel is ``localize_frames`` on the shard.  With
    ``grid_parallel`` the rank scores its grid slice with the SRP-argmax
    kernel and joins the cross-rank argmax; the outputs are
    ``localize_frames``' but 'scores' (never stored), plus 'best_cell' and
    'best_score'.  The frames' batch must divide by the data-axis size."""
    params = shard_params(loc.params, mesh, grid_parallel, loc.pipeline)
    kw = dict(cfg=loc.pipeline, grid_cfg=loc.grid, solver_cfg=loc.solver,
              with_solver=loc.with_solver, gn=loc.gn)
    if not grid_parallel:
        def fn(params, frames):
            loc._check_frames(frames)
            return localizer_mod.localize_frames(
                params, frames, srp_form=loc.srp_form,
                with_heatmap=loc.with_heatmap, **kw)
        return fn, params

    spmd.check_grid_parallel(loc)
    g = loc.grid.num_cells
    start, stop = mesh_lib.grid_range(mesh, g)
    real = max(0, min(stop, g) - start)
    refine = (loc.grid.refine_peak == "on"
              or (loc.grid.refine_peak == "auto" and not loc.with_solver))
    bf16 = loc.pipeline.srp_dtype == "bfloat16"

    def fn(params, frames):
        loc._check_frames(frames)
        return grid_parallel_localize(
            params, frames, spmd.GridShard(params.onehot, start, real), mesh,
            refine=refine, bf16=bf16, **kw)

    return fn, params


def grid_parallel_localize(params, frames, shard: spmd.GridShard, mesh, *,
                           cfg, grid_cfg, solver_cfg, with_solver, gn,
                           refine: bool, bf16: bool) -> dict:
    """``localize_frames`` with the grid split over the model axis: the
    GCC front with its peaks on this rank's frames, the grid peak by
    ``spmd.grid_peak_allreduce``, then the solver tail."""
    lead = frames.shape[:-2]
    flat = localizer_mod._flat_frames(frames, cfg)
    corr_t, shifts, tdoa, peak_val, psr = localizer_mod.gcc_peaks(
        flat, params, cfg)
    best, cell, xy_grid = spmd.grid_peak_allreduce(
        corr_t, shard, mesh, grid_cfg, refine=refine, bf16=bf16)
    out = {"tdoa_samples": tdoa, "best_shift": shifts,
           "correlograms": corr_t, "xy_grid": xy_grid,
           "peak_value": peak_val, "confidence": psr.amin(dim=-1),
           "best_cell": cell, "best_score": best}
    if with_solver:
        out["xy"], out["rms_m"], out["xy_cov"] = localizer_mod.solve_tail(
            tdoa, xy_grid, params, cfg=cfg, grid_cfg=grid_cfg,
            solver_cfg=solver_cfg, gn=gn)
    else:
        out["xy"] = xy_grid
        out["rms_m"] = torch.zeros(tdoa.shape[:-1], dtype=corr_t.dtype,
                                   device=corr_t.device)
    return {k: v.reshape(*lead, *v.shape[1:]) for k, v in out.items()}


def make_sharded_stream_step(sl, mesh):
    """Multi-device streaming: S concurrent streams split over the mesh's
    data axis, each rank stepping its own with no communication.

    ``sl`` is a ``StreamingLocalizer`` or a ``TrackedStreamingLocalizer``
    built on this rank's device.  Returns ``(fn, init_states)``:
    ``init_states(S)`` gives this rank's S / n stacked stream states (S
    must divide by the data-axis size, or ``ValueError``), and
    ``fn(states, chunks)`` with this rank's chunks [S / n, M, C] advances
    them one step (``sl.step_many``).  ``solve_velocity``'s resampling
    matrices are the localizer's own, built once on the rank's device and
    shared by its streams."""
    data_n = mesh_lib.axis_size(mesh, mesh_lib.DATA_AXIS)

    def fn(states, chunks):
        return sl.step_many(states, chunks)

    def init_states(n_streams: int):
        if n_streams % data_n != 0:
            raise ValueError(
                f"{n_streams} streams not divisible by data axis {data_n}")
        return sl.init_states(n_streams // data_n)

    return fn, init_states


def _batch_len(x) -> int:
    """Leading length of a batch argument: a tensor or array, or the first
    field of a dataclass of them (``CalibBatch``)."""
    if dataclasses.is_dataclass(x):
        x = getattr(x, dataclasses.fields(x)[0].name)
    return int(x.shape[0])


def average_gradients(opt: torch.optim.Optimizer, group, n: int) -> None:
    """Every gradient of ``opt``'s parameters replaced by its mean over the
    ranks of ``group`` (one all-reduce for all of them)."""
    grads = [p.grad for pg in opt.param_groups for p in pg["params"]
             if p.grad is not None]
    if not grads or n == 1:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    i = 0
    for g in grads:
        g.copy_(flat[i:i + g.numel()].view_as(g))
        i += g.numel()


def data_parallel_step(step, mesh, axis: str = mesh_lib.DATA_AXIS):
    """A training step with its batch split over ``axis``:
    ``wrapped(params, opt, *batch_shard)`` runs ``step`` (a
    ``Calibrator.train_step`` or ``NeuralLocalizer.train_step``, which
    backpropagates, then steps ``opt``) on this rank's shard, with every
    gradient averaged over the axis by one all-reduce just before the
    optimiser step.  The losses are batch means plus batch-independent
    terms, so with equal shards the step is the whole batch's step, and the
    returned loss is the mean of the ranks' (the whole batch's).  Unequal
    shards are refused with ``ValueError``."""
    group, n = mesh.get_group(axis), mesh_lib.axis_size(mesh, axis)

    def wrapped(params, opt, *batch):
        size = torch.tensor([_batch_len(batch[0])], dtype=torch.int64,
                            device=mesh_lib.mesh_device(mesh))
        lo, hi = size.clone(), size.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
        if int(lo) != int(hi):
            raise ValueError(f"unequal batch shards ({int(lo)} to "
                             f"{int(hi)} rows): the averaged gradient would "
                             "not be the whole batch's")
        handle = opt.register_step_pre_hook(
            lambda o, args, kwargs: average_gradients(o, group, n))
        try:
            params, opt, loss = step(params, opt, *batch)
        finally:
            handle.remove()
        loss = loss.clone()
        dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return params, opt, loss / n

    return wrapped
