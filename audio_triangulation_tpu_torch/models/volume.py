"""Volumetric (3-D) SRP localization: a search box instead of the
fixed-height grid, refined by the free (x, y, z) Gauss-Newton solve.

Counterpart of ``audio_triangulation_tpu.models.volume``.  The raw
correlograms come from ``localizer.conditioned_correlograms`` (the GCC
kernel without peaks, row 2 of the kernel table, where the configuration
takes it; the large-array kernel for a frame too large for it); the box's
D x H x W cells are scored in the reference's form, the one-hot product
when its steering matrix fits 256 MB (``srp.auto_srp_form``) and else the
per-pair gather, here a slice of the batch at a time
(``srp.srp_scores_gather_batched``) so that the [B, P, G] gather is never
whole; the peak is refined per axis, or the solver
(``ops.solver.solve_tdoa_xyz``) starts from it.  Use a non-coplanar array
where height matters: a planar one cannot tell +-z apart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core import geometry
from ..core.config import PipelineConfig, SolverConfig, VolumeConfig
from ..ops import srp, xcorr
from ..ops import solver as solver_ops, window as window_ops
from . import localizer as localizer_mod

# bytes of the [b, P, G] gather a slice of the batch may form
GATHER_SLICE_BYTES = 1 << 30


class VolumeLocalizer(nn.Module):
    """Configured 3-D frame-batch localizer on one device.

    >>> loc = VolumeLocalizer.create(geometry.tetrahedral_array(0.3),
    ...                              device="cuda")
    >>> out = loc(frames)            # frames [B, M, N] on the same device
    >>> out["xyz"]                   # [B, 3] source positions (meters)
    """

    def __init__(self, pipeline: PipelineConfig, volume: VolumeConfig,
                 solver: SolverConfig, params: localizer_mod.LocalizerParams,
                 *, srp_form: str, with_solver: bool = True):
        super().__init__()
        if srp_form not in ("matmul", "gather"):
            raise ValueError(f"srp_form={srp_form!r}")
        if srp_form == "matmul" and params.onehot is None:
            raise ValueError("srp_form='matmul' needs the one-hot matrix")
        self.pipeline = pipeline
        self.volume = volume
        self.solver = solver
        self.srp_form = srp_form
        self.with_solver = with_solver
        for name in localizer_mod.PARAM_NAMES:
            self.register_buffer(name, getattr(params, name))
        if self.window.is_cuda:
            localizer_mod.pin_fp32()

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(),
        volume: VolumeConfig = VolumeConfig(),
        solver: SolverConfig = SolverConfig(),
        *,
        device,
        srp_form: str = "auto",
        with_solver: bool = True,
    ) -> "VolumeLocalizer":
        mic_positions = np.asarray(mic_positions, dtype=np.float32)
        if pipeline.max_shift_samples is None:
            # the lag window covers the array's aperture
            pipeline = dataclasses.replace(
                pipeline, max_shift_samples=geometry.max_lag_for_array(
                    mic_positions, pipeline))
        pairs = geometry.mic_pairs(mic_positions.shape[0])
        lut = geometry.volume_lag_lut(
            volume, mic_positions, pairs, pipeline)  # [P, D, H, W]
        p = lut.shape[0]
        if srp_form == "auto":
            srp_form = srp.auto_srp_form(p, pipeline.num_lags,
                                         volume.num_cells)
        onehot = None
        if srp_form == "matmul":
            # (D*H, W) stand in for the planar grid's (H, W)
            onehot = geometry.lag_onehot(
                lut.reshape(p, volume.depth * volume.height, volume.width),
                pipeline.num_lags)

        def t(a):
            return None if a is None else torch.as_tensor(a, device=device)

        params = localizer_mod.LocalizerParams(
            mic_positions=t(mic_positions), pairs=t(pairs),
            window=t(window_ops.window_for(pipeline)),
            lut_flat=t(lut.reshape(p, -1)), onehot=t(onehot))
        return cls(pipeline, volume, solver, params, srp_form=srp_form,
                   with_solver=with_solver)

    @classmethod
    def from_reference_params(
        cls, arrays: dict, pipeline: PipelineConfig, volume: VolumeConfig,
        solver: SolverConfig, *, device, srp_form: str,
        with_solver: bool = True,
    ) -> "VolumeLocalizer":
        """A localizer from the JAX package's ``LocalizerParams`` of a
        ``VolumeLocalizer`` as numpy arrays (``pipeline`` the reference's,
        already widened)."""
        from ..utils.convert import params_from_reference

        params = localizer_mod.LocalizerParams(
            **params_from_reference(arrays, device))
        return cls(pipeline, volume, solver, params, srp_form=srp_form,
                   with_solver=with_solver)

    @property
    def params(self) -> localizer_mod.LocalizerParams:
        return localizer_mod.LocalizerParams(
            **{n: getattr(self, n) for n in localizer_mod.PARAM_NAMES})

    def forward(self, frames: torch.Tensor) -> dict:
        m = self.mic_positions.shape[0]
        n = self.pipeline.frame_size
        if not isinstance(frames, torch.Tensor):
            raise TypeError("frames must be a torch.Tensor on the "
                            "localizer's device")
        if frames.ndim < 2 or frames.shape[-2] != m or frames.shape[-1] != n:
            raise ValueError(
                f"frames must be [..., {m} mics, {n} samples]; "
                f"got {tuple(frames.shape)}")
        if frames.device != self.window.device:
            raise ValueError(f"frames are on {frames.device}; this localizer "
                             f"lives on {self.window.device}")
        if frames.is_cuda:
            localizer_mod.pin_fp32()
        return localize_frames_volume(
            self.params, frames, cfg=self.pipeline, volume=self.volume,
            solver_cfg=self.solver, srp_form=self.srp_form,
            with_solver=self.with_solver)


def volume_peak_xyz(
    scores: torch.Tensor,          # [..., G3]
    volume: VolumeConfig,
    *,
    refine: bool = True,
) -> torch.Tensor:
    """Volume-grid first-max argmax -> (x, y, z) meters [..., 3], with
    optional per-axis parabolic sub-cell refinement (interior cells only,
    clipped to +-0.5 cell; none on an axis of fewer than 3 cells)."""
    d, h, w = volume.depth, volume.height, volume.width
    flat_idx = scores.argmax(dim=-1)
    iz = torch.div(flat_idx, h * w, rounding_mode="floor")
    iy = torch.div(flat_idx, w, rounding_mode="floor") % h
    ix = flat_idx % w

    def axis_delta(idx, axis_len, stride):
        if axis_len < 3:
            return torch.zeros(idx.shape, dtype=scores.dtype,
                               device=scores.device)
        c = idx.clamp(1, axis_len - 2)
        base = flat_idx + (c - idx) * stride

        def take(i):
            return scores.gather(-1, i[..., None])[..., 0]

        cm, c0, cp = take(base - stride), take(base), take(base + stride)
        den = cm - 2.0 * c0 + cp
        delta = torch.where(den.abs() > 1e-20, 0.5 * (cm - cp) / den,
                            torch.zeros_like(den))
        delta = torch.where((idx >= 1) & (idx <= axis_len - 2), delta,
                            torch.zeros_like(delta))
        return delta.clamp(-0.5, 0.5)

    if refine:
        dz = axis_delta(iz, d, h * w)
        dy = axis_delta(iy, h, w)
        dx = axis_delta(ix, w, 1)
    else:
        dx = dy = dz = torch.zeros(flat_idx.shape, dtype=scores.dtype,
                                   device=scores.device)
    cpm = volume.cells_per_m
    x = (ix.to(scores.dtype) + dx - volume.half_cells_x) / cpm
    y = (volume.half_cells_y - (iy.to(scores.dtype) + dy)) / cpm
    z = volume.z_min_m + (iz.to(scores.dtype) + dz) * volume.z_step_m
    return torch.stack([x, y, z], dim=-1)


def localize_frames_volume(
    params: localizer_mod.LocalizerParams,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    volume: VolumeConfig,
    solver_cfg: SolverConfig,
    srp_form: str,
    with_solver: bool = True,
) -> dict:
    """Volumetric pipeline on frames [..., M, N].  Returns 'tdoa_samples'
    and 'best_shift' [..., P], 'correlograms' [..., P, L] (tapered),
    'scores' [..., G3] (z-major), 'xyz_grid' [..., 3] (the peak, refined
    per axis without the solver), 'peak_value' [..., P], 'xyz' [..., 3]
    (the free 3-D Gauss-Newton solve from the peak, ``iterations`` + 3
    steps, z >= min(z_min_m, 0.05)) and 'rms_m' [...]."""
    k = cfg.max_shift
    lead = frames.shape[:-2]
    flat = localizer_mod._flat_frames(frames, cfg)
    corr = localizer_mod.conditioned_correlograms(flat, params, cfg)
    shifts = xcorr.best_lag(corr, k)
    tdoa_samples, peak_val = xcorr.subsample_peak(corr, k)
    if not cfg.subsample_peak:
        tdoa_samples = shifts.to(corr.dtype)
    corr_t = (xcorr.peak_taper(corr, k, cfg.taper_denom, shifts)
              if cfg.taper_enabled else corr)

    if srp_form == "matmul":
        scores = srp.srp_scores_matmul(corr_t, params.onehot, cfg.srp_dtype)
    else:
        n_pairs = params.pairs.shape[0]
        chunk = cfg.pair_chunk
        if chunk is None and n_pairs > localizer_mod.LARGE_ARRAY_PAIRS:
            chunk = 128
        if chunk is not None and n_pairs > chunk:
            scores = srp.srp_scores_matmul_blocked(
                corr_t, params.lut_flat, cfg.num_lags, chunk,
                dtype=cfg.srp_dtype)
        else:
            scores = srp.srp_scores_gather_batched(
                corr_t, params.lut_flat, GATHER_SLICE_BYTES)

    xyz_grid = volume_peak_xyz(scores, volume, refine=not with_solver)
    out = {
        "tdoa_samples": tdoa_samples,
        "best_shift": shifts,
        "correlograms": corr_t,
        "scores": scores,
        "xyz_grid": xyz_grid,
        "peak_value": peak_val,
    }
    if with_solver:
        xyz, rms = solver_ops.solve_tdoa_xyz(
            tdoa_samples / cfg.sample_rate_hz, params.mic_positions,
            params.pairs, speed_of_sound=cfg.speed_of_sound_mps,
            init_xyz=xyz_grid, iterations=solver_cfg.iterations + 3,
            z_min=min(volume.z_min_m, 0.05))
        out["xyz"] = xyz
        out["rms_m"] = rms
    else:
        out["xyz"] = xyz_grid
        out["rms_m"] = torch.zeros(tdoa_samples.shape[:-1],
                                   dtype=corr_t.dtype, device=corr_t.device)
    return {key: v.reshape(*lead, *v.shape[1:]) for key, v in out.items()}
