"""Multi-array fusion: K mic arrays in one world frame scoring one grid,
clock-synchronised fusion and array registration.

Counterpart of ``audio_triangulation_tpu.models.fusion``.  Frames [..., K,
M, N] fold the array axis into the batch for the raw correlograms
(``localizer.conditioned_correlograms``: the GCC kernel without peaks, row
2 of the kernel table, where the configuration takes it; the large-array
kernel for a frame too large for it); each array scores the world grid
through its own steering matrix and the per-array maps are fused, with
weights, in one product; a joint Gauss-Newton solve over all K * P TDOAs
refines the peak (:class:`ArrayFusionLocalizer`).  ``localize_sync`` adds
the cross-array TDOAs (``xcorr.xcorr_fft`` on a lag window that covers the
world aperture) and solves every event's position with the arrays' clock
offsets, and drifts given event times (``ops.solver.solve_tdoa_sync``).
:func:`register_arrays` recovers each array's pose from events they all
localized (weighted Kabsch).  The world grid is the plane projection: the
sphere of ``GridConfig`` is centred on one array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..core import geometry
from ..core.config import GridConfig, PipelineConfig, SolverConfig
from ..ops import solver as solver_ops
from ..ops import srp, window as window_ops, xcorr
from . import localizer as localizer_mod


@dataclasses.dataclass
class FusionParams:
    """Tensor-valued constants of the fusion pipeline."""

    mic_world: torch.Tensor    # [K, M, 2] world-frame mic positions
    pairs: torch.Tensor        # [P, 2] per-array pair indices
    window: torch.Tensor       # [N]
    onehot: torch.Tensor       # [K, P*L, G] per-array steering matrices
    cat_mics: torch.Tensor     # [K*M, 2] concatenated mics (joint solve)
    cat_pairs: torch.Tensor    # [K*P, 2] pair indices into cat_mics
    cross_pairs: torch.Tensor  # [Pc, 2] cross-array pairs into cat_mics
    mic_array_id: torch.Tensor  # [K*M] array index of each concatenated mic


FUSION_PARAM_NAMES = tuple(f.name for f in dataclasses.fields(FusionParams))


class ArrayFusionLocalizer(nn.Module):
    """Configured multi-array fusion localizer on one device.

    >>> fus = ArrayFusionLocalizer.create([mics_a, mics_b], device="cuda")
    >>> out = fus(frames)            # frames [B, K, M, N]
    >>> out["xy"]                    # [B, 2] world-frame positions
    """

    def __init__(self, pipeline: PipelineConfig, grid: GridConfig,
                 solver: SolverConfig, params: FusionParams, *,
                 with_solver: bool = True, sync_max_shift: int = 0):
        super().__init__()
        self.pipeline = pipeline
        self.grid = grid
        self.solver = solver
        self.with_solver = with_solver
        # the lag window of the cross-array correlograms (world aperture);
        # intra-array scoring keeps pipeline.max_shift
        self.sync_max_shift = sync_max_shift
        for name in FUSION_PARAM_NAMES:
            self.register_buffer(name, getattr(params, name))
        if self.window.is_cuda:
            localizer_mod.pin_fp32()

    @classmethod
    def create(
        cls,
        arrays: Sequence[np.ndarray],
        pipeline: PipelineConfig = PipelineConfig(),
        grid: Optional[GridConfig] = None,
        solver: Optional[SolverConfig] = None,
        *,
        device,
        with_solver: bool = True,
    ) -> "ArrayFusionLocalizer":
        """``arrays``: K mic arrays [M, 2] in world coordinates, all of one
        M.  Grid and solver default to the planar world model."""
        arrays = [np.asarray(a, np.float32) for a in arrays]
        m = arrays[0].shape[0]
        if any(a.shape != (m, 2) for a in arrays):
            raise ValueError(
                "all arrays must share shape [M, 2]; got "
                f"{[a.shape for a in arrays]}")
        if grid is None:
            grid = GridConfig(projection="plane")
        elif grid.projection != "plane":
            raise ValueError(
                "multi-array fusion needs GridConfig(projection='plane'): "
                "the sphere projection is centered on a single array")
        if solver is None:
            solver = SolverConfig(constrain_to_sphere=False)
        elif solver.constrain_to_sphere:
            raise ValueError(
                "multi-array fusion needs "
                "SolverConfig(constrain_to_sphere=False)")

        k = len(arrays)
        pairs = geometry.mic_pairs(m)
        onehots = [geometry.lag_onehot(geometry.lag_lut(grid, a, pairs,
                                                        pipeline),
                                       pipeline.num_lags) for a in arrays]
        cat_mics = np.concatenate(arrays, axis=0)  # [K*M, 2]
        cat_pairs = np.concatenate(
            [pairs + i * m for i in range(k)], axis=0)  # [K*P, 2]
        aid = np.repeat(np.arange(k), m)  # [K*M]
        ii, jj = np.triu_indices(k * m, 1)
        cross = np.stack([ii, jj], axis=-1)[aid[ii] != aid[jj]]

        def t(a):
            return torch.as_tensor(a, device=device)

        params = FusionParams(
            mic_world=t(np.stack(arrays)), pairs=t(pairs),
            window=t(window_ops.window_for(pipeline)),
            onehot=t(np.stack(onehots)), cat_mics=t(cat_mics),
            cat_pairs=t(cat_pairs), cross_pairs=t(cross.astype(np.int32)),
            mic_array_id=t(aid.astype(np.int32)))
        return cls(pipeline, grid, solver, params, with_solver=with_solver,
                   sync_max_shift=geometry.max_lag_for_array(cat_mics,
                                                             pipeline))

    @classmethod
    def from_reference_params(
        cls, arrays: dict, pipeline: PipelineConfig, grid: GridConfig,
        solver: SolverConfig, *, device, with_solver: bool = True,
        sync_max_shift: int,
    ) -> "ArrayFusionLocalizer":
        """A localizer from the JAX package's ``FusionParams`` as numpy
        arrays (``utils.convert.fusion_params_from_reference``) and its
        ``sync_max_shift``."""
        from ..utils.convert import fusion_params_from_reference

        return cls(pipeline, grid, solver, FusionParams(
            **fusion_params_from_reference(arrays, device)),
            with_solver=with_solver, sync_max_shift=sync_max_shift)

    @property
    def params(self) -> FusionParams:
        return FusionParams(**{n: getattr(self, n)
                               for n in FUSION_PARAM_NAMES})

    @property
    def n_arrays(self) -> int:
        return int(self.mic_world.shape[0])

    def _weights(self, weights) -> torch.Tensor:
        k = self.n_arrays
        if weights is None:
            return torch.ones((k,), dtype=torch.float32,
                              device=self.window.device)
        return torch.as_tensor(weights, dtype=torch.float32,
                               device=self.window.device)

    def _check(self, frames, exact_rank: bool) -> None:
        k, m = self.mic_world.shape[:2]
        n = self.pipeline.frame_size
        if not isinstance(frames, torch.Tensor):
            raise TypeError("frames must be a torch.Tensor on the "
                            "localizer's device")
        bad_rank = frames.ndim != 4 if exact_rank else frames.ndim < 3
        if bad_rank or tuple(frames.shape[-3:]) != (k, m, n):
            want = "[E, " if exact_rank else "[..., "
            raise ValueError(
                f"frames must be {want}{k} arrays, {m} mics, {n} samples]; "
                f"got {tuple(frames.shape)}")
        if frames.device != self.window.device:
            raise ValueError(f"frames are on {frames.device}; this localizer "
                             f"lives on {self.window.device}")
        if frames.is_cuda:
            localizer_mod.pin_fp32()

    def forward(self, frames: torch.Tensor, weights=None) -> dict:
        """frames [..., K, M, N]; optional per-array ``weights`` [K] (0 drops
        a faulted array)."""
        self._check(frames, exact_rank=False)
        return fuse_frames(
            self.params, frames, self._weights(weights), cfg=self.pipeline,
            grid_cfg=self.grid, solver_cfg=self.solver,
            with_solver=self.with_solver)

    def localize_sync(self, frames: torch.Tensor, weights=None,
                      event_times_s=None) -> dict:
        """Joint localization and clock synchronisation over an event batch
        frames [E, K, M, N] of K free-running arrays: the intra-array
        outputs plus 'xy_sync' [E, 2], 'clock_offsets_s' [K-1],
        'sync_rms_m' [E] and 'tdoa_cross' [E, Pc], and 'clock_drift' [K-1]
        (seconds a second) when capture times ``event_times_s`` [E] are
        given."""
        self._check(frames, exact_rank=True)
        times = (None if event_times_s is None else torch.as_tensor(
            event_times_s, dtype=torch.float32, device=self.window.device))
        return fuse_frames_sync(
            self.params, frames, self._weights(weights), times,
            cfg=self.pipeline, grid_cfg=self.grid, solver_cfg=self.solver,
            sync_max_shift=self.sync_max_shift)


# ----------------------------------------------------------------------
# Functional pipeline
# ----------------------------------------------------------------------

def fusion_correlograms(params: FusionParams, frames: torch.Tensor,
                        cfg: PipelineConfig):
    """frames [..., K, M, N] -> (tapered correlograms [..., K, P, L], best
    shifts, sub-sample TDOAs [..., K, P], peak-to-sidelobe ratios), the
    array axis riding the batch through the GCC engines."""
    lead = frames.shape[:-2]
    loc_params = localizer_mod.LocalizerParams(
        mic_positions=params.cat_mics, pairs=params.pairs,
        window=params.window, lut_flat=None, onehot=None)
    flat = localizer_mod._flat_frames(frames, cfg)
    corr = localizer_mod.conditioned_correlograms(flat, loc_params, cfg)
    corr = corr.reshape(*lead, *corr.shape[1:])
    kk = cfg.max_shift
    shifts = xcorr.best_lag(corr, kk)
    tdoa, _ = xcorr.subsample_peak(corr, kk)
    if not cfg.subsample_peak:
        tdoa = shifts.to(corr.dtype)
    psr = xcorr.peak_confidence(corr, kk)
    corr_t = (xcorr.peak_taper(corr, kk, cfg.taper_denom, shifts)
              if cfg.taper_enabled else corr)
    return corr_t, shifts, tdoa, psr


def fused_scores(corr_t: torch.Tensor, onehot: torch.Tensor,
                 weights: torch.Tensor, dtype: str = "float32"
                 ) -> torch.Tensor:
    """Weighted sum of the per-array SRP maps in one product: corr_t [...,
    K, P, L] x onehot [K, P*L, G] -> [..., G]; 'bfloat16' rounds the
    weighted correlograms and sums in f32."""
    *lead, k, p, l = corr_t.shape
    flat = corr_t.reshape(*lead, k, p * l) * weights[:, None]
    if dtype == "bfloat16":
        flat = flat.to(torch.bfloat16).float()
    return torch.matmul(flat.reshape(*lead, k * p * l),
                        onehot.reshape(k * p * l, -1))


def fuse_frames(
    params: FusionParams,
    frames: torch.Tensor,
    weights: torch.Tensor,
    *,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    with_solver: bool = True,
) -> dict:
    """Fusion pipeline on frames [..., K, M, N]: 'tdoa_samples' and
    'best_shift' [..., K, P], 'scores' [..., G] (fused), 'xy_grid' [..., 2],
    'confidence' [..., K] (each array's weakest-pair PSR), and 'xy' [...,
    2], 'rms_m' [...] and 'xy_cov' [..., 2, 2] of the joint solve (the grid
    peak without the solver)."""
    corr_t, shifts, tdoa, psr = fusion_correlograms(params, frames, cfg)
    scores = fused_scores(corr_t, params.onehot, weights, cfg.srp_dtype)
    refine = (grid_cfg.refine_peak == "on"
              or (grid_cfg.refine_peak == "auto" and not with_solver))
    xy_grid = srp.grid_peak_xy(
        scores, (grid_cfg.height, grid_cfg.width),
        (grid_cfg.half_cells_x, grid_cfg.half_cells_y),
        grid_cfg.cells_per_m, refine=refine)
    out = {
        "tdoa_samples": tdoa,
        "best_shift": shifts,
        "scores": scores,
        "xy_grid": xy_grid,
        "confidence": psr.amin(dim=-1),
    }
    if with_solver:
        *lead, k, p = tdoa.shape
        tdoa_s = tdoa.reshape(-1, k * p) / cfg.sample_rate_hz
        xy, rms = solver_ops.solve_tdoa_batched(
            tdoa_s, params.cat_mics, params.cat_pairs,
            speed_of_sound=cfg.speed_of_sound_mps, height=grid_cfg.height_m,
            init_xy=xy_grid.reshape(-1, 2),
            weights=weights.repeat_interleave(p), cfg=solver_cfg)
        cov = solver_ops.solution_covariance(
            xy, rms, params.cat_mics, params.cat_pairs,
            height=grid_cfg.height_m, cfg=solver_cfg)
        out["xy"] = xy.reshape(*lead, 2)
        out["rms_m"] = rms.reshape(lead)
        out["xy_cov"] = cov.reshape(*lead, 2, 2)
    else:
        out["xy"] = xy_grid
        out["rms_m"] = torch.zeros(tdoa.shape[:-2], dtype=corr_t.dtype,
                                   device=corr_t.device)
    return out


def cross_array_tdoas(
    params: FusionParams,
    frames: torch.Tensor,
    cfg: PipelineConfig,
    sync_max_shift: int,
) -> torch.Tensor:
    """Sub-sample TDOAs [..., Pc] of the cross-array pairs, on the FFT
    engine with their own lag window ``sync_max_shift``: no window (the
    transient sits far off-centre in one frame of a long-baseline pair, and
    the taper would bias its peak) and linear padding sized from that
    window (a pinned ``fft_size`` or circular padding would alias the
    hundreds-of-samples delays)."""
    *lead, k, m, n = frames.shape
    flat = frames.reshape(*lead, k * m, n)
    cfg_sync = dataclasses.replace(
        cfg, max_shift_samples=sync_max_shift, window_enabled=False,
        fft_size=None, fft_pad_mode="linear")
    cond = localizer_mod.condition_frames(flat, params.window, cfg_sync)
    corr = xcorr.xcorr_fft(cond, params.cross_pairs, cfg_sync)
    tdoa, _ = xcorr.subsample_peak(corr, sync_max_shift)
    if not cfg.subsample_peak:
        tdoa = xcorr.best_lag(corr, sync_max_shift).to(corr.dtype)
    return tdoa


def fuse_frames_sync(
    params: FusionParams,
    frames: torch.Tensor,
    weights: torch.Tensor,
    event_times_s: torch.Tensor | None = None,
    *,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    sync_max_shift: int,
) -> dict:
    """Fusion of unsynchronised arrays, frames [E, K, M, N]: the intra-array
    pipeline (offset-free: a pair inside one array shares its clock) seeds
    the joint solve of every event's position and the K-1 offsets (and
    drifts with ``event_times_s``) over the intra and cross pairs; a cross
    pair weighs the geometric mean of its arrays' weights."""
    out = fuse_frames(params, frames, weights, cfg=cfg, grid_cfg=grid_cfg,
                      solver_cfg=solver_cfg, with_solver=True)
    tdoa_cross = cross_array_tdoas(params, frames, cfg, sync_max_shift)
    out["tdoa_cross"] = tdoa_cross

    e, k, p = out["tdoa_samples"].shape
    fs = cfg.sample_rate_hz
    tdoa_all = torch.cat([out["tdoa_samples"].reshape(e, k * p) / fs,
                          tdoa_cross / fs], dim=-1)  # [E, KP + Pc]
    pairs_all = torch.cat([params.cat_pairs, params.cross_pairs], dim=0)
    aid = params.mic_array_id.long()
    cross = params.cross_pairs.long()
    w_intra = weights.repeat_interleave(p)
    w_cross = torch.sqrt(weights[aid[cross[:, 0]]] * weights[aid[cross[:, 1]]])
    res = solver_ops.solve_tdoa_sync(
        tdoa_all, params.cat_mics, pairs_all, params.mic_array_id,
        int(params.mic_world.shape[0]),
        speed_of_sound=cfg.speed_of_sound_mps, height=grid_cfg.height_m,
        init_xy=out["xy"], weights=torch.cat([w_intra, w_cross]),
        event_times_s=event_times_s, iterations=solver_cfg.iterations + 4,
        damping=solver_cfg.damping)
    if event_times_s is None:
        xy_sync, offsets, rms = res
    else:
        xy_sync, offsets, drift, rms = res
        out["clock_drift"] = drift
    out["xy_sync"] = xy_sync
    out["clock_offsets_s"] = offsets
    out["sync_rms_m"] = rms
    return out


# ----------------------------------------------------------------------
# Inter-array registration
# ----------------------------------------------------------------------

def register_arrays(local_xy, *, anchor: int = 0, weights=None) -> dict:
    """Rigid poses of K arrays from E events each localized in its own
    frame: local_xy [K, E, d] (d = 2 or 3), optional weights [K, E] (0
    drops an event for an array; event e counts for array k with weight
    w[k, e] w[anchor, e]).  Weighted Kabsch, one d x d SVD an array, the
    determinant's sign fixed so that each 'rot' [K, d, d] is a proper
    rotation; world = rot @ local + 'trans' [K, d]; 'rms' [K] is the fit's
    residual against the anchor's fixes.  Runs on ``local_xy``'s device
    (a numpy input runs on the CPU)."""
    local_xy = torch.as_tensor(local_xy, dtype=torch.float32)
    k, e, d = local_xy.shape
    dev = local_xy.device
    if weights is None:
        weights = torch.ones((k, e), dtype=torch.float32, device=dev)
    weights = torch.as_tensor(weights, dtype=torch.float32, device=dev)
    w = weights * weights[anchor][None, :]          # [K, E]
    wn = w / w.sum(dim=1, keepdim=True).clamp_min(1e-12)

    b = local_xy[anchor]                            # [E, d] target frame
    a_bar = torch.einsum("ke,ked->kd", wn, local_xy)
    b_bar = torch.einsum("ke,ed->kd", wn, b)
    a_c = local_xy - a_bar[:, None, :]
    b_c = b[None] - b_bar[:, None, :]
    h = torch.einsum("ke,ked,kef->kdf", wn, a_c, b_c)  # [K, d, d]
    u, _, vt = torch.linalg.svd(h)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, ut))
    signs = torch.cat([torch.ones((k, d - 1), dtype=torch.float32,
                                  device=dev), det[:, None]], dim=1)
    rot = torch.matmul(v * signs[:, None, :], ut)
    trans = b_bar - torch.einsum("kij,kj->ki", rot, a_bar)
    fit = torch.einsum("kij,kej->kei", rot, local_xy) + trans[:, None, :]
    rms = torch.sqrt(torch.einsum("ke,ke->k", wn,
                                  ((fit - b[None]) ** 2).sum(dim=-1)))
    return {"rot": rot, "trans": trans, "rms": rms}


def registered_arrays(local_arrays: Sequence[np.ndarray],
                      reg: dict) -> list[np.ndarray]:
    """Each array's local mic coordinates through its :func:`register_arrays`
    pose: world-frame arrays for :meth:`ArrayFusionLocalizer.create`."""
    rot = np.asarray(torch.as_tensor(reg["rot"]).cpu())
    trans = np.asarray(torch.as_tensor(reg["trans"]).cpu())
    return [np.asarray(a, np.float32) @ rot[i].T + trans[i]
            for i, a in enumerate(local_arrays)]
