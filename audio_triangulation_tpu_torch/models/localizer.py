"""Frame-batch localizer: raw multi-mic frames -> TDOAs -> source positions.

    frames [B, M, N] -> condition -> window -> GCC(-PHAT) -> peaks + taper
      -> SRP grid scores -> grid peak -> Gauss-Newton refine -> xy [B, 2]

Counterpart of ``audio_triangulation_tpu.models.localizer`` (``Localizer``
and ``localize_frames``).  Hand-written CUDA kernels carry the path on a
GPU: ``ops/cuda/gcc_kernel`` (conditioning through per-pair peaks, in its
base mode, its spectral-stats mode or its in-kernel SRP mode),
``ops/cuda/gcc_large`` (cross-power and lag synthesis of every pair of a
large array) and ``ops/cuda/gn_kernel`` (the Gauss-Newton solve and the
position covariance in one launch).  On a CPU tensor each wrapper runs its
plain PyTorch version.  SRP scoring outside
the kernel, the grid peak and the unfused correlation engines are plain
torch, as they were plain XLA in the reference.

Routing follows the reference's with its kernels switched on
(``fused_kernel='on'``), on every device.  Up to ``LARGE_ARRAY_PAIRS``
pairs, :func:`kernel_route` says when the GCC kernel serves a configuration
(in its stats mode for ``band_hz='auto'`` or a phase/hybrid sub-sample),
with in-kernel peaks when taper and sub-sample are both on, else plain
peak ops after it; ``fused_srp='on'`` adds SRP scoring and the grid argmax
to that kernel under :func:`in_kernel_srp`'s conditions.  Past that pair
count :func:`large_route` says when the large-array kernel serves it, again
with in-kernel peaks when taper and sub-sample are both on; that kernel
also takes a frame too large for the GCC kernel's shared memory
(:func:`gcc_routes`, asked from the shape).
Configurations neither kernel takes run the unfused engines
(:func:`correlate_frames`, a chunk of pairs at a time under ``pair_chunk``
or past ``LARGE_ARRAY_PAIRS``), then the plain peak ops and, for
phase/hybrid, the reference's unfused phase-slope branch.  Scoring takes
the reference's branches: the one-hot product, and for a large array in
gather form one product against ``onehot_big`` (built when it fits
``srp_big_matmul_budget_bytes``) or the pair-blocked product.  The GN
kernel solves, and writes the covariance, for a coplanar array (every mic
at z = 0) of at most 11 mics (64 pairs) with ``robust='none'``, decided
once when the localizer is built (``Localizer.gn``); else the batched
solver and ``solution_covariance`` do, as the reference's CPU route does
(its TPU route would solve a non-coplanar array as if it were planar).
The TPU dispatch knobs ``fused_kernel``, ``fused_tile_b``
and ``fused_sub_tiles`` are accepted and change nothing; both
``dft_precision`` values compute in exact fp32.

``Localizer.localize_multi`` resolves simultaneous sources of a planar
array from raw correlograms (:func:`conditioned_correlograms`: the GCC
kernel without peaks, or the large-array kernel, or the unfused engines),
and ``Localizer.localize_moving`` adds the delay-Doppler velocity
(``ops.caf``) to the pipeline's position.

:func:`localize_stream` runs a whole raw [M, T] stream on the device:
every trigger of the variance detector, the frame ending at each, and the
localizer on that batch.  :func:`localize_frames_int` is the firmware's
fixed-point event burst in torch integers, bit-exact against
``utils.golden``; like the reference's, it is plain tensor ops (no kernel).
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Optional

import numpy as np
import torch
from torch import nn

from ..core import geometry
from ..core.config import GridConfig, PipelineConfig, SolverConfig
from ..ops import caf, conditioning, detector, multisource, mxu_fft, srp
from ..ops import solver as solver_ops, window as window_ops, xcorr
from ..ops._device import device_constant
from ..ops.cuda import gcc_kernel, gcc_large, gn_kernel

SAVE_FORMAT = "audio_triangulation_tpu.Localizer/1"
# more pairs than this take the large-array routes (the reference's rule for
# its pair-blocked engine, scoring and steering matrix)
LARGE_ARRAY_PAIRS = 256


@dataclasses.dataclass
class LocalizerParams:
    """Tensor-valued constants of the pipeline."""

    mic_positions: torch.Tensor  # [M, 2] float32
    pairs: torch.Tensor  # [P, 2] int32
    window: torch.Tensor  # [N] float32
    lut_flat: torch.Tensor  # [P, G] int32 lag indices
    onehot: Optional[torch.Tensor]  # [P*L, G] float32 (matmul form) or None
    score_bias: Optional[torch.Tensor] = None  # [G] additive, or None
    # [P*L', G] float32 steering matrix of a large array in gather form,
    # when it fits the budget (L' >= L: the reference pads its lag axis)
    onehot_big: Optional[torch.Tensor] = None


PARAM_NAMES = tuple(f.name for f in dataclasses.fields(LocalizerParams))


def kernel_route(cfg: PipelineConfig) -> bool:
    """Whether the GCC kernel serves ``cfg``: the reference's fused-kernel
    conditions (``_fused_tile``) without its TPU-only batch and VMEM rules.
    The kernel takes the matmul engine with shift8/none normalisation and
    none/PHAT weighting at beta 1, and its stats mode the full band of an
    even-length DFT."""
    if cfg.xcorr_mode != "mxu":
        return False
    if cfg.normalize_mode not in ("shift8", "none"):
        return False
    if cfg.effective_weighting in ("scot", "roth", "ml"):
        return False
    if gcc_kernel.needs_stats(cfg) and (cfg.band_crop
                                        or cfg.fft_length % 2 != 0):
        return False
    return not (cfg.phat and cfg.phat_beta != 1.0)


def large_route(cfg: PipelineConfig, n_pairs: int) -> bool:
    """Whether the large-array GCC kernel serves ``cfg``: the reference's
    ``_use_gcc_large`` conditions without its backend and precision rules
    (the port computes in exact fp32 either way)."""
    return (n_pairs > LARGE_ARRAY_PAIRS and cfg.xcorr_mode == "mxu"
            and cfg.effective_weighting in ("none", "phat"))


def in_kernel_srp(cfg: PipelineConfig, srp_form: str, refine: bool,
                  has_bias: bool) -> bool:
    """Whether ``fused_srp='on'`` puts scoring and the grid argmax into the
    GCC kernel: the reference's conditions (bf16 one-hot scoring of a plain
    grid argmax, base mode only) on a configuration that already takes the
    kernel with its peaks.  The kernel's own size limit is asked at the
    call (``gcc_kernel.srp_mode_fits``)."""
    return (cfg.fused_srp == "on" and not gcc_kernel.needs_stats(cfg)
            and srp_form == "matmul" and cfg.srp_dtype == "bfloat16"
            and not has_bias and not refine)


def gn_route(mic_positions: np.ndarray, pairs: np.ndarray,
             pipeline: PipelineConfig, grid: GridConfig,
             solver: SolverConfig) -> Optional[gn_kernel.GnSolver]:
    """The GN kernel bound to this array and configuration when it takes
    them (``gn_kernel.refusal``), else None: the batched solver.  Decided
    once, from host copies of the array, when a localizer is built."""
    if gn_kernel.refusal(mic_positions, pairs, solver) is not None:
        return None
    return gn_kernel.GnSolver(
        mic_positions[:, :2], c=pipeline.speed_of_sound_mps, h=grid.height_m,
        iters=solver.iterations, damping=solver.damping,
        sphere=solver.constrain_to_sphere)


def pin_fp32() -> None:
    """Turn TF32 off: PHAT whitening and the GN solve need full fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Localizer(nn.Module):
    """Configured frame-batch localizer on one device.

    >>> loc = Localizer.create(mic_positions, device="cuda")
    >>> out = loc(frames)           # frames [B, M, N] on the same device
    >>> out["xy"]                   # [B, 2] source positions (meters)
    """

    def __init__(self, pipeline: PipelineConfig, grid: GridConfig,
                 solver: SolverConfig, params: LocalizerParams, *,
                 srp_form: str, with_solver: bool = True,
                 with_heatmap: bool = False):
        super().__init__()
        if srp_form not in ("matmul", "gather"):
            raise ValueError(f"srp_form={srp_form!r}")
        if srp_form == "matmul" and params.onehot is None:
            raise ValueError("srp_form='matmul' needs the one-hot matrix")
        if params.onehot is not None and pipeline.srp_dtype == "bfloat16":
            # srp_scores_matmul takes the one-hot as is: round it once
            params = dataclasses.replace(
                params, onehot=params.onehot.to(torch.bfloat16).float())
        self.pipeline = pipeline
        self.grid = grid
        self.solver = solver
        self.srp_form = srp_form
        self.with_solver = with_solver
        self.with_heatmap = with_heatmap
        for name in PARAM_NAMES:
            self.register_buffer(name, getattr(params, name))
        # the GN kernel bound to this array, or None: the batched solver
        # (also on the meta device, which holds no coordinates to decide on)
        self.gn = None if params.mic_positions.is_meta else gn_route(
            params.mic_positions.cpu().numpy(), params.pairs.cpu().numpy(),
            pipeline, grid, solver)
        if self.window.is_cuda:
            pin_fp32()

    # ------------------------------------------------------------------
    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(),
        grid: GridConfig = GridConfig(),
        solver: SolverConfig = SolverConfig(),
        *,
        device,
        srp_form: str = "auto",
        with_solver: bool = True,
        with_heatmap: bool = False,
        init_grid_stride: int = 1,
    ) -> "Localizer":
        """Build the localizer's constants on ``device``.

        ``init_grid_stride`` > 1 coarsens the SRP grid by that factor: the
        solver only needs an init inside the right basin, so the refined
        ``xy`` is unchanged while scoring shrinks ~stride^2-fold.  It needs
        ``with_solver`` and no heatmap (grid outputs would be coarse)."""
        if init_grid_stride > 1:
            if with_heatmap or not with_solver:
                raise ValueError(
                    "init_grid_stride > 1 needs with_solver=True and "
                    "with_heatmap=False (grid outputs would be coarse)")
            s = init_grid_stride
            grid = dataclasses.replace(
                grid, half_cells_x=grid.half_cells_x // s,
                half_cells_y=grid.half_cells_y // s,
                cells_per_m=grid.cells_per_m / s)
        mic_positions = np.asarray(mic_positions, dtype=np.float32)
        pairs = geometry.mic_pairs(mic_positions.shape[0])
        lut = geometry.lag_lut(grid, mic_positions, pairs, pipeline)
        if srp_form == "auto":
            srp_form = srp.auto_srp_form(
                pairs.shape[0], pipeline.num_lags, grid.num_cells)
        onehot = None
        if srp_form == "matmul":
            onehot = geometry.lag_onehot(lut, pipeline.num_lags)

        def t(a):
            return None if a is None else torch.as_tensor(a, device=device)

        lut_flat = t(lut.reshape(lut.shape[0], -1))
        onehot_big = None
        if (srp_form != "matmul" and pairs.shape[0] > LARGE_ARRAY_PAIRS
                and pipeline.srp_big_matmul_budget_bytes > 0):
            # the reference's rule, on its padded bf16/f32 size, so both
            # packages take the same scoring branch
            itemsize = 2 if pipeline.srp_dtype == "bfloat16" else 4
            if (pairs.shape[0] * srp.sublane_pad_lags(pipeline.num_lags)
                    * grid.num_cells * itemsize
                    <= pipeline.srp_big_matmul_budget_bytes):
                onehot_big = srp.big_onehot_device(
                    lut_flat, pipeline.num_lags, pipeline.srp_dtype)
        params = LocalizerParams(
            mic_positions=t(mic_positions), pairs=t(pairs),
            window=t(window_ops.window_for(pipeline)),
            lut_flat=lut_flat, onehot=t(onehot), onehot_big=onehot_big)
        return cls(pipeline, grid, solver, params, srp_form=srp_form,
                   with_solver=with_solver, with_heatmap=with_heatmap)

    @classmethod
    def from_reference_params(
        cls, arrays: dict, pipeline: PipelineConfig, grid: GridConfig,
        solver: SolverConfig, *, device, srp_form: str,
        with_solver: bool = True, with_heatmap: bool = False,
    ) -> "Localizer":
        """A localizer from the JAX package's ``LocalizerParams`` given as
        numpy arrays (``grid`` is the possibly stride-coarsened grid the
        reference stores)."""
        from ..utils.convert import params_from_reference

        params = LocalizerParams(**params_from_reference(arrays, device))
        return cls(pipeline, grid, solver, params, srp_form=srp_form,
                   with_solver=with_solver, with_heatmap=with_heatmap)

    @property
    def params(self) -> LocalizerParams:
        return LocalizerParams(**{n: getattr(self, n) for n in PARAM_NAMES})

    # ------------------------------------------------------------------
    def _check_frames(self, frames) -> None:
        m = self.mic_positions.shape[0]
        n = self.pipeline.frame_size
        if not isinstance(frames, torch.Tensor):
            raise TypeError("frames must be a torch.Tensor on the "
                            "localizer's device")
        if frames.ndim < 2 or frames.shape[-2] != m or frames.shape[-1] != n:
            raise ValueError(f"frames must be [..., {m} mics, {n} samples]; "
                             f"got {tuple(frames.shape)}")
        if frames.device != self.window.device:
            raise ValueError(f"frames are on {frames.device}; this localizer "
                             f"lives on {self.window.device}")
        if frames.is_cuda:
            pin_fp32()

    def forward(self, frames: torch.Tensor) -> dict:
        self._check_frames(frames)
        return localize_frames(
            self.params, frames, cfg=self.pipeline, grid_cfg=self.grid,
            solver_cfg=self.solver, srp_form=self.srp_form,
            with_solver=self.with_solver, with_heatmap=self.with_heatmap,
            gn=self.gn)

    def localize_multi(self, frames: torch.Tensor, n_sources: int = 2, *,
                       min_separation_m: float = 0.4,
                       assoc_window_samples: float = 3.0) -> dict:
        """Up to ``n_sources`` simultaneous sources per frame of a planar
        array (see :func:`localize_frames_multi` for the outputs: 'xy' is
        [..., n_sources, 2], strongest first, and 'source_score' ranks the
        slots)."""
        self._check_frames(frames)
        return localize_frames_multi(
            self.params, frames, cfg=self.pipeline, grid_cfg=self.grid,
            solver_cfg=self.solver, srp_form=self.srp_form,
            n_sources=n_sources, min_separation_m=float(min_separation_m),
            assoc_window_samples=float(assoc_window_samples))

    def localize_moving(self, frames: torch.Tensor, *, v_max: float = 8.0,
                        n_scales: int = 33) -> dict:
        """Position and instantaneous velocity of moving sources: the
        pipeline's outputs, and from the delay-Doppler CAF (``ops.caf``) on
        the same frames 'velocity' ([..., 2] m/s, in the plane, for a
        coplanar array, else [..., 3]), 'pair_rel_speed' and 'alpha'
        [..., P], and 'tdoa_doppler' [..., P] (the best-scale TDOAs).  The
        resampling operator is built on the localizer's device once per
        (v_max, n_scales)."""
        if not self.with_solver:
            raise ValueError("localize_moving needs with_solver=True "
                             "(the velocity model linearizes at the "
                             "refined position)")
        out = dict(self(frames))
        resample, mic3, coplanar = self._moving_operator(float(v_max),
                                                         int(n_scales))
        dd = caf.estimate_delay_doppler(
            frames, self.window, self.pairs, self.pipeline, v_max=v_max,
            n_scales=n_scales, resample=resample)
        xy = out["xy"]
        pos3 = torch.cat([xy, torch.full_like(xy[..., :1],
                                              self.grid.height_m)], dim=-1)
        out.update({
            "velocity": caf.solve_velocity(
                pos3, dd["pair_rel_speed"], mic3, self.pairs,
                in_plane=coplanar),
            "pair_rel_speed": dd["pair_rel_speed"],
            "alpha": dd["alpha"],
            "tdoa_doppler": dd["tdoa_samples"]})
        return out

    def _moving_operator(self, v_max: float, n_scales: int):
        """(resampling operator, mics [M, 3], coplanar) for
        :meth:`localize_moving`, built once per (v_max, n_scales)."""
        cache = self.__dict__.setdefault("_moving_cache", {})
        key = (v_max, n_scales)
        if key not in cache:
            mics = self.mic_positions.cpu().numpy()
            mic3 = np.zeros((mics.shape[0], 3), np.float32)
            mic3[:, :mics.shape[1]] = mics
            cfg = self.pipeline
            cache[key] = (
                caf.precompute_resample(
                    cfg.frame_size, v_max, n_scales, cfg.speed_of_sound_mps,
                    cfg=cfg, device=self.window.device),
                torch.as_tensor(mic3, device=self.window.device),
                bool(np.ptp(mic3[:, 2]) < 1e-6))
        return cache[key]

    def extract(self, frames: torch.Tensor, xy=None, *, method: str = "das",
                **kwargs) -> torch.Tensor:
        """Beamformed source audio [..., N] at position(s) ``xy`` (localized
        from ``frames`` when omitted): delay-and-sum ('das') or adaptive
        MVDR ('mvdr'; ``kwargs`` go to ``ops.beamform.extract_mvdr``).  It
        steers at the solver's own 3-D lift (its height and
        ``constrain_to_sphere``), as the reference does."""
        from ..ops import beamform

        fn = {"das": beamform.extract_das,
              "mvdr": beamform.extract_mvdr}[method]
        if xy is None:
            xy = self(frames)["xy"]
        elif (not isinstance(frames, torch.Tensor)
              or frames.device != self.window.device):
            raise ValueError("frames must be a torch.Tensor on the "
                             f"localizer's device ({self.window.device})")
        delays = beamform.source_delays(
            torch.as_tensor(xy, dtype=torch.float32, device=frames.device),
            self.mic_positions, self.pipeline, height=self.grid.height_m,
            constrain_sphere=self.solver.constrain_to_sphere)
        return fn(frames, delays, self.pipeline, **kwargs)

    def save(self, path: str) -> str:
        """Write the exact configuration as JSON (the same format the JAX
        package writes; every tensor is derived from it)."""
        blob = {
            "format": SAVE_FORMAT,
            "pipeline": dataclasses.asdict(self.pipeline),
            "grid": dataclasses.asdict(self.grid),
            "solver": dataclasses.asdict(self.solver),
            "srp_form": self.srp_form,
            "with_solver": self.with_solver,
            "with_heatmap": self.with_heatmap,
            "mic_positions": self.mic_positions.cpu().numpy().tolist(),
        }
        if not path.endswith(".json"):
            path = path + ".json"
        with open(path, "w") as f:
            json.dump(blob, f, indent=1)
        return path

    @classmethod
    def load(cls, path: str, *, device) -> "Localizer":
        """Rebuild a localizer saved by :meth:`save` (or by the JAX
        package's ``Localizer.save``).  The stored grid already reflects
        any ``init_grid_stride``, so it is used as it is."""
        if not path.endswith(".json"):
            path = path + ".json"
        with open(path) as f:
            blob = json.load(f)
        fmt = blob.get("format", "")
        if not fmt.startswith("audio_triangulation_tpu.Localizer/"):
            raise ValueError(f"not a saved Localizer: {path} ({fmt!r})")

        def detuple(d):  # JSON turns tuples (band_hz) into lists
            return {k: tuple(v) if isinstance(v, list) else v
                    for k, v in d.items()}

        return cls.create(
            np.asarray(blob["mic_positions"], np.float32),
            PipelineConfig(**detuple(blob["pipeline"])),
            GridConfig(**detuple(blob["grid"])),
            SolverConfig(**detuple(blob["solver"])),
            device=device, srp_form=blob["srp_form"],
            with_solver=blob["with_solver"],
            with_heatmap=blob["with_heatmap"])


# ----------------------------------------------------------------------
# Functional pipeline
# ----------------------------------------------------------------------

def condition_frames(frames: torch.Tensor, window: torch.Tensor,
                     cfg: PipelineConfig) -> torch.Tensor:
    """DC removal -> gain -> window (float)."""
    x = frames.to(window.dtype)
    if cfg.nan_guard:
        x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    x = conditioning.dc_remove(x)
    x = conditioning.normalize(x, cfg.normalize_mode)
    if cfg.window_enabled:
        x = window_ops.apply_window(x, window)
    return x


def correlate_frames(frames: torch.Tensor, params: LocalizerParams,
                     cfg: PipelineConfig) -> torch.Tensor:
    """Conditioned frames [..., M, N] -> correlograms [..., P, L] through
    the unfused engine ``cfg`` selects, as the reference routes it."""
    if cfg.effective_weighting in ("scot", "roth", "ml"):
        return xcorr.xcorr_fft(frames, params.pairs, cfg)
    if cfg.band_auto and cfg.xcorr_mode != "mxu":
        return xcorr.xcorr_fft(frames, params.pairs, cfg)
    if cfg.xcorr_mode == "mxu":
        n_pairs = params.pairs.shape[0]
        chunk = _pair_chunk(cfg, n_pairs)
        if chunk is not None and n_pairs > chunk:
            return mxu_fft.xcorr_mxu_pairblocked(
                frames, params.pairs, cfg, matmul_dtype=cfg.matmul_dtype,
                pair_chunk=chunk)
        return mxu_fft.xcorr_mxu(frames, params.pairs, cfg,
                                 matmul_dtype=cfg.matmul_dtype)
    if cfg.xcorr_mode == "fft":
        return xcorr.xcorr_fft(frames, params.pairs, cfg)
    if cfg.xcorr_mode == "time":
        return xcorr.xcorr_time(frames, params.pairs, cfg.max_shift)
    raise ValueError(f"unknown xcorr mode {cfg.xcorr_mode}")


def _pair_chunk(cfg: PipelineConfig, n_pairs: int):
    """``cfg.pair_chunk``, or 128 for a large array that names none."""
    if cfg.pair_chunk is None and n_pairs > LARGE_ARRAY_PAIRS:
        return 128
    return cfg.pair_chunk


def _phase_subsample(frames, params: LocalizerParams, cfg: PipelineConfig,
                     shifts, tdoa_par):
    """The reference's unfused phase/hybrid sub-sample branch, as written
    there: its hybrid gate averages coherence over the bins of the band
    mask, or over all bins, Nyquist included, without one."""
    cond = condition_frames(frames, params.window, cfg)
    spectra = xcorr.rfft_frames(cond, cfg.fft_length)
    wm = xcorr.band_mask(cfg)
    if wm is None and cfg.band_auto:
        wm = xcorr.auto_band_weight(spectra, params.pairs, cfg)[..., None, :]
    tdoa_phase = xcorr.tdoa_phase_slope(
        spectra, params.pairs, shifts, fft_length=cfg.fft_length,
        half_width=cfg.coherence_bins, eps=cfg.phat_eps, weight_mask=wm)
    if cfg.subsample_method != "hybrid":
        return tdoa_phase
    _, _, _, g2 = xcorr.smoothed_cross_stats(
        spectra, params.pairs, cfg.coherence_bins, eps=cfg.phat_eps)
    w_bins = (torch.ones_like(g2) if wm is None else torch.broadcast_to(
        torch.as_tensor(wm, dtype=g2.dtype, device=g2.device), g2.shape))
    coh = (g2 * w_bins).sum(dim=-1) / w_bins.sum(dim=-1).clamp_min(1e-12)
    return torch.where(coh >= cfg.hybrid_coherence_min, tdoa_phase,
                       tdoa_par)


def _flat_frames(frames: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """frames [..., M, N] as float32 [B, M, N], non-finite samples zeroed
    under ``cfg.nan_guard``."""
    m, n = frames.shape[-2:]
    flat = frames.reshape(-1, m, n).float()
    if cfg.nan_guard:
        flat = torch.nan_to_num(flat, nan=0.0, posinf=0.0, neginf=0.0)
    return flat


def gcc_routes(flat: torch.Tensor, cfg: PipelineConfig, n_pairs: int,
               with_peaks: bool) -> tuple[bool, bool]:
    """(on the GCC kernel, on the large-array kernel) for frames [B, M, N]
    (as :func:`_flat_frames` gives them): the GCC kernel where
    :func:`kernel_route` holds and a frame fits it
    (``gcc_kernel.fits``, asked from the shape); the large-array kernel
    where :func:`large_route` holds, and in the GCC kernel's place for a
    frame too large for its shared memory; neither: the unfused engines."""
    on_kernel = n_pairs <= LARGE_ARRAY_PAIRS and kernel_route(cfg)
    if on_kernel and not gcc_kernel.fits(flat, cfg, n_pairs, with_peaks):
        return False, True
    return on_kernel, large_route(cfg, n_pairs)


def conditioned_correlograms(flat: torch.Tensor, params: LocalizerParams,
                             cfg: PipelineConfig) -> torch.Tensor:
    """Raw frames [B, M, N] (as :func:`_flat_frames` gives them) -> raw,
    untapered correlograms [B, P, L]: the GCC kernel without peaks, the
    large-array kernel or the unfused engines, as :func:`gcc_routes`
    says."""
    on_kernel, on_large = gcc_routes(flat, cfg, params.pairs.shape[0],
                                     with_peaks=False)
    if on_kernel:
        return gcc_kernel.fused_gcc(flat, params.window, params.pairs, cfg,
                                    with_peaks=False)
    x = condition_frames(flat, params.window, cfg)
    if on_large:
        return gcc_large.xcorr_large(x, params.pairs, cfg)
    return correlate_frames(x, params, cfg)


def _srp_scores(corr_t, params: LocalizerParams, cfg: PipelineConfig,
                srp_form: str, p_n: int) -> torch.Tensor:
    """SRP scores [..., G] of tapered correlograms, by the reference's
    branches: the one-hot product, or for a large array in gather form one
    product against ``onehot_big``, the pair-blocked product, or the
    gather."""
    if srp_form == "matmul":
        return srp.srp_scores_matmul(corr_t, params.onehot, cfg.srp_dtype)
    if params.onehot_big is not None:
        return srp.srp_scores_matmul_big(corr_t, params.onehot_big,
                                         dtype=cfg.srp_dtype)
    chunk = _pair_chunk(cfg, p_n)
    if chunk is not None and p_n > chunk:
        return srp.srp_scores_matmul_blocked(
            corr_t, params.lut_flat, cfg.num_lags, chunk, dtype=cfg.srp_dtype)
    return srp.srp_scores_gather(corr_t, params.lut_flat)


def gcc_peaks(flat: torch.Tensor, params: LocalizerParams,
              cfg: PipelineConfig):
    """Raw frames [B, M, N] (as :func:`_flat_frames` gives them) ->
    (tapered correlograms [B, P, L], best shifts [B, P], sub-sample TDOAs
    [B, P] in lags, raw peak values [B, P], peak-to-sidelobe ratios
    [B, P]): the GCC kernel or the large-array kernel with their peak stage
    when taper and sub-sample are both on, else the correlograms as
    :func:`conditioned_correlograms` gives them and the plain peak ops; for
    phase/hybrid the reference's unfused phase-slope branch after them."""
    k = cfg.max_shift
    in_kernel_peaks = cfg.taper_enabled and cfg.subsample_peak
    on_kernel, on_large = gcc_routes(flat, cfg, params.pairs.shape[0],
                                     in_kernel_peaks)
    if on_kernel and in_kernel_peaks:
        # taper, argmax, sub-sample peak and PSR inside the GCC kernel
        return gcc_kernel.fused_gcc(flat, params.window, params.pairs, cfg,
                                    with_peaks=True)
    if on_large and in_kernel_peaks:
        # the same peak stage inside the large-array kernel
        corr_t, shifts, tdoa_samples, peak_val, psr = (
            gcc_large.xcorr_large_peaks(
                condition_frames(flat, params.window, cfg), params.pairs,
                cfg))
        if cfg.subsample_method in ("phase", "hybrid"):
            tdoa_samples = _phase_subsample(flat, params, cfg, shifts,
                                            tdoa_samples)
        return corr_t, shifts, tdoa_samples, peak_val, psr
    corr = conditioned_correlograms(flat, params, cfg)
    shifts = xcorr.best_lag(corr, k)
    tdoa_samples, peak_val = xcorr.subsample_peak(corr, k)
    psr = xcorr.peak_confidence(corr, k)  # raw, pre-taper
    if not cfg.subsample_peak:
        tdoa_samples = shifts.to(corr.dtype)
    elif cfg.subsample_method in ("phase", "hybrid"):
        tdoa_samples = _phase_subsample(flat, params, cfg, shifts,
                                        tdoa_samples)
    corr_t = (xcorr.peak_taper(corr, k, cfg.taper_denom, shifts)
              if cfg.taper_enabled else corr)
    return corr_t, shifts, tdoa_samples, peak_val, psr


def solve_tail(tdoa_samples: torch.Tensor, xy_grid: torch.Tensor,
               params: LocalizerParams, *, cfg: PipelineConfig,
               grid_cfg: GridConfig, solver_cfg: SolverConfig,
               gn: Optional[gn_kernel.GnSolver]):
    """(xy, rms_m, xy_cov) of the solver tail from TDOAs [B, P] in samples
    and the grid peak [B, 2]: the GN kernel ``gn`` when given, else the
    batched solver and ``solution_covariance``."""
    tdoa_s = tdoa_samples / cfg.sample_rate_hz
    if gn is not None:
        return gn(tdoa_s, xy_grid)
    xy, rms = solver_ops.solve_tdoa_batched(
        tdoa_s, params.mic_positions, params.pairs,
        speed_of_sound=cfg.speed_of_sound_mps,
        height=grid_cfg.height_m, init_xy=xy_grid, cfg=solver_cfg)
    cov = solver_ops.solution_covariance(
        xy, rms, params.mic_positions, params.pairs,
        height=grid_cfg.height_m, cfg=solver_cfg)
    return xy, rms, cov


def localize_frames(
    params: LocalizerParams,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    srp_form: str,
    with_solver: bool = True,
    with_heatmap: bool = False,
    gn: Optional[gn_kernel.GnSolver],
) -> dict:
    """Full pipeline on frames [..., M, N].  ``gn``: the GN kernel bound to
    these mics and configurations (``Localizer.gn``), which then solves and
    writes the covariance; None solves with the batched solver.  Returns a
    dict of:

    - 'tdoa_samples' [..., P]: sub-sample TDOAs (fractional lags)
    - 'best_shift'   [..., P]: integer argmax lags
    - 'correlograms' [..., P, L]: tapered correlograms
    - 'scores'       [..., G]: SRP grid scores
    - 'xy_grid'      [..., 2]: grid peak (meters)
    - 'peak_value'   [..., P], 'confidence' [...]: weakest-pair PSR
    - 'xy'           [..., 2]: Gauss-Newton refined position
    - 'rms_m'        [...]: solver residual (meters)
    - 'xy_cov'       [..., 2, 2]: position covariance (with the solver)
    - 'heat_levels'  [..., G] uint8 (only with ``with_heatmap``)
    """
    k = cfg.max_shift
    p_n = params.pairs.shape[0]
    lead = frames.shape[:-2]
    flat = _flat_frames(frames, cfg)

    refine = (grid_cfg.refine_peak == "on"
              or (grid_cfg.refine_peak == "auto" and not with_solver))
    in_kernel_peaks = cfg.taper_enabled and cfg.subsample_peak
    on_kernel, _ = gcc_routes(flat, cfg, p_n, in_kernel_peaks)
    best_cell = scores = None
    if (on_kernel and in_kernel_peaks
            and in_kernel_srp(cfg, srp_form, refine,
                              params.score_bias is not None)
            and gcc_kernel.srp_mode_fits(flat, cfg, p_n)):
        # taper, argmax, sub-sample peak, PSR, the SRP scores and the grid
        # argmax inside the GCC kernel
        (corr_t, shifts, tdoa_samples, peak_val, psr, best_cell, _,
         scores) = gcc_kernel.fused_gcc_srp(
             flat, params.window, params.pairs, params.lut_flat, cfg)
    else:
        corr_t, shifts, tdoa_samples, peak_val, psr = gcc_peaks(
            flat, params, cfg)

    # with the in-kernel SRP the scores come from the kernel: the one-hot
    # product's sums, in pair order
    if scores is None:
        scores = _srp_scores(corr_t, params, cfg, srp_form, p_n)
    if params.score_bias is not None:
        scores = scores + params.score_bias

    half_cells = (grid_cfg.half_cells_x, grid_cfg.half_cells_y)
    if best_cell is not None:
        xy_grid = srp.cell_to_xy(best_cell, grid_cfg.width, half_cells,
                                 grid_cfg.cells_per_m)
    else:
        xy_grid = srp.grid_peak_xy(
            scores, (grid_cfg.height, grid_cfg.width), half_cells,
            grid_cfg.cells_per_m, refine=refine)

    out = {
        "tdoa_samples": tdoa_samples,
        "best_shift": shifts,
        "correlograms": corr_t,
        "scores": scores,
        "xy_grid": xy_grid,
        "peak_value": peak_val,
        "confidence": psr.amin(dim=-1),
    }
    if with_heatmap:
        out["heat_levels"] = srp.quantize_heatmap(scores)

    if with_solver:
        out["xy"], out["rms_m"], out["xy_cov"] = solve_tail(
            tdoa_samples, xy_grid, params, cfg=cfg, grid_cfg=grid_cfg,
            solver_cfg=solver_cfg, gn=gn)
    else:
        out["xy"] = xy_grid
        out["rms_m"] = torch.zeros(tdoa_samples.shape[:-1],
                                   dtype=corr_t.dtype, device=corr_t.device)

    # restore the caller's leading batch dims
    return {key: v.reshape(*lead, *v.shape[1:]) for key, v in out.items()}


@functools.lru_cache(maxsize=16)
def cell_xy(grid_cfg: GridConfig) -> np.ndarray:
    """``multisource.cell_centers_xy`` as one array per grid, so its device
    copy is made once (``device_constant`` keys on the array)."""
    return multisource.cell_centers_xy(grid_cfg)


def planar_mic3(mic_positions: torch.Tensor) -> torch.Tensor:
    """Planar mics [M, 2] lifted to z = 0 [M, 3], on their device."""
    return torch.cat([mic_positions, torch.zeros_like(mic_positions[:, :1])],
                     dim=-1)


def check_planar(mic_positions: torch.Tensor, what: str) -> None:
    """Refuse a [M, 3] array where the reference's multi-source path takes
    only planar [M, 2] ones (it lifts every mic to z = 0)."""
    if mic_positions.shape[-1] != 2:
        raise ValueError(
            f"{what} takes planar [M, 2] arrays only (the simultaneous-"
            f"source path lifts every mic to z = 0); got mics of shape "
            f"{tuple(mic_positions.shape)}")


def resolve_sources(
    corr: torch.Tensor,
    scores: torch.Tensor,
    params: LocalizerParams,
    *,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    n_sources: int,
    min_separation_m: float,
    assoc_window_samples: float,
) -> dict:
    """Up to ``n_sources`` sources from raw correlograms corr [..., P, L]
    and their SRP scores [..., G'] (the first G the grid's cells): the K
    separated grid peaks (``srp.top_k_peaks``), each candidate's per-pair
    TDOA re-measured within ``assoc_window_samples`` of the lag it predicts
    (``multisource.windowed_subsample_peak``), and the batched Gauss-Newton
    solve from it.  Returns (S = n_sources) 'xy' [..., S, 2] (strongest
    first), 'xy_grid' [..., S, 2], 'tdoa_samples' [..., S, P],
    'peak_value' [..., S, P], 'source_score' [..., S], 'rms_m' [..., S]
    and 'xy_cov' [..., S, 2, 2]."""
    fs = cfg.sample_rate_hz
    cells = device_constant(cell_xy(grid_cfg), corr.device)
    peak_xy, peak_score = srp.top_k_peaks(
        scores[..., :grid_cfg.num_cells], cells, n_sources, min_separation_m)
    pred_lags = solver_ops.predicted_tdoas(
        peak_xy, planar_mic3(params.mic_positions), params.pairs,
        cfg.speed_of_sound_mps, grid_cfg.height_m,
        solver_cfg.constrain_to_sphere) * fs  # [..., S, P]
    tdoa_samples, peak_val = multisource.windowed_subsample_peak(
        corr[..., None, :, :], cfg.max_shift, pred_lags,
        assoc_window_samples)
    xy, rms = solver_ops.solve_tdoa_batched(
        tdoa_samples / fs, params.mic_positions, params.pairs,
        speed_of_sound=cfg.speed_of_sound_mps, height=grid_cfg.height_m,
        init_xy=peak_xy, cfg=solver_cfg)
    xy_cov = solver_ops.solution_covariance(
        xy, rms, params.mic_positions, params.pairs,
        height=grid_cfg.height_m, cfg=solver_cfg)
    return {
        "xy": xy,
        "xy_grid": peak_xy,
        "tdoa_samples": tdoa_samples,
        "peak_value": peak_val,
        "source_score": peak_score,
        "rms_m": rms,
        "xy_cov": xy_cov,
    }


def localize_frames_multi(
    params: LocalizerParams,
    frames: torch.Tensor,
    *,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    srp_form: str,
    n_sources: int = 2,
    min_separation_m: float = 0.4,
    assoc_window_samples: float = 3.0,
) -> dict:
    """Up to ``n_sources`` simultaneous sources per frame, frames
    [..., M, N] of a planar array:

    1. raw (untapered: the taper would erase the weaker source's peak)
       correlograms (:func:`conditioned_correlograms`) score the SRP grid;
    2. ``srp.top_k_peaks`` takes K separated grid peaks;
    3. each candidate's per-pair TDOA is re-measured as the correlogram's
       local maximum within ``assoc_window_samples`` of the lag it predicts
       (``multisource.windowed_subsample_peak``);
    4. the batched Gauss-Newton solver refines each candidate.

    Returns (leading dims kept, S = n_sources): 'xy' [..., S, 2] (strongest
    first), 'xy_grid' [..., S, 2] (the grid candidates), 'tdoa_samples'
    [..., S, P], 'peak_value' [..., S, P], 'source_score' [..., S] (the SRP
    peak score), 'rms_m' [..., S], 'xy_cov' [..., S, 2, 2] and 'scores'
    [..., G]."""
    check_planar(params.mic_positions, "localize_multi")
    p_n = params.pairs.shape[0]
    lead = frames.shape[:-2]
    flat = _flat_frames(frames, cfg)
    corr = conditioned_correlograms(flat, params, cfg)  # [B, P, L]
    scores = _srp_scores(corr, params, cfg, srp_form, p_n)
    if params.score_bias is not None:
        scores = scores + params.score_bias

    out = resolve_sources(corr, scores, params, cfg=cfg, grid_cfg=grid_cfg,
                          solver_cfg=solver_cfg, n_sources=n_sources,
                          min_separation_m=min_separation_m,
                          assoc_window_samples=assoc_window_samples)
    out["scores"] = scores
    return {key: v.reshape(*lead, *v.shape[1:]) for key, v in out.items()}


# ----------------------------------------------------------------------
# One-shot offline stream and the bit-exact integer pipeline
# ----------------------------------------------------------------------

def localize_stream(loc: Localizer, stream: torch.Tensor, *,
                    max_events: int = 16, refractory: int = 0) -> dict:
    """A raw [M, T] stream on the localizer's device -> every detected
    event -> one batched localization, with no read back to the host.

    The detector runs on the stream cast to int64 (its exact integer
    prefix sums; a float stream's fractions are truncated), up to
    ``max_events`` triggers with a holdoff of ``refractory`` samples (a
    frame when 0).  The frame ending at each trigger (its start clamped to
    0) is cut from the stream as float32 and localized.  Returns the
    localizer's outputs for the [max_events] batch plus 'trigger_idx'
    [max_events] and 'valid' [max_events]: absent events are masked, not
    dropped."""
    if stream.device != loc.window.device:
        raise ValueError(f"the stream is on {stream.device}; the localizer "
                         f"lives on {loc.window.device}")
    n = loc.pipeline.frame_size
    idxs, valid = detector.all_triggers_capped(
        stream.to(torch.int64)[None], loc.pipeline, max_events=max_events,
        refractory=refractory)
    idxs, valid = idxs[0], valid[0]
    start = (idxs - (n - 1)).clamp(0, stream.shape[-1] - n)
    cols = start[:, None] + torch.arange(n, device=stream.device)
    frames = stream.to(torch.float32)[:, cols].transpose(0, 1)  # [E, M, N]
    out = dict(loc(frames.contiguous()))
    out["trigger_idx"] = idxs
    out["valid"] = valid
    return out


def localize_frames_int(frames_u8: torch.Tensor, pairs: torch.Tensor,
                        window_q15: torch.Tensor, lut_flat: torch.Tensor,
                        cfg: PipelineConfig) -> dict:
    """The firmware's exact fixed-point event burst on raw 8-bit frames
    [..., M, N] (values 0..255 as the ADC delivers them), on their device:

    DC removal (sum >> bits) -> int16 <<8 -> Q15 window -> int64 xcorr ->
    first-max argmax -> float32 Gaussian taper truncated to int64 -> shift
    gate -> int64 SRP scores + 4-level heat colours.

    The heaviest transients at 16,384 frames of 3 pairs and 10,201 cells:
    the correlation's lag windows (``xcorr.XCORR_INT_CHUNK_BYTES`` at a
    time) and the scores' [B, P, G] int64 gather (4.0 GB)."""
    x = frames_u8.to(torch.int16)
    x = conditioning.dc_remove_int(x, cfg.frame_size_bits)
    x = conditioning.normalize_shift8_int(x)
    x = window_ops.apply_window_q15(x, window_q15)

    corr = xcorr.xcorr_time_int(x, pairs, cfg.max_shift)
    shifts = xcorr.best_lag(corr, cfg.max_shift)
    corr_t = xcorr.peak_taper_int(corr, cfg.max_shift, cfg.taper_denom)

    s64 = shifts.to(torch.int64)
    gate = (s64 * s64).sum(dim=-1) > cfg.shift_gate

    scores = srp.srp_scores_int(corr_t, lut_flat)
    return {
        "frames_conditioned": x,
        "correlograms": corr_t,
        "correlograms_raw": corr,
        "best_shift": shifts,
        "gate": gate,
        "scores": scores,
        "heat_levels": srp.quantize_heatmap(scores),
    }
