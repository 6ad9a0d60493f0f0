"""Array self-calibration: learn microphone geometry (and per-channel gain)
from observed frames by gradient descent through the GCC chain.

Counterpart of ``audio_triangulation_tpu.models.calibration``.  Given frames
of events at known (or jointly estimated) source positions, it minimises
the mismatch between

- **measured** TDOAs: the soft-argmax over the GCC correlogram
  (differentiable through DC removal, gain, window, rFFT, cross-power,
  whitening and irFFT: ``ops.xcorr.xcorr_fft``, plain torch), and
- **predicted** TDOAs from the current geometry estimate.

Gradients are ``torch.autograd`` through plain torch; the GCC chain is
recomputed on the backward pass (``torch.utils.checkpoint``, the
reference's ``jax.checkpoint``).  No kernel takes this chain: the kernels
have no backward pass, and their wrappers refuse inputs that require grad.
The optimiser is ``torch.optim.Adam`` with optax's defaults (betas 0.9,
0.999, eps 1e-8), the same update from zero moments.  Parameters are
dataclasses of leaf tensors with ``requires_grad``; a step returns
``(params, optimizer, loss)`` as the reference's does.

``fit_em`` and ``fit_tracked`` localize with a ``Localizer`` on the
calibrator's device (on the card: the GCC kernel with peaks and the GN
kernel, once a localization); ``fit_tracked`` steps the port's ``Tracker``
there one event at a time and fits the trajectory on the host in float64.

A trap of the reference, ported as written: ``soft_tdoa`` max-normalises
each correlogram, which cancels a per-mic gain exactly, so the gradient
with respect to ``log_gain`` is rounding noise (1e-9 .. 1e-7 against ~30
for ``mic_xy``), and Adam turns it into steps of up to ``lr`` each.
Neither package's ``log_gain`` trajectory means anything; ``mic_xy`` does
not feel it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint as _remat

from ..core import geometry
from ..core.config import PipelineConfig
from ..ops import conditioning, solver as solver_ops, window as window_ops
from ..ops import xcorr
from .localizer import planar_mic3

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8


def _leaf(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=device,
                        requires_grad=True)


@dataclasses.dataclass
class CalibParams:
    """Trainable parameters."""

    mic_xy: torch.Tensor  # [M, 2] microphone positions (meters)
    log_gain: torch.Tensor  # [M] per-channel gain (log-domain)


@dataclasses.dataclass
class CalibBatch:
    """One training batch."""

    frames: torch.Tensor  # [B, M, N] raw PCM
    source_xy: torch.Tensor  # [B, 2] known source plane positions


def init_params(mic_xy_guess: np.ndarray, device="cuda") -> CalibParams:
    m = np.asarray(mic_xy_guess, np.float32)
    return CalibParams(mic_xy=_leaf(m, device),
                       log_gain=_leaf(np.zeros(m.shape[0]), device))


def soft_tdoa(correlograms: torch.Tensor, max_shift: int,
              beta: float = 2.0) -> torch.Tensor:
    """Differentiable TDOA: softmax-weighted lag expectation.

    correlograms [..., L] are max-normalized before the softmax so ``beta``
    is scale-free.  ``amax`` splits the gradient of a tie evenly, as the
    reference's ``jnp.max`` does."""
    lags = torch.arange(-max_shift, max_shift + 1, dtype=correlograms.dtype,
                        device=correlograms.device)
    c = correlograms / (correlograms.abs().amax(dim=-1, keepdim=True)
                        + 1e-20)
    w = torch.softmax(beta * c * max_shift, dim=-1)
    return (w * lags).sum(dim=-1)


def _gcc(frames, log_gain, pairs, window, cfg: PipelineConfig):
    x = frames.to(window.dtype)
    x = conditioning.dc_remove(x)
    x = x * torch.exp(log_gain)[:, None]
    x = window_ops.apply_window(x, window)
    return xcorr.xcorr_fft(x, pairs, cfg)


def measured_tdoas(params: CalibParams, frames: torch.Tensor,
                   pairs: torch.Tensor, window: torch.Tensor,
                   cfg: PipelineConfig, beta: float = 2.0, *,
                   checkpoint: bool = True) -> torch.Tensor:
    """Frames [B, M, N] -> differentiable TDOAs [B, P] (samples).

    With ``checkpoint`` the GCC chain is recomputed on the backward pass
    instead of keeping its [B, M, F] and [B, P, F] complex spectra: the
    reference always does so; off, the same values and gradients."""
    if checkpoint:
        corr = _remat(_gcc, frames, params.log_gain, pairs, window, cfg,
                      use_reentrant=False)
    else:
        corr = _gcc(frames, params.log_gain, pairs, window, cfg)
    return soft_tdoa(corr, cfg.max_shift, beta)


def _residual_loss(meas, mic_xy, source_xy, pairs, cfg: PipelineConfig,
                   height: float, anchor_weight: float):
    """Mean squared TDOA residual (samples^2) + the centroid anchor."""
    pred = solver_ops.predicted_tdoas(
        source_xy, planar_mic3(mic_xy), pairs, cfg.speed_of_sound_mps,
        height, True) * cfg.sample_rate_hz  # [B, P] samples
    resid = meas - pred
    centroid = mic_xy.mean(dim=0)
    return (resid * resid).mean() + anchor_weight * (centroid
                                                     * centroid).sum()


def calib_loss(params: CalibParams, batch: CalibBatch, pairs: torch.Tensor,
               window: torch.Tensor, cfg: PipelineConfig, *,
               height: float = 1.2, beta: float = 2.0,
               anchor_weight: float = 1.0,
               checkpoint: bool = True) -> torch.Tensor:
    """Mean squared TDOA residual (samples^2) + gauge anchors.

    The anchors fix the translation/rotation gauge freedom: centroid at the
    origin and zero net rotation relative to the initial estimate are not
    observable from TDOAs alone."""
    meas = measured_tdoas(params, batch.frames, pairs, window, cfg, beta,
                          checkpoint=checkpoint)
    return _residual_loss(meas, params.mic_xy, batch.source_xy, pairs, cfg,
                          height, anchor_weight)


def estimate_speed_of_sound(
    frames,
    source_xy,
    mic_positions: np.ndarray,
    pipeline: PipelineConfig = PipelineConfig(),
    *,
    height: float = 1.2,
    min_pred_samples: float = 2.0,
    device=None,
) -> tuple[float, dict]:
    """Estimate the speed of sound from events at KNOWN positions with
    KNOWN mic geometry: closed form, no iteration.

    c and the geometry's overall scale are jointly unobservable from TDOAs,
    so geometry stays fixed and only c is estimated.  With the model
    tau_p = K_p / c (K_p the geometric path difference times the sample
    rate), least squares in 1/c gives

        c* = sum_w K^2 / sum_w K * tau_meas

    over every (event, pair) whose predicted |tau| clears
    ``min_pred_samples``.  Measurements are sub-sample GCC peaks
    (``condition_frames`` -> ``xcorr_fft`` -> ``subsample_peak`` on
    ``device``), the fit numpy in float64.

    frames: [B, M, N] (a tensor, or an array taken to ``device``: the card
    unless the caller says otherwise); source_xy: [B, 2] plane coords
    (lifted to the radius-``height`` sphere, the reference's source model).
    Returns (c_mps, diagnostics) with diagnostics = {'n_used',
    'rms_samples', 'c_samples': per-event c estimates}.
    """
    from . import localizer as localizer_mod

    if device is None:
        device = (frames.device if isinstance(frames, torch.Tensor)
                  else "cuda")
    mic_xy = np.asarray(mic_positions, np.float32)
    m = mic_xy.shape[0]
    pairs = geometry.mic_pairs(m)
    win = torch.as_tensor(window_ops.window_for(pipeline), device=device)
    x = localizer_mod.condition_frames(
        torch.as_tensor(frames, dtype=torch.float32, device=device), win,
        pipeline)
    corr = xcorr.xcorr_fft(x, torch.as_tensor(pairs, device=device),
                           pipeline)
    meas, _ = xcorr.subsample_peak(corr, pipeline.max_shift)  # [B, P]
    meas = meas.cpu().numpy().astype(np.float64)

    src3 = solver_ops.lift_to_model(
        torch.as_tensor(np.asarray(source_xy), dtype=torch.float32), height,
        True).numpy().astype(np.float64)
    mic3 = np.zeros((m, 3))
    mic3[:, : mic_xy.shape[1]] = mic_xy
    d = np.linalg.norm(src3[:, None, :] - mic3[None], axis=-1)  # [B, M]
    k = ((d[:, pairs[:, 1]] - d[:, pairs[:, 0]])
         * pipeline.sample_rate_hz)                             # [B, P]

    mask = np.abs(k) / pipeline.speed_of_sound_mps >= min_pred_samples
    kw = k[mask]
    mw = meas[mask]
    denom = float(np.sum(kw * mw))
    if not mask.any() or denom <= 0:
        raise ValueError(
            "no informative (event, pair) TDOAs for a speed-of-sound fit "
            "(all predicted TDOAs below min_pred_samples, or degenerate "
            "measurements)")
    c = float(np.sum(kw * kw) / denom)
    resid = mw - kw / c
    per_event = np.where(
        np.sum(k * meas * mask, axis=1) > 0,
        np.sum(k * k * mask, axis=1)
        / np.maximum(np.sum(k * meas * mask, axis=1), 1e-12), np.nan)
    return c, {
        "n_used": int(mask.sum()),
        "rms_samples": float(np.sqrt(np.mean(resid ** 2))),
        "c_samples": per_event,
    }


@dataclasses.dataclass
class JointParams:
    """Unsupervised calibration: mic geometry AND per-event source positions
    are latent (the events themselves are the calibration signal)."""

    mic_xy: torch.Tensor  # [M, 2]
    log_gain: torch.Tensor  # [M]
    source_xy: torch.Tensor  # [B, 2] latent per-event source positions


def _anchored(loss, mic_xy, mic_anchor, orientation_weight: float):
    """``loss`` + the weak orientation prior toward ``mic_anchor``."""
    return loss + orientation_weight * ((mic_xy - mic_anchor) ** 2).mean()


def joint_loss(params: JointParams, frames: torch.Tensor,
               pairs: torch.Tensor, window: torch.Tensor,
               cfg: PipelineConfig, mic_anchor: torch.Tensor, *,
               height: float = 1.2, beta: float = 2.0,
               anchor_weight: float = 1.0, orientation_weight: float = 0.1,
               checkpoint: bool = True) -> torch.Tensor:
    """TDOA self-consistency + gauge anchors.

    Without labels the problem has translation/rotation gauge freedom; the
    centroid anchor and a weak orientation prior toward the initial guess
    (mic_anchor) fix it.  Scale is observable (the speed of sound sets it)."""
    cal = CalibParams(mic_xy=params.mic_xy, log_gain=params.log_gain)
    meas = measured_tdoas(cal, frames, pairs, window, cfg, beta,
                          checkpoint=checkpoint)
    loss = _residual_loss(meas, params.mic_xy, params.source_xy, pairs, cfg,
                          height, anchor_weight)
    return _anchored(loss, params.mic_xy, mic_anchor, orientation_weight)


@dataclasses.dataclass
class TrackedParams:
    """Self-calibration from tracked motion: the per-event source positions
    lie on a polynomial trajectory xy(t) = sum_d coeffs[d] t^d, so B events
    of one moving source constrain only 2 (order+1) trajectory DOF."""

    mic_xy: torch.Tensor       # [M, 2]
    log_gain: torch.Tensor     # [M]
    traj_coeffs: torch.Tensor  # [order+1, 2] polynomial in centered time


def traj_positions(coeffs: torch.Tensor, times: torch.Tensor) -> torch.Tensor:
    """Polynomial trajectory sample: coeffs [D+1, 2], times [B] -> [B, 2]."""
    powers = times[:, None] ** torch.arange(
        coeffs.shape[0], dtype=times.dtype, device=times.device)[None, :]
    return powers @ coeffs


def tracked_loss(params: TrackedParams, frames: torch.Tensor,
                 times: torch.Tensor, pairs: torch.Tensor,
                 window: torch.Tensor, cfg: PipelineConfig,
                 mic_anchor: torch.Tensor, *, height: float = 1.2,
                 beta: float = 2.0, anchor_weight: float = 1.0,
                 orientation_weight: float = 0.1,
                 checkpoint: bool = True) -> torch.Tensor:
    """TDOA self-consistency with trajectory-constrained source positions
    (``times`` [B] centered, see :meth:`Calibrator.fit_tracked`).  Gauge
    anchors as in :func:`joint_loss`."""
    cal = CalibParams(mic_xy=params.mic_xy, log_gain=params.log_gain)
    meas = measured_tdoas(cal, frames, pairs, window, cfg, beta,
                          checkpoint=checkpoint)
    src = traj_positions(params.traj_coeffs, times)  # [B, 2]
    loss = _residual_loss(meas, params.mic_xy, src, pairs, cfg, height,
                          anchor_weight)
    return _anchored(loss, params.mic_xy, mic_anchor, orientation_weight)


def _adam_step(opt: torch.optim.Optimizer, loss_fn):
    """One optimiser step on ``loss_fn()``; returns the detached loss."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    opt.step()
    return loss.detach()


@dataclasses.dataclass(frozen=True)
class Calibrator:
    """Adam-based calibration trainer on the device of ``window``.

    >>> calib = Calibrator.create(8, device="cuda")
    >>> params, opt = calib.init(mic_xy_guess)
    >>> params, opt, loss = calib.train_step(params, opt, batch)
    """

    pipeline: PipelineConfig
    pairs: torch.Tensor
    window: torch.Tensor
    height: float = 1.2
    beta: float = 2.0
    learning_rate: float = 3e-3

    @classmethod
    def create(cls, n_mics: int, pipeline: PipelineConfig = PipelineConfig(),
               *, device="cuda", **kwargs) -> "Calibrator":
        """Constants on ``device``: the card unless the caller says
        otherwise."""
        pairs = torch.as_tensor(geometry.mic_pairs(n_mics), device=device)
        win = torch.as_tensor(window_ops.window_for(pipeline), device=device)
        return cls(pipeline=pipeline, pairs=pairs, window=win, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.window.device

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def optimizer(self, params) -> torch.optim.Adam:
        """Adam over the tensors of a parameter dataclass (optax.adam's
        update)."""
        return torch.optim.Adam(
            [getattr(params, f.name) for f in dataclasses.fields(params)],
            lr=self.learning_rate, betas=ADAM_BETAS, eps=ADAM_EPS)

    def init(self, mic_xy_guess: np.ndarray):
        params = init_params(mic_xy_guess, self.device)
        return params, self.optimizer(params)

    def train_step(self, params: CalibParams, opt, batch: CalibBatch):
        """(params, opt, batch) -> (params, opt, loss); the leaves are
        updated in place."""
        batch = CalibBatch(frames=self._f32(batch.frames),
                           source_xy=self._f32(batch.source_xy))
        loss = _adam_step(opt, lambda: calib_loss(
            params, batch, self.pairs, self.window, self.pipeline,
            height=self.height, beta=self.beta))
        return params, opt, loss

    def fit(self, mic_xy_guess, batches, steps_per_batch: int = 1):
        params, opt = self.init(mic_xy_guess)
        losses = []
        for batch in batches:
            for _ in range(steps_per_batch):
                params, opt, loss = self.train_step(params, opt, batch)
                losses.append(loss)
        return params, [float(v) for v in losses]

    # ------------------------------------------------------------------
    # Unsupervised (joint) mode: no labeled source positions

    def init_joint(self, mic_xy_guess: np.ndarray,
                   source_xy_guess: np.ndarray):
        m = np.asarray(mic_xy_guess, np.float32)
        params = JointParams(
            mic_xy=_leaf(m, self.device),
            log_gain=_leaf(np.zeros(m.shape[0]), self.device),
            source_xy=_leaf(source_xy_guess, self.device))
        return params, self.optimizer(params)

    def fit_em(self, mic_xy_guess: np.ndarray, frames,
               em_rounds: int = 6, inner_steps: int = 80):
        """Unsupervised self-calibration by expectation-maximization:
        the E-step localizes the events with the current geometry estimate
        (a ``Localizer`` on the calibrator's device), the M-step refines the
        geometry supervised on those positions, with a fresh optimiser
        each round.  Identifiability is pair-count-limited: >= ~6 mics give
        a strongly overdetermined system."""
        from .localizer import Localizer

        frames = self._f32(frames)
        mic_est = np.asarray(mic_xy_guess, np.float32).copy()
        losses = []
        for _ in range(em_rounds):
            loc = Localizer.create(mic_est, self.pipeline,
                                   device=self.device)
            batch = CalibBatch(frames=frames, source_xy=loc(frames)["xy"])
            params, opt = self.init(mic_est)
            for _ in range(inner_steps):
                params, opt, loss = self.train_step(params, opt, batch)
            mic_est = params.mic_xy.detach().cpu().numpy()
            losses.append(float(loss))
        return mic_est, losses

    # ------------------------------------------------------------------
    # Self-calibration from tracked motion: a moving source's tracker
    # trajectory becomes the reference source

    def train_step_tracked(self, params: TrackedParams, opt, frames, times,
                           mic_anchor):
        """Trajectory-constrained step: (params, opt, frames, times,
        mic_anchor) -> (params, opt, loss)."""
        frames, times = self._f32(frames), self._f32(times)
        mic_anchor = self._f32(mic_anchor)
        loss = _adam_step(opt, lambda: tracked_loss(
            params, frames, times, self.pairs, self.window, self.pipeline,
            mic_anchor, height=self.height, beta=self.beta))
        return params, opt, loss

    def fit_tracked(self, mic_xy_guess: np.ndarray, frames,
                    event_times: np.ndarray, *, traj_order: int = 1,
                    steps: int = 300, tracker_cfg=None):
        """Unsupervised self-calibration from a single moving source.

        1. Localize each event with the initial geometry guess.
        2. Run the Kalman tracker over the timestamped positions, one event
           at a time on the calibrator's device; its filtered trajectory
           initializes the polynomial trajectory (a float64 ``polyfit`` on
           the host; order 1 = the tracker's constant-velocity model).
        3. Jointly refine geometry + gains + trajectory against the
           measured TDOAs (:func:`tracked_loss`).

        Returns (mic_xy [M, 2], traj_coeffs [order+1, 2] in centered time,
        losses)."""
        from . import tracking
        from .localizer import Localizer

        mic0 = np.asarray(mic_xy_guess, np.float32)
        times = np.asarray(event_times, np.float32)
        tc = times - float(times.mean())  # centered: conditions the basis
        frames = self._f32(frames)

        # E-step 0: localize + track with the guessed geometry
        loc = Localizer.create(mic0, self.pipeline, device=self.device)
        xy = loc(frames)["xy"].cpu().numpy()  # [B, 2]
        tr = tracking.Tracker(tracker_cfg or tracking.TrackerConfig(
            measurement_noise=0.05, process_noise=0.5), device=self.device)
        st = tr.init()
        filt = []
        for i in np.argsort(times):
            st, out = tr.step(st, xy[i], times[i])
            k = int(out["assigned"])
            filt.append(out["track_xy"][max(k, 0)].cpu().numpy())
        filt = np.asarray(filt)[np.argsort(np.argsort(times))]  # undo sort

        coeffs = np.stack([
            np.polyfit(tc, filt[:, d], traj_order)[::-1]
            for d in range(2)], axis=-1).astype(np.float32)  # [order+1, 2]
        params = TrackedParams(
            mic_xy=_leaf(mic0, self.device),
            log_gain=_leaf(np.zeros(mic0.shape[0]), self.device),
            traj_coeffs=_leaf(coeffs, self.device))
        opt = self.optimizer(params)
        tc_t, anchor = self._f32(tc), self._f32(mic0)
        losses = []
        for _ in range(steps):
            params, opt, loss = self.train_step_tracked(
                params, opt, frames, tc_t, anchor)
            losses.append(loss)
        return (params.mic_xy.detach().cpu().numpy(),
                params.traj_coeffs.detach().cpu().numpy(),
                torch.stack(losses).cpu().tolist())

    def train_step_joint(self, params: JointParams, opt, frames, mic_anchor):
        """Unsupervised step: (params, opt, frames, mic_anchor) -> (params,
        opt, loss)."""
        frames, mic_anchor = self._f32(frames), self._f32(mic_anchor)
        loss = _adam_step(opt, lambda: joint_loss(
            params, frames, self.pairs, self.window, self.pipeline,
            mic_anchor, height=self.height, beta=self.beta))
        return params, opt, loss
