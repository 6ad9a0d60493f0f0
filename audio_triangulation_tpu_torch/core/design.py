"""Array design: CRLB evaluation and gradient-based mic placement.

Counterpart of ``audio_triangulation_tpu.core.design``.  Given a coverage
region, evaluate how well an array CAN localize there (the Cramer-Rao lower
bound of the TDOA model) and optimize mic positions against it.

The bound reuses the pipeline's own measurement model
(``ops.solver.predicted_tdoas``): for a source at x, the pairwise-TDOA
Jacobian G = dtau/dx [P, 2] (``torch.func.vmap`` of ``torch.func.jacfwd``)
gives the Fisher information I = G^T G / sigma_tau^2 under independent
per-pair timing noise.  Everything is differentiable through the geometry
(the Jacobian by forward mode, the placement gradient by ``torch.autograd``
through it), so placement is a few hundred ``torch.optim.Adam`` steps on
the mic coordinates with soft constraints (aperture radius, minimum
separation).  Plain torch: no kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry
from .config import PipelineConfig
from ..ops import solver as solver_ops


def tdoa_jacobian(
    xy: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    speed_of_sound: float,
    height: float,
    constrain_sphere: bool = False,
) -> torch.Tensor:
    """d tau / d xy [..., P, 2] (seconds per meter) at source points
    [..., 2], differentiable in both the points and the mic positions."""
    mic3 = _mic3(mic_positions, xy.dtype)

    def tau(pt):
        return solver_ops.predicted_tdoas(pt, mic3, pairs, speed_of_sound,
                                          height, constrain_sphere)

    flat = xy.reshape(-1, 2)
    jac = torch.func.vmap(torch.func.jacfwd(tau))(flat)  # [B, P, 2]
    return jac.reshape(*xy.shape[:-1], jac.shape[-2], 2)


def crlb(
    mic_positions: torch.Tensor,
    points_xy: torch.Tensor,
    *,
    sigma_tau_s: float,
    pipeline: PipelineConfig = PipelineConfig(),
    height: float = 1.2,
    constrain_sphere: bool = False,
    ridge: float = 1e-12,
) -> torch.Tensor:
    """Position-error lower bound [..., 2, 2] (meters^2) at each coverage
    point, for per-pair TDOA noise ``sigma_tau_s`` (seconds RMS), on the
    device of ``mic_positions``.

    CRLB = sigma_tau^2 (G^T G)^{-1}, by the closed-form 2x2 inverse."""
    pairs = torch.as_tensor(geometry.mic_pairs(int(mic_positions.shape[0])),
                            device=mic_positions.device)
    g = tdoa_jacobian(
        points_xy, mic_positions, pairs,
        speed_of_sound=pipeline.speed_of_sound_mps, height=height,
        constrain_sphere=constrain_sphere)  # [..., P, 2]
    a = torch.einsum("...pi,...pj->...ij", g, g)  # [..., 2, 2]
    a00 = a[..., 0, 0] + ridge
    a11 = a[..., 1, 1] + ridge
    a01 = a[..., 0, 1]
    det = (a00 * a11 - a01 * a01).clamp_min(1e-30)
    inv = torch.stack([
        torch.stack([a11, -a01], dim=-1),
        torch.stack([-a01, a00], dim=-1)], dim=-2) / det[..., None, None]
    return (sigma_tau_s ** 2) * inv


def crlb_rms_m(mic_positions, points_xy, **kwargs) -> torch.Tensor:
    """sqrt(trace CRLB) [...]: the best achievable position RMS (meters)
    at each point.  The design objective and the map to plot."""
    c = crlb(mic_positions, points_xy, **kwargs)
    return torch.sqrt(c[..., 0, 0] + c[..., 1, 1])


def optimize_array(
    init_positions: np.ndarray,
    coverage_xy: np.ndarray,
    *,
    sigma_tau_s: float = 2e-6,
    pipeline: PipelineConfig = PipelineConfig(),
    height: float = 1.2,
    aperture_m: float = 0.25,
    min_separation_m: float = 0.05,
    steps: int = 300,
    learning_rate: float = 3e-3,
    penalty: float = 100.0,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Gradient-descend mic positions to minimize the mean best-achievable
    RMS over the coverage points, on ``device`` (the card unless the caller
    says otherwise).

    Soft constraints: every mic inside ``aperture_m`` of the array center,
    pairwise separation at least ``min_separation_m`` (quadratic hinge
    penalties).  Returns (optimized [M, 2] positions re-centered on their
    centroid, per-step objective history [steps]).
    """
    pts = torch.as_tensor(np.asarray(coverage_xy, np.float32), device=device)
    mics = torch.tensor(np.asarray(init_positions, np.float32),
                        device=device, requires_grad=True)
    pair_i, pair_j = (torch.as_tensor(ix, device=device)
                      for ix in np.triu_indices(mics.shape[0], k=1))

    def loss():
        centered = mics - mics.mean(dim=0)
        obj = crlb_rms_m(centered, pts, sigma_tau_s=sigma_tau_s,
                         pipeline=pipeline, height=height).mean()
        r = torch.linalg.vector_norm(centered, dim=-1)
        pen_ap = (torch.relu(r - aperture_m) ** 2).sum()
        sep = torch.linalg.vector_norm(centered[pair_i] - centered[pair_j],
                                       dim=-1)
        pen_sep = (torch.relu(min_separation_m - sep) ** 2).sum()
        return obj + penalty * (pen_ap + pen_sep), obj

    # optax.adam's defaults, as in models.calibration
    opt = torch.optim.Adam([mics], lr=learning_rate, betas=(0.9, 0.999),
                           eps=1e-8)
    history = []
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        total, obj = loss()
        total.backward()
        opt.step()
        history.append(obj.detach())
    with torch.no_grad():
        out = (mics - mics.mean(dim=0)).cpu().numpy()
    hist = (torch.stack(history).cpu().numpy() if history
            else np.zeros(0, np.float32))
    return out, hist.astype(np.float32)


def _mic3(mic_positions: torch.Tensor, dtype) -> torch.Tensor:
    """Mics [M, D] (D <= 3) as [M, 3] of ``dtype``, zero-padded; no write
    into a leaf, so the positions keep their gradient."""
    m, d = mic_positions.shape
    pad = torch.zeros((m, 3 - d), dtype=dtype, device=mic_positions.device)
    return torch.cat([mic_positions.to(dtype), pad], dim=-1)
