"""TDOA cycle-consistency: denoising, residuals, and mic-fault diagnosis.

Counterpart of ``audio_triangulation_tpu.ops.consistency``.  Pairwise TDOAs
are redundant: any cycle must close (tau_ij + tau_jk = tau_ik).  Projecting
measured TDOAs onto the consistent subspace, the image of the
pair-difference operator S (tau = S t for per-mic arrival times t),
averages that redundancy away, and the projection RESIDUAL attributes
inconsistency to individual microphones: a mic whose correlations are
garbage (dead channel, saturated ADC, loose cable) poisons exactly the
pairs that touch it, while a merely delayed mic stays consistent (the
delay is absorbed into its arrival time).

Every op is batched over leading axes; the solve is on the M-dim
arrival-time space, never on the P-dim pair space.  The solves use
``torch.linalg.solve_ex``, which does not wait for the device to check for
a singular matrix (the gauge-augmented Laplacians here never are).
"""

from __future__ import annotations

import torch


def pair_selection(pairs: torch.Tensor, n_mics: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The +-1 pair-difference matrix S [P, M] with tau_p = t_j - t_i."""
    one_hot = torch.nn.functional.one_hot
    return (one_hot(pairs[:, 1].long(), n_mics).to(dtype)
            - one_hot(pairs[:, 0].long(), n_mics).to(dtype))


def _touch(pairs: torch.Tensor, n_mics: int, dtype) -> torch.Tensor:
    """[P, M]: 1 where the pair touches the mic."""
    one_hot = torch.nn.functional.one_hot
    return (one_hot(pairs[:, 0].long(), n_mics).to(dtype)
            + one_hot(pairs[:, 1].long(), n_mics).to(dtype))


def _median(x: torch.Tensor) -> torch.Tensor:
    """Median over the last axis, kept, averaging the two middle values of
    an even count (``torch.median`` takes the lower one)."""
    return torch.quantile(x, 0.5, dim=-1, keepdim=True)


def project_consistent(tdoas: torch.Tensor, pairs: torch.Tensor,
                       n_mics: int, weights: torch.Tensor | None = None):
    """Least-squares projection onto the cycle-consistent subspace.

    tdoas [..., P] (any time unit), optional per-pair weights [..., P].
    Returns (tau_consistent [..., P], arrival_times [..., M] zero-mean,
    residual [..., P] = measured - consistent).  Solves
    min_t sum_p w_p (tau_p - (t_j - t_i))^2 with the mean-t gauge fixed by
    adding 11^T / M to the singular graph Laplacian S^T W S, which is exact
    because the solution is orthogonal to 1."""
    dt = tdoas.dtype
    sel = pair_selection(pairs, n_mics, dt)  # [P, M]
    if weights is None:
        lap = sel.T @ sel  # [M, M]
        rhs = torch.einsum("pm,...p->...m", sel, tdoas)
    else:
        w = weights.to(dt)
        lap = torch.einsum("pm,pn,...p->...mn", sel, sel, w)
        rhs = torch.einsum("pm,...p,...p->...m", sel, w, tdoas)
    gauge = torch.full((n_mics, n_mics), 1.0 / n_mics, dtype=dt,
                       device=tdoas.device)
    a = (lap + gauge).expand(*rhs.shape, n_mics)
    t = torch.linalg.solve_ex(a, rhs[..., None])[0][..., 0]
    tau_c = torch.einsum("pm,...m->...p", sel, t)
    return tau_c, t, tdoas - tau_c


def mic_consistency_scores(residual: torch.Tensor, pairs: torch.Tensor,
                           n_mics: int) -> torch.Tensor:
    """Per-mic mean |residual| over the pairs touching each mic [..., M]: a
    healthy array scores near the TDOA noise floor on every mic, a mic with
    garbage correlations high on ALL its pairs."""
    touch = _touch(pairs, n_mics, residual.dtype)
    num = torch.einsum("pm,...p->...m", touch, residual.abs())
    return num / touch.sum(dim=0)


def mic_weights(scores: torch.Tensor, *, ratio: float = 3.0,
                floor: float = 1e-9) -> torch.Tensor:
    """Per-mic down-weights [..., M] from consistency scores [..., M]: the
    Cauchy weight ``1 / (1 + (s / (ratio * max(median, floor)))^2)`` on the
    score in units of the median of the mics, so a healthy array gets
    near-uniform weights and a garbage channel collapses toward
    ``(ratio * med / s)^2``."""
    r = scores / (ratio * _median(scores).clamp_min(floor))
    return 1.0 / (1.0 + r * r)


def pair_weights(w_mic: torch.Tensor, pairs: torch.Tensor,
                 n_mics: int) -> torch.Tensor:
    """Per-pair weights ``w_i * w_j`` [..., P] from per-mic weights
    [..., M]."""
    return (w_mic.index_select(-1, pairs[:, 0].long())
            * w_mic.index_select(-1, pairs[:, 1].long()))


def mic_exclusion_weights(tdoas: torch.Tensor, pairs: torch.Tensor,
                          n_mics: int, *, ratio: float = 3.0,
                          floor: float = 1e-9) -> torch.Tensor:
    """Per-mic weights [..., M] by leave-one-mic-out consistency testing:
    project M times, each time with one mic's pairs (near-)zeroed, and take
    the residual RMS over the surviving pairs.  Leaving out a healthy mic
    keeps the bad pairs in (the RMS stays high); leaving out the dead mic
    drops it to the noise floor.  The weight is Cauchy in
    ``median(rms) / rms[m]``: about 0.9 for every mic of a healthy array,
    small exactly for a faulty one.  ``floor`` is in the tdoas' units."""
    dt = tdoas.dtype
    touch_t = _touch(pairs, n_mics, dt).T  # [M, P]
    # 1e-6 and not 0: a zero row would cut the left-out mic from the pair
    # graph and make the gauge-augmented Laplacian singular
    w_excl = (1.0 - touch_t).clamp_min(1e-6)
    tau_b = tdoas[..., None, :].expand(*tdoas.shape[:-1], *w_excl.shape)
    _, _, resid = project_consistent(tau_b, pairs, n_mics, weights=w_excl)
    keep = 1.0 - touch_t  # exact 0/1 mask for the RMS itself
    rms = torch.sqrt((keep * resid * resid).sum(dim=-1) / keep.sum(dim=-1))
    score = _median(rms) / rms.clamp_min(floor)
    r = score / ratio
    return 1.0 / (1.0 + r * r)


def fault_weights(tdoas: torch.Tensor, pairs: torch.Tensor, n_mics: int, *,
                  rounds: int = 3, ratio: float = 3.0, floor: float = 1e-9):
    """Leave-one-mic-out mic weights (dead channels) seeding per-pair IRLS
    (lone multipath pairs).  Returns (w_pair [..., P], tau_consistent
    [..., P], w_mic [..., M]): ``w_pair`` multiplies squared residuals (its
    root is the solver's ``weights``), ``tau_consistent`` is the denoised
    TDOA set of the final weighted projection."""
    w_mic = mic_exclusion_weights(tdoas, pairs, n_mics, ratio=ratio,
                                  floor=floor)
    w0 = pair_weights(w_mic, pairs, n_mics)
    w = w0
    tau_c = tdoas
    for _ in range(rounds):
        tau_c, _, resid = project_consistent(tdoas, pairs, n_mics, weights=w)
        r = resid / (ratio * _median(resid.abs()).clamp_min(floor))
        w = w0 / (1.0 + r * r)
    return w, tau_c, w_mic


def diagnose_mics(tdoas: torch.Tensor, pairs: torch.Tensor, n_mics: int, *,
                  weights: torch.Tensor | None = None,
                  ratio_thresh: float = 3.0, floor: float = 1e-9) -> dict:
    """Flag faulty microphones from TDOA inconsistency: 'scores' [..., M]
    per-mic mean |cycle residual|, 'faulty' [..., M] bool (score >
    ratio_thresh * median), 'residual_rms' [...].  A constant per-mic delay
    is invisible by design (it is a valid arrival-time shift)."""
    _, _, resid = project_consistent(tdoas, pairs, n_mics, weights)
    scores = mic_consistency_scores(resid, pairs, n_mics)
    faulty = scores > ratio_thresh * _median(scores).clamp_min(floor)
    rms = torch.sqrt(torch.mean(resid * resid, dim=-1))
    return {"scores": scores, "faulty": faulty, "residual_rms": rms}
