"""Position-space multi-target tracking over per-event localizations.

Counterpart of ``audio_triangulation_tpu.models.tracking``: a bank of
constant-velocity Kalman filters over the per-event positions, with track
lifecycle (spawn -> tentative -> confirmed -> dropped), nearest, soft (PDA)
and joint (JPDA) association, an IMM bank of mode-matched filters and an
offline RTS smoother.

Every function is written batched over any leading stream axes: a bank
state holds ``[..., K, 2*dim]`` filters, a measurement is ``[..., dim]``
and a time ``[...]`` (the reference writes one stream and ``vmap``s it).
Updates are masked, never branched on a tensor, and no constant is copied
from the host per call, so a step waits for nothing and records into a
CUDA graph.  Per-track prediction uses each track's own elapsed time, so
irregular event-driven updates are handled exactly.

Typical wiring: ``states, out = sl.step_many(...)`` -> ``tracker.step_many(
tstates, out["xy"], t, out["event"])``.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
from typing import Optional

import numpy as np
import torch

from ..ops._device import device_constant


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Constant-velocity Kalman tracker bank configuration."""

    max_tracks: int = 4
    # position dimension: 2 (xy, the default) or 3 (xyz).  State per track
    # is [pos(dim), vel(dim)]; measurements are [dim].
    dim: int = 2
    # continuous white-noise acceleration spectral density [(m/s^2)^2 * s]
    process_noise: float = 1.0
    # measurement noise std [m] on each position component
    measurement_noise: float = 0.03
    # association gate: Mahalanobis distance^2 (2 dof; 9.21 = 99%.  For
    # dim=3 the 99% point is 11.34: set it explicitly)
    gate_maha2: float = 9.21
    # initial velocity std [m/s] for a freshly spawned track
    init_vel_std: float = 1.0
    # velocity-measurement noise std [m/s] on each component, used when a
    # step provides ``z_vel``; per-measurement ``v_cov`` overrides it
    velocity_noise: float = 0.5
    # hits to confirm a track
    confirm_hits: int = 2
    # drop a track not updated for this long [s]
    max_coast_s: float = 2.0
    # 'nearest': hard nearest-neighbour gated assignment (default).
    # 'soft': PDA-style probabilistic association: every gated track is
    # updated with its posterior association weight.
    association: str = "nearest"
    # soft association only: detection probability and clutter density
    # [false events / m^2 / event]
    detect_prob: float = 0.9
    clutter_density: float = 0.5
    # soft association only: spawn a new track when the no-association
    # posterior beta_0 exceeds this
    spawn_b0: float = 0.5
    # step_multi association weights: 'cheap' (Fitzgerald's normalization,
    # O(N K)) or 'exact' (every joint association event enumerated into a
    # constant table and marginalized; fine for N, K <= ~6)
    joint_association: str = "cheap"
    # IMM: a tuple of process-noise densities makes each track a bank of
    # mode-matched CV filters mixed by a Markov mode chain, e.g. (0.05,
    # 8.0) = cruising vs manoeuvring.  None = the single-model tracker.
    # Single-measurement step path only (hard and soft association, z_cov).
    imm_q: Optional[tuple] = None
    # self-transition probability of the mode chain (off-diagonal mass is
    # split uniformly across the other modes)
    imm_stay: float = 0.95


@dataclasses.dataclass
class TrackState:
    """Tracker bank state; the track slot axis follows any stream axes."""

    x: torch.Tensor  # [..., K, 2*dim] state: pos(dim), vel(dim)
    p: torch.Tensor  # [..., K, 2*dim, 2*dim] covariance
    active: torch.Tensor  # [..., K] bool
    hits: torch.Tensor  # [..., K] int32
    last_t: torch.Tensor  # [..., K] float32 time of the last assignment
    # time the stored (x, p) refer to: every step predicts active tracks to
    # its t and stores them, so the next prediction starts here (from last_t
    # an unassigned track would be advanced twice)
    state_t: torch.Tensor  # [..., K] float32
    born_t: torch.Tensor  # [..., K] float32 spawn time
    track_id: torch.Tensor  # [..., K] int32 (monotonic; 0 = never used)
    next_id: torch.Tensor  # [...] int32
    dropped: torch.Tensor  # [...] int32 cumulative dropped tracks
    unassigned: torch.Tensor  # [...] int32 measurements with no free slot


@dataclasses.dataclass
class ImmTrackState:
    """IMM bank state: per-track per-mode filters and mode beliefs; the
    bookkeeping fields are :class:`TrackState`'s, the filters gain a mode
    axis R = len(cfg.imm_q)."""

    xm: torch.Tensor  # [..., K, R, 2*dim] per-mode state
    pm: torch.Tensor  # [..., K, R, 2*dim, 2*dim] per-mode covariance
    mu: torch.Tensor  # [..., K, R] mode probabilities
    active: torch.Tensor
    hits: torch.Tensor
    last_t: torch.Tensor
    state_t: torch.Tensor
    born_t: torch.Tensor
    track_id: torch.Tensor
    next_id: torch.Tensor
    dropped: torch.Tensor
    unassigned: torch.Tensor


def _bookkeeping(k: int, lead: tuple, device) -> dict:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    return dict(active=zeros(k, dtype=torch.bool),
                hits=zeros(k, dtype=torch.int32), last_t=zeros(k),
                state_t=zeros(k), born_t=zeros(k),
                track_id=zeros(k, dtype=torch.int32),
                next_id=torch.ones(lead, dtype=torch.int32, device=device),
                dropped=zeros(dtype=torch.int32),
                unassigned=zeros(dtype=torch.int32))


def init_state(cfg: TrackerConfig, device="cuda", lead: tuple = ()
               ) -> TrackState:
    """An empty bank on ``device``; ``lead`` stacks one per stream."""
    k, sd = cfg.max_tracks, 2 * cfg.dim
    return TrackState(
        x=torch.zeros((*lead, k, sd), device=device),
        p=torch.zeros((*lead, k, sd, sd), device=device),
        **_bookkeeping(k, lead, device))


def init_state_imm(cfg: TrackerConfig, device="cuda", lead: tuple = ()
                   ) -> ImmTrackState:
    if not cfg.imm_q:
        raise ValueError("init_state_imm needs cfg.imm_q (a tuple of "
                         "per-mode process-noise densities)")
    k, r, sd = cfg.max_tracks, len(cfg.imm_q), 2 * cfg.dim
    return ImmTrackState(
        xm=torch.zeros((*lead, k, r, sd), device=device),
        pm=torch.zeros((*lead, k, r, sd, sd), device=device),
        mu=torch.full((*lead, k, r), 1.0 / r, device=device),
        **_bookkeeping(k, lead, device))


@functools.lru_cache(maxsize=32)
def _joint_event_tables(n: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Enumerate every joint association event for N measurements x K tracks.

    An event assigns each measurement to one track or to clutter, with each
    track taking at most one measurement.  Returns

    - onehot [E, N, K] float32: onehot[e, n, k] = 1 iff event e assigns
      measurement n to track k;
    - n_clutter [E] float32: number of clutter-assigned measurements.

    E = sum_m C(N, m) * P(K, m); 209 events for the default N = K = 4.
    """
    # guard before enumerating: E in closed form, so an oversize (n, k)
    # raises at once; construction is O(E) (subsets x permutations)
    e = sum(math.comb(n, m) * math.perm(k, m) for m in range(min(n, k) + 1))
    if e > 200_000:
        raise ValueError(
            f"exact JPDA event table has {e} events for N={n}, K={k}; "
            "use joint_association='cheap' at this scale")
    onehot = np.zeros((e, n, k), np.float32)
    n_clutter = np.zeros((e,), np.float32)
    ei = 0
    for m in range(min(n, k) + 1):
        for subset in itertools.combinations(range(n), m):
            for perm in itertools.permutations(range(k), m):
                for ni, ki in zip(subset, perm):
                    onehot[ei, ni, ki] = 1.0
                n_clutter[ei] = n - m
                ei += 1
    assert ei == e, (ei, e)
    return onehot, n_clutter


def _inv_det(s):
    """Closed-form inverse and determinant of tiny SPD matrices [..., d, d]
    (2x2 / 3x3 adjugate)."""
    d = s.shape[-1]
    if d == 2:
        det = (s[..., 0, 0] * s[..., 1, 1]
               - s[..., 0, 1] * s[..., 1, 0]).clamp_min(1e-12)
        inv = torch.stack([
            torch.stack([s[..., 1, 1], -s[..., 0, 1]], -1),
            torch.stack([-s[..., 1, 0], s[..., 0, 0]], -1),
        ], -2) / det[..., None, None]
        return inv, det
    if d == 3:
        a, b, c = s[..., 0, 0], s[..., 0, 1], s[..., 0, 2]
        dd, e, f = s[..., 1, 0], s[..., 1, 1], s[..., 1, 2]
        g, h, i = s[..., 2, 0], s[..., 2, 1], s[..., 2, 2]
        co00 = e * i - f * h
        co01 = f * g - dd * i
        co02 = dd * h - e * g
        det = (a * co00 + b * co01 + c * co02).clamp_min(1e-15)
        adj = torch.stack([
            torch.stack([co00, c * h - b * i, b * f - c * e], -1),
            torch.stack([co01, a * i - c * g, c * dd - a * f], -1),
            torch.stack([co02, b * g - a * h, a * e - b * dd], -1),
        ], -2)
        return adj / det[..., None, None], det
    det = torch.linalg.det(s).clamp_min(1e-15)
    return torch.linalg.inv_ex(s)[0], det


def _eye(dim: int, device):
    return torch.eye(dim, dtype=torch.float32, device=device)


def _transition(dt, dim):
    """The constant-velocity transition F [..., 2d, 2d] over dt [...]."""
    return _eye(2 * dim, dt.device) + dt[..., None, None] * torch.diag(
        torch.ones(dim, device=dt.device), diagonal=dim)


def _predict(x, p, dt, q, dim):
    """CV-model predict: x [..., 2d], p [..., 2d, 2d], dt [...]; ``q`` a
    float or a tensor broadcastable to dt."""
    f = _transition(dt, dim)
    # white-noise-acceleration Q per axis
    dtm = dt[..., None, None]
    eye = _eye(dim, x.device)
    d3 = dtm * dtm * dtm / 3.0
    d2 = dtm * dtm / 2.0
    qm = torch.cat([torch.cat([d3 * eye, d2 * eye], dim=-1),
                    torch.cat([d2 * eye, dtm * eye], dim=-1)], dim=-2)
    if isinstance(q, torch.Tensor):
        q = q[..., None, None]
    xn = (f @ x[..., None])[..., 0]
    pn = f @ p @ f.mT + q * qm
    return xn, pn


def _meas_cov(cfg: TrackerConfig, r, device):
    """The measurement-noise covariance [..., d, d]: ``r`` as float32, or
    the isotropic cfg.measurement_noise**2 I."""
    if r is None:
        return cfg.measurement_noise ** 2 * _eye(cfg.dim, device)
    return r.to(torch.float32)


def _coast(state, t, cfg: TrackerConfig):
    """Drop active tracks not assigned for longer than max_coast_s:
    (active, dropped)."""
    stale = state.active & ((t[..., None] - state.last_t) > cfg.max_coast_s)
    return (state.active & ~stale,
            state.dropped + stale.sum(dim=-1, dtype=torch.int32))


def _predict_all(state: TrackState, t, cfg: TrackerConfig, r=None):
    """Coast-drop and predict every active track to time t [...]; returns
    the predicted states and the innovation covariance S = HPH' + R
    [..., K, d, d] with its inverse and determinant.  ``r`` [..., d, d]
    measurement-noise covariance (default the isotropic one)."""
    dim = cfg.dim
    r = _meas_cov(cfg, r, state.x.device)
    active, dropped = _coast(state, t, cfg)
    # predict from the time the STORED state refers to (TrackState.state_t)
    dt = (t[..., None] - state.state_t).clamp_min(0.0) * active  # [..., K]
    xp, pp = _predict(state.x, state.p, dt, cfg.process_noise, dim)
    s = pp[..., :dim, :dim] + r[..., None, :, :]
    sinv, det = _inv_det(s)
    return active, dropped, xp, pp, s, sinv, det


def _spawn_cov(cfg: TrackerConfig, r=None, rv=None, device="cpu"):
    """Covariance of a fresh track [..., 2d, 2d]: blocks r and rv."""
    dim = cfg.dim
    if r is None:
        r = cfg.measurement_noise ** 2 * _eye(dim, device)
    if rv is None:
        rv = cfg.init_vel_std ** 2 * _eye(dim, device)
    r, rv = torch.broadcast_tensors(r.to(torch.float32),
                                    rv.to(torch.float32))
    z = torch.zeros_like(r)
    return torch.cat([torch.cat([r, z], dim=-1),
                      torch.cat([z, rv], dim=-1)], dim=-2)


def _gain(pp, sinv, dim):
    """Kalman gain K = P H^T S^-1 (H = position selector) [..., K, 2d, d]."""
    return pp[..., :, :dim] @ sinv


def _maha2(innov, sinv):
    """innov' S^-1 innov over the last axis: [..., d] x [..., d, d]."""
    return torch.einsum("...i,...ij,...j->...", innov, sinv, innov)


def _associate(maha2, det, active, valid, cfg: TrackerConfig):
    """Association weights of one measurement per bank: (b [..., K], the
    slots it is assigned to [..., K], whether it spawns a track [...],
    ``terms``).  ``terms`` holds the values the decisions threshold."""
    k, dim = cfg.max_tracks, cfg.dim
    maha2 = torch.where(active, maha2, torch.inf)
    best = torch.argmin(maha2, dim=-1)
    gated = active & (maha2 <= cfg.gate_maha2)
    terms = {"maha2": maha2}
    if cfg.association == "soft":
        # posterior over {track 1..K, clutter}: b_k ~ Pd N(innov_k; 0, S_k),
        # b0 ~ clutter density
        like = torch.where(
            gated, torch.exp(-0.5 * maha2.clamp_max(80.0))
            / ((2.0 * math.pi) ** (dim / 2.0) * torch.sqrt(det)), 0.0)
        denom = cfg.clutter_density + cfg.detect_prob * like.sum(dim=-1)
        b = valid[..., None] * cfg.detect_prob * like / denom[..., None]
        b0 = torch.where(valid, cfg.clutter_density / denom, 1.0)
        terms.update(b=b, b0=b0)
        return b, b > 0.5, valid & (b0 > cfg.spawn_b0), terms
    # hard nearest-neighbour: b is the one-hot winner, which reduces the
    # weighted update to the plain Kalman update
    can_assoc = valid & gated.gather(-1, best[..., None])[..., 0]
    slot_sel = (torch.arange(k, device=maha2.device) == best[..., None]) & (
        can_assoc[..., None])
    return slot_sel.to(torch.float32), slot_sel, valid & ~can_assoc, terms


def _first_true(mask):
    """Index of the first True along the last axis (0 where none)."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _assigned(slot_sel):
    """The slot a measurement was assigned to, -1 where none [...]."""
    return torch.where(slot_sel.any(dim=-1), _first_true(slot_sel),
                       -1).to(torch.int32)


def _book(state, active, hits, last_t) -> dict:
    """A bank's bookkeeping fields after association, before spawning."""
    return dict(active=active, hits=hits, last_t=last_t,
                born_t=state.born_t, track_id=state.track_id,
                next_id=state.next_id, unassigned=state.unassigned)


def _spawn(book: dict, spawn, t, k: int):
    """A measurement that spawns takes the first free slot, if any.
    Returns the slot mask [..., K] and the updated bookkeeping."""
    free = ~book["active"]
    have_free = free.any(dim=-1)
    do_spawn = spawn & have_free
    sm = (torch.arange(k, device=free.device)
          == _first_true(free)[..., None]) & do_spawn[..., None]
    t_k = t[..., None]
    return sm, dict(
        active=book["active"] | sm,
        hits=book["hits"].masked_fill(sm, 1),
        last_t=torch.where(sm, t_k, book["last_t"]),
        born_t=torch.where(sm, t_k, book["born_t"]),
        track_id=torch.where(sm, book["next_id"][..., None],
                             book["track_id"]),
        next_id=book["next_id"] + do_spawn.to(torch.int32),
        unassigned=book["unassigned"] + (spawn & ~have_free).to(torch.int32))


def _outputs(x_hat, book: dict, assigned, cfg: TrackerConfig) -> dict:
    dim = cfg.dim
    return {
        "track_xy": x_hat[..., :dim],
        "track_vel": x_hat[..., dim:],
        "track_active": book["active"],
        "track_confirmed": book["active"] & (book["hits"]
                                             >= cfg.confirm_hits),
        "track_id": book["track_id"],
        "assigned": assigned,
    }


def _as_time(t, like):
    return torch.as_tensor(t, dtype=torch.float32, device=like.device)


def step(state: TrackState, z, t, valid, cfg: TrackerConfig, z_cov=None,
         z_vel=None, v_cov=None):
    """One event-driven tracker update of every bank: (new state, outputs).

    ``z`` [..., d] measured position, ``t`` [...] seconds, ``valid`` [...]
    bool (is this a real measurement).  ``z_cov`` [..., d, d] (optional) is
    this measurement's noise covariance, e.g. the localizer's ``xy_cov``,
    in place of the isotropic cfg.measurement_noise.  ``z_vel`` [..., d]
    (optional) is a velocity measurement, applied as a sequential Kalman
    update after the position update; a spawned track starts from it.
    ``v_cov`` overrides cfg.velocity_noise.

    Outputs: 'track_xy' / 'track_vel' [..., K, d], 'track_active' /
    'track_confirmed' [..., K] bool, 'track_id' [..., K] int32 and
    'assigned' [...] int32, the slot updated by this measurement (-1 none).
    """
    return _step(state, z, t, valid, cfg, z_cov, z_vel, v_cov)[:2]


def _step(state, z, t, valid, cfg, z_cov=None, z_vel=None, v_cov=None):
    """:func:`step` and the values its decisions threshold."""
    k, dim = cfg.max_tracks, cfg.dim
    dev = state.x.device
    z = z.to(torch.float32)
    t = _as_time(t, state.x)
    r = None if z_cov is None else z_cov.to(torch.float32)
    active, dropped, xp, pp, _, sinv, det = _predict_all(state, t, cfg, r)
    innov = z[..., None, :] - xp[..., :dim]  # [..., K, d]
    b, slot_sel, spawn, terms = _associate(_maha2(innov, sinv), det, active,
                                           valid, cfg)

    # weighted Kalman update of every gated track, weight b_k
    gain = _gain(pp, sinv, dim)  # [..., K, 2d, d]
    ky = (gain @ innov[..., None])[..., 0]  # [..., K, 2d]
    x_new = xp + b[..., None] * ky
    ksk = gain @ pp[..., :dim, :]  # K S K^T
    # PDA covariance: P- - b KSK' + b(1-b) (Ky)(Ky)' (zero spread in hard
    # mode, where b is 0 or 1)
    spread = (b * (1.0 - b))[..., None, None] * (
        ky[..., :, None] * ky[..., None, :])
    p_new = pp - b[..., None, None] * ksk + spread

    rv = None
    if z_vel is not None:
        # sequential velocity-measurement update on the position-updated
        # state (exact for block-diagonal R), same weights b
        zv = z_vel.to(torch.float32)
        rv = (cfg.velocity_noise ** 2 * _eye(dim, dev) if v_cov is None
              else v_cov.to(torch.float32))
        sv = p_new[..., dim:, dim:] + rv[..., None, :, :]
        svinv, _ = _inv_det(sv)
        kv = p_new[..., :, dim:] @ svinv
        iv = zv[..., None, :] - x_new[..., dim:]
        kyv = (kv @ iv[..., None])[..., 0]
        x_new = x_new + b[..., None] * kyv
        kskv = kv @ p_new[..., dim:, :]
        spreadv = (b * (1.0 - b))[..., None, None] * (
            kyv[..., :, None] * kyv[..., None, :])
        p_new = p_new - b[..., None, None] * kskv + spreadv

    hits = state.hits + slot_sel.to(torch.int32)
    last_t = torch.where(slot_sel, t[..., None], state.last_t)

    # an unexplained measurement takes a free slot
    sm, book = _spawn(_book(state, active, hits, last_t), spawn, t, k)
    x0 = torch.cat([z, torch.zeros_like(z) if z_vel is None
                    else z_vel.to(torch.float32)], dim=-1)
    p0 = _spawn_cov(cfg, r, rv, dev)
    x_new = torch.where(sm[..., None], x0[..., None, :], x_new)
    p_new = torch.where(sm[..., None, None], p0[..., None, :, :], p_new)

    # inactive slots keep their stored time (no huge dt on reuse)
    new_state = TrackState(
        x=x_new, p=p_new, state_t=torch.where(book["active"], t[..., None],
                                              state.state_t),
        dropped=dropped, **book)
    terms["coast"] = t[..., None] - state.last_t
    terms["active_before"] = state.active
    return new_state, _outputs(x_new, book, _assigned(slot_sel), cfg), terms


# ----------------------------------------------------------------------
# IMM (interacting multiple model) bank
# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _imm_arrays(cfg: TrackerConfig) -> tuple[np.ndarray, np.ndarray]:
    """(per-mode process noise [R], Markov transition matrix pi [R, R] with
    pi[i, j] = P(mode i -> mode j)), as arrays kept for device_constant."""
    return (np.asarray(cfg.imm_q, np.float32), _imm_transition(cfg))


def _imm_transition(cfg: TrackerConfig) -> np.ndarray:
    r = len(cfg.imm_q)
    if r == 1:
        return np.ones((1, 1), np.float32)
    off = (1.0 - cfg.imm_stay) / (r - 1)
    pi = np.full((r, r), off, np.float32)
    np.fill_diagonal(pi, cfg.imm_stay)
    return pi


def step_imm(state: ImmTrackState, z, t, valid, cfg: TrackerConfig,
             z_cov=None):
    """One event-driven IMM update (Blom & Bar-Shalom 1988) of every bank:
    per active track (1) mix the mode-conditioned estimates under the
    transition prior, (2) predict each mode with its process noise, (3)
    gate and associate on the moment-matched mixture (:func:`step`'s
    rules), (4) weighted Kalman update per mode, (5) reweight the modes by
    their measurement likelihoods.

    Outputs as :func:`step` plus 'model_prob' [..., K, R]."""
    return _step_imm(state, z, t, valid, cfg, z_cov)[:2]


def _step_imm(state, z, t, valid, cfg, z_cov=None):
    k, dim = cfg.max_tracks, cfg.dim
    dev = state.xm.device
    q_np, pi_np = _imm_arrays(cfg)
    qvec, pi = device_constant(q_np, dev), device_constant(pi_np, dev)
    z = z.to(torch.float32)
    t = _as_time(t, state.xm)
    r_meas = _meas_cov(cfg, z_cov, dev)
    active, dropped = _coast(state, t, cfg)

    # 1) interaction / mixing
    cbar = torch.einsum("...ki,ij->...kj", state.mu, pi)  # [..., K, R]
    mucond = (state.mu[..., :, :, None] * pi) / cbar.clamp_min(
        1e-12)[..., :, None, :]
    x0 = torch.einsum("...kij,...kid->...kjd", mucond, state.xm)
    dx = state.xm[..., :, :, None, :] - x0[..., :, None, :, :]
    p0 = (torch.einsum("...kij,...kide->...kjde", mucond, state.pm)
          + torch.einsum("...kij,...kijd,...kije->...kjde", mucond, dx, dx))

    # 2) per-mode predict from the stored filters' time
    dt = (t[..., None] - state.state_t).clamp_min(0.0) * active  # [..., K]
    xp, pp = _predict(x0, p0, dt[..., None], qvec, dim)  # [..., K, R, ...]
    r_m = r_meas[..., None, None, :, :]
    sinv_m, det_m = _inv_det(pp[..., :dim, :dim] + r_m)

    # 3) association on the moment-matched mixture
    xbar = torch.einsum("...kj,...kjd->...kd", cbar, xp)  # [..., K, 2d]
    dpos = xp[..., :dim] - xbar[..., None, :dim]
    pbar_pos = (torch.einsum("...kj,...kjde->...kde", cbar,
                             pp[..., :dim, :dim])
                + torch.einsum("...kj,...kjd,...kje->...kde", cbar, dpos,
                               dpos))
    sinv_bar, det_bar = _inv_det(pbar_pos + r_meas[..., None, :, :])
    innov_bar = z[..., None, :] - xbar[..., :dim]
    b, slot_sel, spawn, terms = _associate(
        _maha2(innov_bar, sinv_bar), det_bar, active, valid, cfg)

    # 4) weighted Kalman update per mode
    innov_m = z[..., None, None, :] - xp[..., :dim]  # [..., K, R, d]
    gain = _gain(pp, sinv_m, dim)
    ky = (gain @ innov_m[..., None])[..., 0]  # [..., K, R, 2d]
    bw = b[..., None]  # [..., K, 1]
    x_new = xp + bw[..., None] * ky
    ksk = gain @ pp[..., :dim, :]
    spread = (bw * (1.0 - bw))[..., None, None] * (
        ky[..., :, None] * ky[..., None, :])
    p_new = pp - bw[..., None, None] * ksk + spread

    # 5) mode probabilities: tracks that took the measurement reweight,
    # the others keep the prior mix
    lam = (torch.exp(-0.5 * _maha2(innov_m, sinv_m).clamp_max(80.0))
           / ((2.0 * math.pi) ** (dim / 2.0) * torch.sqrt(det_m)))
    mu_meas = cbar * lam.clamp_min(1e-30)
    mu_meas = mu_meas / mu_meas.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    mu_new = torch.where(slot_sel[..., None], mu_meas, cbar)
    mu_new = mu_new / mu_new.sum(dim=-1, keepdim=True).clamp_min(1e-30)

    hits = state.hits + slot_sel.to(torch.int32)
    last_t = torch.where(slot_sel, t[..., None], state.last_t)

    # spawn: all modes identical, uniform beliefs
    sm, book = _spawn(_book(state, active, hits, last_t), spawn, t, k)
    x0s = torch.cat([z, torch.zeros_like(z)], dim=-1)
    p0s = _spawn_cov(cfg, None if z_cov is None else r_meas, None, dev)
    x_new = torch.where(sm[..., None, None], x0s[..., None, None, :], x_new)
    p_new = torch.where(sm[..., None, None, None],
                        p0s[..., None, None, :, :], p_new)
    mu_new = torch.where(sm[..., None], 1.0 / len(cfg.imm_q), mu_new)

    new_state = ImmTrackState(
        xm=x_new, pm=p_new, mu=mu_new,
        state_t=torch.where(book["active"], t[..., None], state.state_t),
        dropped=dropped, **book)
    x_hat = torch.einsum("...kr,...krd->...kd", mu_new, x_new)
    out = _outputs(x_hat, book, _assigned(slot_sel), cfg)
    out["model_prob"] = mu_new
    terms["coast"] = t[..., None] - state.last_t
    terms["active_before"] = state.active
    return new_state, out, terms


def step_multi(state: TrackState, zs, t, valids, cfg: TrackerConfig,
               z_covs=None):
    """Joint (JPDA) update of every bank with N simultaneous measurements
    zs [..., N, d] (valids [..., N] bool): the regime a multi-event chunk
    produces, where serial single-measurement steps could update one track
    twice.

    Association weights (``cfg.joint_association``): 'cheap', Fitzgerald's
    normalization b[n,k] = L[n,k] / (sum_k' L[n,k'] + sum_n' L[n',k] -
    L[n,k] + B) with B = clutter_density / detect_prob; 'exact', every
    joint association event of the constant table weighted by
    prod L[n,k] * B^{#clutter} and marginalized.  Both reduce to the soft
    single-measurement posterior at N = 1.  Each track is updated once with
    its combined weighted innovation; unexplained measurements spawn into
    free slots in order.  ``z_covs`` [..., N, d, d] gives each measurement
    its own noise covariance (per-(measurement, track) gains).

    Outputs as :func:`step`, plus 'beta' [..., N, K]; 'assigned' is
    [..., N] (dominant track per measurement, -1 if none above 0.5)."""
    return _step_multi(state, zs, t, valids, cfg, z_covs)[:2]


def _step_multi(state, zs, t, valids, cfg, z_covs=None):
    k, dim = cfg.max_tracks, cfg.dim
    n = zs.shape[-2]
    dev = state.x.device
    zs = zs.to(torch.float32)
    t = _as_time(t, state.x)
    valids = valids.to(torch.bool)

    active, dropped, xp, pp, _, sinv_k, det_k = _predict_all(state, t, cfg)
    innov = zs[..., :, None, :] - xp[..., None, :, :dim]  # [..., N, K, d]
    if z_covs is not None:
        # heterogeneous R: innovation covariance per (measurement, track)
        sinv, det = _inv_det(pp[..., None, :, :dim, :dim]
                             + z_covs.to(torch.float32)[..., :, None, :, :])
    else:
        sinv, det = sinv_k[..., None, :, :, :], det_k[..., None, :]
    maha2 = _maha2(innov, sinv)  # [..., N, K]
    gated = (active[..., None, :] & (maha2 <= cfg.gate_maha2)
             & valids[..., :, None])
    like = torch.where(
        gated, torch.exp(-0.5 * maha2.clamp_max(80.0))
        / ((2.0 * math.pi) ** (dim / 2.0) * torch.sqrt(det)), 0.0)
    b_const = cfg.clutter_density / cfg.detect_prob
    if cfg.joint_association == "exact":
        # log-weight of event e = sum_{n assigned k} log L[n,k] + (#clutter
        # in e) log(lambda / Pd); gated-out cells get -1e30 so any event
        # using them vanishes (the all-clutter event is always finite)
        onehot_np, nclut_np = _joint_event_tables(n, k)
        onehot = device_constant(onehot_np, dev)
        nclut = device_constant(nclut_np, dev)
        loglike = torch.where(like > 0.0,
                              torch.log(like.clamp_min(1e-38)), -1e30)
        logw = (torch.einsum("enk,...nk->...e", onehot, loglike)
                + nclut * math.log(b_const))
        beta = torch.einsum("...e,enk->...nk", torch.softmax(logw, dim=-1),
                            onehot)
    else:
        denom = (like.sum(dim=-1, keepdim=True)
                 + like.sum(dim=-2, keepdim=True) - like + b_const)
        beta = like / denom  # [..., N, K]

    # combined weighted Kalman update per track
    w_k = beta.sum(dim=-2)  # [..., K] total association probability
    if z_covs is None:
        ybar = torch.einsum("...nk,...nki->...ki", beta, innov)
        gain = _gain(pp, sinv_k, dim)  # [..., K, 2d, d]
        x_new = xp + (gain @ ybar[..., None])[..., 0]
        ksk = gain @ pp[..., :dim, :]
        # spread of innovations: K (sum_n b y y' - ybar ybar') K'
        yy = (torch.einsum("...nk,...nki,...nkj->...kij", beta, innov, innov)
              - ybar[..., :, None] * ybar[..., None, :])
        p_new = (pp - w_k[..., None, None] * ksk
                 + torch.einsum("...kij,...kjl,...kml->...kim", gain, yy,
                                gain))
    else:
        # per-(n, k) gains K_nk = P_k H' S_nk^-1 [..., N, K, 2d, d]
        gain_nk = pp[..., None, :, :, :dim] @ sinv
        ky = (gain_nk @ innov[..., None])[..., 0]  # [..., N, K, 2d]
        kybar = torch.einsum("...nk,...nki->...ki", beta, ky)
        x_new = xp + kybar
        # P = P- - sum_n b K S K' + (sum_n b Ky Ky' - kybar kybar'), with
        # K S K' = K (H P)
        ksk = gain_nk @ pp[..., None, :, :dim, :]
        p_new = (pp - torch.einsum("...nk,...nkil->...kil", beta, ksk)
                 + torch.einsum("...nk,...nki,...nkl->...kil", beta, ky, ky)
                 - kybar[..., :, None] * kybar[..., None, :])

    updated = w_k > 0.5
    hits = state.hits + updated.to(torch.int32)
    last_t = torch.where(updated, t[..., None], state.last_t)

    # unexplained measurements take free slots, in order
    leftover = 1.0 - beta.sum(dim=-1)  # [..., N] no-association posterior
    spawn_n = valids & (leftover > cfg.spawn_b0)
    p0 = _spawn_cov(cfg, device=dev)
    book = _book(state, active, hits, last_t)
    for i in range(n):  # unrolled over the (small) measurement count
        sm, book = _spawn(book, spawn_n[..., i], t, k)
        x0 = torch.cat([zs[..., i, :], torch.zeros_like(zs[..., i, :])],
                       dim=-1)
        x_new = torch.where(sm[..., None], x0[..., None, :], x_new)
        p_new = torch.where(sm[..., None, None], p0, p_new)

    new_state = TrackState(
        x=x_new, p=p_new,
        state_t=torch.where(book["active"], t[..., None], state.state_t),
        dropped=dropped, **book)
    out = _outputs(x_new, book, torch.where(
        beta.amax(dim=-1) > 0.5, torch.argmax(beta, dim=-1),
        -1).to(torch.int32), cfg)
    out["beta"] = beta
    terms = {"maha2": torch.where(active[..., None, :], maha2, torch.inf),
             "w_k": w_k, "leftover": leftover, "beta": beta,
             "coast": t[..., None] - state.last_t,
             "active_before": state.active}
    return new_state, out, terms


# ----------------------------------------------------------------------
# Offline trajectory smoothing (Rauch-Tung-Striebel)
# ----------------------------------------------------------------------

def rts_smooth(x, p, t, cfg: TrackerConfig = TrackerConfig()):
    """RTS smoother over recorded filter histories of single tracks.

    ``x`` [..., T, 2*dim], ``p`` [..., T, 2*dim, 2*dim] are a track's
    filtered posteriors at its event times ``t`` [..., T] (strictly
    increasing); record them after each step from ``state.x[..., k, :]`` /
    ``state.p[..., k, :, :]`` at the track's slot k (slots are stable while
    a track lives; match by ``state.track_id``).  The backward pass uses
    the forward filter's transition and process noise, so gaps in t are
    handled as the filter handles them.

    Returns smoothed (xs, ps) of the same shapes; the last entry equals the
    filtered one (the smoother's anchor)."""
    dim = x.shape[-1] // 2
    xs_n, ps_n = x[..., -1, :], p[..., -1, :, :]
    xs_out, ps_out = [xs_n], [ps_n]
    for i in range(x.shape[-2] - 2, -1, -1):  # the reverse scan
        xk, pk = x[..., i, :], p[..., i, :, :]
        dt = t[..., i + 1] - t[..., i]  # advances i -> i + 1
        xp, pp = _predict(xk, pk, dt, cfg.process_noise, dim)
        f = _transition(dt, dim)
        # C = P_k F' Pp^{-1}; all three symmetric, so one solve does it
        c = torch.linalg.solve_ex(pp, f @ pk)[0].mT
        xs_n = xk + (c @ (xs_n - xp)[..., None])[..., 0]
        ps_n = pk + c @ (ps_n - pp) @ c.mT
        ps_n = 0.5 * (ps_n + ps_n.mT)  # keep symmetric under f32 roundoff
        xs_out.append(xs_n)
        ps_out.append(ps_n)
    return (torch.stack(xs_out[::-1], dim=-2),
            torch.stack(ps_out[::-1], dim=-3))


@dataclasses.dataclass(frozen=True)
class Tracker:
    """Single- and multi-stream stepping of one bank configuration on
    ``device`` (the card unless the caller asks for the CPU).  Inputs may
    be arrays or tensors; they are taken to the device as float32."""

    cfg: TrackerConfig = TrackerConfig()
    device: str = "cuda"

    def init(self):
        if self.cfg.imm_q:
            return init_state_imm(self.cfg, self.device)
        return init_state(self.cfg, self.device)

    def init_many(self, n_streams: int):
        lead = (n_streams,)
        if self.cfg.imm_q:
            return init_state_imm(self.cfg, self.device, lead)
        return init_state(self.cfg, self.device, lead)

    def _f32(self, v):
        return None if v is None else torch.as_tensor(
            np.asarray(v, np.float32) if not isinstance(v, torch.Tensor)
            else v, dtype=torch.float32, device=self.device)

    def _valid(self, v):
        return torch.as_tensor(
            np.asarray(v, bool) if not isinstance(v, torch.Tensor) else v,
            dtype=torch.bool, device=self.device)

    def step(self, state, z, t, valid=True, z_cov=None, z_vel=None,
             v_cov=None):
        """``z_cov`` [d, d] (e.g. the localizer's per-event ``xy_cov``)
        replaces cfg.measurement_noise for this measurement; ``z_vel`` [d]
        adds a sequential velocity-measurement update, with ``v_cov``
        [d, d] overriding cfg.velocity_noise."""
        if v_cov is not None and z_vel is None:
            # v_cov only qualifies a velocity measurement; without z_vel it
            # would be silently ignored
            raise ValueError("v_cov requires z_vel (it is the noise of the "
                             "velocity measurement, not a standalone input)")
        if self.cfg.imm_q and z_vel is not None:
            raise ValueError("z_vel is not supported with the IMM bank "
                             "(imm_q); use the single-model tracker for "
                             "velocity-measurement fusion")
        return self.step_many(state, z, t, valid, z_cov, z_vel, v_cov)

    def step_many(self, states, zs, ts, valids, z_covs=None, z_vels=None,
                  v_covs=None):
        """The same update on banks stacked on leading stream axes: zs
        [..., d], ts [...], valids [...]; z_covs (optional) [..., d, d]."""
        args = (states, self._f32(zs), self._f32(ts), self._valid(valids),
                self.cfg)
        if self.cfg.imm_q:
            return step_imm(*args, z_cov=self._f32(z_covs))
        return step(*args, z_cov=self._f32(z_covs), z_vel=self._f32(z_vels),
                    v_cov=self._f32(v_covs))

    def smooth(self, x, p, t):
        """Offline RTS smoothing of one track's recorded filter history
        (see :func:`rts_smooth`): x [T, 2*dim], p [T, 2*dim, 2*dim], t [T]
        -> smoothed (xs, ps)."""
        return rts_smooth(self._f32(x), self._f32(p), self._f32(t), self.cfg)

    def step_multi(self, state, zs, t, valids=None, z_covs=None):
        """Joint JPDA update with N simultaneous measurements: zs [..., N,
        d]; z_covs (optional) [..., N, d, d] per-measurement noise."""
        if self.cfg.imm_q:
            raise ValueError("step_multi is not supported with the IMM "
                             "bank (imm_q); use association='soft' with "
                             "per-measurement step calls instead")
        zs = self._f32(zs)
        if valids is None:
            valids = torch.ones(zs.shape[:-1], dtype=torch.bool,
                                device=self.device)
        return step_multi(state, zs, self._f32(t), self._valid(valids),
                          self.cfg, z_covs=self._f32(z_covs))
