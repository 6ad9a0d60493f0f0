"""TDOA source solvers: damped Gauss-Newton on the sphere or plane model,
its position covariance, the free 3-D solve, the joint solve of positions
and clock offsets across unsynchronised arrays and the far-field bearing.

Counterpart of ``audio_triangulation_tpu.ops.solver``.  In the
constrained solves the source lies on the radius-h sphere around the array
center or on the z = h plane; residuals are r_p = (|x - m_j| - |x - m_i|)
- c tau_p.  The batched iterations work on the M-space sufficient
statistics Q = S^T W S and t2 = S^T W t of the +-1 pair-difference matrix
S, so no [B, P] tensor is formed per step.  ``robust='huber'|'cauchy'``
adds IRLS rounds.  Runs in fp32 (TF32 off on CUDA); the small linear
systems go through ``torch.linalg.solve_ex``, which, unlike
``torch.linalg.solve``, does not wait for the device to check its result.
"""

from __future__ import annotations

import torch

from ..core.config import SolverConfig
from . import consistency


def lift_to_model(xy: torch.Tensor, height: float,
                  constrain_sphere: bool) -> torch.Tensor:
    """Planar coords [..., 2] -> 3-D source model points [..., 3]."""
    raw = torch.cat([xy, torch.full_like(xy[..., :1], height)], dim=-1)
    if constrain_sphere:
        r = torch.linalg.vector_norm(raw, dim=-1, keepdim=True)
        return raw * (height / r.clamp_min(1e-12))
    return raw


def predicted_tdoas(xy: torch.Tensor, mic_pos3: torch.Tensor,
                    pairs: torch.Tensor, speed_of_sound: float,
                    height: float, constrain_sphere: bool = True):
    """Model TDOAs [..., P] (seconds) for planar source coords [..., 2]."""
    p3 = lift_to_model(xy, height, constrain_sphere)
    d = torch.linalg.vector_norm(p3[..., None, :] - mic_pos3, dim=-1)
    dt = d[..., pairs[:, 1].long()] - d[..., pairs[:, 0].long()]
    return dt / speed_of_sound


def solve_tdoa(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    speed_of_sound: float,
    height: float,
    init_xy: torch.Tensor,
    weights: torch.Tensor | None = None,
    cfg: SolverConfig = SolverConfig(),
):
    """Damped Gauss-Newton TDOA solve of one frame, the Jacobian by forward
    differentiation.  tdoas [P] seconds, init_xy [2] (typically the SRP
    grid peak), ``weights`` [P] -> (xy [2], rms residual in meters)."""
    mic3 = _mic3(mic_positions, init_xy.dtype)
    c = speed_of_sound

    def residual(xy):
        pred = predicted_tdoas(xy, mic3, pairs, c, height,
                               cfg.constrain_to_sphere)
        r = (pred - tdoas) * c  # meters
        return r if weights is None else r * weights

    damp = cfg.damping * torch.eye(2, dtype=init_xy.dtype,
                                   device=init_xy.device)
    xy = init_xy
    for _ in range(cfg.iterations):
        r = residual(xy)
        jac = torch.func.jacfwd(residual)(xy)  # [P, 2]
        delta = torch.linalg.solve_ex(jac.T @ jac + damp,
                                      (jac.T @ r)[:, None])[0][:, 0]
        xy = xy - delta
    r = residual(xy)
    return xy, torch.sqrt(torch.mean(r * r))


def _mic3(mic_positions: torch.Tensor, dt) -> torch.Tensor:
    m = mic_positions.shape[0]
    mic3 = torch.zeros((m, 3), dtype=dt, device=mic_positions.device)
    mic3[:, : mic_positions.shape[1]] = mic_positions.to(dt)
    return mic3


def _dist_grad(xy, h, mic3, sphere):
    """Distances d [..., M] and their gradients [..., M, 2] w.r.t. xy."""
    v = torch.cat([xy, torch.full_like(xy[..., :1], h)], dim=-1)
    # d(x, y, h)/d(x, y); built on the device (writing Python scalars into
    # a CUDA tensor would copy each from host memory and sync the stream)
    e = torch.eye(3, 2, dtype=xy.dtype, device=xy.device)
    if sphere:
        nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        vhat = v / nv.clamp_min(1e-12)
        s = h * vhat
        scale = h / nv.clamp_min(1e-12)
        js = scale[..., None] * (e - vhat[..., None] * vhat[..., None, :2])
    else:
        s = v
        js = e.expand(*xy.shape[:-1], 3, 2)
    diff = s[..., None, :] - mic3
    d = torch.linalg.vector_norm(diff, dim=-1)
    u = diff / d.clamp_min(1e-12)[..., None]
    return d, torch.einsum("...mi,...ij->...mj", u, js)


def solve_tdoa_batched(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    speed_of_sound: float,
    height: float,
    init_xy: torch.Tensor,
    weights: torch.Tensor | None = None,
    cfg: SolverConfig = SolverConfig(),
):
    """tdoas [B, P] seconds, init_xy [B, 2] -> (xy [B, 2], rms [B] meters).
    ``weights`` (standard-deviation style, squared inside) are per pair [P]
    or per row and pair [B, P]."""
    dt = init_xy.dtype
    m = mic_positions.shape[0]
    mic3 = _mic3(mic_positions, dt)
    h = float(height)
    target = tdoas.to(dt) * speed_of_sound  # [B, P] meters
    sel = consistency.pair_selection(pairs, m, dt)  # [P, M]
    w2 = None if weights is None else (weights * weights).to(dt)
    if w2 is not None and w2.ndim > 1:  # per-row weights [B, P]
        q = torch.einsum("pm,pn,...p->...mn", sel, sel, w2)  # [B, M, M]
        t2 = torch.einsum("pm,...p,...p->...m", sel, w2, target)
    else:
        sel_w = sel if w2 is None else sel * w2[:, None]
        q = sel.T @ sel_w  # [M, M]
        t2 = torch.einsum("pm,...p->...m", sel_w, target)  # [B, M]

    def gn_loop(q_, t2_, xy):
        for _ in range(cfg.iterations):
            d, gd = _dist_grad(xy, h, mic3, cfg.constrain_to_sphere)
            qgd = torch.einsum("...mn,...nj->...mj", q_, gd)
            a = torch.einsum("...mi,...mj->...ij", gd, qgd)
            qd = torch.einsum("...mn,...n->...m", q_, d)
            b = torch.einsum("...mi,...m->...i", gd, qd - t2_)
            a00 = a[..., 0, 0] + cfg.damping
            a11 = a[..., 1, 1] + cfg.damping
            a01 = a[..., 0, 1]
            det = a00 * a11 - a01 * a01
            inv_det = 1.0 / torch.where(det.abs() > 1e-20, det,
                                        torch.full_like(det, 1e-20))
            dx = (a11 * b[..., 0] - a01 * b[..., 1]) * inv_det
            dy = (a00 * b[..., 1] - a01 * b[..., 0]) * inv_det
            xy = xy - torch.stack([dx, dy], dim=-1)
        return xy

    def pair_residual(xy, weighted=True):
        d, _ = _dist_grad(xy, h, mic3, cfg.constrain_to_sphere)
        r = torch.einsum("pm,...m->...p", sel, d) - target
        return r if (weights is None or not weighted) else r * weights

    xy = gn_loop(q, t2, init_xy)

    if cfg.robust != "none":
        base_w2 = (torch.ones(pairs.shape[0], dtype=dt, device=xy.device)
                   if w2 is None else w2)
        for _ in range(cfg.irls_iterations):
            # robust weights and the MAD scale come from the raw residual
            ar = pair_residual(xy, weighted=False).abs()
            if cfg.robust_scale_m > 0:
                delta = torch.tensor(cfg.robust_scale_m, dtype=dt,
                                     device=xy.device)
            else:
                # 1.4826 * MAD; quantile(0.5) averages the two middle
                # values of an even count, like numpy's median
                delta = (1.345 * 1.4826) * torch.quantile(
                    ar, 0.5, dim=-1, keepdim=True).clamp_min(1e-6)
            if cfg.robust == "huber":
                w_rob = torch.clamp(delta / ar.clamp_min(1e-12), max=1.0)
            elif cfg.robust == "cauchy":
                w_rob = 1.0 / (1.0 + (ar / delta) ** 2)
            else:
                raise ValueError(f"unknown robust mode {cfg.robust!r}")
            w2_tot = base_w2 * w_rob  # [B, P]
            q_b = torch.einsum("pm,pn,...p->...mn", sel, sel, w2_tot)
            t2_b = torch.einsum("pm,...p,...p->...m", sel, w2_tot, target)
            xy = gn_loop(q_b, t2_b, xy)

    r = pair_residual(xy)
    rms = torch.sqrt(torch.mean(r * r, dim=-1))
    return xy, rms


def solution_covariance(
    xy: torch.Tensor,
    rms: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    height: float,
    n_pairs: int | None = None,
    cfg: SolverConfig = SolverConfig(),
    min_sigma_m: float = 1e-4,
) -> torch.Tensor:
    """Position covariance sigma^2 (J^T J + damping)^-1 [..., 2, 2] at the
    solution, sigma^2 = P rms^2 / (P - 2) with sigma floored at
    ``min_sigma_m``."""
    dt = xy.dtype
    m = mic_positions.shape[0]
    mic3 = _mic3(mic_positions, dt)
    p_count = int(pairs.shape[0]) if n_pairs is None else int(n_pairs)
    sel = consistency.pair_selection(pairs, m, dt)
    q = sel.T @ sel
    _, gd = _dist_grad(xy, float(height), mic3, cfg.constrain_to_sphere)
    qgd = torch.einsum("mn,...nj->...mj", q, gd)
    a = torch.einsum("...mi,...mj->...ij", gd, qgd)
    dof = max(p_count - 2, 1)
    sigma2 = rms.clamp_min(min_sigma_m) ** 2 * (p_count / dof)
    a00 = a[..., 0, 0] + cfg.damping
    a11 = a[..., 1, 1] + cfg.damping
    a01 = a[..., 0, 1]
    det = (a00 * a11 - a01 * a01).clamp_min(1e-20)
    inv = torch.stack([torch.stack([a11, -a01], dim=-1),
                       torch.stack([-a01, a00], dim=-1)], dim=-2)
    return sigma2[..., None, None] * (inv / det[..., None, None])


def solve_tdoa_xyz(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    speed_of_sound: float,
    init_xyz: torch.Tensor,
    iterations: int = 8,
    damping: float = 1e-3,
    z_min: float = 0.05,
):
    """Free 3-D damped Gauss-Newton TDOA solve (batched): the source is
    unconstrained in (x, y, z), z clamped to >= ``z_min`` after every step
    (a planar array cannot tell +-z apart).  tdoas [B, P] seconds,
    init_xyz [B, 3] -> (xyz [B, 3], rms [B] meters)."""
    dt = init_xyz.dtype
    m = mic_positions.shape[0]
    mic3 = _mic3(mic_positions, dt)
    target = tdoas.to(dt) * speed_of_sound
    sel = consistency.pair_selection(pairs, m, dt)  # [P, M]
    q = sel.T @ sel  # [M, M]
    t2 = torch.einsum("pm,...p->...m", sel, target)  # [B, M]
    damp = damping * torch.eye(3, dtype=dt, device=init_xyz.device)

    def dist_unit(xyz):
        diff = xyz[..., None, :] - mic3  # [B, M, 3]
        d = torch.linalg.vector_norm(diff, dim=-1)
        return d, diff / d.clamp_min(1e-12)[..., None]

    xyz = init_xyz
    for _ in range(iterations):
        d, u = dist_unit(xyz)
        qu = torch.einsum("mn,...nj->...mj", q, u)
        a = torch.einsum("...mi,...mj->...ij", u, qu) + damp
        qd = torch.einsum("mn,...n->...m", q, d)
        b = torch.einsum("...mi,...m->...i", u, qd - t2)
        xyz = xyz - torch.linalg.solve_ex(a, b[..., None])[0][..., 0]
        xyz = torch.cat([xyz[..., :2], xyz[..., 2:].clamp_min(z_min)],
                        dim=-1)
    d, _ = dist_unit(xyz)
    r = torch.einsum("pm,...m->...p", sel, d) - target  # final only
    return xyz, torch.sqrt(torch.mean(r * r, dim=-1))


def solve_tdoa_xyz_multistart(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    *,
    speed_of_sound: float,
    init_xy: torch.Tensor,
    z_inits: tuple = (0.4, 1.2, 2.0),
    iterations: int = 40,
    damping: float = 1e-4,
    z_min: float = 0.05,
):
    """Free 3-D solve from a few starting heights, keeping each row's
    lowest-residual start: from one height GN stalls on nearly overhead
    sources, where range enters only through the wavefront's curvature.
    The starts run as one batched solve.  tdoas [B, P] seconds, init_xy
    [B, 2] -> (xyz [B, 3], rms [B] meters)."""
    n_z, b = len(z_inits), init_xy.shape[0]
    # filled on the device: no host copy (a CUDA graph may capture this)
    z0 = torch.cat([torch.full((b, 1), z, dtype=init_xy.dtype,
                               device=init_xy.device) for z in z_inits])
    init = torch.cat([init_xy.repeat(n_z, 1), z0], dim=-1)
    xyz, rms = solve_tdoa_xyz(
        tdoas.repeat(n_z, 1), mic_positions, pairs,
        speed_of_sound=speed_of_sound, init_xyz=init, iterations=iterations,
        damping=damping, z_min=z_min)
    xyz, rms = xyz.reshape(n_z, b, 3), rms.reshape(n_z, b)
    pick = rms.argmin(dim=0)  # [B]
    rows = torch.arange(b, device=pick.device)
    return xyz[pick, rows], rms[pick, rows]


def solve_tdoa_sync(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    mic_array_id: torch.Tensor,
    n_arrays: int,
    *,
    speed_of_sound: float,
    height: float,
    init_xy: torch.Tensor,
    init_offsets_s: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
    event_times_s: torch.Tensor | None = None,
    iterations: int = 12,
    damping: float = 1e-3,
):
    """Joint positions of E events and clock offsets of arrays 1..K-1
    (array 0 is the time reference) from TDOAs over pairs of the
    concatenated mics, where a pair spanning arrays a(i) != a(j) reads
    tau = (|s - m_j| - |s - m_i|) / c + delta_a(j) - delta_a(i).  Damped
    Gauss-Newton on the plane model z = ``height``: each iteration
    eliminates the per-event 2 x 2 position blocks in closed form and
    solves the small shared Schur complement (``solve_ex``: no read back).
    With ``event_times_s`` [E] each clock error is delta_k + rho_k (t -
    mean t) and the drifts rho are solved too.

    tdoas [E, P] seconds, mic_positions [Mall, 2], mic_array_id [Mall],
    init_xy [E, 2], weights [P] (optional).  Returns (xy [E, 2], offsets_s
    [K-1], rms [E]), or (xy, offsets_s, drift_s_per_s [K-1], rms) with
    event times."""
    if n_arrays < 2:
        raise ValueError("solve_tdoa_sync needs >= 2 arrays")
    dt = init_xy.dtype
    dev = init_xy.device
    m = mic_positions.shape[0]
    mic3 = _mic3(mic_positions, dt)
    c = float(speed_of_sound)
    target = tdoas.to(dt) * c  # [E, P] meters
    kk = n_arrays - 1
    with_drift = event_times_s is not None
    n_shared = 2 * kk if with_drift else kk

    sel = consistency.pair_selection(pairs, m, dt)  # [P, M] +-1
    # offset-difference design D [P, K-1]: delta_a(j) - delta_a(i), delta_0 = 0
    a_of = mic_array_id.long()
    aj = a_of[pairs[:, 1].long()]
    ai = a_of[pairs[:, 0].long()]
    ks = torch.arange(1, n_arrays, device=dev)
    d_mat = ((aj[:, None] == ks).to(dt)
             - (ai[:, None] == ks).to(dt))  # [P, K-1]
    w = None if weights is None else weights.to(dt)  # [P]
    e_events = tdoas.shape[0]
    # the shared block's Jacobian [E, P, S]: c D, and c D (t - mean t) for
    # the drifts (centred times keep the two groups near-orthogonal)
    if with_drift:
        t = event_times_s.to(dt)
        t = t - t.mean()
        jd = torch.cat([
            (c * d_mat).expand(e_events, *d_mat.shape),
            c * d_mat * t[:, None, None]], dim=-1)
    else:
        jd = (c * d_mat).expand(e_events, *d_mat.shape)
    jd_w = jd if w is None else jd * w[:, None]
    eye = torch.eye(n_shared, dtype=dt, device=dev)

    def raw_residual(xy, shared):
        d, gd = _dist_grad(xy, height, mic3, False)
        r = (torch.einsum("pm,em->ep", sel, d)
             + torch.einsum("eps,s->ep", jd, shared) - target)  # [E, P]
        return r, gd

    def step(xy, shared):
        r, gd = raw_residual(xy, shared)
        jp = torch.einsum("pm,emj->epj", sel, gd)  # [E, P, 2]
        if w is not None:
            r = r * w
            jp = jp * w[:, None]
        a = torch.einsum("epi,epj->eij", jp, jp)  # [E, 2, 2]
        b = torch.einsum("epi,eps->eis", jp, jd_w)  # [E, 2, S]
        bp = torch.einsum("epi,ep->ei", jp, r)  # [E, 2]
        cmat = torch.einsum("eps,epq->sq", jd_w, jd_w)  # [S, S]
        bd = torch.einsum("eps,ep->s", jd_w, r)  # [S]
        a00 = a[:, 0, 0] + damping
        a11 = a[:, 1, 1] + damping
        a01 = a[:, 0, 1]
        det = (a00 * a11 - a01 * a01).abs().clamp_min(1e-20)
        inv = torch.stack([torch.stack([a11, -a01], dim=-1),
                           torch.stack([-a01, a00], dim=-1)],
                          dim=-2) / det[:, None, None]
        ainv_b = torch.einsum("eij,ejs->eis", inv, b)  # [E, 2, S]
        ainv_bp = torch.einsum("eij,ej->ei", inv, bp)  # [E, 2]
        schur = (cmat - torch.einsum("eis,eiq->sq", b, ainv_b)
                 + damping * eye)
        rhs = bd - torch.einsum("eis,ei->s", b, ainv_bp)
        d_sh = torch.linalg.solve_ex(schur, rhs[:, None])[0][:, 0]  # [S]
        d_xy = ainv_bp - torch.einsum("eis,s->ei", ainv_b, d_sh)
        return xy - d_xy, shared - d_sh

    xy = init_xy
    shared = torch.zeros((n_shared,), dtype=dt, device=dev)
    if init_offsets_s is not None:
        shared = torch.cat([init_offsets_s.to(dt), shared[kk:]])
    for _ in range(iterations):
        xy, shared = step(xy, shared)

    r, _ = raw_residual(xy, shared)
    if w is not None:
        r = r * w
    rms = torch.sqrt(torch.mean(r * r, dim=-1))
    if with_drift:
        return xy, shared[:kk], shared[kk:], rms
    return xy, shared, rms


def farfield_bearing(
    tdoas: torch.Tensor,
    mic_positions: torch.Tensor,
    pairs: torch.Tensor,
    speed_of_sound: float,
) -> torch.Tensor:
    """Linear far-field direction estimate: the least-squares unit vector u
    of (m_j - m_i) . u = -c tau_p.  mic_positions [M, dim] (dim 2 or 3),
    tdoas [..., P] -> bearings [..., dim].  For a coplanar [M, 3] array the
    z row of the normal equations is empty; the 1e-9 damping keeps it
    solvable and z comes out ~0 (the caller resolves +-z)."""
    pairs = pairs.long()
    d = mic_positions[pairs[:, 1]] - mic_positions[pairs[:, 0]]  # [P, dim]
    rhs = -speed_of_sound * tdoas
    dim = d.shape[1]
    ata = d.T @ d + 1e-9 * torch.eye(dim, dtype=d.dtype, device=d.device)
    atb = torch.einsum("pi,...p->...i", d, rhs)
    u = torch.linalg.solve_ex(ata.expand(*atb.shape[:-1], dim, dim),
                              atb[..., None])[0][..., 0]
    return u / torch.linalg.vector_norm(u, dim=-1,
                                        keepdim=True).clamp_min(1e-12)
