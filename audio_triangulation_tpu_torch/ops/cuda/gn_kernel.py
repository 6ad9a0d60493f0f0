"""Batched damped Gauss-Newton TDOA solve and its position covariance as
one CUDA kernel.

Counterpart of ``audio_triangulation_tpu.ops.pallas.gn_kernel``
(``solve_tdoa_pallas``) followed by ``ops.solver.solution_covariance``: the
Localizer's whole solver tail.  A :class:`GnSolver` holds one array's mic
coordinates and the solver's constants on the host, built once per
configuration.  Called on CUDA tensors it launches ``csrc/gn_kernel.cu``
(one launch and nothing else: the constants travel in the launch's
parameter block) or raises; on CPU tensors it runs :func:`gn_reference`,
the plain PyTorch version of the same formulas.  The kernel takes coplanar
arrays (every mic at z = 0) of 2 to 11 mics with their canonical pair list
(``geometry.mic_pairs``: at most 55 of the reference kernel's 64 pairs) and
no robust reweighting; :func:`refusal` says why a configuration does not
fit.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from ...core import geometry
from ...core.config import SolverConfig
from . import _build

MAX_MICS = 11
MIN_SIGMA_M = 1e-4  # solution_covariance's default floor on sigma
launches = 0


def refusal(mic_positions: np.ndarray, pairs: np.ndarray,
            cfg: SolverConfig) -> str | None:
    """Why the kernel does not take this array and solver configuration
    (host arrays), or None when it does."""
    mics = np.asarray(mic_positions)
    m = mics.shape[0]
    if cfg.robust != "none":
        return "robust IRLS runs in the batched solver"
    if not 2 <= m <= MAX_MICS:
        return f"the GN kernel takes 2 to {MAX_MICS} mics (at most 64 pairs)"
    if mics.shape[1] > 2 and np.any(mics[:, 2:] != 0):
        return "the GN kernel assumes mics at z = 0"
    if not np.array_equal(np.asarray(pairs), geometry.mic_pairs(m)):
        return "the GN kernel takes the array's canonical pair list"
    return None


def gn_reference(tau, init, mics, pairs, *, c: float, h: float, iters: int,
                 damping: float, sphere: bool):
    """Plain PyTorch version of the kernel.  tau [B, P] seconds, init
    [B, 2], mics [M, 2+] and pairs [P, 2] (host arrays or tensors) -> (xy
    [B, 2], rms [B] meters, cov [B, 2, 2] square meters)."""
    mic_xy = [(float(a), float(b)) for a, b in mics[:, :2].tolist()]
    pair_ij = [(int(i), int(j)) for i, j in pairs.tolist()]
    n_pairs = len(pair_ij)
    targets = [tau[:, p] * c for p in range(n_pairs)]
    x, y = init[:, 0], init[:, 1]

    def residual_jac(x, y):
        if sphere:
            nv = torch.sqrt(x * x + y * y + h * h)
            inv = 1.0 / nv
            s = h * inv
            sx, sy, sz = x * s, y * s, h * s
            vx, vy, vz = x * inv, y * inv, h * inv
            j11, j21, j31 = s * (1.0 - vx * vx), s * (-vy * vx), s * (-vz * vx)
            j12, j22, j32 = s * (-vx * vy), s * (1.0 - vy * vy), s * (-vz * vy)
        else:
            sx, sy, sz = x, y, torch.full_like(x, h)
            one, zero = torch.ones_like(x), torch.zeros_like(x)
            j11, j21, j31 = one, zero, zero
            j12, j22, j32 = zero, one, zero
        dists, g1, g2 = [], [], []
        for mx, my in mic_xy:
            dx, dy, dz = sx - mx, sy - my, sz
            d = torch.sqrt(dx * dx + dy * dy + dz * dz)
            ud = 1.0 / d
            ux, uy, uz = dx * ud, dy * ud, dz * ud
            dists.append(d)
            g1.append(ux * j11 + uy * j21 + uz * j31)
            g2.append(ux * j12 + uy * j22 + uz * j32)
        rs = [dists[j] - dists[i] - targets[p]
              for p, (i, j) in enumerate(pair_ij)]
        ja = [g1[j] - g1[i] for i, j in pair_ij]
        jb = [g2[j] - g2[i] for i, j in pair_ij]
        return rs, ja, jb

    def normal_matrix(ja, jb):
        return (sum(q * q for q in ja) + damping,
                sum(q * q for q in jb) + damping,
                sum(p * q for p, q in zip(ja, jb)))

    for _ in range(iters):
        rs, ja, jb = residual_jac(x, y)
        a00, a11, a01 = normal_matrix(ja, jb)
        b0 = sum(p * q for p, q in zip(ja, rs))
        b1 = sum(p * q for p, q in zip(jb, rs))
        det = a00 * a11 - a01 * a01
        inv_det = 1.0 / torch.where(det.abs() > 1e-20, det,
                                    torch.full_like(det, 1e-20))
        x, y = (x - (a11 * b0 - a01 * b1) * inv_det,
                y - (a00 * b1 - a01 * b0) * inv_det)
    # the covariance from the final pass's Jacobian (solution_covariance)
    rs, ja, jb = residual_jac(x, y)
    rms = torch.sqrt(sum(q * q for q in rs) / n_pairs)
    a00, a11, a01 = normal_matrix(ja, jb)
    sigma2 = rms.clamp_min(MIN_SIGMA_M) ** 2 * (n_pairs / max(n_pairs - 2, 1))
    det = (a00 * a11 - a01 * a01).clamp_min(1e-20)
    inv = torch.stack([torch.stack([a11, -a01], dim=-1),
                       torch.stack([-a01, a00], dim=-1)], dim=-2)
    cov = sigma2[:, None, None] * (inv / det[:, None, None])
    return torch.stack([x, y], dim=-1), rms, cov


class GnSolver:
    """The GN kernel bound to one array and solver configuration.

    >>> gn = GnSolver.create(mics, geometry.mic_pairs(4),
    ...                      speed_of_sound=343.0, height=1.2)
    >>> xy, rms, cov = gn(tdoas, init_xy)   # [B, P] s, [B, 2] -> outputs

    Drop-in for ``solver.solve_tdoa_batched`` followed by
    ``solver.solution_covariance`` with ``robust='none'``."""

    def __init__(self, mics_xy: np.ndarray, *, c: float, h: float,
                 iters: int, damping: float, sphere: bool):
        self.mics = np.ascontiguousarray(mics_xy, dtype=np.float32)
        self.pairs = geometry.mic_pairs(self.mics.shape[0])
        self.kw = dict(c=float(c), h=float(h), iters=int(iters),
                       damping=float(damping), sphere=bool(sphere))
        self._mics_ptr = self.mics.ctypes.data_as(
            ctypes.POINTER(ctypes.c_float))

    @classmethod
    def create(cls, mic_positions: np.ndarray, pairs: np.ndarray, *,
               speed_of_sound: float, height: float,
               cfg: SolverConfig = SolverConfig()) -> "GnSolver":
        """From host arrays; raises ValueError when the kernel does not
        take them (:func:`refusal`)."""
        why = refusal(mic_positions, pairs, cfg)
        if why is not None:
            raise ValueError(why)
        return cls(np.asarray(mic_positions, np.float32)[:, :2],
                   c=speed_of_sound, h=height, iters=cfg.iterations,
                   damping=cfg.damping, sphere=cfg.constrain_to_sphere)

    def __call__(self, tdoas: torch.Tensor, init_xy: torch.Tensor):
        """tdoas [B, P] seconds, init_xy [B, 2] -> (xy [B, 2], rms [B]
        meters, cov [B, 2, 2] square meters)."""
        if tdoas.device.type == "cpu":
            return self.reference(tdoas.float(), init_xy.float())
        return self.launch(tdoas, init_xy)

    def reference(self, tau: torch.Tensor, init: torch.Tensor):
        """:func:`gn_reference` with this solver's constants, on the device
        of ``tau``.  The constants go in as the host arrays they are: a
        tensor made here would be read back to the host, which
        ``torch.export`` cannot trace (``utils.serving``)."""
        return gn_reference(tau, init, self.mics, self.pairs, **self.kw)

    def launch(self, tau: torch.Tensor, init: torch.Tensor):
        """Run ``csrc/gn_kernel.cu`` on CUDA tensors: tau [B, P] and init
        [B, 2] float32, contiguous, on one device; raises on anything
        else.  One kernel launch, no other work on the device."""
        global launches
        _build.refuse_grad("gn_kernel", tau, init)
        if tau.device.type != "cuda" or init.device != tau.device:
            raise ValueError(f"the GN kernel needs CUDA tensors on one "
                             f"device; tau is on {tau.device}, init on "
                             f"{init.device}")
        b, p = tau.shape
        if (p != self.pairs.shape[0] or init.shape != (b, 2)
                or tau.dtype != torch.float32 or init.dtype != torch.float32
                or not (tau.is_contiguous() and init.is_contiguous())
                or init.data_ptr() % 8):
            raise ValueError(
                f"the GN kernel takes float32 contiguous tau [B, "
                f"{self.pairs.shape[0]}] and 8-byte aligned init [B, 2]; got "
                f"{tuple(tau.shape)} {tau.dtype}, {tuple(init.shape)} "
                f"{init.dtype}")
        dev = tau.device
        xy = torch.empty((b, 2), dtype=torch.float32, device=dev)
        rms = torch.empty((b,), dtype=torch.float32, device=dev)
        cov = torch.empty((b, 2, 2), dtype=torch.float32, device=dev)
        if b == 0:
            return xy, rms, cov
        lib = _lib()
        kw = self.kw
        with (contextlib.nullcontext()
              if dev.index == torch.cuda.current_device()
              else torch.cuda.device(dev)):
            err = lib.att_gn(tau.data_ptr(), init.data_ptr(), self._mics_ptr,
                             xy.data_ptr(), rms.data_ptr(), cov.data_ptr(), b,
                             self.mics.shape[0], kw["c"], kw["h"],
                             kw["h"] * kw["h"], kw["iters"], kw["damping"],
                             int(kw["sphere"]),
                             torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "gn_kernel launch", lib)
        with _build.count_lock:
            launches += 1
        return xy, rms, cov


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_gn.argtypes is None:
            vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.att_gn.argtypes = ([vp, vp, ctypes.POINTER(ctypes.c_float),
                                    vp, vp, vp, ci, ci, cf, cf, cf, ci, cf, ci,
                                    vp])
            lib.att_gn.restype = ci
    return lib
