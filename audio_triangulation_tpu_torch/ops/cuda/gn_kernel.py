"""Batched damped Gauss-Newton TDOA solve as a CUDA kernel.

Counterpart of ``audio_triangulation_tpu.ops.pallas.gn_kernel``
(``solve_tdoa_pallas``).  On a CUDA tensor :func:`solve_tdoa_gn` launches
``csrc/gn_kernel.cu`` or raises; on a CPU tensor it runs
:func:`gn_reference`, the plain PyTorch version of the same formulas.
Mics lie at z = 0; at most 64 pairs.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...core.config import SolverConfig
from . import _build

MAX_PAIRS = 64
launches = 0


def gn_reference(tau, init, mics, pairs, *, c: float, h: float, iters: int,
                 damping: float, sphere: bool):
    """Plain PyTorch version of the kernel.  tau [B, P] seconds, init
    [B, 2], mics [M, 2], pairs [P, 2] -> (xy [B, 2], rms [B] meters)."""
    mic_xy = [(float(a), float(b)) for a, b in mics[:, :2].tolist()]
    pair_ij = [(int(i), int(j)) for i, j in pairs.tolist()]
    targets = [tau[:, p] * c for p in range(len(pair_ij))]
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

    for _ in range(iters):
        rs, ja, jb = residual_jac(x, y)
        a00 = sum(q * q for q in ja) + damping
        a11 = sum(q * q for q in jb) + damping
        a01 = sum(p * q for p, q in zip(ja, jb))
        b0 = sum(p * q for p, q in zip(ja, rs))
        b1 = sum(p * q for p, q in zip(jb, rs))
        det = a00 * a11 - a01 * a01
        inv_det = 1.0 / torch.where(det.abs() > 1e-20, det,
                                    torch.full_like(det, 1e-20))
        x, y = (x - (a11 * b0 - a01 * b1) * inv_det,
                y - (a00 * b1 - a01 * b0) * inv_det)
    rs, _, _ = residual_jac(x, y)
    rms = torch.sqrt(sum(q * q for q in rs) / len(pair_ij))
    return torch.stack([x, y], dim=-1), rms


def solve_tdoa_gn(tdoas: torch.Tensor, mic_positions: torch.Tensor,
                  pairs: torch.Tensor, *, speed_of_sound: float,
                  height: float, init_xy: torch.Tensor,
                  cfg: SolverConfig = SolverConfig()):
    """Drop-in for ``solver.solve_tdoa_batched`` with ``robust='none'``:
    tdoas [B, P] seconds, init_xy [B, 2] -> (xy [B, 2], rms [B] meters)."""
    if pairs.shape[0] > MAX_PAIRS:
        raise ValueError(f"{pairs.shape[0]} pairs; the GN kernel takes at "
                         f"most {MAX_PAIRS}")
    if mic_positions.shape[-1] > 2 and bool(
            (mic_positions[:, 2:] != 0).any()):
        raise ValueError("the GN kernel assumes mics at z = 0")
    kw = dict(c=float(speed_of_sound), h=float(height),
              iters=cfg.iterations, damping=float(cfg.damping),
              sphere=cfg.constrain_to_sphere)
    if tdoas.device.type == "cpu":
        return gn_reference(tdoas.float(), init_xy.float(),
                            mic_positions.cpu(), pairs.cpu(), **kw)
    return launch(tdoas, init_xy, mic_positions, pairs, **kw)


def launch(tau, init, mics, pairs, *, c: float, h: float, iters: int,
           damping: float, sphere: bool):
    """Run ``csrc/gn_kernel.cu`` on CUDA tensors (same contract as
    :func:`gn_reference`); raises on anything it does not take.  The pair
    indices are not range-checked here (that would sync with the device in
    the middle of a localizer call): they must index the M mics, as
    ``Localizer.create`` and ``params_from_reference`` ensure."""
    global launches
    if tau.device.type != "cuda":
        raise ValueError(f"the GN kernel needs CUDA tensors; tau is on "
                         f"{tau.device}")
    dev = tau.device
    b, p = tau.shape
    m = mics.shape[0]
    if init.shape != (b, 2) or pairs.shape != (p, 2) or not 1 <= p <= MAX_PAIRS:
        raise ValueError("GN operand shapes do not match")
    tau = tau.to(dtype=torch.float32).contiguous()
    init = init.to(device=dev, dtype=torch.float32).contiguous()
    mics2 = mics[:, :2].to(device=dev, dtype=torch.float32).contiguous()
    pairs32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
    xy = torch.empty((b, 2), dtype=torch.float32, device=dev)
    rms = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0:
        return xy, rms
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.att_gn(tau.data_ptr(), init.data_ptr(), mics2.data_ptr(),
                         pairs32.data_ptr(), xy.data_ptr(), rms.data_ptr(),
                         b, m, p, c, h, h * h, iters, damping, int(sphere),
                         torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    _build.check(err, "gn_kernel launch", lib)
    return xy, rms


def _lib():
    lib = _build.load_library()
    if lib.att_gn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.att_gn.argtypes = ([vp] * 6 + [ci] * 3 + [cf] * 3
                               + [ci, cf, ci, vp])
        lib.att_gn.restype = ci
    return lib
