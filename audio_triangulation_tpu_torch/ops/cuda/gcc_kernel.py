"""Fused GCC kernel: raw frames -> (tapered) correlograms and per-pair peaks.

Counterpart of ``audio_triangulation_tpu.ops.pallas.gcc_kernel`` in its base
mode (``fused_gcc`` / ``fused_gcc_peaks``).  On a CUDA tensor
:func:`fused_gcc` launches ``csrc/gcc_kernel.cu`` or raises; on a CPU tensor
it runs :func:`gcc_reference`, the plain PyTorch version of the same
function.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ...core.config import PipelineConfig
from .. import mxu_fft, xcorr
from . import _build

launches = 0


class GccMatrices(NamedTuple):
    """The GCC operands fixed by the configuration (f32, one device)."""

    cos: torch.Tensor  # [N, F] DFT, real part
    msin: torch.Tensor  # [N, F] DFT, imaginary part (-sin)
    sync: torch.Tensor  # [F, L] lag synthesis, cos rows
    syns: torch.Tensor  # [F, L] lag synthesis, sin rows
    # [N, Fp, 2]: (cos, -sin) of bin f side by side, F padded to even with a
    # zero bin, so the kernel reads bins f and f + 1 in one 16-byte load
    cs: torch.Tensor

    def to(self, dtype: torch.dtype) -> "GccMatrices":
        return GccMatrices(*(t.to(dtype) for t in self))


@functools.lru_cache(maxsize=32)
def _matrices(cfg: PipelineConfig, n: int, device: str) -> GccMatrices:
    cos, msin, sync, syns = (
        torch.as_tensor(a, dtype=torch.float32, device=device)
        for a in mxu_fft.gcc_matrices(cfg, n))
    f = cos.shape[1]
    cs = torch.zeros((n, f + f % 2, 2), dtype=torch.float32, device=device)
    cs[:, :f, 0] = cos
    cs[:, :f, 1] = msin
    return GccMatrices(cos, msin, sync, syns, cs)


def window_gain(window: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """The window with the shift8 gain folded in (ones when windowing is
    off), the one conditioning vector the kernel applies after removing
    the mean."""
    win = window.float() if cfg.window_enabled else torch.ones_like(
        window, dtype=torch.float32)
    return win * (256.0 if cfg.normalize_mode == "shift8" else 1.0)


def gcc_reference(frames, win_gain, mats: GccMatrices, pairs, *,
                  phat: bool, phat_eps: float, max_shift: int,
                  taper_denom: float, with_peaks: bool):
    """Plain PyTorch version of the kernel, on the kernel's own operands.

    frames [B, M, N] -> correlograms [B, P, L]; with ``with_peaks`` ->
    (tapered correlograms, best shift int32 [B, P], sub-sample tdoa [B, P]
    in lags, peak value [B, P], psr [B, P]), peaks taken on the raw
    correlogram."""
    x = (frames - frames.mean(dim=-1, keepdim=True)) * win_gain
    re, im = mxu_fft.rdft(x, mats.cos, mats.msin)
    rr, jj = mxu_fft.cross_power_reim(re, im, pairs, phat=phat,
                                      phat_eps=phat_eps)
    corr = mxu_fft.lag_correlogram(rr, jj, mats.sync, mats.syns)
    if not with_peaks:
        return corr
    shifts = xcorr.best_lag(corr, max_shift)
    tdoa, peak = xcorr.subsample_peak(corr, max_shift)
    psr = xcorr.peak_confidence(corr, max_shift)
    corr_t = xcorr.peak_taper(corr, max_shift, taper_denom, shifts)
    return corr_t, shifts, tdoa, peak, psr


def operands(frames: torch.Tensor, window: torch.Tensor,
             cfg: PipelineConfig):
    """(win_gain, GccMatrices) for ``frames``' device; the matrices are
    built once per configuration and device."""
    return (window_gain(window.to(frames.device), cfg),
            _matrices(cfg, frames.shape[-1], str(frames.device)))


def fused_gcc(frames: torch.Tensor, window: torch.Tensor,
              pairs: torch.Tensor, cfg: PipelineConfig, *,
              with_peaks: bool):
    """Raw frames [B, M, N] f32 -> correlograms [B, P, L] (conditioning,
    DFT, PHAT per ``cfg``, cross-power, lag synthesis), or with
    ``with_peaks`` the tapered correlograms plus per-pair peaks (see
    :func:`gcc_reference`)."""
    if frames.ndim != 3 or frames.dtype != torch.float32:
        raise ValueError(f"frames must be f32 [B, M, N]; got "
                         f"{tuple(frames.shape)} {frames.dtype}")
    ops = operands(frames, window, cfg)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, with_peaks=with_peaks)
    if frames.device.type == "cpu":
        return gcc_reference(frames, *ops, pairs.to(frames.device), **kw)
    return launch(frames, *ops, pairs, **kw)


def launch(frames, win_gain, mats: GccMatrices, pairs, *, phat: bool,
           phat_eps: float, max_shift: int, taper_denom: float,
           with_peaks: bool):
    """Run ``csrc/gcc_kernel.cu`` on CUDA tensors (same contract as
    :func:`gcc_reference`); raises on anything it does not take.  The pair
    indices are not range-checked here (that would sync with the device):
    they must index the M mics, as ``Localizer.create`` and
    ``params_from_reference`` ensure."""
    global launches
    if frames.device.type != "cuda":
        raise ValueError(f"the GCC kernel needs CUDA tensors; frames are on "
                         f"{frames.device}")
    b, m, n = frames.shape
    f, l = mats.sync.shape
    fp = f + f % 2
    p = pairs.shape[0]
    dev = frames.device
    frames = frames.contiguous()
    pairs32 = pairs.to(device=dev, dtype=torch.int32).contiguous()
    ins = [t.to(device=dev, dtype=torch.float32).contiguous()
           for t in (win_gain, mats.cs, mats.sync, mats.syns)]
    if (ins[0].shape != (n,) or ins[1].shape != (n, fp, 2)
            or ins[3].shape != (f, l)):
        raise ValueError("GCC operand shapes do not match the frames")
    if p < 1 or pairs32.shape != (p, 2) or l % 2 == 0:
        raise ValueError("bad pair list or lag count for the GCC kernel")
    lib = _lib()
    if lib.att_gcc_frames_per_block(m, f, l) < 1:
        raise ValueError(f"one frame of {m} mics x {f} bins does not fit "
                         "the kernel's shared memory")
    corr = torch.empty((b, p, l), dtype=torch.float32, device=dev)
    if with_peaks:
        shift = torch.empty((b, p), dtype=torch.int32, device=dev)
        tdoa, peak, psr = (torch.empty((b, p), dtype=torch.float32,
                                       device=dev) for _ in range(3))
        outs = (corr, shift, tdoa, peak, psr)
    else:
        outs = (corr,)
    if b == 0:
        return outs if with_peaks else corr
    # Temporaries may be freed once launched: the caching allocator reuses
    # memory in the order of the stream the kernel runs on.
    ptr = [t.data_ptr() for t in (frames, *ins, pairs32)]
    optr = [t.data_ptr() for t in outs] + [None] * (5 - len(outs))
    per_mic = phat and xcorr.phat_per_mic(m)
    with torch.cuda.device(dev):
        err = lib.att_gcc(*ptr, *optr, b, m, n, f, fp, p, l, int(phat),
                          int(per_mic), phat_eps, taper_denom,
                          int(with_peaks),
                          torch.cuda.current_stream(dev).cuda_stream)
    launches += 1
    _build.check(err, "gcc_kernel launch", lib)
    return outs if with_peaks else corr


def _lib():
    lib = _build.load_library()
    if lib.att_gcc.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.att_gcc.argtypes = ([vp] * 11 + [ci] * 9 + [cf, cf, ci, vp])
        lib.att_gcc.restype = ci
        lib.att_gcc_frames_per_block.argtypes = [ci, ci, ci]
        lib.att_gcc_frames_per_block.restype = ci
    return lib
