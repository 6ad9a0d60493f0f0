"""Numpy constants on a device, copied there once.

The matrices of the matmul engines (DFT, lag synthesis, smoothing) are numpy
arrays built once per configuration by cached functions.  Copying one from
host memory at every call costs its bytes over the bus and makes the host
wait for the stream (a copy from pageable memory synchronises), so the
device copies are kept, keyed by the array object itself.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

MAX_ENTRIES = 32
_cache: dict = {}
_lock = threading.Lock()  # threads of one server share the cache


def device_constant(arr: np.ndarray, device, dtype=torch.float32):
    """``arr`` as a ``dtype`` tensor on ``device``.  For a device other than
    the CPU the tensor is kept for as long as ``arr`` is one of the last
    ``MAX_ENTRIES`` arrays asked for; ``arr`` must not be changed
    afterwards (the arrays of the cached matrix functions never are)."""
    device = torch.device(device)
    if device.type == "cpu":
        return torch.as_tensor(arr, dtype=dtype)
    key = (id(arr), str(device), dtype)
    with _lock:
        hit = _cache.get(key)
        if hit is None or hit[0] is not arr:  # a freed array's id can recur
            while len(_cache) >= MAX_ENTRIES:
                _cache.pop(next(iter(_cache)))
            hit = (arr, torch.as_tensor(arr, dtype=dtype, device=device))
            _cache[key] = hit
    return hit[1]


def true_div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as one rounded division on every device.  CUDA divides a
    tensor by a host scalar as a product with the scalar's reciprocal,
    which lands an ulp off the quotient at times, and a Gauss-Newton solve
    from a far grid cell can carry an ulp of its init or its TDOAs to 1e-4
    m; a divisor on ``x``'s device is divided by, as the CPU does."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def pin_fp32_for(x: torch.Tensor) -> None:
    """Turn TF32 off (``models.localizer.pin_fp32``) when ``x`` lies on a
    CUDA device: the entry points of plain-torch paths call this."""
    if x.is_cuda:
        from ..models.localizer import pin_fp32

        pin_fp32()


def irfft(spec: torch.Tensor, n: int) -> torch.Tensor:
    """``torch.fft.irfft`` over the last dim of a one-sided spectrum, its
    DC and (for even ``n``) Nyquist bins read as real on every device.

    The CPU's FFT reads only those bins' real parts, as numpy's and the
    JAX package's do; cuFFT's batched complex-to-real transform (2,048
    transforms or more, measured on an H100) adds their imaginary parts
    into the output (2% of scale on random spectra).  A spectrum that is
    not Hermitian there (a phase-shifted or filtered one) is made so
    first, on a copy."""
    spec = spec.clone(memory_format=torch.contiguous_format)
    spec[..., 0].imag.zero_()
    if n % 2 == 0 and spec.shape[-1] > n // 2:
        spec[..., n // 2].imag.zero_()
    return torch.fft.irfft(spec, n=n, dim=-1)
