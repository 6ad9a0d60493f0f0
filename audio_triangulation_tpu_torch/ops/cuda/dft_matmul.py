"""The DFT-shaped pair of products ``(x + s) @ w1 + (x + s) @ w2`` in f32,
bf16 or int8 operands.

Counterpart of ``tools/int8_microbench.py``'s ``_kernel`` in the JAX
package: the fused GCC kernel's matmul shape ([rows, N] @ [N, F], once for
the cos and once for the -sin matrix) as a kernel of its own, to time the
operand types against each other.  ``s`` is a one-element tensor added to
``x`` in ``x``'s own type (a bf16 add, a wrapping int8 add) before the
products; they accumulate and come out in f32 (f32, bf16) or int32 (int8).

On CUDA tensors :func:`dft_matmul` launches ``csrc/dft_matmul.cu`` or
raises.  Every type set runs as ``wgmma`` products on the tensor cores,
which read ``w1`` and ``w2`` K-major: bf16 and int8 as one product per
matrix against :func:`k_major` copies, f32 as a split-fp32 product (three
TF32 products per matrix, as every fp32 DFT of the main path runs) against
:func:`split_k_major` copies; the copies are made on every call.  On CPU
tensors it runs :func:`dft_matmul_reference`, the plain PyTorch version
(exact f32 products); :func:`dft_matmul_split_reference` repeats the f32
kernel's arithmetic in plain PyTorch.  ``launches`` counts kernel launches
per type set.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .srp_kernel import tf32_split

# name -> (operand dtype, accumulator / output / scalar dtype, kernel code)
TYPE_SETS = {
    "f32": (torch.float32, torch.float32, 0),
    "bf16": (torch.bfloat16, torch.float32, 1),
    "int8": (torch.int8, torch.int32, 2),
}
launches = {name: 0 for name in TYPE_SETS}
# steps of 8 values of K that the f32 kernel sums in the tensor cores before
# it adds them into fp32 registers (kSpFlushStages stages of 32 values)
FLUSH_STEPS = 16
# att_dft_matmul's return when the TMA tensor maps could not be encoded
TENSOR_MAP_ERROR = -1


def _type_set(x: torch.Tensor):
    for name, (in_dt, acc_dt, code) in TYPE_SETS.items():
        if x.dtype == in_dt:
            return name, acc_dt, code
    raise ValueError(f"x must be f32, bf16 or int8; got {x.dtype}")


def _checked(x, w1, w2, s):
    name, acc_dt, code = _type_set(x)
    if (x.ndim != 2 or w1.ndim != 2 or w1.shape != w2.shape
            or w1.shape[0] != x.shape[1] or w1.dtype != x.dtype
            or w2.dtype != x.dtype):
        raise ValueError(
            f"need x [R, N] and w1, w2 [N, F] of one dtype; got "
            f"{tuple(x.shape)} {x.dtype}, {tuple(w1.shape)} {w1.dtype}, "
            f"{tuple(w2.shape)} {w2.dtype}")
    if s.numel() != 1 or s.dtype != acc_dt:
        raise ValueError(f"s must be one {acc_dt} value; got "
                         f"{tuple(s.shape)} {s.dtype}")
    return name, acc_dt, code


def dft_matmul_reference(x: torch.Tensor, w1: torch.Tensor,
                         w2: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [R, N], w1 and w2 [N, F] in
    f32, bf16 or int8, s one f32 (int32 for int8) value -> [R, F] f32
    (int32 for int8).  The int8 products are formed in float64, which is
    exact for any N below 2^17 (|x w| < 2^14, sums below 2^31), so the
    result equals an int32 accumulation bit for bit."""
    _, acc_dt, _ = _checked(x, w1, w2, s)
    xs = x + s.reshape(1).to(x.dtype)  # in x's type: int8 wraps
    if x.dtype == torch.int8:
        xd = xs.double()
        out = torch.matmul(xd, w1.double()) + torch.matmul(xd, w2.double())
        return out.to(torch.int64).to(torch.int32)
    # bf16 values are exact in f32, where the products are summed
    xf = xs.to(acc_dt)
    return torch.matmul(xf, w1.to(acc_dt)) + torch.matmul(xf, w2.to(acc_dt))


def dft_matmul_split_reference(x: torch.Tensor, w1: torch.Tensor,
                               w2: torch.Tensor, s: torch.Tensor
                               ) -> torch.Tensor:
    """Plain PyTorch version of the f32 kernel's arithmetic (same contract
    as :func:`dft_matmul_reference`, f32 only): ``x + s`` and both matrices
    split into TF32 parts by :func:`~.srp_kernel.tf32_split`; every 8
    values of K add ``lo hi``, ``hi lo`` and ``hi hi`` of w1, then of w2, to
    one f32 accumulator (``lo lo`` is dropped), which is added into the f32
    result every :data:`FLUSH_STEPS` steps and at the end."""
    name, _, _ = _checked(x, w1, w2, s)
    if name != "f32":
        raise ValueError(f"the split product takes f32 operands; got {name}")
    n = x.shape[1]
    xh, xl = tf32_split(x + s.reshape(1))
    parts = [tf32_split(w) for w in (w1, w2)]
    total = torch.zeros((x.shape[0], w1.shape[1]), dtype=torch.float32,
                        device=x.device)
    acc = torch.zeros_like(total)
    for step, k0 in enumerate(range(0, n, 8)):
        ks = slice(k0, k0 + 8)
        for wh, wl in parts:
            acc += xl[:, ks] @ wh[ks]
            acc += xh[:, ks] @ wl[ks]
            acc += xh[:, ks] @ wh[ks]
        if (step + 1) % FLUSH_STEPS == 0 or k0 + 8 >= n:
            total += acc
            acc.zero_()
    return total


def split_k_major_reference(w1: torch.Tensor,
                            w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`split_k_major`."""
    (h1, l1), (h2, l2) = tf32_split(w1), tf32_split(w2)
    return torch.stack((h1.t(), l1.t(), h2.t(), l2.t())).contiguous()


def split_k_major(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """[4, F, N] f32: the TF32 hi and lo parts of w1, then of w2 [N, F],
    each transposed so that K runs fastest (the f32 kernel's B operand).
    A small kernel of ``csrc/dft_matmul.cu`` on CUDA tensors, the plain
    version on CPU tensors."""
    if w1.device.type == "cpu":
        return split_k_major_reference(w1, w2)
    _build.refuse_grad("split_pack_kernel", w1, w2)
    n, f = w1.shape
    if (w1.device.type != "cuda" or w2.device != w1.device
            or w2.shape != w1.shape or w1.dtype != torch.float32
            or w2.dtype != torch.float32):
        raise ValueError(
            f"need two CUDA [N, F] f32 matrices; got {tuple(w1.shape)} "
            f"{w1.dtype} on {w1.device}, {tuple(w2.shape)} {w2.dtype} on "
            f"{w2.device}")
    w1, w2 = w1.contiguous(), w2.contiguous()
    out = torch.empty((4, f, n), dtype=torch.float32, device=w1.device)
    lib = _lib()
    with torch.cuda.device(w1.device):
        err = lib.att_dft_split_pack(
            w1.data_ptr(), w2.data_ptr(), out.data_ptr(), n, f,
            torch.cuda.current_stream(w1.device).cuda_stream)
    _build.check(err, "split_pack_kernel launch", lib)
    return out


def k_major_reference(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`k_major`."""
    return torch.stack((w1.t(), w2.t())).contiguous()


def k_major(w1: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """[2, F, N]: the transposes of w1 and w2 [N, F] (bf16 or int8),
    contiguous, so that K runs fastest: the layout ``wgmma`` reads an int8
    operand in.  A small kernel of ``csrc/dft_matmul.cu`` on CUDA tensors,
    the plain version on CPU tensors."""
    if w1.device.type == "cpu":
        return k_major_reference(w1, w2)
    _build.refuse_grad("k_major_kernel", w1, w2)
    n, f = w1.shape
    if (w1.device.type != "cuda" or w2.device != w1.device
            or w2.shape != w1.shape or w2.dtype != w1.dtype
            or w1.element_size() not in (1, 2)):
        raise ValueError(
            f"need two CUDA [N, F] matrices of one 1- or 2-byte dtype; got "
            f"{tuple(w1.shape)} {w1.dtype} on {w1.device}, "
            f"{tuple(w2.shape)} {w2.dtype} on {w2.device}")
    w1, w2 = w1.contiguous(), w2.contiguous()
    out = torch.empty((2, f, n), dtype=w1.dtype, device=w1.device)
    lib = _lib()
    with torch.cuda.device(w1.device):
        err = lib.att_dft_k_major(
            w1.data_ptr(), w2.data_ptr(), out.data_ptr(), n, f,
            w1.element_size(),
            torch.cuda.current_stream(w1.device).cuda_stream)
    _build.check(err, "k_major_kernel launch", lib)
    return out


def launch(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           s: torch.Tensor) -> torch.Tensor:
    """Run ``csrc/dft_matmul.cu`` on CUDA tensors (same contract as
    :func:`dft_matmul_reference`); raises on anything it does not take:
    N must be a multiple of 64 and F of 16."""
    _build.refuse_grad("dft_matmul_kernel", x, w1, w2, s)
    name, acc_dt, code = _checked(x, w1, w2, s)
    r, n = x.shape
    f = w1.shape[1]
    if r < 1 or n % 64 or f % 16 or n < 64 or f < 16:
        raise ValueError(f"the kernel takes N a multiple of 64 and F a "
                         f"multiple of 16; got R={r}, N={n}, F={f}")
    if x.device.type != "cuda":
        raise ValueError(f"the DFT-product kernel needs CUDA tensors; x is "
                         f"on {x.device}")
    dev = x.device
    if any(t.device != dev for t in (w1, w2, s)):
        raise ValueError("x, w1, w2 and s must be on one device")
    x, s = x.contiguous(), s.contiguous()
    if name == "f32":
        w1 = w2 = split_k_major(w1, w2)  # the kernel reads [4, F, N]
    else:
        w1, w2 = k_major(w1, w2)
    out = torch.empty((r, f), dtype=acc_dt, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.att_dft_matmul(
            x.data_ptr(), w1.data_ptr(), w2.data_ptr(), s.data_ptr(),
            out.data_ptr(), r, n, f, code,
            torch.cuda.current_stream(dev).cuda_stream)
    if err == TENSOR_MAP_ERROR:
        raise RuntimeError(
            f"dft_matmul_kernel {name}: cuTensorMapEncodeTiled was not found "
            f"in libcuda.so.1 or refused x {tuple(x.shape)}, w [{f}, {n}]; "
            "nothing was launched")
    with _build.count_lock:
        launches[name] += 1
    _build.check(err, "dft_matmul_kernel launch", lib)
    return out


def dft_matmul(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """``(x + s) @ w1 + (x + s) @ w2`` (see :func:`dft_matmul_reference`):
    the kernel on CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return dft_matmul_reference(x, w1, w2, s)
    return launch(x, w1, w2, s)


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_dft_matmul.argtypes is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.att_dft_matmul.argtypes = [vp] * 5 + [ci] * 4 + [vp]
            lib.att_dft_matmul.restype = ci
            lib.att_dft_k_major.argtypes = [vp] * 3 + [ci] * 3 + [vp]
            lib.att_dft_k_major.restype = ci
            lib.att_dft_split_pack.argtypes = [vp] * 3 + [ci] * 2 + [vp]
            lib.att_dft_split_pack.restype = ci
    return lib
