"""SRP scoring with the grid argmax in one kernel: [B, G] is never stored.

Counterpart of ``audio_triangulation_tpu.ops.pallas.srp_kernel``
(``srp_argmax``): correlograms [B, P, L] times any matrix [P*L, G] (a
steering one-hot, or a general one), reduced at once to the best score and
its first cell per frame, for grids whose [B, G] score buffer is itself the
problem.

On CUDA tensors :func:`srp_argmax` launches ``csrc/srp_kernel.cu`` or
raises; on CPU tensors it runs :func:`srp_argmax_reference`, the plain
PyTorch version.  The kernel multiplies on the tensor cores: in f32 mode
as three TF32 products of operands split into a high and a low part, in
bf16 mode as one bf16 product, both summed in fp32;
:func:`srp_argmax_split_reference` repeats that arithmetic in plain
PyTorch.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .split_fp32 import split_product

launches = 0


def srp_argmax_reference(flat: torch.Tensor, matrix: torch.Tensor,
                         num_cells: int, *, bf16: bool = False):
    """Plain PyTorch version of the kernel, in the operands' dtype:
    flat [B, K] @ matrix [K, G] -> (best score [B], first best cell int32
    [B]) over the cells below ``num_cells``.  ``bf16`` rounds both operands
    to bf16 and sums in the operands' dtype.  It stores [B, G]."""
    if bf16:
        flat = flat.to(torch.bfloat16).to(flat.dtype)
        matrix = matrix.to(torch.bfloat16).to(matrix.dtype)
    scores = torch.matmul(flat, matrix)[:, :num_cells]
    cell = scores.argmax(dim=-1)  # the first maximum
    val = scores.gather(-1, cell[:, None])[:, 0]
    return val, cell.to(torch.int32)


def srp_argmax_split_reference(flat: torch.Tensor, matrix: torch.Tensor,
                               num_cells: int, *, bf16: bool = False):
    """Plain PyTorch version that repeats the kernel's arithmetic on f32
    operands (same contract as :func:`srp_argmax_reference`).  f32 mode:
    both operands split by :func:`~.split_fp32.tf32_split`, and every 8
    values of K add ``a_lo w_hi``, then ``a_hi w_lo``, then ``a_hi w_hi`` to
    one f32 accumulator.  bf16 mode: operands rounded to bf16, every 16
    values of K added to one f32 accumulator.  Both are
    :func:`~.split_fp32.split_product`."""
    if bf16:
        flat, matrix = flat.float().bfloat16(), matrix.float().bfloat16()
    scores = split_product(flat, matrix, k=16 if bf16 else 8,
                           hi_only=bf16)[:, :num_cells]
    cell = scores.argmax(dim=-1)
    val = scores.gather(-1, cell[:, None])[:, 0]
    return val, cell.to(torch.int32)


def launch(flat: torch.Tensor, matrix: torch.Tensor, num_cells: int, *,
           bf16: bool = False):
    """Run ``csrc/srp_kernel.cu`` on CUDA tensors (same contract as
    :func:`srp_argmax_reference`); raises on anything it does not take."""
    global launches
    _build.refuse_grad("srp_argmax_kernel", flat, matrix)
    if flat.device.type != "cuda":
        raise ValueError(f"the SRP argmax kernel needs CUDA tensors; the "
                         f"correlograms are on {flat.device}")
    if (flat.ndim != 2 or matrix.ndim != 2 or flat.dtype != torch.float32
            or flat.shape[1] != matrix.shape[0]):
        raise ValueError(f"need f32 [B, K] correlograms and a [K, G] "
                         f"matrix; got {tuple(flat.shape)} {flat.dtype} and "
                         f"{tuple(matrix.shape)}")
    b, k = flat.shape
    g = matrix.shape[1]
    if k < 1 or not 1 <= num_cells <= g:
        raise ValueError(f"num_cells {num_cells} must lie in 1..{g}, K >= 1")
    dev = flat.device
    flat = flat.contiguous()
    matrix = matrix.to(device=dev, dtype=torch.float32).contiguous()
    val = torch.empty((b,), dtype=torch.float32, device=dev)
    cell = torch.empty((b,), dtype=torch.int32, device=dev)
    if b > 0:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.att_srp_argmax(
                flat.data_ptr(), matrix.data_ptr(), val.data_ptr(),
                cell.data_ptr(), b, k, g, num_cells, int(bf16),
                torch.cuda.current_stream(dev).cuda_stream)
        with _build.count_lock:
            launches += 1
        _build.check(err, "srp_argmax_kernel launch", lib)
    return val, cell


def srp_argmax(correlograms: torch.Tensor, onehot: torch.Tensor,
               num_cells: int, *, tile_b: int = 256, gt: int = 2048,
               bf16: bool = False):
    """(best score [B], best cell int32 [B]) of correlograms [B, P, L]
    against ``onehot`` [P*L, G] without storing the [B, G] scores.  G may
    exceed ``num_cells`` (padding): cells from ``num_cells`` on never win.
    The first maximum wins, as ``argmax``.  ``tile_b`` and ``gt`` are the
    reference's tile sizes and change nothing here: any B and G are taken."""
    if correlograms.ndim != 3:
        raise ValueError(f"correlograms must be [B, P, L]; got "
                         f"{tuple(correlograms.shape)}")
    b, p, l = correlograms.shape
    flat = correlograms.reshape(b, p * l)
    if flat.device.type == "cpu":
        return srp_argmax_reference(flat, onehot.to(flat.dtype), num_cells,
                                    bf16=bf16)
    return launch(flat.float(), onehot, num_cells, bf16=bf16)


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_srp_argmax.argtypes is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.att_srp_argmax.argtypes = [vp] * 4 + [ci] * 5 + [vp]
            lib.att_srp_argmax.restype = ci
    return lib
