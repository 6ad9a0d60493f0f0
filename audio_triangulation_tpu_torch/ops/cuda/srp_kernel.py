"""SRP scoring with the grid argmax in one kernel: [B, G] is never stored.

Counterpart of ``audio_triangulation_tpu.ops.pallas.srp_kernel``
(``srp_argmax``): correlograms [B, P, L] times any matrix [P*L, G] (a
steering one-hot, or a general one), reduced at once to the best score and
its first cell per frame, for grids whose [B, G] score buffer is itself the
problem.

On CUDA tensors :func:`srp_argmax` launches ``csrc/srp_kernel.cu`` or
raises; on CPU tensors it runs :func:`srp_argmax_reference`, the plain
PyTorch version.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

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


def launch(flat: torch.Tensor, matrix: torch.Tensor, num_cells: int, *,
           bf16: bool = False):
    """Run ``csrc/srp_kernel.cu`` on CUDA tensors (same contract as
    :func:`srp_argmax_reference`); raises on anything it does not take."""
    global launches
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
    if lib.att_srp_argmax.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.att_srp_argmax.argtypes = [vp] * 4 + [ci] * 5 + [vp]
        lib.att_srp_argmax.restype = ci
    return lib
