"""The detector's prefix sums: x [..., T] f32 -> the inclusive prefix sums of
x and of x * x along the last axis, in the reference's summation order.

The JAX package launches no Pallas kernel here: its detector sums 128-wide
blocks with a triangular matmul and scans the block totals
(``audio_triangulation_tpu.ops.detector._blocked_cumsum_f32``).  Trigger
positions come out of that order of adds, so both devices of this package
repeat it add for add:

- :func:`prefix_sums_reference`, the plain PyTorch version, one small op per
  position (what CPU tensors take);
- :func:`launch`, ``csrc/detector_scan.cu``: one kernel launch that reads x
  once and writes both sums, equal to the plain version bit for bit.  It
  launches on the current stream and allocates only its outputs, so a
  captured step (``StreamingLocalizer.graph_step_many``) replays it.

``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

CUMSUM_BLOCK = 128
MAX_SAMPLES = CUMSUM_BLOCK * 4096  # the kernel's longest row


def _serial_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, every partial sum rounded
    in ``x``'s dtype in index order, one add per position (``torch.cumsum``
    accumulates float32 in float64 on the CPU and scans in parallel on a
    CUDA device: other last bits)."""
    acc = x[..., 0]
    sums = [acc]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
        sums.append(acc)
    return torch.stack(sums, dim=-1)


def _tiled_cumsum(x: torch.Tensor, tile: int = 16) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in the order the reference's
    compiler gives ``cumsum`` on the CPU, where the parity tests run it:
    serial inside ``tile``-wide tiles, plus the inclusive prefix sum of the
    tile totals (taken the same way) shifted by one tile."""
    n = x.shape[-1]
    if n <= tile:
        return _serial_cumsum(x)
    nt = -(-n // tile)
    xt = torch.nn.functional.pad(x, (0, nt * tile - n)).reshape(
        *x.shape[:-1], nt, tile)
    inner = _serial_cumsum(xt)
    incl = _tiled_cumsum(inner[..., -1], tile)
    offsets = torch.nn.functional.pad(incl[..., :-1], (1, 0))
    return (inner + offsets[..., None]).reshape(
        *x.shape[:-1], nt * tile)[..., :n]


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis in the reference's order,
    in plain PyTorch: serial sums inside 128-wide blocks, plus the exclusive
    prefix sum of the block totals (:func:`_tiled_cumsum`).  It differs from
    one serial ``cumsum`` in the last bits, and the reference's trigger
    positions come from this order."""
    t_len = x.shape[-1]
    nb = -(-t_len // CUMSUM_BLOCK)
    pad = nb * CUMSUM_BLOCK - t_len
    xb = torch.nn.functional.pad(x, (0, pad)).reshape(
        *x.shape[:-1], nb, CUMSUM_BLOCK)
    inblk = _serial_cumsum(xb)
    totals = inblk[..., -1]
    offsets = _tiled_cumsum(totals) - totals
    out = inblk + offsets[..., None]
    return out.reshape(*x.shape[:-1], nb * CUMSUM_BLOCK)[..., :t_len]


def prefix_sums_reference(x: torch.Tensor):
    """Plain PyTorch version of the kernel, in ``x``'s dtype: (prefix sums
    of x, prefix sums of x * x) along the last axis, each by
    :func:`blocked_cumsum` (the square is rounded before it is added)."""
    return blocked_cumsum(x), blocked_cumsum(x * x)


def launch(x: torch.Tensor):
    """Run ``csrc/detector_scan.cu`` on a CUDA tensor (same contract as
    :func:`prefix_sums_reference`, f32 only); raises on anything it does
    not take."""
    global launches
    _build.refuse_grad("detector_scan_kernel", x)
    if x.device.type != "cuda":
        raise ValueError(f"the detector scan kernel needs a CUDA tensor; x "
                         f"is on {x.device}")
    if x.dtype != torch.float32 or x.ndim < 1:
        raise ValueError(f"the detector scan kernel takes f32 [..., T]; got "
                         f"{tuple(x.shape)} {x.dtype}")
    t_len = x.shape[-1]
    if not 1 <= t_len <= MAX_SAMPLES:
        raise ValueError(f"rows of {t_len} samples: the detector scan kernel "
                         f"takes 1..{MAX_SAMPLES}")
    x = x.contiguous()
    rows = x.numel() // t_len
    if rows > 0x7FFFFFFF:
        raise ValueError(f"{rows} rows are more than the kernel's grid takes")
    out1, out2 = torch.empty_like(x), torch.empty_like(x)
    if rows > 0:
        lib = _lib()
        with torch.cuda.device(x.device):
            err = lib.att_detector_scan(
                x.data_ptr(), out1.data_ptr(), out2.data_ptr(), rows, t_len,
                torch.cuda.current_stream(x.device).cuda_stream)
        with _build.count_lock:
            launches += 1
        _build.check(err, "detector_scan_kernel launch", lib)
    return out1, out2


def prefix_sums(x: torch.Tensor):
    """(prefix sums of x, prefix sums of x * x) along the last axis of a
    floating-point x in the reference's order: the kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return prefix_sums_reference(x)
    return launch(x)


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_detector_scan.argtypes is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.att_detector_scan.argtypes = [vp] * 3 + [ci] * 2 + [vp]
            lib.att_detector_scan.restype = ci
    return lib
