"""SRP scoring as a gather: correlograms [..., P, L] and the lag table
[P, G] -> every cell's score [..., G] and each frame's first-max cell, in
one pass.

The JAX package launches no Pallas kernel here: it scores with a matmul
against the one-hot steering matrix [P * L, G] (``ops.srp.
srp_scores_matmul``), an MXU workaround for a gather, and takes the argmax
after it.  Where the steering matrix is the lag table's one-hot, the
scores are sums of P correlogram values, one a pair, and this module
computes them so:

- :func:`scores_first_max_reference`, the plain PyTorch version: the
  gather in pair order (after the bf16 rounding ``srp_dtype`` asks for),
  NaN in every cell of a frame that holds a non-finite value (the
  product's 0 * inf and 0 * NaN), and ``argmax``'s first maximum;
- :func:`launch`, ``csrc/srp_gather.cu``: one kernel launch that reads the
  correlograms once, writes the scores once and returns the cells, equal
  to the plain version bit for bit.  Its scores are a view of rows padded
  to a multiple of 32 bytes (a row that starts inside a sector costs the
  kernel a third of its time).  It launches on the current stream and
  allocates only its outputs, so a captured step
  (``StreamingLocalizer.graph_step_many``, ``utils.serving.aot_compile``)
  replays it.

:func:`is_lag_onehot` decides once, when an estimator is built, whether
its steering matrix is the one-hot of its lag table ``lut_flat``; the
kernel then reads that table (int32 on the device, narrowed to bytes as a
CTA stages it).  :func:`route` decides a call from what it can observe
(:func:`refusal`: that flag, no score bias, float32 correlograms on a CUDA
device with the table, lags that fit a byte, and the table and two frame
tiles in shared memory, as the library reckons it); it counts the span
system's ``srp.route.kernel`` or ``srp.route.product``.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ...utils import profiling
from . import _build

launches = 0

MAX_LAGS = 256  # the kernel stages the lags as uint8
ROW_ALIGN = 8  # the scores' rows are padded to 32 bytes
DTYPES = ("float32", "bfloat16")


def is_lag_onehot(lut_flat: Optional[torch.Tensor],
                  onehot: Optional[torch.Tensor], num_lags: int) -> bool:
    """Whether ``onehot`` [P * L, G] is the one-hot steering matrix of the
    integer ``lut_flat`` [P, G] (a 1 at row p * L + lut[p, g] of column g,
    0 elsewhere, every lag in [0, L)): then the kernel scores what that
    product scores.  Compares on the device, once: call it when an
    estimator is built, never a call."""
    if (lut_flat is None or onehot is None or lut_flat.is_meta
            or onehot.is_meta or lut_flat.ndim != 2
            or lut_flat.is_floating_point() or lut_flat.numel() == 0):
        return False
    p, g = lut_flat.shape
    if tuple(onehot.shape) != (p * num_lags, g):
        return False
    if int(lut_flat.min()) < 0 or int(lut_flat.max()) >= num_lags:
        return False
    lags = torch.arange(num_lags, dtype=lut_flat.dtype,
                        device=lut_flat.device)
    want = (lut_flat[:, None, :] == lags[None, :, None]).reshape(
        p * num_lags, g)
    return bool(torch.equal(onehot.to(lut_flat.device),
                            want.to(onehot.dtype)))


def refusal(corr: torch.Tensor, lut: Optional[torch.Tensor],
            lag_onehot: bool = True, has_bias: bool = False) -> Optional[str]:
    """Why the kernel does not score ``corr`` [..., P, L] at the lags
    ``lut`` [P, G] (None: it does).  ``lag_onehot`` is
    :func:`is_lag_onehot` of the estimator's steering matrix.  Only a call
    that passes every other check asks the library whether the shape fits
    shared memory: the library is built only where there is a card."""
    if not lag_onehot:
        return "the steering matrix is not the one-hot of the lag table"
    if has_bias:
        return "a score bias"
    if corr.dtype != torch.float32 or corr.ndim < 2:
        return (f"correlograms {tuple(corr.shape)} {corr.dtype}: the kernel "
                "takes float32 [..., P, L]")
    if lut is None or lut.dtype != torch.int32 or lut.ndim != 2:
        return "no int32 lag table [P, G]"
    (p, l), g = corr.shape[-2:], lut.shape[1]
    if p != lut.shape[0]:
        return f"{p} pairs of correlograms against a table of {lut.shape[0]}"
    if l > MAX_LAGS:
        return f"{l} lags: the kernel stages them as bytes (up to {MAX_LAGS})"
    if not corr.is_cuda:
        return f"correlograms on {corr.device}: the kernel runs on CUDA"
    if lut.device != corr.device:
        return f"the lag table on {lut.device}, the correlograms on " \
            f"{corr.device}"
    if corr.requires_grad:
        return "correlograms that require grad (the kernel has no backward)"
    if _lib().att_srp_gather_tile(p, l, g) < 1:
        return (f"{p} pairs x {l} lags and {g} cells do not fit a block's "
                "shared memory")
    return None


def route(corr: torch.Tensor, lut: Optional[torch.Tensor],
          lag_onehot: bool, has_bias: bool = False) -> bool:
    """Whether :func:`launch` scores ``corr`` (no :func:`refusal`), else
    today's scoring.  Counts the route in the span system
    (``srp.route.kernel`` / ``srp.route.product``)."""
    kernel = refusal(corr, lut, lag_onehot, has_bias) is None
    profiling.count("srp.route.kernel" if kernel else "srp.route.product")
    return kernel


def _check_dtype(dtype: str) -> None:
    if dtype not in DTYPES:
        raise ValueError(f"dtype={dtype!r}: the SRP gather takes {DTYPES}")


def scores_first_max_reference(corr: torch.Tensor, lut: torch.Tensor,
                               dtype: str = "float32"):
    """Plain PyTorch version of the kernel: (scores [..., G] in ``corr``'s
    dtype, first-max cell [...] int64).  With ``dtype`` 'bfloat16' each
    value is rounded to bf16 first; the values at the lags ``lut`` [P, G]
    are added in the order p = 0..P-1 from 0; a frame holding a non-finite
    value scores NaN in every cell; the cell is ``argmax``'s (NaN above
    every number, the first index on a tie)."""
    _check_dtype(dtype)
    c = corr.to(torch.bfloat16).to(corr.dtype) if dtype == "bfloat16" \
        else corr
    idx = lut.to(device=corr.device, dtype=torch.long)
    scores = torch.zeros((*c.shape[:-2], idx.shape[1]), dtype=c.dtype,
                         device=c.device)
    for p in range(idx.shape[0]):
        scores = scores + c[..., p, :].index_select(-1, idx[p])
    bad = ~torch.isfinite(c).flatten(-2).all(dim=-1)
    scores = torch.where(bad[..., None], torch.nan, scores)
    return scores, scores.argmax(dim=-1)


def launch(corr: torch.Tensor, lut: torch.Tensor, dtype: str = "float32"):
    """Run ``csrc/srp_gather.cu`` (same contract as
    :func:`scores_first_max_reference`); raises ValueError on what it
    refuses (:func:`refusal`).  The lags are not range-checked here (that
    would sync with the device): pass a table whose one-hot
    :func:`is_lag_onehot` found, every lag below L."""
    global launches
    _check_dtype(dtype)
    _build.refuse_grad("srp_gather_kernel", corr)
    why = refusal(corr, lut)
    if why is not None:
        raise ValueError(f"the SRP gather kernel does not take these: {why}")
    *lead, p, l = corr.shape
    g = lut.shape[1]
    corr = corr.contiguous()
    lut = lut.contiguous()
    b = corr.numel() // (p * l)
    if b > 0x7FFFFFFF:
        raise ValueError(f"{b} frames are more than the kernel takes")
    # rows padded to 32 bytes: the scores are a view of their first G
    ldo = -(-g // ROW_ALIGN) * ROW_ALIGN
    rows = torch.empty((*lead, ldo), dtype=torch.float32, device=corr.device)
    cell = torch.empty(lead, dtype=torch.int64, device=corr.device)
    if b > 0:
        lib = _lib()
        with torch.cuda.device(corr.device):
            err = lib.att_srp_gather(
                corr.data_ptr(), lut.data_ptr(), rows.data_ptr(),
                cell.data_ptr(), b, p, l, g, ldo, int(dtype == "bfloat16"),
                torch.cuda.current_stream(corr.device).cuda_stream)
        with _build.count_lock:
            launches += 1
        _build.check(err, "srp_gather_kernel launch", lib)
    return rows[..., :g], cell


def _lib():
    lib = _build.load_library()
    with _build.bind_lock:  # threads may ask at once
        if lib.att_srp_gather.argtypes is None:
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.att_srp_gather.argtypes = [vp] * 4 + [ci] * 6 + [vp]
            lib.att_srp_gather.restype = ci
            lib.att_srp_gather_tile.argtypes = [ci] * 3
            lib.att_srp_gather_tile.restype = ci
    return lib
