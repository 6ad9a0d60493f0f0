"""Microbenchmark: the fused GCC kernel's matmul shape in f32, bf16 and int8.

Counterpart of ``tools/int8_microbench.py`` in the JAX package.  The GCC
kernel's matrix work per tile is two [rows, N] @ [N, F] DFT products; this
tool runs that shape through ``ops.cuda.dft_matmul`` in each operand type
and reports ms per call and T(FL)OP/s, to decide whether an int8 or bf16
numerics mode could pay before building one.  All three run on the tensor
cores; f32 as the split-fp32 product (three TF32 products per matrix)
that every fp32 DFT of the main path uses, so the types compare as this
card runs them.

The loop is chained: the scalar added to ``x`` in call i is call i - 1's
``out[0, 0] % 3``, computed on the device, so the calls are sequential and
nothing is read by the host inside the loop.  CUDA events time it.

    python -m audio_triangulation_tpu_torch.tools.int8_microbench
        [--rows 256] [--n 1024] [--f 512] [--grid 256] [--iters 40]
        [--device cuda]

``--device cpu`` runs the plain PyTorch version (for tests; its times say
nothing about the card).  A type set that fails to build or launch ends the
run with a non-zero exit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..ops.cuda import dft_matmul


def make_inputs(dtype_name: str, rows: int, n: int, f: int, grid: int,
                device, seed: int = 0):
    """(x [grid * rows, n], w [n, f], carry dtype) of a type set, from a
    seed: int8 x in [-64, 64) and w in [-127, 128), else standard normal
    values rounded to the type."""
    in_dt, acc_dt, _ = dft_matmul.TYPE_SETS[dtype_name]
    rng = np.random.default_rng(seed)
    if dtype_name == "int8":
        x = rng.integers(-64, 64, (grid * rows, n)).astype(np.int8)
        w = rng.integers(-127, 128, (n, f)).astype(np.int8)
        return (torch.from_numpy(x).to(device), torch.from_numpy(w).to(device),
                acc_dt)
    x = rng.standard_normal((grid * rows, n), dtype=np.float32)
    w = rng.standard_normal((n, f), dtype=np.float32)
    return (torch.from_numpy(x).to(device).to(in_dt),
            torch.from_numpy(w).to(device).to(in_dt), acc_dt)


def carry(out: torch.Tensor) -> torch.Tensor:
    """The next call's scalar: ``out[0, 0] % 3`` with the divisor's sign, as
    one value of the output's dtype, on the output's device."""
    return torch.remainder(out[:1, 0], 3)


def chained(x: torch.Tensor, w: torch.Tensor, acc_dt, iters: int):
    """``iters`` chained calls from a zero scalar; returns the last scalar."""
    s = torch.zeros((1,), dtype=acc_dt, device=x.device)
    for _ in range(iters):
        s = carry(dft_matmul.dft_matmul(x, w, w, s))
    return s


def run(dtype_name: str, rows: int, n: int, f: int, grid: int, iters: int,
        device) -> float:
    """Seconds per call of one type set, printed with its rate."""
    x, w, acc_dt = make_inputs(dtype_name, rows, n, f, grid, device)
    chained(x, w, acc_dt, 2)  # build, warm up
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chained(x, w, acc_dt, iters)
        stop.record()
        torch.cuda.synchronize()
        dt = start.elapsed_time(stop) / 1e3 / iters
    else:
        t0 = time.perf_counter()
        chained(x, w, acc_dt, iters)
        dt = (time.perf_counter() - t0) / iters
    flops = 2 * 2 * grid * rows * n * f
    print(f"{dtype_name:>5}: {dt * 1e3:8.3f} ms/iter  "
          f"{flops / dt / 1e12:7.1f} T(FL)OPS", flush=True)
    return dt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=256)   # frames a tile x mics
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--f", type=int, default=512)
    ap.add_argument("--grid", type=int, default=256)   # 16,384 frames / 64
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(f"device: {torch.cuda.get_device_name(args.device)}",
              flush=True)
    for d in ("f32", "bf16", "int8"):
        run(d, args.rows, args.n, args.f, args.grid, args.iters, args.device)


if __name__ == "__main__":
    main()
