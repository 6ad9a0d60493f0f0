"""Roofline arithmetic: the published peaks of one H100 and the least time
the card could take for a kernel's work.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at its full power limit
of 700 W (a run prints the card's own limit beside every share).  A share
of the roofline is the bound over the measured time; the operations and
bytes are counted from the shapes, each input byte read once and each
output byte written once.  The counts are those of the program's smoke
test (``chip_smoke.py`` ``bound``, ``gcc_bound`` and the scan's bound).
"""

from __future__ import annotations

import subprocess

PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_PER_S = 3.35e12


def bound(flops: float, nbytes: float, rate: float = PEAK_FP32_FLOPS) -> dict:
    """The larger of the operations at ``rate`` and the bytes at the
    memory's rate, in ms, and which of the two it is."""
    t_ops = flops / rate * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def gcc_bound(b, m, n, f, p, l, *, with_peaks=True,
              split_products=True) -> dict:
    """One GCC kernel launch on [b, m, n] frames with f bins, p pairs and
    l lags: the DFT (re and im of f bins a sample), the cross-power and the
    lag synthesis (a cos and a sin term a bin and lag); frames, window, DFT
    and synthesis matrices read, correlograms and the four [b, p] peak
    outputs written.  With ``split_products`` the DFT and the synthesis
    count as three TF32 products each on the tensor cores and the rest at
    the fp32 rate, one after the other."""
    products = b * 4 * (m * n * f + p * f * l)
    flops = b * 6 * p * f + products
    nbytes = 4 * (b * m * n + n + 2 * n * f + 2 * f * l + 2 * p
                  + b * p * l + (4 * b * p if with_peaks else 0))
    if split_products:
        flops = (flops - products
                 + 3 * products * PEAK_FP32_FLOPS / PEAK_TF32_FLOPS)
    return bound(flops, nbytes)


def scan_bound(numel: int) -> dict:
    """The detector's two prefix sums over ``numel`` float32 samples: two
    operations a sample, the samples read once and both sums written."""
    return bound(2 * numel, 3 * 4 * numel)


def power_limit_w(index: int = 0):
    """The card's power limit in watts (``nvidia-smi``), or None."""
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True)
        return float(smi.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None
