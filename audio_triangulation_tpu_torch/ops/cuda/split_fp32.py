"""The split-fp32 product of the port's tensor-core kernels, in plain PyTorch.

A kernel that multiplies f32 operands on the tensor cores splits each into
two TF32 values, hi and lo (:func:`tf32_split`), and sums three TF32
products, ``a_lo b_hi``, ``a_hi b_lo`` and ``a_hi b_hi`` (``a_lo b_lo`` is
dropped), in fp32.  :func:`split_product` repeats that arithmetic in the
order of the sums each kernel's constants fix; every kernel's plain version
arranges its operands in the kernel's K order and calls it.
"""

from __future__ import annotations

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as the kernel and ``cvt.rna.tf32.f32`` do: half a TF32 ulp
    added to the magnitude bits, the 13 low bits cleared.  A dense operand
    keeps its strides."""
    bits = t.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(t: torch.Tensor):
    """(hi, lo), both TF32 values, with hi + lo within 2^-21 of t: hi is t
    rounded to TF32 and lo the rounded remainder."""
    hi = tf32_round(t)
    return hi, tf32_round(t - hi)


def split_product(a: torch.Tensor, b: torch.Tensor, *, k: int = 8,
                  tc_steps: int = 0, flush_steps: int = 0,
                  hi_only: bool = False) -> torch.Tensor:
    """a [..., K] @ b [K, N] -> [..., N] f32 in a tensor-core kernel's
    split-fp32 arithmetic, both operands already in the kernel's K order;
    each is split here by :func:`tf32_split`.  K goes in steps of ``k`` values;
    each step adds ``a_lo b_hi``, then ``a_hi b_lo``, then ``a_hi b_hi``
    (``a_hi b_hi`` alone with ``hi_only``, for operands that have no low
    part) to one f32 accumulator.  With ``tc_steps`` each group of that many
    steps is summed from zero first (the tensor cores' sum) and then added
    to the accumulator; with ``flush_steps`` the accumulator is added into
    a total and cleared every that many steps and at the end.  The products
    read the operands in their own layouts: a CPU matmul may sum a step's
    products in another order when the strides change."""
    a_hi, a_lo = tf32_split(a.float())
    b_hi, b_lo = tf32_split(b.float())
    n_steps = -(-a.shape[-1] // k)
    total = torch.zeros((*a.shape[:-1], b.shape[-1]), dtype=torch.float32,
                        device=a.device)
    acc = torch.zeros_like(total)
    group = torch.zeros_like(total) if tc_steps else acc
    for s in range(n_steps):
        ks = slice(k * s, k * s + k)
        if tc_steps and s % tc_steps == 0:
            group.zero_()
        if not hi_only:
            group += a_lo[..., ks] @ b_hi[ks]
            group += a_hi[..., ks] @ b_lo[ks]
        group += a_hi[..., ks] @ b_hi[ks]
        if tc_steps and ((s + 1) % tc_steps == 0 or s + 1 == n_steps):
            acc += group
        if flush_steps and (s + 1) % flush_steps == 0:
            total += acc
            acc.zero_()
    return total + acc
