"""Small complex linear algebra of the subspace and adaptive estimators.

Counterpart of ``audio_triangulation_tpu.ops.linalg``, whose real block
embeddings [[A, -B], [B, A]] stand in for the complex eigh and LU a TPU
lacks.  torch has both on complex tensors, so the three functions keep
their names and contracts and compute on ``complex64`` directly:

- :func:`complex_eigh`: ``torch.linalg.eigh`` (each eigenvalue once, not
  twice as in the embedding);
- :func:`subspace_projector_quadform`: ||U^H a||^2 for an orthonormal
  basis U of the subspace (the reference's 0.5 ||W^H a||^2 of the
  embedded basis W is the same number);
- :func:`complex_solve`: ``torch.linalg.solve``.

``torch.linalg.eigh`` and ``torch.linalg.solve`` read their status back to
the host on a CUDA device; the callers are once-a-scene paths.
"""

from __future__ import annotations

import torch


def complex_eigh(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigenvalues [..., M] ascending and unit eigenvectors [..., M, M] (one
    a column) of Hermitian r [..., M, M].  Only eigenvalues, projectors and
    quadratic forms are defined: the vectors of a repeated eigenvalue are
    any basis of its eigenspace, and each vector any phase."""
    return torch.linalg.eigh(r)


def subspace_projector_quadform(vecs: torch.Tensor,
                                a: torch.Tensor) -> torch.Tensor:
    """a^H P_S a = ||U^H a||^2 for the subspace S with orthonormal basis
    ``vecs`` U [..., M, K] complex, over steering vectors ``a`` [..., M, G]
    complex.  Returns [..., G] real."""
    proj = torch.matmul(vecs.conj().transpose(-1, -2), a)  # [..., K, G]
    return (proj.real ** 2 + proj.imag ** 2).sum(dim=-2)


def complex_solve(r: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with r x = b: r [..., M, M] complex, b [..., M, K] complex."""
    return torch.linalg.solve(r, b)
