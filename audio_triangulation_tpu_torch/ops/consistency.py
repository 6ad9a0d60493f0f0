"""Pair-difference algebra shared by the solver (counterpart of
``audio_triangulation_tpu.ops.consistency``; only ``pair_selection`` so far)."""

from __future__ import annotations

import torch


def pair_selection(pairs: torch.Tensor, n_mics: int,
                   dtype=torch.float32) -> torch.Tensor:
    """The +-1 pair-difference matrix S [P, M] with tau_p = t_j - t_i."""
    one_hot = torch.nn.functional.one_hot
    return (one_hot(pairs[:, 1].long(), n_mics).to(dtype)
            - one_hot(pairs[:, 0].long(), n_mics).to(dtype))
