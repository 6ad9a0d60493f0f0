"""Stream -> overlapped frames (the batch analogue of the rolling capture).

Counterpart of ``audio_triangulation_tpu.ops.framing``.  The firmware
captures one frame per detected event; the batched offline equivalent is
dense overlapped framing of a long stream.  The reference builds it from
reshapes because strided gathers were slow on its hardware; ``unfold``
gives the same frames here.
"""

from __future__ import annotations

import numpy as np
import torch


def _n_frames(t: int, frame_size: int, hop: int) -> int:
    n_frames = (t - frame_size) // hop + 1
    if n_frames <= 0:
        raise ValueError("stream shorter than one frame")
    return n_frames


def frame_stream(stream: torch.Tensor, frame_size: int,
                 hop: int) -> torch.Tensor:
    """stream [..., T] -> frames [..., n_frames, frame_size] with the given
    hop; n_frames = (T - frame_size) // hop + 1."""
    _n_frames(stream.shape[-1], frame_size, hop)
    return stream.unfold(-1, frame_size, hop).contiguous()


def frame_multichannel(stream: torch.Tensor, frame_size: int,
                       hop: int) -> torch.Tensor:
    """[M, T] -> [n_frames, M, frame_size] (pipeline-ready ordering)."""
    f = frame_stream(stream, frame_size, hop)  # [M, F, N]
    return f.movedim(-3, -2).contiguous() if f.ndim == 3 else f


def frame_multichannel_lanes(stream: torch.Tensor, frame_size: int,
                             hop: int):
    """[M, T] -> (frames [n_frames, M, frame_size] in LANE order, time_order
    [n_frames] numpy), for hop | frame_size: frames grouped by start-offset
    residue (lane k = frames starting at k * hop mod frame_size), the
    reference's layout for its hardware, returned as the reference returns
    it.  ``frames[order]`` is time order; restore it on the small per-frame
    outputs (``xy[order]``)."""
    if frame_size % hop != 0:
        raise ValueError("lane framing needs hop | frame_size "
                         f"(got {hop} vs {frame_size})")
    n_frames = _n_frames(stream.shape[-1], frame_size, hop)
    r = frame_size // hop
    lanes, order_src = [], []
    for k in range(min(r, n_frames)):
        start = k * hop
        n_k = (n_frames - 1 - k) // r + 1
        lane = stream[..., start: start + n_k * frame_size]
        lane = lane.reshape(*stream.shape[:-1], n_k, frame_size)
        lanes.append(lane.movedim(-3, -2))  # [F_k, M, N]
        order_src.extend(k + i * r for i in range(n_k))
    frames = torch.cat(lanes, dim=-3) if len(lanes) > 1 else lanes[0]
    order = np.argsort(np.asarray(order_src, np.int64), kind="stable")
    return frames.contiguous(), order
