"""Acoustic event detection over sample streams.

Counterpart of ``audio_triangulation_tpu.ops.detector``.  The firmware keeps
running sums and sums of squares of each mic's newest half frame
("incoming") and the half frame before it ("outgoing"); an event triggers
when the mic-summed outgoing variance exceeds the incoming one plus a
threshold, i.e. when a transient has fully entered the older half.  The
per-sample recurrences are prefix sums, so the statistic at EVERY sample
position comes from two cumulative sums, batched over streams and mics:

    incoming_power(t) = H * S2[t-H+1 .. t]   - S1[t-H+1 .. t]^2
    outgoing_power(t) = H * S2[t-2H+1 .. t-H] - S1[t-2H+1 .. t-H]^2

with H = frame / 2.  Integer input is exact in int64.

Trigger positions must equal the reference's exactly, so the float prefix
sums keep the reference's summation order (``cuda.detector_scan``).
The reference's one-hot matmul forms of the window capture were TPU gather
workarounds; :func:`extract_window_mm` is a direct gather here, bit-equal.
"""

from __future__ import annotations

import torch

from ..core.config import PipelineConfig
from .cuda import detector_scan


def _windowed(c: torch.Tensor, win: int) -> torch.Tensor:
    """Trailing-window sums from inclusive prefix sums c [..., T]."""
    shifted = torch.nn.functional.pad(c[..., :-win], (win, 0))
    return c - shifted


def half_window_powers(streams: torch.Tensor, frame_size: int):
    """(incoming, outgoing) detector powers at every sample position of
    streams [..., T], integer or float.  Positions t < frame_size - 1 are
    partial (``trigger_mask`` masks them).  Integer input uses exact int64
    arithmetic; the float path sums in the input dtype (both prefix sums
    from one launch of the scan kernel on a CUDA device, which takes
    float32), which is exact enough for windows of about a frame plus a
    chunk, not for long offline streams (pass those as integers)."""
    half = frame_size // 2
    if streams.is_floating_point():
        c1, c2 = detector_scan.prefix_sums(streams)
        s1, s2 = _windowed(c1, half), _windowed(c2, half)
    else:
        x = streams.to(torch.int64)
        s1 = _windowed(torch.cumsum(x, dim=-1), half)
        s2 = _windowed(torch.cumsum(x * x, dim=-1), half)
    inc = half * s2 - s1 * s1
    # the outgoing window ends half a frame earlier: outgoing[t] is
    # incoming[t - half]
    out = torch.nn.functional.pad(inc, (half, 0))[..., : streams.shape[-1]]
    return inc, out


def trigger_mask(streams: torch.Tensor, cfg: PipelineConfig,
                 mic_axis: int = -2) -> torch.Tensor:
    """Boolean [..., T] mask of trigger positions of streams [..., M, T]: the
    mic-summed outgoing power exceeds the threshold plus the mic-summed
    incoming power (``trigger_mode='absolute'``) or the threshold plus
    ``trigger_ratio`` times it, compared in float32 (``'relative'``), and
    the full frame window is populated (t >= frame_size - 1)."""
    inc, out = half_window_powers(streams, cfg.frame_size)
    inc_sum = inc.sum(dim=mic_axis)
    out_sum = out.sum(dim=mic_axis)
    t = torch.arange(streams.shape[-1], device=streams.device)
    is_full = t >= cfg.frame_size - 1
    if cfg.trigger_mode == "relative":
        fire = (out_sum.to(torch.float32)
                > float(cfg.detect_threshold)
                + float(cfg.trigger_ratio) * inc_sum.to(torch.float32))
    elif cfg.trigger_mode == "absolute":
        fire = out_sum > cfg.detect_threshold + inc_sum
    else:
        raise ValueError(f"unknown trigger_mode {cfg.trigger_mode!r}")
    return fire & is_full


def first_true(mask: torch.Tensor):
    """(index [...] int64, found [...] bool) of the first True along the
    last axis of a boolean mask; index 0 where there is none (``argmax`` of
    the mask as integers returns its first maximum)."""
    return mask.to(torch.uint8).argmax(dim=-1), mask.any(dim=-1)


def first_trigger(streams: torch.Tensor, cfg: PipelineConfig):
    """(index [...], found [...]) of the first trigger along the last axis,
    the sequential loop's first break.  Index 0 when there is none."""
    idx, found = first_true(trigger_mask(streams, cfg))
    return torch.where(found, idx, torch.zeros_like(idx)), found


def extract_window_mm(window: torch.Tensor, start: torch.Tensor, n: int,
                      max_start: int) -> torch.Tensor:
    """window [..., M, W], start [...] -> the n samples from ``start``
    (clamped to [0, max_start]) of every mic: [..., M, n].  The reference
    does this as a coarse select and a one-hot matmul, bit-exact; here it
    is a gather."""
    start = start.clamp(0, max_start).long()
    idx = start[..., None, None] + torch.arange(n, device=window.device)
    return window.gather(-1, idx.expand(*window.shape[:-1], n))


def extract_frames_at(streams: torch.Tensor, trigger_idx: torch.Tensor,
                      frame_size: int) -> torch.Tensor:
    """The frame_size samples ENDING at trigger_idx per batch entry:
    streams [B, M, T], trigger_idx [B] -> [B, M, frame_size] (the ring's
    contents at the firmware's break, oldest first).  Starts before the
    stream clamp to 0."""
    start = (trigger_idx.long() - (frame_size - 1)).clamp_min(0)
    idx = start[:, None, None] + torch.arange(frame_size,
                                              device=streams.device)
    return streams.gather(-1, idx.expand(-1, streams.shape[1], -1))


def all_triggers_capped(streams: torch.Tensor, cfg: PipelineConfig,
                        max_events: int, refractory: int = 0):
    """Up to ``max_events`` trigger indices per stream with a holdoff of
    ``refractory`` samples (a frame when 0) after each: (indices
    [B, max_events], valid [B, max_events]).  Absent events are masked, not
    dropped."""
    mask = trigger_mask(streams, cfg)  # [B, T]
    t = torch.arange(mask.shape[-1], device=mask.device)
    hold = refractory if refractory > 0 else cfg.frame_size
    idxs, valids = [], []
    for _ in range(max_events):
        idx, found = first_true(mask)
        within = (t >= idx[:, None]) & (t < idx[:, None] + hold)
        mask = mask & ~(within & found[:, None])
        idxs.append(torch.where(found, idx, torch.zeros_like(idx)))
        valids.append(found)
    return torch.stack(idxs, dim=-1), torch.stack(valids, dim=-1)
