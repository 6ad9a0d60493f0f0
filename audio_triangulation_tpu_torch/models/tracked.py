"""Tracked streaming: chunks in, tracks out, in one step.

Counterpart of ``audio_triangulation_tpu.models.tracked``: the streaming
localizer's chunk step (:func:`.streaming.stream_step`) and the Kalman
tracker bank update (:mod:`.tracking`) in one batched step of S streams,
with no host round trip between localization and association.  On the
card :meth:`TrackedStreamingLocalizer.graph_step_many` replays the whole
step as one CUDA graph, and :meth:`~TrackedStreamingLocalizer.
graph_step_many_scan` K steps a replay (the counterpart of the reference's
scanned dispatch).

Semantics per chunk:

- the localization half is exactly ``stream_step`` (same outputs);
- the tracker takes the chunk's event, the Gauss-Newton position ``xy``
  with its ``xy_cov`` as per-measurement noise (or the free 3-D ``xyz``
  under ``StreamConfig.solve_xyz``), at the accepted trigger's stream time,
  masked by the accept flag;
- chunks with no accepted event leave the tracker state untouched (the bank
  is event-driven: coasting and drop decisions happen at the next event);
- with ``StreamConfig.n_sources > 1`` every event slot's resolved sources
  update the bank jointly through the JPDA ``tracking.step_multi``, one
  slot after the other at each slot's trigger time (a slot without an
  event runs at the previous time with every measurement invalid, and is
  reverted);
- with ``fuse_velocity`` (needs ``StreamConfig.solve_velocity``, a
  single-model bank) the delay-Doppler velocity is a velocity measurement
  (``tracking.step(z_vel=...)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core.config import (GridConfig, PipelineConfig, SolverConfig,
                           StreamConfig)
from . import tracking as tracking_mod
from .streaming import (GraphedStep, StreamState, StreamingLocalizer,
                        _check_chunks, map_state, stream_step)
from .tracking import Tracker, TrackerConfig


@dataclasses.dataclass
class TrackedStreamState:
    """Carried state of the tracked step: the streaming localizer's state
    and the tracker bank's (``TrackState`` or ``ImmTrackState``), one
    stream or S streams stacked on a leading axis."""

    stream: StreamState
    track: Any


def _keep(mask: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """``new`` where the per-stream ``mask`` [S] is set, else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)),
                       new, old)


def _keep_state(mask, new, old):
    return type(new)(**{f.name: _keep(mask, getattr(new, f.name),
                                      getattr(old, f.name))
                        for f in dataclasses.fields(new)})


def tracked_stream_step(state: TrackedStreamState, chunks: torch.Tensor, *,
                        tracker_cfg: TrackerConfig, use_imm: bool,
                        fuse_velocity: bool = False, **stream_kwargs):
    """One tracked step of S stacked streams, chunks [S, M, C]: (new state,
    outputs).  ``outputs`` is ``stream_step``'s dict plus the tracker's
    ('track_xy', 'track_vel', 'track_active', 'track_confirmed',
    'track_id', 'assigned', and 'model_prob' for the IMM bank or 'beta' for
    the JPDA update).  Pure, like both halves."""
    s_state, out = stream_step(state.stream, chunks, **stream_kwargs)
    any_event = out["event"]  # [S]
    # measurement time: the last accepted event's stream time this chunk.
    # On a no-event chunk the tracker state is reverted below and t is
    # pinned to the previous event time, so the speculative update runs at
    # dt = 0 and its outputs equal the carried state's (no stale drops, no
    # prediction), which the output passthrough below relies on
    t = torch.where(any_event, s_state.last_event_s,
                    state.stream.last_event_s)
    if stream_kwargs.get("n_sources", 1) > 1:
        # joint JPDA updates from every event slot's resolved sources, in
        # slot order at each slot's trigger time; a slot without an event
        # runs at the previous time with invalid measurements and is
        # reverted, so it changes nothing
        t_state, t_out = state.track, None
        t_prev = state.stream.last_event_s
        for k in range(out["multi_xy"].shape[1]):
            ev_k = out["events"][:, k]
            t_k = torch.where(ev_k, out["event_time_s"][:, k], t_prev)
            s_new, o_k = tracking_mod.step_multi(
                t_state, out["multi_xy"][:, k], t_k, out["multi_valid"][:, k],
                tracker_cfg, z_covs=out["multi_xy_cov"][:, k])
            t_state = _keep_state(ev_k, s_new, t_state)
            t_out = o_k if t_out is None else {
                kk: _keep(ev_k, o_k[kk], v) for kk, v in t_out.items()}
            t_prev = t_k
    else:
        if stream_kwargs.get("xyz_z_inits") is not None:
            z, z_cov = out["xyz"], None  # the free 3-D solve has no cov
        else:
            z, z_cov = out["xy"], out["xy_cov"]
        if use_imm:
            t_state, t_out = tracking_mod.step_imm(
                state.track, z, t, any_event, tracker_cfg, z_cov=z_cov)
        else:
            t_state, t_out = tracking_mod.step(
                state.track, z, t, any_event, tracker_cfg, z_cov=z_cov,
                z_vel=out["velocity"] if fuse_velocity else None)

    # event-driven bank: silence leaves the tracker untouched (a masked
    # revert, so the step stays free of branches on tensors)
    t_state = _keep_state(any_event, t_state, state.track)
    # 'assigned' is -1 on a no-event chunk (nothing was associated); every
    # other output equals the carried state's there
    t_out["assigned"] = _keep(any_event, t_out["assigned"],
                              torch.full_like(t_out["assigned"], -1))
    out.update(t_out)
    return TrackedStreamState(stream=s_state, track=t_state), out


class TrackedStreamingLocalizer:
    """Streaming localizer and tracker bank in one step.

    >>> tsl = TrackedStreamingLocalizer.create(mics, stream=StreamConfig(
    ...     chunk_size=512), device="cuda")
    >>> states = tsl.init_states(4096)
    >>> states, out = tsl.step_many(states, chunks)   # chunks [S, M, C]
    >>> g = tsl.graph_step_many(tsl.init_states(4096), chunks)
    >>> out = g(chunks)                               # one graph replay

    Equality contract: the localization outputs equal
    :class:`StreamingLocalizer`'s bit for bit, and the tracker state after
    an event chunk equals feeding that chunk's measurement through
    ``Tracker.step``.
    """

    def __init__(self, sl: StreamingLocalizer, tracker: Tracker,
                 fuse_velocity: bool = False):
        self.sl = sl
        self.tracker = tracker
        # the delay-Doppler velocity as a tracker measurement
        self.fuse_velocity = fuse_velocity

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(),
        grid: GridConfig = GridConfig(),
        solver: SolverConfig = SolverConfig(),
        stream: StreamConfig = StreamConfig(),
        tracker_cfg: TrackerConfig | None = None,
        fuse_velocity: bool = False,
        *,
        device,
        **kwargs,
    ) -> "TrackedStreamingLocalizer":
        """Build the constants on ``device``; ``kwargs`` go to
        ``StreamingLocalizer.create``.  The default bank is 2-D, or 3-D with
        the 3-D gate under ``solve_xyz``."""
        if tracker_cfg is None:
            dim = 3 if stream.solve_xyz else 2
            tracker_cfg = TrackerConfig(
                dim=dim, gate_maha2=11.34 if dim == 3 else 9.21)
        if stream.solve_xyz and tracker_cfg.dim != 3:
            raise ValueError("StreamConfig.solve_xyz feeds xyz measurements"
                             " — tracker_cfg.dim must be 3")
        if stream.n_sources > 1 and tracker_cfg.imm_q:
            raise ValueError("multi-source chunks update via JPDA "
                             "step_multi, which does not support the IMM "
                             "bank (imm_q)")
        if fuse_velocity and not stream.solve_velocity:
            raise ValueError("fuse_velocity needs StreamConfig."
                             "solve_velocity (the CAF measurement)")
        if fuse_velocity and stream.n_sources > 1:
            raise ValueError("multi-source chunks update via JPDA "
                             "step_multi, which has no velocity-"
                             "measurement path — fuse_velocity needs "
                             "n_sources == 1")
        if fuse_velocity and tracker_cfg.imm_q:
            raise ValueError("velocity-measurement fusion is single-model "
                             "only (no imm_q)")
        sl = StreamingLocalizer.create(mic_positions, pipeline, grid, solver,
                                       stream, device=device, **kwargs)
        return cls(sl, Tracker(tracker_cfg, sl.params.window.device),
                   fuse_velocity)

    # ------------------------------------------------------------------
    def init_state(self) -> TrackedStreamState:
        """The state of one fresh stream (no leading axis)."""
        return TrackedStreamState(stream=self.sl.init_state(),
                                  track=self.tracker.init())

    def init_states(self, n_streams: int) -> TrackedStreamState:
        """The stacked state of ``n_streams`` fresh streams."""
        return TrackedStreamState(stream=self.sl.init_states(n_streams),
                                  track=self.tracker.init_many(n_streams))

    def _step(self, states, chunks):
        return tracked_stream_step(
            states, chunks, tracker_cfg=self.tracker.cfg,
            use_imm=bool(self.tracker.cfg.imm_q),
            fuse_velocity=self.fuse_velocity, **self.sl.step_kwargs())

    def __call__(self, state: TrackedStreamState, chunk: torch.Tensor):
        """One stream, one chunk [M, C]: (new state, outputs), both without
        a stream axis."""
        _check_chunks(chunk, self.sl.params, "chunk")
        new, out = self._step(map_state(lambda x: x[None], state),
                              chunk[None])
        return (map_state(lambda x: x[0], new),
                {k: v[0] for k, v in out.items()})

    def step_many(self, states: TrackedStreamState, chunks: torch.Tensor):
        """S streams advance in one batched step: ``states`` stacked on a
        leading axis, chunks [S, M, C].  The same step as the single-stream
        call, at any S (``batch_chunk_streams`` has no effect)."""
        _check_chunks(chunks, self.sl.params, "chunks")
        return self._step(states, chunks)

    def step_many_scan(self, states: TrackedStreamState,
                       chunks: torch.Tensor):
        """K chunk steps in one call: chunks [S, K, M, C], step k taking
        chunk k; outputs stacked with a leading K axis [K, S, ...], as the
        reference's scan returns them.  On the card,
        :meth:`graph_step_many_scan` replays the K steps as one graph."""
        _check_chunks(chunks, self.sl.params, "chunks")
        outs = []
        for k in range(chunks.shape[1]):
            states, out = self._step(states, chunks[:, k])
            outs.append(out)
        return states, {key: torch.stack([o[key] for o in outs])
                        for key in outs[0]}

    def graph_step_many(self, states: TrackedStreamState,
                        chunks: torch.Tensor) -> GraphedStep:
        """:meth:`step_many` for ``states`` and chunks of this shape,
        captured once as a CUDA graph: one replay per chunk.  CUDA only;
        see :class:`.streaming.GraphedStep` (its outputs and states are the
        graph's own buffers, overwritten by the next call)."""
        _check_chunks(chunks, self.sl.params, "chunks")
        return GraphedStep(self._step, states, chunks)

    def graph_step_many_scan(self, states: TrackedStreamState,
                             chunks: torch.Tensor) -> GraphedStep:
        """:meth:`step_many_scan` captured once as a CUDA graph: each
        replay takes chunks [S, K, M, C] and runs the K steps, outputs
        [K, S, ...].  CUDA only."""
        _check_chunks(chunks, self.sl.params, "chunks")
        return GraphedStep(self._step, states, chunks,
                           steps=chunks.shape[1])

    def run(self, streams):
        """Drive one whole [M, T] stream (array or tensor) through chunked
        steps from the host: (final state, list of per-chunk outputs as
        numpy arrays)."""
        c = self.sl.stream.chunk_size
        streams = torch.as_tensor(np.asarray(streams, np.float32),
                                  device=self.sl.params.window.device)
        state = self.init_state()
        outs = []
        for i in range(0, streams.shape[-1] - streams.shape[-1] % c, c):
            state, out = self(state, streams[:, i: i + c])
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return state, outs
