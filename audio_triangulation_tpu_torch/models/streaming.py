"""Streaming localizer: stateful chunked ingest with event detection and
EMA-smoothed correlograms.

Counterpart of ``audio_triangulation_tpu.models.streaming``.  Where the
firmware paces one sample every 20 us through a ring buffer and bursts
compute on a trigger, this consumes fixed-size chunks, detects triggers with
the vectorized variance detector and, masked, not branched, runs the
correlation and localization burst and the EMA update for chunks that hold
an event.  The serving shape is many streams at once: every function here
is written batched over a leading stream axis [S, ...] (the reference writes
one stream and ``vmap``s it), and the single-stream call adds that axis.
A step is pure: it returns a new :class:`StreamState` and never writes into
the one it was given.

Reference-parity behaviours:
- trigger = summed outgoing variance > threshold + summed incoming variance
- post-event ring reset: detection stays suppressed until a full frame of
  fresh samples has streamed in
- shift gate: events with sum(best_shift^2) <= gate do not update the EMA
- EMA decay 1 - exp(-dt / tau), dt the real time since the last accepted
  event

The reference's streaming step launches none of its hand kernels (it
correlates through the unfused matmul engine and solves with the batched
solver), so this path is plain torch on tensors, but for the detector's
prefix sums (``ops.detector``) and, on a CUDA device, the one-hot SRP
scores and their first-max cell (``ops.cuda.srp_gather``, where
``srp_gather.route`` takes them; the multi-source scores keep the
product).  On a CUDA device no step waits for the host: there is no
branch on a tensor and no constant copied per step.
``StreamConfig.batch_chunk_streams`` (the reference's sub-batch dispatch,
a limit of its compiler's fast memory) is accepted and changes nothing:
one batched step runs at any number of streams.  An eager step
is several hundred small launches, which the host cannot issue as fast as
the card runs them below a few thousand streams;
:meth:`StreamingLocalizer.graph_step_many` captures the same step once as
a CUDA graph (the counterpart of the reference's single compiled program)
and replays it per chunk.  ``solve_xyz`` adds the free 3-D position of the
smoothed TDOAs (multi-start Gauss-Newton), in the two-rate localizer too.
``n_sources > 1`` resolves simultaneous sources in every event slot from
its raw correlograms (``multi_*`` outputs), and ``solve_velocity`` adds the
delay-Doppler velocity of the primary captured frame (``ops.caf``; its
resampling operator is built once per localizer and captured with the
graph).  The two-rate localizer accepts both fields and ignores them, as the
reference's does; its ``with_audio`` adds each event slot's delay-and-sum
waveform at its position (``ops.beamform``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..core.config import (GridConfig, PipelineConfig, SolverConfig,
                           StreamConfig)
from ..ops import (beamform, caf, consistency, detector,
                   solver as solver_ops, srp, xcorr)
from ..ops._device import device_constant
from ..ops.cuda import srp_gather
from ..utils import profiling
from . import localizer as localizer_mod


@dataclasses.dataclass
class StreamState:
    """Carried state of the streaming localizer: one stream, or S streams
    stacked on a leading axis."""

    context: torch.Tensor  # [S, M, frame_size - 1] trailing samples
    ema_corr: torch.Tensor  # [S, P, L] float32 smoothed correlograms
    best_shift: torch.Tensor  # [S, P] int32 current best shifts
    time_s: torch.Tensor  # [S] stream clock (seconds)
    last_event_s: torch.Tensor  # [S] time of the last accepted event
    # countdown of fresh samples during which triggering stays suppressed
    # (the post-event ring refill)
    suppress: torch.Tensor  # [S] int32
    # absolute sample counter, for event reporting only (wraps after 2^31
    # samples, about 12 h at 50 kHz)
    abs_sample: torch.Tensor  # [S] int32
    event_count: torch.Tensor  # [S] int32


STATE_NAMES = tuple(f.name for f in dataclasses.fields(StreamState))


def map_state(fn, state):
    """``fn`` applied to every tensor of a state, a dataclass whose fields
    are tensors or such dataclasses (a ``StreamState``, or a tracked
    stream's state holding one and a tracker bank's)."""
    if dataclasses.is_dataclass(state):
        return type(state)(**{f.name: map_state(fn, getattr(state, f.name))
                              for f in dataclasses.fields(state)})
    return fn(state)


def state_leaves(state) -> list:
    """The tensors of a state (see :func:`map_state`), in field order."""
    if dataclasses.is_dataclass(state):
        return [leaf for f in dataclasses.fields(state)
                for leaf in state_leaves(getattr(state, f.name))]
    return [state]


def xyz_starts(stream: StreamConfig) -> Optional[tuple]:
    """The free 3-D solve's starting heights, or None without
    ``solve_xyz``."""
    return tuple(stream.xyz_z_inits) if stream.solve_xyz else None


def _init_state(params, cfg: PipelineConfig, lead: tuple) -> StreamState:
    dev = params.window.device
    m = params.mic_positions.shape[0]
    p = params.pairs.shape[0]
    n = cfg.frame_size

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros((*lead, *shape), dtype=dtype, device=dev)

    return StreamState(
        context=zeros(m, n - 1), ema_corr=zeros(p, cfg.num_lags),
        best_shift=zeros(p, dtype=torch.int32), time_s=zeros(),
        last_event_s=zeros(),
        suppress=torch.full(lead, n - 1, dtype=torch.int32, device=dev),
        abs_sample=zeros(dtype=torch.int32),
        event_count=zeros(dtype=torch.int32))


def _check_chunks(chunks, params, what: str) -> None:
    m = params.mic_positions.shape[0]
    if not isinstance(chunks, torch.Tensor):
        raise TypeError(f"{what} must be a torch.Tensor on the localizer's "
                        "device")
    if chunks.shape[-2] != m:
        raise ValueError(f"{what} must be [..., {m} mics, samples]; got "
                         f"{tuple(chunks.shape)}")
    if chunks.device != params.window.device:
        raise ValueError(f"{what} are on {chunks.device}; this localizer "
                         f"lives on {params.window.device}")
    if chunks.is_cuda:
        localizer_mod.pin_fp32()


class StreamingLocalizer:
    """Chunked streaming pipeline around a :class:`Localizer`'s constants.

    >>> sl = StreamingLocalizer.create(mics, stream=StreamConfig(
    ...     chunk_size=512), device="cuda")
    >>> states = sl.init_states(2048)
    >>> states, out = sl.step_many(states, chunks)   # chunks [2048, M, 512]
    >>> out["events"], out["xy"]                     # [2048, K], [2048, 2]
    """

    def __init__(self, base: localizer_mod.Localizer, stream: StreamConfig,
                 with_solver: bool = True):
        if stream.n_sources > 1:
            localizer_mod.check_planar(base.mic_positions,
                                       "StreamConfig.n_sources > 1")
        self.pipeline = base.pipeline
        self.grid = base.grid
        self.solver = base.solver
        self.stream = stream
        self.params = base.params
        self.srp_form = base.srp_form
        # Gauss-Newton refine of the smoothed peak each step
        self.with_solver = with_solver
        # solve_velocity's resampling operator, built once on the device
        # (the graphed step captures it), and whether the array is coplanar
        # (then the velocity is solved in the plane)
        self.caf_resample = None
        self.velocity_in_plane = False
        if stream.solve_velocity:
            cfg = base.pipeline
            self.caf_resample = caf.precompute_resample(
                cfg.frame_size, stream.velocity_v_max,
                stream.velocity_n_scales, cfg.speed_of_sound_mps, cfg=cfg,
                device=base.window.device)
            mics = base.mic_positions.cpu().numpy()
            self.velocity_in_plane = mics.shape[1] < 3 or bool(
                np.ptp(mics[:, 2]) < 1e-6)

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(),
        grid: GridConfig = GridConfig(),
        solver: SolverConfig = SolverConfig(),
        stream: StreamConfig = StreamConfig(),
        *,
        device,
        with_solver: bool = True,
        **kwargs,
    ) -> "StreamingLocalizer":
        """Build the constants on ``device``; ``kwargs`` go to
        ``Localizer.create`` (``srp_form``, ``init_grid_stride``)."""
        base = localizer_mod.Localizer.create(
            mic_positions, pipeline, grid, solver, device=device, **kwargs)
        return cls(base, stream, with_solver)

    # ------------------------------------------------------------------
    def init_state(self) -> StreamState:
        """The state of one fresh stream (no leading axis)."""
        return _init_state(self.params, self.pipeline, ())

    def init_states(self, n_streams: int) -> StreamState:
        """The stacked state of ``n_streams`` fresh streams."""
        return _init_state(self.params, self.pipeline, (n_streams,))

    def step_kwargs(self) -> dict:
        """The keyword arguments binding :func:`stream_step` to this
        localizer's configuration."""
        return dict(
            params=self.params, cfg=self.pipeline, grid_cfg=self.grid,
            solver_cfg=self.solver, srp_form=self.srp_form,
            max_events=self.stream.max_events_per_chunk,
            refractory=self.stream.refractory_samples,
            with_solver=self.with_solver,
            n_sources=self.stream.n_sources,
            multi_min_separation_m=self.stream.multi_min_separation_m,
            multi_assoc_window=self.stream.multi_assoc_window_samples,
            xyz_z_inits=xyz_starts(self.stream),
            velocity_v_max=self.stream.velocity_v_max,
            velocity_n_scales=self.stream.velocity_n_scales,
            velocity_in_plane=self.velocity_in_plane,
            caf_resample=self.caf_resample,
            health_weighting=self.stream.health_weighting,
            health_ratio=self.stream.health_ratio,
            health_floor_s=self.stream.health_floor_s)

    def __call__(self, state: StreamState, chunk: torch.Tensor):
        """One stream, one chunk [M, C]: (new state, outputs), both without
        a stream axis."""
        _check_chunks(chunk, self.params, "chunk")
        new, out = stream_step(map_state(lambda x: x[None], state),
                               chunk[None], **self.step_kwargs())
        return (map_state(lambda x: x[0], new),
                {k: v[0] for k, v in out.items()})

    def step_many(self, states: StreamState, chunks: torch.Tensor):
        """S independent streams advance in one batched step: ``states``
        stacked on a leading axis, chunks [S, M, C].  The serving shape:
        thousands of arrays sharing one card.  It runs the same step as the
        single-stream call, at any S (``batch_chunk_streams`` has no
        effect)."""
        _check_chunks(chunks, self.params, "chunks")
        return stream_step(states, chunks, **self.step_kwargs())

    def graph_step_many(self, states: StreamState,
                        chunks: torch.Tensor) -> "GraphedStep":
        """:meth:`step_many` for ``states`` and chunks of this shape,
        captured once as a CUDA graph: one replay per chunk in place of
        several hundred launches.  CUDA only.  See :class:`GraphedStep`."""
        _check_chunks(chunks, self.params, "chunks")
        kw = self.step_kwargs()
        return GraphedStep(lambda st, ch: stream_step(st, ch, **kw), states,
                           chunks)

    def run(self, streams):
        """Drive one whole [M, T] stream (array or tensor) through chunked
        steps from the host: (final state, list of per-chunk outputs as
        numpy arrays)."""
        c = self.stream.chunk_size
        dev = self.params.window.device
        streams = torch.as_tensor(np.asarray(streams), device=dev)
        state = self.init_state()
        outs = []
        for i in range(0, streams.shape[-1] - streams.shape[-1] % c, c):
            state, out = self(state, streams[:, i: i + c])
            outs.append({k: v.cpu().numpy() for k, v in out.items()})
        return state, outs


class GraphedStep:
    """Batched steps captured as one CUDA graph, with the stream states kept
    inside.

    >>> g = sl.graph_step_many(sl.init_states(2048), chunks)
    >>> out = g(chunks)      # advances g.states; one graph replay
    >>> g.states             # the carried state (static buffers)

    ``step(states, chunks) -> (new states, outputs)`` is any pure batched
    step; a state is a dataclass of tensors, nested or not (see
    :func:`map_state`).  With ``steps=K`` one replay runs K steps in turn:
    chunks are [S, K, ...], chunk k feeding step k, and each output is
    stacked to [K, S, ...].  The arithmetic is the eager steps' (the same
    ops are recorded, not rewritten).  ``out`` and ``states`` are the
    graph's own buffers: each call overwrites them, so read (or clone) what
    is needed before the next call.  Chunks must keep the captured shape.

    A call opens the spans ``stream.ingest`` (the chunk's copy) and
    ``stream.replay`` (``utils.profiling``).  Captured with tracing on, the
    step's own spans are event nodes of the graph: each replay made with
    tracing on yields one record a span, a child of ``stream.replay``,
    whose device time is read at the next call (waiting for the replay) or
    when the records are read; and it counts the frames the step
    correlates (``stream.frames_correlated``, an [S, K] ``events`` output's
    size a step) and the events it accepted (``stream.events_accepted``,
    from the states' ``event_count``)."""

    WARMUP_STEPS = 3

    def __init__(self, step, states, chunks: torch.Tensor, steps: int = 1):
        if not chunks.is_cuda:
            raise ValueError("a CUDA graph needs CUDA tensors; chunks are on "
                             f"{chunks.device}")
        if steps > 1 and chunks.shape[1] != steps:
            raise ValueError(f"chunks must be [S, {steps}, ...] for "
                             f"{steps} steps a replay; got "
                             f"{tuple(chunks.shape)}")
        self.states = map_state(torch.clone, states)
        self._chunks = chunks.to(torch.float32).clone()

        def run(st):
            if steps == 1:
                return step(st, self._chunks)
            outs = []
            for k in range(steps):
                st, out = step(st, self._chunks[:, k])
                outs.append(out)
            return st, {key: torch.stack([o[key] for o in outs])
                        for key in outs[0]}

        # warm up on a side stream, as capture asks (the step is pure:
        # nothing carries over)
        side = torch.cuda.Stream(chunks.device)
        side.wait_stream(torch.cuda.current_stream(chunks.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARMUP_STEPS):
                run(self.states)
        torch.cuda.current_stream(chunks.device).wait_stream(side)
        self._graph = torch.cuda.CUDAGraph()
        # with tracing on, the step's spans are captured as event nodes
        with (profiling.capture() as self._spans,
              torch.cuda.graph(self._graph)):
            new, self._out = run(self.states)
            for held, leaf in zip(state_leaves(self.states),
                                  state_leaves(new)):
                held.copy_(leaf)
        self._replayed = []
        # a stream step correlates one frame an event slot: [S, K] a step
        events = self._out.get("events")
        self._frames = 0 if events is None else events.numel()
        self._event_count = _leaf(self.states, "event_count")
        self._counted = None

    def __call__(self, chunks: torch.Tensor) -> dict:
        if chunks.shape != self._chunks.shape:
            raise ValueError(f"chunks must be {tuple(self._chunks.shape)}, "
                             f"the captured shape; got {tuple(chunks.shape)}")
        # the last replay's stage times, read before this one records over
        # its events
        profiling.resolve(self._replayed)
        if profiling.enabled() and self._event_count is not None:
            self._count()
        call = profiling.call_id()
        with profiling.annotate("stream.ingest", call=call):
            self._chunks.copy_(chunks)
        with profiling.annotate("stream.replay", call=call):
            self._graph.replay()
            self._replayed = profiling.replayed(self._spans)
        return self._out

    def _count(self) -> None:
        """Frames correlated, counted on the host each traced replay, and
        events accepted from the first on: the change in the states'
        ``event_count`` since then, read when the counts are read."""
        if self._counted != profiling.generation():
            self._counted = profiling.generation()
            held, base = self._event_count, self._event_count.clone()
            profiling.count_at_read(
                "stream.events_accepted",
                lambda: int((held - base).sum()))
        profiling.count("stream.frames_correlated", self._frames)


def _leaf(state, name: str):
    """The tensor field ``name`` of a state or of a state inside it (see
    :func:`map_state`), or None."""
    if not dataclasses.is_dataclass(state):
        return None
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        found = value if f.name == name else _leaf(value, name)
        if found is not None:
            return found
    return None


# ----------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _band_mask(cfg: PipelineConfig):
    """``xcorr.band_mask`` as one array per configuration, so its device
    copy is made once (``device_constant`` keys on the array)."""
    return xcorr.band_mask(cfg)


def _detect_and_capture(state: StreamState, chunks: torch.Tensor, *,
                        cfg: PipelineConfig, max_events: int,
                        refractory: int):
    """The detection front half, for chunks [S, M, C]: advance the detector
    over the chunk and extract up to ``max_events`` triggers and their
    captured frames.

    Returns (window [S, M, N-1+C], founds [S, K], t_rels [S, K] window
    indices, frames [S, K, M, N], trig_times [S, K] stream seconds, arm [S]
    countdown)."""
    n = cfg.frame_size
    fs = cfg.sample_rate_hz
    window = torch.cat([state.context, chunks.to(torch.float32)], dim=-1)

    # w indexes window positions; the fresh (this-chunk) positions start at
    # w = n - 1 (chunk sample 0)
    mask0 = detector.trigger_mask(window, cfg)  # [S, W]
    chunk_pos = torch.arange(mask0.shape[-1], device=window.device) - (n - 1)
    mask0 = mask0 & (chunk_pos >= 0)

    # sequential trigger extraction with post-event holdoff: ``arm`` is the
    # chunk-relative position from which triggering is armed; it starts at
    # the carried countdown and jumps past each event's frame refill plus
    # the configured refractory
    holdoff = n + refractory
    founds, t_rels = [], []
    arm = state.suppress.long()
    for _ in range(max_events):
        t_k, f_k = detector.first_true(mask0 & (chunk_pos >= arm[:, None]))
        founds.append(f_k)
        t_rels.append(t_k)
        arm = torch.where(f_k, (t_k - (n - 1)) + holdoff, arm)
    founds = torch.stack(founds, dim=-1)  # [S, K]
    t_rels = torch.stack(t_rels, dim=-1)  # [S, K]

    starts = (t_rels - (n - 1)).clamp_min(0)
    frames = detector.extract_window_mm(
        window[:, None].expand(-1, max_events, -1, -1), starts, n,
        max_start=window.shape[-1] - n)  # [S, K, M, N]
    trig_times = state.time_s[:, None] + (
        t_rels - (n - 1) + 1).to(torch.float32) / fs
    return window, founds, t_rels, frames, trig_times, arm


def stream_step(
    state: StreamState,
    chunks: torch.Tensor,  # [S, M, C]
    *,
    params: localizer_mod.LocalizerParams,
    cfg: PipelineConfig,
    grid_cfg: GridConfig,
    solver_cfg: SolverConfig,
    srp_form: str,
    max_events: int = 1,
    refractory: int = 0,
    with_solver: bool = False,
    n_sources: int = 1,
    multi_min_separation_m: float = 0.4,
    multi_assoc_window: float = 3.0,
    xyz_z_inits: Optional[tuple] = None,
    velocity_v_max: float = 8.0,
    velocity_n_scales: int = 33,
    velocity_in_plane: bool = False,
    caf_resample=None,
    health_weighting: bool = False,
    health_ratio: float = 3.0,
    health_floor_s: float = 1e-5,
):
    """One streaming step of S stacked streams: (new state, outputs dict,
    every value with the leading stream axis).

    Extracts up to ``max_events`` triggers per chunk (each followed by the
    full-frame refill holdoff plus ``refractory`` samples) and EMA-merges
    every accepted event in stream order.  ``with_solver`` adds a
    Gauss-Newton refine of the smoothed correlogram peak (``xy``, ``rms_m``,
    ``xy_cov``), and ``xyz_z_inits`` (starting heights; None: none) the free
    3-D position of the same TDOAs (``xyz``, ``xyz_rms_m``).
    Like ``xy``, they are computed for every stream at every step, from its
    smoothed state.  ``health_weighting`` turns the per-mic cycle-consistency
    scores into pair weights on the SRP scoring and the solve.

    With the solver, ``caf_resample`` (the operator of
    ``caf.precompute_resample`` at ``velocity_v_max`` and
    ``velocity_n_scales``; None: no velocity) adds the delay-Doppler
    velocity of each stream's primary captured frame at that position
    (``velocity`` [S, D], in the plane with ``velocity_in_plane``, and
    ``pair_rel_speed`` [S, P]); it is computed every step and means
    something where ``event`` is set.  ``n_sources`` > 1 resolves simultaneous sources in
    every event slot from its raw correlograms (SRP top-K, per-source TDOA
    re-measurement, batched solve; the scoring is f32 whatever
    ``srp_dtype`` says, as in the reference): ``multi_xy`` [S, K, n, 2],
    ``multi_score``, ``multi_rms_m`` [S, K, n], ``multi_tdoa_samples``
    [S, K, n, P], ``multi_xy_cov`` [S, K, n, 2, 2] and ``multi_valid``
    [S, K, n], sized for ``tracking.step_multi``."""
    n = cfg.frame_size
    c_len = chunks.shape[-1]
    fs = cfg.sample_rate_hz
    k_max = cfg.max_shift

    dev, call = chunks.device, profiling.call_id()
    with profiling.annotate("stream.detect", dev, call):
        window, founds, t_rels, frames, trig_times, arm = \
            _detect_and_capture(state, chunks, cfg=cfg,
                                max_events=max_events, refractory=refractory)

    # --- correlation bursts (computed every step, masked into the state) ---
    with profiling.annotate("stream.correlate", dev, call):
        x = localizer_mod.condition_frames(frames, params.window, cfg)
        corr = localizer_mod.correlate_frames(x, params, cfg)  # [S, K, P, L]

    with profiling.annotate("stream.smooth", dev, call):
        shifts = xcorr.best_lag(corr, k_max)  # [S, K, P]
        corr_t = (xcorr.peak_taper(corr, k_max, cfg.taper_denom, shifts)
                  if cfg.taper_enabled else corr)

        gates = (shifts * shifts).sum(dim=-1) > cfg.shift_gate
        accepts = founds & gates  # [S, K]

        # EMA with the real dt since the last accepted event, applied in
        # stream order (dt chains through accepted events)
        ema_corr = state.ema_corr
        last_event = state.last_event_s
        for k in range(max_events):
            dt = (trig_times[:, k] - last_event).clamp_min(0.0)
            decay = xcorr.ema_decay(dt, cfg.ema_tau_s)[:, None, None]
            ema_new = xcorr.ema_update(ema_corr, corr_t[:, k], decay)
            ema_corr = torch.where(accepts[:, k, None, None], ema_new,
                                   ema_corr)
            last_event = torch.where(accepts[:, k], trig_times[:, k],
                                     last_event)
        any_accept = accepts.any(dim=-1)
        best = torch.where(any_accept[:, None],
                           xcorr.best_lag(ema_corr, k_max), state.best_shift)

    # --- array health (every step): the TDOA cycle-consistency residual of
    # the smoothed correlogram peaks, in seconds
    with profiling.annotate("stream.health", dev, call):
        n_mics = params.mic_positions.shape[0]
        tdoa_samples = xcorr.subsample_peak(ema_corr, k_max)[0]  # [S, P]
        if (cfg.subsample_peak
                and cfg.subsample_method in ("phase", "hybrid")):
            # on EVENT steps, from the PRIMARY captured frame's spectra: the
            # EMA state carries no phase, but right after an accepted event
            # its peak tracks that event's correlogram, so the phase-slope
            # refinement anchors on the smoothed integer peak.  Other steps
            # (and, under 'hybrid', low-coherence pairs) keep the parabolic
            # estimate.
            spectra = xcorr.rfft_frames(x[:, 0], cfg.fft_length)  # [S, M, F]
            wm = _band_mask(cfg)
            if wm is not None:
                wm = device_constant(wm, spectra.device)
            elif cfg.band_auto:
                wm = xcorr.auto_band_weight(
                    spectra, params.pairs, cfg)[..., None, :]
            tdoa_phase = xcorr.tdoa_phase_slope(
                spectra, params.pairs, best, fft_length=cfg.fft_length,
                half_width=cfg.coherence_bins, eps=cfg.phat_eps,
                weight_mask=wm)
            use_phase = accepts[:, :1]
            if cfg.subsample_method == "hybrid":
                _, _, _, g2 = xcorr.smoothed_cross_stats(
                    spectra, params.pairs, cfg.coherence_bins,
                    eps=cfg.phat_eps)
                w_bins = (torch.ones_like(g2) if wm is None
                          else wm.to(g2.dtype).expand_as(g2))
                coh = ((g2 * w_bins).sum(dim=-1)
                       / w_bins.sum(dim=-1).clamp_min(1e-12))
                use_phase = use_phase & (coh >= cfg.hybrid_coherence_min)
            tdoa_samples = torch.where(use_phase, tdoa_phase, tdoa_samples)
        _, _, c_resid = consistency.project_consistent(
            tdoa_samples / fs, params.pairs, n_mics)
        mic_scores = consistency.mic_consistency_scores(
            c_resid, params.pairs, n_mics)
        w2_health = None
        if health_weighting:
            # leave-one-mic-out mic weights and seeded per-pair IRLS: a
            # failing channel's pairs are suppressed in BOTH the SRP init
            # grid and the solve (a dead mic is fully absorbed from 5 mics
            # on)
            w2_health, tdoa_clean_s, w_mic = consistency.fault_weights(
                tdoa_samples / fs, params.pairs, n_mics, ratio=health_ratio,
                floor=health_floor_s)

    # --- localization from the smoothed correlograms ---
    with profiling.annotate("stream.srp", dev, call):
        srp_in = (ema_corr if w2_health is None
                  else ema_corr * w2_health[..., None])
        cell = None
        if srp_form == "matmul" and srp_gather.route(
                srp_in, params.lut_flat, params.lag_onehot):
            # the one-hot product's scores and first-max cell (f32)
            scores, cell = srp_gather.launch(srp_in, params.lut_flat)
        elif srp_form == "matmul":
            scores = srp.srp_scores_matmul(srp_in, params.onehot)
        else:
            scores = srp.srp_scores_gather(srp_in, params.lut_flat)
        xy_grid = srp.grid_peak_xy(
            scores, (grid_cfg.height, grid_cfg.width),
            (grid_cfg.half_cells_x, grid_cfg.half_cells_y),
            grid_cfg.cells_per_m, flat_idx=cell)

    new_state = StreamState(
        context=window[..., -(n - 1):],
        ema_corr=ema_corr,
        best_shift=best,
        time_s=state.time_s + c_len / fs,
        last_event_s=last_event,
        # post-event: a full fresh frame is needed (the countdown is
        # relative, so arbitrarily long streams never overflow)
        suppress=(arm - c_len).clamp_min(0).to(torch.int32),
        abs_sample=state.abs_sample + c_len,
        event_count=state.event_count + accepts.sum(dim=-1).to(torch.int32),
    )
    event_abs = torch.where(
        founds, state.abs_sample[:, None] + (t_rels - (n - 1)),
        torch.full_like(t_rels, -1))
    out = {
        "event": accepts[:, 0] if max_events == 1 else any_accept,
        "triggered": founds.any(dim=-1),
        "trigger_abs": event_abs[:, 0],
        # per-slot event reporting
        "events": accepts,  # [S, K] accepted-event mask
        "events_found": founds,  # [S, K] raw trigger mask (pre shift gate)
        "event_trigger_abs": event_abs,  # [S, K]
        "event_time_s": trig_times,  # [S, K] stream seconds (valid iff found)
        "event_shifts": shifts,  # [S, K, P] per-event integer lags
        "best_shift": best,
        "tdoa_samples": tdoa_samples,
        "xy_grid": xy_grid,
        "event_count": new_state.event_count,
        "consistency_rms": torch.sqrt(torch.mean(c_resid * c_resid, dim=-1)),
        "mic_consistency": mic_scores,
    }
    if w2_health is not None:
        out["pair_weight"] = w2_health  # [S, P] fault-tolerance weights
        out["mic_weight"] = w_mic  # [S, M] leave-one-out mic weights
    if with_solver:
        with profiling.annotate("stream.solve", dev, call):
            # health path: solve the DENOISED TDOAs (every pair
            # re-synthesized from arrival times fitted to the healthy pairs)
            # with the IRLS weights; the solver squares its weights, so it
            # gets their root
            tdoa_s = tdoa_samples / fs if w2_health is None else tdoa_clean_s
            xy, rms = solver_ops.solve_tdoa_batched(
                tdoa_s, params.mic_positions, params.pairs,
                speed_of_sound=cfg.speed_of_sound_mps,
                height=grid_cfg.height_m,
                weights=None if w2_health is None else torch.sqrt(w2_health),
                init_xy=xy_grid, cfg=solver_cfg)
            out["xy"] = xy
            out["rms_m"] = rms
            out["xy_cov"] = solver_ops.solution_covariance(
                xy, rms, params.mic_positions, params.pairs,
                height=grid_cfg.height_m, cfg=solver_cfg)
            if xyz_z_inits is not None:
                out["xyz"], out["xyz_rms_m"] = (
                    solver_ops.solve_tdoa_xyz_multistart(
                        tdoa_s, params.mic_positions, params.pairs,
                        speed_of_sound=cfg.speed_of_sound_mps, init_xy=xy,
                        z_inits=xyz_z_inits))
            if caf_resample is not None:
                dd = caf.estimate_delay_doppler(
                    frames[:, 0], params.window, params.pairs, cfg,
                    v_max=velocity_v_max, n_scales=velocity_n_scales,
                    resample=caf_resample)
                if xyz_z_inits is not None:
                    pos = out["xyz"]
                else:
                    pos = torch.cat([xy, torch.full_like(xy[:, :1],
                                                         grid_cfg.height_m)],
                                    dim=-1)
                mic3 = params.mic_positions
                if mic3.shape[-1] < 3:
                    mic3 = localizer_mod.planar_mic3(mic3)
                out["velocity"] = caf.solve_velocity(
                    pos, dd["pair_rel_speed"], mic3, params.pairs,
                    in_plane=velocity_in_plane)
                out["pair_rel_speed"] = dd["pair_rel_speed"]

    if n_sources > 1:
        # from the raw per-event correlograms: the tapered, smoothed state
        # above keeps its single-source semantics
        if srp_form == "matmul":
            mscores = srp.srp_scores_matmul(corr, params.onehot)
        else:
            mscores = srp.srp_scores_gather(corr, params.lut_flat)
        res = localizer_mod.resolve_sources(
            corr, mscores, params, cfg=cfg, grid_cfg=grid_cfg,
            solver_cfg=solver_cfg, n_sources=n_sources,
            min_separation_m=multi_min_separation_m,
            assoc_window_samples=multi_assoc_window)
        out["multi_xy"] = res["xy"]  # [S, K, n, 2], strongest first
        out["multi_score"] = res["source_score"]
        out["multi_rms_m"] = res["rms_m"]
        out["multi_tdoa_samples"] = res["tdoa_samples"]
        out["multi_xy_cov"] = res["xy_cov"]
        out["multi_valid"] = accepts[..., None] & torch.ones(
            n_sources, dtype=torch.bool, device=accepts.device)
    return new_state, out


# ----------------------------------------------------------------------
# Two-rate serving: chunk-rate detection, event-rate localization
# ----------------------------------------------------------------------

def detect_step(state: StreamState, chunks: torch.Tensor, *,
                cfg: PipelineConfig, refractory: int = 0):
    """Detector-only step of S stacked streams (the cheap rate of the
    two-rate design): advances context, clocks and holdoff exactly like
    :func:`stream_step` but runs no correlation, SRP or solve.  Returns the
    captured frame and trigger metadata for a later event-rate pass
    (:meth:`TwoRateStreamingLocalizer.localize_triggered`)."""
    n = cfg.frame_size
    c_len = chunks.shape[-1]
    window, founds, t_rels, frames, trig_times, arm = _detect_and_capture(
        state, chunks, cfg=cfg, max_events=1, refractory=refractory)
    new_state = dataclasses.replace(
        state,
        context=window[..., -(n - 1):],
        time_s=state.time_s + c_len / cfg.sample_rate_hz,
        suppress=(arm - c_len).clamp_min(0).to(torch.int32),
        abs_sample=state.abs_sample + c_len)  # events count at localization
    out = {
        "triggered": founds[:, 0],
        "frame": frames[:, 0],  # [S, M, N] (valid iff triggered)
        "trig_time": trig_times[:, 0],
        "trigger_abs": torch.where(
            founds[:, 0], state.abs_sample + (t_rels[:, 0] - (n - 1)),
            torch.full_like(t_rels[:, 0], -1)),
    }
    return new_state, out


class TwoRateStreamingLocalizer:
    """Batched serving with split rates: detection every chunk for every
    stream (prefix sums only), localization only for streams that triggered,
    compacted into a fixed-capacity event batch.

        states, det = tr.detect_many(states, chunks)        # every chunk
        states, ev = tr.localize_triggered(states, det)     # event rate

    ``localize_triggered`` sorts triggered streams first (a stable sort of
    the mask: fixed shapes, no host round-trip), localizes the first
    ``event_capacity`` as one batch and scatters the updated EMA state back.
    Triggered streams beyond the capacity are dropped and counted
    (``overflow``).  Detection and holdoff are :func:`stream_step`'s.
    ``StreamConfig.n_sources`` and ``solve_velocity`` are accepted and change
    nothing here, as in the reference's two-rate localizer.  ``with_audio``
    also returns 'audio' [E, N]: the delay-and-sum waveform of each slot's
    raw frame at its position ('xy', or 'xy_grid' without the solver)."""

    def __init__(self, base: localizer_mod.Localizer, stream: StreamConfig,
                 event_capacity: int = 64, with_solver: bool = True,
                 with_audio: bool = False):
        self.pipeline = base.pipeline
        self.grid = base.grid
        self.solver = base.solver
        self.stream = stream
        self.params = base.params
        self.srp_form = base.srp_form
        self.event_capacity = event_capacity
        self.with_solver = with_solver
        self.with_audio = with_audio

    @classmethod
    def create(
        cls,
        mic_positions: np.ndarray,
        pipeline: PipelineConfig = PipelineConfig(),
        grid: GridConfig = GridConfig(),
        solver: SolverConfig = SolverConfig(),
        stream: StreamConfig = StreamConfig(),
        *,
        device,
        event_capacity: int = 64,
        with_solver: bool = True,
        with_audio: bool = False,
        **kwargs,
    ) -> "TwoRateStreamingLocalizer":
        base = localizer_mod.Localizer.create(
            mic_positions, pipeline, grid, solver, device=device, **kwargs)
        return cls(base, stream, event_capacity, with_solver, with_audio)

    def init_states(self, n_streams: int) -> StreamState:
        return _init_state(self.params, self.pipeline, (n_streams,))

    def detect_many(self, states: StreamState, chunks: torch.Tensor):
        """states: stacked StreamState; chunks [S, M, C]."""
        _check_chunks(chunks, self.params, "chunks")
        return detect_step(states, chunks, cfg=self.pipeline,
                           refractory=self.stream.refractory_samples)

    def localize_triggered(self, states: StreamState, det: dict):
        """Localize the chunk's triggered streams (compacted to
        ``event_capacity``) and merge their EMA state.  Returns (new states,
        events dict with [E]-shaped fields): 'stream_idx', 'accepted'
        (triggered AND past the shift gate), 'triggered', 'event_shifts',
        'tdoa_samples', 'xy_grid', 'confidence', 'xy' / 'rms_m' with the
        solver (and 'xyz' / 'xyz_rms_m' with ``solve_xyz``), 'audio' [E, N]
        with ``with_audio``, and the scalar 'overflow'."""
        return _localize_triggered(
            states, det["triggered"], det["frame"], det["trig_time"],
            params=self.params, cfg=self.pipeline, grid_cfg=self.grid,
            solver_cfg=self.solver, srp_form=self.srp_form,
            capacity=self.event_capacity, with_solver=self.with_solver,
            xyz_z_inits=xyz_starts(self.stream), with_audio=self.with_audio)


def _localize_triggered(states: StreamState, triggered, frames, trig_times,
                        *, params, cfg: PipelineConfig, grid_cfg: GridConfig,
                        solver_cfg: SolverConfig, srp_form: str,
                        capacity: int, with_solver: bool,
                        xyz_z_inits: Optional[tuple],
                        with_audio: bool = False):
    k = cfg.max_shift
    # stable sort: triggered streams first, in stream order
    order = torch.argsort((~triggered).to(torch.uint8), stable=True)
    sel = order[:capacity]  # [E] stream indices
    m_sel = triggered[sel]
    f_sel = frames[sel]  # [E, M, N]
    t_sel = trig_times[sel]

    # the event burst on the compact batch (stream_step's ops)
    x = localizer_mod.condition_frames(f_sel, params.window, cfg)
    corr = localizer_mod.correlate_frames(x, params, cfg)  # [E, P, L]
    shifts = xcorr.best_lag(corr, k)
    corr_t = (xcorr.peak_taper(corr, k, cfg.taper_denom, shifts)
              if cfg.taper_enabled else corr)
    accepts = m_sel & ((shifts * shifts).sum(dim=-1) > cfg.shift_gate)

    # per-stream EMA merge (dt from each stream's own last accepted event)
    ema_sel = states.ema_corr[sel]
    dt = (t_sel - states.last_event_s[sel]).clamp_min(0.0)
    decay = xcorr.ema_decay(dt, cfg.ema_tau_s)[:, None, None]
    ema_new = torch.where(accepts[:, None, None],
                          xcorr.ema_update(ema_sel, corr_t, decay), ema_sel)

    if srp_form == "matmul":
        scores = srp.srp_scores_matmul(ema_new, params.onehot, cfg.srp_dtype)
    else:
        scores = srp.srp_scores_gather(ema_new, params.lut_flat)
    xy_grid = srp.grid_peak_xy(
        scores, (grid_cfg.height, grid_cfg.width),
        (grid_cfg.half_cells_x, grid_cfg.half_cells_y), grid_cfg.cells_per_m)
    tdoa_samples, _ = xcorr.subsample_peak(ema_new, k)

    out = {
        "stream_idx": sel,
        "accepted": accepts,
        "triggered": m_sel,
        "event_shifts": shifts,
        "tdoa_samples": tdoa_samples,
        "xy_grid": xy_grid,
        "confidence": xcorr.peak_confidence(corr, k).amin(dim=-1),
        # triggered streams beyond the capacity are dropped this chunk
        "overflow": (triggered.sum() - capacity).clamp_min(0),
    }
    if with_solver:
        tdoa_s = tdoa_samples / cfg.sample_rate_hz
        xy, rms = solver_ops.solve_tdoa_batched(
            tdoa_s, params.mic_positions, params.pairs,
            speed_of_sound=cfg.speed_of_sound_mps, height=grid_cfg.height_m,
            init_xy=xy_grid, cfg=solver_cfg)
        out["xy"] = xy
        out["rms_m"] = rms
        if xyz_z_inits is not None:  # as stream_step (the reference's
            # two-rate localizer has none)
            out["xyz"], out["xyz_rms_m"] = (
                solver_ops.solve_tdoa_xyz_multistart(
                    tdoa_s, params.mic_positions, params.pairs,
                    speed_of_sound=cfg.speed_of_sound_mps, init_xy=xy,
                    z_inits=xyz_z_inits))
    if with_audio:
        # each slot's raw frame steered at its solved (or grid) position,
        # at the solver's 3-D lift
        delays = beamform.source_delays(
            out.get("xy", out["xy_grid"]), params.mic_positions, cfg,
            height=grid_cfg.height_m,
            constrain_sphere=solver_cfg.constrain_to_sphere)
        out["audio"] = beamform.extract_das(f_sel, delays, cfg)  # [E, N]

    # scatter the merged state back (slots not accepted write their old
    # values; sel has no duplicates)
    new_states = dataclasses.replace(
        states,
        ema_corr=states.ema_corr.index_copy(0, sel, ema_new),
        best_shift=states.best_shift.index_copy(0, sel, torch.where(
            accepts[:, None], xcorr.best_lag(ema_new, k),
            states.best_shift[sel])),
        last_event_s=states.last_event_s.index_copy(0, sel, torch.where(
            accepts, t_sel, states.last_event_s[sel])),
        event_count=states.event_count.index_add(
            0, sel, accepts.to(torch.int32)))
    return new_states, out
