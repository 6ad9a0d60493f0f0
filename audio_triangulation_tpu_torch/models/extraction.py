"""Streaming source extraction: a continuous "virtual microphone".

Counterpart of ``audio_triangulation_tpu.models.extraction``.  After the
streaming pipeline says where (``StreamingLocalizer`` / ``Tracker``), this
recovers what: a continuous, chunk-rate enhanced waveform of the source at
the steered position, by running the batch beamformers
(:mod:`..ops.beamform`) under a stateful weighted overlap-add (WOLA)
harness.  Plain torch, as the reference's is plain XLA.

- A step is a pure function of (state, chunk, xy); ``step_many`` is the
  same step batched over a leading stream axis (the reference ``vmap`` s
  it), and ``step`` takes one stream.
- Steering moves once a chunk and is interpolated linearly per frame inside
  the chunk, so a tracked source glides without clicks (the sqrt-Hann
  synthesis window cross-fades neighbouring frames).
- The overlap-add is r strided adds into one buffer
  (``ops.dereverb.overlap_add``).

sqrt-Hann analysis x sqrt-Hann synthesis at 50% overlap satisfies COLA, so
a zero-delay steer reproduces the input (up to the float32 FFT round trip)
after the fixed ``frame - hop`` sample latency.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..ops import beamform, dereverb, framing
from ..ops._device import device_constant, pin_fp32_for


@dataclasses.dataclass
class ExtractorState:
    """Carried WOLA state: one stream, or streams stacked on a leading
    axis."""

    in_tail: torch.Tensor   # [..., M, frame - hop] trailing input samples
    out_tail: torch.Tensor  # [..., frame - hop] synthesis overlap carry
    delays: torch.Tensor    # [..., M] current steering delays (seconds)


class StreamingExtractor:
    """Chunk-rate beamformed extraction at a (moving) steered position.

    >>> ex = StreamingExtractor.create(mics, device="cuda")
    >>> state = ex.init_state()
    >>> state, y = ex.step(state, chunk, xy)   # y: [chunk] enhanced audio

    ``y`` lags the input by ``frame - hop`` samples (the WOLA synthesis
    latency).  Feed ``StreamingLocalizer`` outputs (``xy`` / ``xy_grid``)
    or a ``Tracker`` posterior mean as the steer; a constant ``xy`` gives
    the static beamformer.
    """

    def __init__(self, mic_positions, cfg, frame, hop, method, height,
                 constrain_sphere, mvdr_kwargs, device):
        self.mic_positions = np.asarray(mic_positions, np.float32)
        self.pipeline = cfg
        self.frame = int(frame)
        self.hop = int(hop)
        self.method = method
        self.height = height
        self.constrain_sphere = constrain_sphere
        self.mvdr_kwargs = dict(mvdr_kwargs)
        self.device = torch.device(device)
        if self.frame % self.hop != 0:
            raise ValueError("hop must divide frame")
        # periodic sqrt-Hann: hann overlap-adds to a constant at
        # hop = frame / 2^k, so analysis * synthesis reconstructs
        win = np.sqrt(0.5 - 0.5 * np.cos(
            2.0 * np.pi * np.arange(self.frame) / self.frame))
        self._ola_gain = dereverb.ola_gain(win, self.frame, self.hop,
                                           atol=1e-8)
        self._win = torch.as_tensor(win, dtype=torch.float32,
                                    device=self.device)
        self.device = self._win.device  # "cuda" as the tensors name it
        self._synth = self._win / self._ola_gain
        pin_fp32_for(self._win)

    @classmethod
    def create(
        cls,
        mic_positions,
        cfg: PipelineConfig | None = None,
        *,
        device,
        frame: int = 512,
        hop: int | None = None,
        method: str = "das",
        height: float | None = None,
        constrain_sphere: bool = True,
        **mvdr_kwargs,
    ) -> "StreamingExtractor":
        """``method`` is 'das' (delay-and-sum) or 'mvdr' (adaptive,
        frequency-smoothed Capon; extra kwargs go to
        :func:`..ops.beamform.extract_mvdr`)."""
        if method not in ("das", "mvdr"):
            raise ValueError(f"unknown method {method!r}")
        if method == "das" and mvdr_kwargs:
            raise TypeError(
                f"method='das' takes no extra kwargs, got "
                f"{sorted(mvdr_kwargs)} (MVDR-only knobs)")
        allowed = {"smooth_bins", "diagonal_loading"}
        unknown = set(mvdr_kwargs) - allowed
        if unknown:
            raise TypeError(
                f"unknown extract_mvdr kwargs {sorted(unknown)}; "
                f"allowed: {sorted(allowed)}")
        return cls(mic_positions, cfg or PipelineConfig(), frame,
                   hop if hop is not None else frame // 2, method, height,
                   constrain_sphere, mvdr_kwargs, device)

    # -- state ----------------------------------------------------------
    def init_state(self) -> ExtractorState:
        m = self.mic_positions.shape[0]
        lat = self.frame - self.hop
        return ExtractorState(
            in_tail=torch.zeros(m, lat, device=self.device),
            out_tail=torch.zeros(lat, device=self.device),
            delays=torch.zeros(m, device=self.device))

    def init_states(self, n_streams: int) -> ExtractorState:
        one = self.init_state()
        return ExtractorState(**{
            f.name: getattr(one, f.name).expand(
                n_streams, *getattr(one, f.name).shape).clone()
            for f in dataclasses.fields(ExtractorState)})

    @property
    def latency_samples(self) -> int:
        return self.frame - self.hop

    # -- stepping -------------------------------------------------------
    def step(self, state: ExtractorState, chunk: torch.Tensor, xy):
        """One chunk [M, C] (C a multiple of hop) steered at ``xy`` ([2]
        position, or [3]) -> (state, y [C])."""
        return self._step(state, chunk, xy)

    def step_many(self, states: ExtractorState, chunks: torch.Tensor, xys):
        """The same step on S streams: states stacked on a leading axis,
        chunks [S, M, C], steers [S, 2 or 3] -> (states, y [S, C])."""
        return self._step(states, chunks, xys)

    def _step(self, state: ExtractorState, chunk: torch.Tensor, xy):
        if not isinstance(chunk, torch.Tensor):
            raise TypeError("chunks must be a torch.Tensor on the "
                            "extractor's device")
        if chunk.device != self.device:
            raise ValueError(f"chunks are on {chunk.device}; this extractor "
                             f"lives on {self.device}")
        m = self.mic_positions.shape[0]
        if chunk.shape[-2] != m:
            raise ValueError(f"chunks must be [..., {m} mics, samples]; got "
                             f"{tuple(chunk.shape)}")
        f, h = self.frame, self.hop
        c = chunk.shape[-1]
        if c % h != 0:
            raise ValueError(f"chunk {c} not a multiple of hop {h}")
        k = c // h
        xy = torch.as_tensor(xy, dtype=torch.float32, device=self.device)

        z = torch.cat([state.in_tail, chunk.float()], dim=-1)  # [..., M, T]
        frames = framing.frame_stream(z, f, h).transpose(-3, -2)
        xw = frames * self._win                               # [..., K, M, f]

        # steer: glide linearly from the carried delays to xy's over the
        # chunk's frames (cross-faded by the synthesis overlap)
        tgt = beamform.source_delays(
            xy, self.mic_positions, self.pipeline, height=self.height,
            constrain_sphere=self.constrain_sphere)           # [..., M]
        alpha = device_constant(_glide(k), self.device)[:, None]  # [K, 1]
        dly = ((1.0 - alpha) * state.delays[..., None, :]
               + alpha * tgt[..., None, :])                   # [..., K, M]
        if self.method == "das":
            y = beamform.extract_das(xw, dly, self.pipeline)  # [..., K, f]
        else:
            y = beamform.extract_mvdr(xw, dly, self.pipeline,
                                      **self.mvdr_kwargs)
        out, tail = dereverb.overlap_add(y * self._synth, state.out_tail, h)
        return ExtractorState(in_tail=z[..., -(f - h):], out_tail=tail,
                              delays=tgt), out

    # -- convenience ----------------------------------------------------
    def run(self, stream, xys, chunk_size: int = 512) -> np.ndarray:
        """Offline helper: stream [M, T] + per-chunk steers [T/chunk, 2]
        (or one steer) -> enhanced [T] (numpy), latency-compensated by
        zero-padding the input with trailing whole chunks."""
        stream = np.asarray(stream, np.float32)
        m, t = stream.shape
        if t % chunk_size != 0:
            stream = np.pad(stream, [(0, 0), (0, chunk_size - t % chunk_size)])
        lat = self.latency_samples
        # flush: enough whole chunks to push the last `lat` delayed samples
        # out of the WOLA pipeline
        flush = -(-lat // chunk_size) * chunk_size
        stream = torch.as_tensor(np.pad(stream, [(0, 0), (0, flush)]),
                                 device=self.device)
        n_chunks = stream.shape[-1] // chunk_size
        xys = np.asarray(xys, np.float32)
        if xys.ndim == 1:
            xys = np.broadcast_to(xys, (n_chunks, xys.shape[0]))
        xys = torch.as_tensor(np.ascontiguousarray(xys), device=self.device)
        state = self.init_state()
        outs = []
        for i in range(n_chunks):
            state, y = self.step(
                state, stream[:, i * chunk_size:(i + 1) * chunk_size],
                xys[min(i, len(xys) - 1)])
            outs.append(y)
        return torch.cat(outs)[lat:lat + t].cpu().numpy()


@functools.lru_cache(maxsize=16)
def _glide(k: int) -> np.ndarray:
    """[K] float32 (1 .. K) / K: the steer's share at each frame."""
    return np.arange(1, k + 1, dtype=np.float32) / np.float32(k)
