"""Multi-channel dereverberation: WPE in the STFT domain.

Counterpart of ``audio_triangulation_tpu.ops.dereverb``: weighted
prediction error (WPE) delayed linear prediction (Nakatani et al., IEEE
TASLP 2010).  Per STFT bin the late tail of each channel is predicted from
frames at least ``delay`` hops in the past and subtracted, leaving the
direct path and early reflections (which carry the TDOAs) untouched.

- Analysis and synthesis are ``torch.fft`` over ``ops.framing`` frames;
  the overlap-add is r strided adds into one buffer, in the reference's
  order.
- Block WPE (:func:`wpe_stft`) solves every bin's ``MK x MK`` Hermitian
  system in one batched ``ops.linalg.complex_solve``.
- Adaptive WPE (:func:`wpe_rls_step`, Caroselli et al., Interspeech 2017)
  makes rank-1 updates of the inverse tap covariance, batched over bins and
  over any leading (stream) axes; the reference's ``lax.scan`` over frames
  is a loop here.  The inverse is updated by a difference and never
  re-symmetrised, as in the reference.

Everything is plain torch, as it was plain XLA in the reference: no hand
kernel.  Functions run on the device of the tensors they are given;
:class:`StreamingDereverb` and :func:`wpe_rls_init` take a ``device``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import framing, linalg
from ._device import device_constant, irfft, pin_fp32_for


# ---------------------------------------------------------------------------
# STFT analysis / synthesis
# ---------------------------------------------------------------------------

def sqrt_hann(frame: int) -> np.ndarray:
    """Square root of the periodic Hann window (analysis == synthesis
    window gives COLA at hop = frame / 2^k)."""
    n = np.arange(frame)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / frame)
    return np.sqrt(hann).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _sqrt_hann_constant(frame: int) -> np.ndarray:
    return sqrt_hann(frame)  # one array per frame, for ``device_constant``


def _window(frame: int, window, device) -> torch.Tensor:
    if window is None:
        return device_constant(_sqrt_hann_constant(frame), device)
    return torch.as_tensor(np.asarray(window, np.float32), device=device)


def stft(x: torch.Tensor, frame: int, hop: int,
         window: np.ndarray | None = None) -> torch.Tensor:
    """x [..., T] real -> [..., n_frames, F] complex64 (F = frame//2 + 1).

    Windowed rFFT over ``frame_stream`` frames; with the default sqrt-Hann
    pair, ``istft(stft(x))`` reconstructs x except within one frame of the
    edges (no padding is added: WPE wants honest frames)."""
    pin_fp32_for(x)
    w = _window(frame, window, x.device).to(x.dtype)
    frames = framing.frame_stream(x, frame, hop)        # [..., Tf, frame]
    return torch.fft.rfft(frames * w, dim=-1)


def _fold(fr: torch.Tensor, hop: int) -> torch.Tensor:
    """Overlap-add fr [..., Tf, frame] -> [..., (Tf - 1) * hop + frame]:
    for frame = r * hop, r shifted flattenings added in turn; else one
    frame at a time."""
    tf, frame = fr.shape[-2:]
    lead = fr.shape[:-2]
    acc = fr.new_zeros(*lead, (tf - 1) * hop + frame)
    if frame % hop == 0:
        r = frame // hop
        parts = fr.reshape(*lead, tf, r, hop)
        for u in range(r):
            acc[..., u * hop: u * hop + tf * hop] += parts[..., u, :].reshape(
                *lead, tf * hop)
        return acc
    for i in range(tf):
        acc[..., i * hop: i * hop + frame] += fr[..., i, :]
    return acc


def istft(spec: torch.Tensor, frame: int, hop: int,
          window: np.ndarray | None = None) -> torch.Tensor:
    """[..., n_frames, F] complex -> [..., T] real, weighted overlap-add.

    T = (n_frames - 1) * hop + frame.  The synthesis window is applied and
    the output divided by the accumulated window^2 sum, so any COLA window
    / hop pair reconstructs (edges included, down to the first/last hop)."""
    w = _window(frame, window, spec.device)
    frames = irfft(spec, frame) * w  # [..., Tf, frame]
    num = _fold(frames, hop)
    wsum = _fold((w * w).expand(frames.shape[-2], frame), hop)
    return num / wsum.clamp_min(1e-8)


# ---------------------------------------------------------------------------
# Block (offline) WPE
# ---------------------------------------------------------------------------

def _tap_stack(y: torch.Tensor, taps: int, delay: int) -> torch.Tensor:
    """y [..., F, M, T] -> delayed tap stack [..., F, M*taps, T] where
    stack[..., k*M + m, t] = y[..., m, t - delay - k] (zeros before t=0)."""
    t = y.shape[-1]
    outs = []
    for k in range(taps):
        s = delay + k
        out = torch.zeros_like(y)
        if s < t:
            out[..., s:] = y[..., : t - s]
        outs.append(out)
    return torch.cat(outs, dim=-2)


def wpe_stft(y: torch.Tensor, *, taps: int = 10, delay: int = 2,
             iters: int = 3, eps: float = 1e-6) -> torch.Tensor:
    """Block WPE on an STFT tensor y [..., F, M, T] complex -> same shape.

    Per bin (batched over F and any leading dims):
        lam_t   = mean_m |X[m, t]|^2            (X = current dereverbed est)
        R       = sum_t ytil_t ytil_t^H / lam_t
        P       = sum_t ytil_t y_t^H / lam_t
        G       = R^{-1} P                       [MK, M]
        X       = Y - G^H ytil
    iterated ``iters`` times (lam from Y on the first pass).  ``delay``
    hops protect the direct path + early reflections; ``eps`` floors the
    PSD weight and loads R's diagonal."""
    pin_fp32_for(y)
    ytil = _tap_stack(y, taps, delay)                 # [..., F, MK, T]
    ytil_h = ytil.conj().transpose(-1, -2)            # [..., F, T, MK]
    x = y
    for _ in range(iters):
        p2 = (x.abs() ** 2).mean(dim=-2)              # [..., F, T]
        floor = eps * p2.mean(dim=-1, keepdim=True) + 1e-30
        inv_lam = 1.0 / torch.maximum(p2, floor)      # [..., F, T]
        ytw = ytil * inv_lam[..., None, :]
        r = torch.matmul(ytw, ytil_h)                 # [..., F, MK, MK]
        p = torch.matmul(ytw, y.conj().transpose(-1, -2))  # [..., F, MK, M]
        mk = r.shape[-1]
        tr = torch.diagonal(r.real, dim1=-2, dim2=-1).sum(dim=-1)
        ridge = eps * tr / mk + 1e-12
        r = r + ridge[..., None, None] * torch.eye(
            mk, dtype=r.dtype, device=r.device)
        g = linalg.complex_solve(r, p)                # [..., F, MK, M]
        x = y - torch.matmul(g.conj().transpose(-1, -2), ytil)
    return x


def _fit_length(y: torch.Tensor, t: int, dtype) -> torch.Tensor:
    """y [..., T'] trimmed or zero-padded to [..., t]."""
    if y.shape[-1] >= t:
        return y[..., :t].to(dtype)
    return torch.nn.functional.pad(y, (0, t - y.shape[-1])).to(dtype)


def wpe(x: torch.Tensor, *, frame: int = 512, hop: int | None = None,
        taps: int = 10, delay: int = 2, iters: int = 3,
        eps: float = 1e-6) -> torch.Tensor:
    """Time-domain WPE: x [..., M, T] real -> dereverbed [..., M, T].

    STFT -> :func:`wpe_stft` -> iSTFT; the output is trimmed/zero-padded
    back to the input length (the last partial frame's samples come out
    as zeros: feed whole multiples of ``hop`` for gapless output)."""
    hop = frame // 4 if hop is None else hop
    t = x.shape[-1]
    spec = stft(x, frame, hop).movedim(-1, -3)        # [..., F, M, Tf]
    out = wpe_stft(spec, taps=taps, delay=delay, iters=iters, eps=eps)
    y = istft(out.movedim(-3, -1), frame, hop)        # [..., M, T']
    return _fit_length(y, t, x.dtype)


# ---------------------------------------------------------------------------
# Adaptive (streaming) WPE: the RLS recursion
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WpeState:
    """Per-bin RLS state, batched over frequency (and any leading stream
    axes).

    kinv: [..., F, MK, MK] complex64: inverse weighted tap covariance
    g:    [..., F, MK, M] complex64: prediction filter
    hist: [..., F, M, taps + delay - 1] complex64: most recent STFT frames
          (hist[..., -1] is 1 frame ago; hist[..., 0] is delay+taps-1 ago,
          so hist[..., :taps] is exactly the delayed tap window)
    """

    kinv: torch.Tensor
    g: torch.Tensor
    hist: torch.Tensor


def wpe_rls_init(n_bins: int, n_mics: int, *, device, taps: int = 10,
                 delay: int = 2, delta: float = 1e-2) -> WpeState:
    """Fresh RLS state on ``device``: kinv = I/delta, zero filter, zero
    history."""
    if delay < 1:
        raise ValueError("adaptive WPE needs delay >= 1 (the current "
                         "frame must never predict itself)")
    mk = n_mics * taps
    eye = torch.eye(mk, dtype=torch.complex64, device=device) / delta
    return WpeState(
        kinv=eye.expand(n_bins, mk, mk).clone(),
        g=torch.zeros(n_bins, mk, n_mics, dtype=torch.complex64,
                      device=device),
        hist=torch.zeros(n_bins, n_mics, taps + delay - 1,
                         dtype=torch.complex64, device=device))


def wpe_rls_step(state: WpeState, y: torch.Tensor, *, alpha: float = 0.99,
                 eps: float = 1e-6) -> tuple[WpeState, torch.Tensor]:
    """One adaptive-WPE update.  y [..., F, M] complex (one STFT frame);
    returns (new state, dereverbed [..., F, M]).

    With tap vector ytil (frames delay..delay+taps-1 in the past, so the
    current frame never predicts itself):
        e    = y - G^H ytil                       (output)
        lam  = mean_m |y|^2
        nu   = Kinv ytil
        k    = nu / (alpha * lam + ytil^H nu)
        G   += k e^H
        Kinv = (Kinv - k nu^H) / alpha
    All bins update in parallel: elementwise ops and matrix-vector
    products, no solve.  ``state`` is not written."""
    pin_fp32_for(y)
    taps = state.g.shape[-2] // state.hist.shape[-2]
    ytil = state.hist[..., :taps].transpose(-1, -2)   # [..., F, taps, M]
    ytil = ytil.reshape(*ytil.shape[:-2], -1)         # [..., F, MK] k-major
    lam = (y.abs() ** 2).mean(dim=-1)                 # [..., F]
    lam = torch.maximum(lam, eps * lam.mean(dim=-1, keepdim=True) + 1e-30)
    e = y - torch.matmul(ytil[..., None, :], state.g.conj())[..., 0, :]
    nu = torch.matmul(state.kinv, ytil[..., None])[..., 0]  # [..., F, MK]
    denom = alpha * lam + (ytil.conj() * nu).sum(dim=-1).real
    k = nu / denom[..., None]                         # [..., F, MK]
    g = torch.addcmul(state.g, k[..., :, None], e.conj()[..., None, :])
    # Kinv' = (Kinv - k nu^H) / alpha  (nu^H = ytil^H Kinv: Kinv Hermitian)
    kinv = torch.addcmul(state.kinv, k[..., :, None],
                         nu.conj()[..., None, :], value=-1).div_(alpha)
    hist = torch.cat([state.hist[..., 1:], y[..., None]], dim=-1)
    return WpeState(kinv=kinv, g=g, hist=hist), e


@dataclasses.dataclass
class DereverbState:
    """Chunk-streaming WOLA state around the RLS recursion (one stream, or
    streams stacked on a leading axis).

    wpe:      per-bin RLS state (:class:`WpeState`)
    in_tail:  [..., M, frame - hop] trailing input samples (STFT continuity)
    out_tail: [..., M, frame - hop] synthesis overlap carry
    """

    wpe: WpeState
    in_tail: torch.Tensor
    out_tail: torch.Tensor


def ola_gain(win: np.ndarray, frame: int, hop: int, atol: float) -> float:
    """The constant overlap-add of ``win ** 2`` at this hop (the WOLA gain
    of a window used for analysis and synthesis); ValueError if it is not
    constant within ``atol`` (the pair violates COLA)."""
    w2 = np.asarray(win, np.float64) ** 2
    ola = np.zeros(hop)
    for u in range(frame // hop):
        ola += w2[u * hop:(u + 1) * hop]
    if not np.allclose(ola, ola[0], atol=atol):
        raise ValueError(f"frame/hop = {frame}/{hop} violates COLA")
    return float(ola[0])


def overlap_add(y: torch.Tensor, out_tail: torch.Tensor, hop: int):
    """WOLA synthesis of one chunk: y [..., K, frame] (frames starting at
    multiples of ``hop``) and the carried ``out_tail`` [..., frame - hop]
    -> (output [..., K * hop], next tail [..., frame - hop]).  Segment u of
    frame k lands at (k + u) hop: r strided adds into one buffer, then the
    tail, in the reference's order."""
    k, frame = y.shape[-2:]
    lead = y.shape[:-2]
    r = frame // hop
    acc = y.new_zeros(*lead, (k + r - 1) * hop)
    seg = y.reshape(*lead, k, r, hop)
    for u in range(r):
        acc[..., u * hop:(u + k) * hop] += seg[..., u, :].reshape(
            *lead, k * hop)
    acc[..., : frame - hop] += out_tail
    c = k * hop
    return acc[..., :c], acc[..., c:]


class StreamingDereverb:
    """Continuous multi-channel dereverberation for the live path.

    The WOLA carry of :class:`..models.extraction.StreamingExtractor`
    (in-tail for analysis continuity, out-tail for synthesis overlap), so a
    stream fed chunk by chunk gives the same samples as one long
    :func:`wpe_rls` pass.  Output lags the input by ``frame - hop``
    samples.  Put in front of a ``StreamingLocalizer`` to feed it dereverbed
    chunks.  Its constants and states live on ``device``; ``step`` takes
    one stream's chunk [M, C], ``step_many`` S streams' [S, M, C].
    """

    def __init__(self, n_mics: int, *, device, frame: int = 1024,
                 hop: int | None = None, taps: int = 10, delay: int = 4,
                 alpha: float = 0.998, delta: float = 1e-2,
                 eps: float = 1e-6):
        self.n_mics = int(n_mics)
        self.frame = int(frame)
        self.hop = int(frame // 4 if hop is None else hop)
        if self.frame % self.hop != 0:
            raise ValueError("hop must divide frame")
        self.taps, self.delay = int(taps), int(delay)
        self.alpha, self.delta, self.eps = float(alpha), float(delta), float(eps)
        self.n_bins = self.frame // 2 + 1
        self.device = torch.device(device)
        win = sqrt_hann(self.frame)
        self._gain = ola_gain(win, self.frame, self.hop, atol=1e-6)
        self._win = torch.as_tensor(win, device=self.device)
        self.device = self._win.device  # "cuda" as the tensors name it
        self._synth = self._win / self._gain
        pin_fp32_for(self._win)

    @property
    def latency_samples(self) -> int:
        return self.frame - self.hop

    def init_state(self) -> DereverbState:
        lat = self.frame - self.hop
        return DereverbState(
            wpe=wpe_rls_init(self.n_bins, self.n_mics, device=self.device,
                             taps=self.taps, delay=self.delay,
                             delta=self.delta),
            in_tail=torch.zeros(self.n_mics, lat, device=self.device),
            out_tail=torch.zeros(self.n_mics, lat, device=self.device))

    def init_states(self, n_streams: int) -> DereverbState:
        """Stacked fresh states for ``step_many`` ([n_streams] leading)."""
        one = self.init_state()

        def stack(x):
            return x.expand(n_streams, *x.shape).clone()

        return DereverbState(
            wpe=WpeState(**{f.name: stack(getattr(one.wpe, f.name))
                            for f in dataclasses.fields(WpeState)}),
            in_tail=stack(one.in_tail), out_tail=stack(one.out_tail))

    def step(self, state: DereverbState, chunk: torch.Tensor):
        """chunk [M, C] (C a multiple of hop) -> (state, y [M, C])."""
        return self._step(state, chunk)

    def step_many(self, states: DereverbState, chunks: torch.Tensor):
        """The same step on S streams: states stacked on a leading axis,
        chunks [S, M, C] -> (states, y [S, M, C])."""
        return self._step(states, chunks)

    def _step(self, state: DereverbState, chunk: torch.Tensor):
        if not isinstance(chunk, torch.Tensor):
            raise TypeError("chunks must be a torch.Tensor on the "
                            "dereverberator's device")
        if chunk.device != self.device:
            raise ValueError(f"chunks are on {chunk.device}; this "
                             f"dereverberator lives on {self.device}")
        if chunk.shape[-2] != self.n_mics:
            raise ValueError(f"chunks must be [..., {self.n_mics} mics, "
                             f"samples]; got {tuple(chunk.shape)}")
        f, h = self.frame, self.hop
        c = chunk.shape[-1]
        if c % h != 0:
            raise ValueError(f"chunk {c} not a multiple of hop {h}")
        pin_fp32_for(chunk)
        z = torch.cat([state.in_tail, chunk.float()], dim=-1)
        frames = framing.frame_stream(z, f, h)        # [..., M, K, f]
        spec = torch.fft.rfft(frames * self._win, dim=-1)  # [..., M, K, F]
        wst, outs = state.wpe, []
        for kk in range(c // h):
            wst, e = wpe_rls_step(wst, spec[..., kk, :].transpose(-1, -2),
                                  alpha=self.alpha, eps=self.eps)
            outs.append(e)                            # [..., F, M]
        y = irfft(torch.stack(outs, dim=-3).transpose(-1, -2),
                  f) * self._synth  # [..., K, M, f]
        out, tail = overlap_add(y.transpose(-3, -2), state.out_tail, h)
        return DereverbState(wpe=wst, in_tail=z[..., -(f - h):],
                             out_tail=tail), out

    def run(self, stream, chunk_size: int = 1024) -> np.ndarray:
        """Offline helper: stream [M, T] -> dereverbed [M, T] (numpy),
        chunked internally and latency-compensated (trailing zeros flush
        the WOLA pipeline)."""
        stream = np.asarray(stream, np.float32)
        m, t = stream.shape
        lat = self.latency_samples
        pad = (-t) % chunk_size + (-(-lat // chunk_size)) * chunk_size
        stream = torch.as_tensor(np.pad(stream, [(0, 0), (0, pad)]),
                                 device=self.device)
        state = self.init_state()
        outs = []
        for i in range(stream.shape[-1] // chunk_size):
            state, y = self.step(
                state, stream[:, i * chunk_size:(i + 1) * chunk_size])
            outs.append(y)
        return torch.cat(outs, dim=-1)[:, lat:lat + t].cpu().numpy()


def wpe_rls(x: torch.Tensor, *, frame: int = 512, hop: int | None = None,
            taps: int = 10, delay: int = 2, alpha: float = 0.99,
            delta: float = 1e-2, eps: float = 1e-6,
            state: WpeState | None = None,
            ) -> tuple[torch.Tensor, WpeState]:
    """Adaptive WPE over a signal block x [M, T] -> (dereverbed [M, T],
    final state).  :func:`wpe_rls_step` over the STFT frames in turn; pass
    the returned state back in to continue on the next block.  Early
    output (before the RLS has seen ~taps/alpha frames) is essentially the
    input."""
    hop = frame // 4 if hop is None else hop
    t = x.shape[-1]
    spec = stft(x, frame, hop)                        # [M, Tf, F]
    if state is None:
        state = wpe_rls_init(spec.shape[-1], spec.shape[0], device=x.device,
                             taps=taps, delay=delay, delta=delta)
    outs = []
    for i in range(spec.shape[-2]):
        state, e = wpe_rls_step(state, spec[:, i, :].T, alpha=alpha, eps=eps)
        outs.append(e)                                # [F, M]
    out = torch.stack(outs, dim=0).permute(2, 0, 1)   # [M, Tf, F]
    return _fit_length(istft(out, frame, hop), t, x.dtype), state
