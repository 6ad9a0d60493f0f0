"""Synthetic acoustic scene generation (test/bench signal source).

The reference has no simulator — its "test input" is claps in a room.  For a
test pyramid we need controlled scenes: a source at a known (x, y[, z]) emits
a transient; each mic receives it with the exact geometric fractional delay
(applied in the frequency domain), optional 1/r attenuation, noise, and
optional 8-bit ADC quantization matching the firmware's front end
(``src/components/dma_sampler.c``: 8-bit unsigned samples).
"""

from __future__ import annotations

import numpy as np


def chirp_burst(n: int, fs: float, f0: float = 800.0, f1: float = 6000.0,
                center: float = 0.5, width: float = 0.15,
                dtype=np.float64) -> np.ndarray:
    """Gaussian-enveloped linear chirp, peak amplitude 1, centered at
    ``center`` (fraction of the frame)."""
    t = np.arange(n, dtype=dtype) / fs
    t_total = n / fs
    tc = center * t_total
    sweep = f0 + (f1 - f0) * (t / t_total)
    phase = 2 * np.pi * np.cumsum(sweep) / fs
    env = np.exp(-0.5 * ((t - tc) / (width * t_total)) ** 2)
    return (env * np.sin(phase)).astype(dtype)


def click_burst(n: int, fs: float, center: float = 0.5,
                decay_s: float = 0.002, f_ring: float = 3000.0,
                dtype=np.float64) -> np.ndarray:
    """Exponentially-decaying ringing click (clap/snap-like transient)."""
    t = np.arange(n, dtype=dtype) / fs
    t0 = center * n / fs
    dt = t - t0
    env = np.where(dt >= 0, np.exp(-dt / decay_s), 0.0)
    return (env * np.sin(2 * np.pi * f_ring * dt)).astype(dtype)


def colored_burst(n: int, fs: float, cutoff_hz: float = 600.0,
                  width: float = 0.2, seed: int = 0,
                  dtype=np.float64) -> np.ndarray:
    """Speech-like colored noise burst: Gaussian-enveloped noise with a
    strong spectral tilt above ``cutoff_hz``.

    This is the source class where GCC-PHAT earns its keep: plain
    correlation of colored signals has broad, reverberation-biased peaks,
    while whitening restores a sharp direct-path peak."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    spec = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1 / fs)
    spec = spec / (1.0 + (f / cutoff_hz) ** 2)
    x = np.fft.irfft(spec, n)
    env = np.exp(-0.5 * ((np.arange(n) / n - 0.5) / width) ** 2)
    x = x * env
    return (x / np.abs(x).max()).astype(dtype)


def fractional_delay(signal: np.ndarray, delay_samples: np.ndarray,
                     axis: int = -1) -> np.ndarray:
    """Apply (possibly fractional) delays via FFT phase shift.

    signal: [..., N]; delay_samples broadcastable against the leading dims.
    Positive delay shifts the waveform later in time."""
    n = signal.shape[axis]
    spec = np.fft.rfft(signal, axis=axis)
    freqs = np.fft.rfftfreq(n)  # cycles/sample
    shift = np.exp(-2j * np.pi * freqs * np.asarray(delay_samples)[..., None])
    return np.fft.irfft(spec * shift, n=n, axis=axis)


def synth_scene(
    source_xyz: np.ndarray,
    mic_positions: np.ndarray,
    *,
    n: int = 1024,
    fs: float = 50_000.0,
    speed_of_sound: float = 343.0,
    signal: np.ndarray | None = None,
    amplitude: float = 0.8,
    attenuation: bool = False,
    noise_rms: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Per-mic received frames [B, M, N] float64 in [-1, 1].

    source_xyz: [B, 3] (or [3]); mic_positions: [M, 2 or 3] (z = 0 if 2-D).
    Delays are relative to the array center so the transient stays inside the
    frame for any source range."""
    src = np.atleast_2d(np.asarray(source_xyz, dtype=np.float64))  # [B, 3]
    mics = np.asarray(mic_positions, dtype=np.float64)
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, : mics.shape[1]] = mics

    if signal is None:
        signal = chirp_burst(n, fs)
    rng = np.random.default_rng(seed)

    d = np.linalg.norm(src[:, None, :] - mic3[None, :, :], axis=-1)  # [B, M]
    d_ref = np.linalg.norm(src, axis=-1, keepdims=True)  # [B, 1]
    delays = (d - d_ref) / speed_of_sound * fs  # samples, zero-mean-ish

    out = fractional_delay(
        np.broadcast_to(signal, (src.shape[0], mic3.shape[0], n)), delays
    )
    out = out * amplitude
    if attenuation:
        out = out * (d_ref[..., None] / np.maximum(d[..., None], 1e-6))
    if noise_rms > 0:
        out = out + rng.normal(0.0, noise_rms, out.shape)
    return out


def to_adc_u8(frames: np.ndarray, *, dc: int = 128, scale: float = 120.0,
              clip: bool = True) -> np.ndarray:
    """Quantize float frames in [-1, 1] to the firmware's 8-bit unsigned ADC
    format (mid-scale DC offset, dma_sampler.c free-running 8-bit ADC)."""
    x = np.round(frames * scale + dc)
    if clip:
        x = np.clip(x, 0, 255)
    return x.astype(np.uint8)


def synth_scene_reverb(
    source_xyz: np.ndarray,
    mic_positions: np.ndarray,
    *,
    n: int = 1024,
    fs: float = 50_000.0,
    speed_of_sound: float = 343.0,
    signal: np.ndarray | None = None,
    amplitude: float = 0.8,
    noise_rms: float = 0.0,
    n_echoes: int = 6,
    echo_gain: float = 0.5,
    room_scale: float = 3.0,
    seed: int = 0,
) -> np.ndarray:
    """Reverberant scene: direct path + ``n_echoes`` image sources at random
    farther positions with decaying gains (a cheap image-source model).
    For geometrically-consistent echoes and physical RT60s use the shoebox
    simulator in :mod:`audio_triangulation_tpu.utils.room` instead.

    This is the regime where PHAT whitening earns its keep: plain
    cross-correlation peaks get biased toward echo energy, while the
    whitened correlogram keeps a sharp direct-path peak."""
    rng = np.random.default_rng(seed)
    out = synth_scene(
        source_xyz, mic_positions, n=n, fs=fs,
        speed_of_sound=speed_of_sound, signal=signal, amplitude=amplitude,
        noise_rms=0.0, seed=seed)
    src = np.atleast_2d(np.asarray(source_xyz, np.float64))
    for e in range(n_echoes):
        # image source: reflected to a random farther position
        offset = rng.uniform(-room_scale, room_scale, src.shape)
        offset[:, 2] = np.abs(offset[:, 2]) + 0.5
        img = src + offset
        g = amplitude * echo_gain * (0.7 ** e)
        echo = synth_scene(
            img, mic_positions, n=n, fs=fs,
            speed_of_sound=speed_of_sound, signal=signal, amplitude=g,
            noise_rms=0.0, seed=seed + 100 + e)
        # physical arrival delay of the longer echo path (synth_scene centers
        # each source's wavefront; echoes must arrive later than the direct)
        extra = ((np.linalg.norm(img, axis=-1) - np.linalg.norm(src, axis=-1))
                 / speed_of_sound * fs)  # [B] samples
        out = out + fractional_delay(echo, np.abs(extra)[:, None])
    if noise_rms > 0:
        out = out + rng.normal(0.0, noise_rms, out.shape)
    return out


def embed_burst_in_stream(
    frames: np.ndarray, total_len: int, burst_at: int, *,
    noise_rms: float = 0.0, seed: int = 1,
) -> np.ndarray:
    """Place event frames [B, M, N] into longer streams [B, M, total_len]
    starting at sample ``burst_at`` (for detector tests)."""
    b, m, n = frames.shape
    rng = np.random.default_rng(seed)
    out = rng.normal(0.0, noise_rms, (b, m, total_len)) if noise_rms > 0 \
        else np.zeros((b, m, total_len))
    out[..., burst_at: burst_at + n] += frames
    return out


def multisine_burst_fn(f0: float = 800.0, f1: float = 9000.0,
                       duration_s: float = 0.018, n_tones: int = 120,
                       seed: int = 1234):
    """s(t) evaluable at ARBITRARY times: a Hann-enveloped random
    multi-sine — the Doppler-SENSITIVE (thumbtack-ambiguity) waveform for
    delay-Doppler work.  (A linear chirp is Doppler-TOLERANT: its ambiguity
    function is a delay-Doppler ridge, so it cannot exercise ops.caf.)"""
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(f0, f1, n_tones)
    phases = rng.uniform(0.0, 2 * np.pi, n_tones)
    amps = rng.uniform(0.5, 1.0, n_tones) / np.sqrt(n_tones)

    def s(t):
        t = np.asarray(t, np.float64)
        tt = np.clip(t, 0.0, duration_s)
        env = np.where((t >= 0) & (t <= duration_s),
                       0.5 - 0.5 * np.cos(2 * np.pi * tt / duration_s), 0.0)
        sig = np.sum(amps[:, None]
                     * np.sin(2 * np.pi * freqs[:, None] * tt[None]
                              + phases[:, None]), axis=0)
        return env * sig

    return s


def synth_moving_scene(
    source_xyz: np.ndarray,
    velocity_xyz: np.ndarray,
    mic_positions: np.ndarray,
    *,
    n: int = 1024,
    fs: float = 50_000.0,
    speed_of_sound: float = 343.0,
    signal_fn=None,
    amplitude: float = 0.8,
    noise_rms: float = 0.0,
    seed: int = 0,
    t_offset: float = 0.0008,
) -> np.ndarray:
    """[1, M, N] frames of a MOVING source: each mic receives
    r_i(t) = s(t - d_i(t)/c) with d_i(t) = d_i0 + rdot_i t (linearized),
    i.e. the physically exact per-mic delay AND Doppler time-scale
    (1 - rdot_i/c).  ``signal_fn`` defaults to :func:`multisine_burst_fn`;
    delays are referenced to the array center like :func:`synth_scene`."""
    src = np.asarray(source_xyz, np.float64).reshape(-1)
    vel = np.asarray(velocity_xyz, np.float64).reshape(-1)
    src3 = np.zeros(3)
    src3[: src.shape[0]] = src
    vel3 = np.zeros(3)
    vel3[: vel.shape[0]] = vel
    mics = np.asarray(mic_positions, np.float64)
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, : mics.shape[1]] = mics
    if signal_fn is None:
        signal_fn = multisine_burst_fn()
    rng = np.random.default_rng(seed)

    t = np.arange(n) / fs
    d_ref = np.linalg.norm(src3)
    rows = []
    for mi in mic3:
        d0 = np.linalg.norm(src3 - mi)
        u = (src3 - mi) / max(d0, 1e-12)
        rdot = float(u @ vel3)  # d|x - m_i|/dt at t = 0
        rows.append(signal_fn(
            t * (1.0 - rdot / speed_of_sound)
            - (d0 - d_ref) / speed_of_sound + t_offset))
    out = amplitude * np.stack(rows)
    if noise_rms > 0:
        out = out + rng.normal(0.0, noise_rms, out.shape)
    return out[None]
