"""Traffic generators: every input of a run, drawn on the device from
``--seed`` by one ``torch.Generator``.

A source at a known point on the sphere of the grid's height emits a
Gaussian-enveloped linear chirp; each mic receives it delayed by the exact
geometric fractional delay (a phase shift of its spectrum), relative to the
array's centre, scaled by the amplitude.  Frames add white noise; streams
idle at the 8-bit ADC's mid-scale, +-1 count, and some hold one such burst
at their own offset, scaled to ADC counts, rounded and clipped to 0-255.
The arithmetic is the program's test scenes' (``utils/synth``,
``chip_smoke.scene_frames`` / ``stream_scene``), written here in torch.

The traffic file fixes every size; the seed moves only the sources, the
burst offsets and the noise, so every seed makes the same work.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# frames synthesised at a time (bounds the float64 spectra's memory)
SYNTH_BLOCK = 4096


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def chirp(n: int, fs: float, source: dict, device) -> torch.Tensor:
    """The burst [n] float64: a linear chirp from ``f0_hz`` to ``f1_hz``
    over the frame under a Gaussian envelope (``center``, ``width`` as
    fractions of it), peak 1."""
    t = torch.arange(n, dtype=torch.float64, device=device) / fs
    total = n / fs
    sweep = source["f0_hz"] + (source["f1_hz"] - source["f0_hz"]) * (t / total)
    phase = 2 * math.pi * torch.cumsum(sweep, dim=0) / fs
    env = torch.exp(-0.5 * ((t - source["center"] * total)
                            / (source["width"] * total)) ** 2)
    return env * torch.sin(phase)


def sphere_sources(gen: torch.Generator, count: int, radius_m: tuple,
                   height: float, device) -> torch.Tensor:
    """[count, 3] float64 points on the sphere of radius ``height``: plane
    points drawn uniformly over the annulus ``radius_m`` at z = height,
    projected onto the sphere."""
    lo, hi = radius_m
    u = torch.rand(count, dtype=torch.float64, device=device, generator=gen)
    ang = 2 * math.pi * torch.rand(count, dtype=torch.float64, device=device,
                                   generator=gen)
    r = torch.sqrt(lo * lo + (hi * hi - lo * lo) * u)
    v = torch.stack([r * torch.cos(ang), r * torch.sin(ang),
                     torch.full_like(r, height)], dim=-1)
    return v * (height / torch.linalg.vector_norm(v, dim=-1, keepdim=True))


def received(signal: torch.Tensor, sources: torch.Tensor, mics: np.ndarray,
             fs: float, c: float, amplitude: float) -> torch.Tensor:
    """What each mic [M, 2] receives of ``signal`` [n] from ``sources``
    [B, 3]: [B, M, n] float64, delayed by (|s - m| - |s|) / c."""
    n = signal.shape[-1]
    dev = signal.device
    mic3 = torch.zeros((mics.shape[0], 3), dtype=torch.float64, device=dev)
    mic3[:, :2] = torch.as_tensor(mics[:, :2], dtype=torch.float64, device=dev)
    d = torch.linalg.vector_norm(sources[:, None, :] - mic3, dim=-1)
    delay = (d - torch.linalg.vector_norm(sources, dim=-1, keepdim=True)) \
        / c * fs
    spec = torch.fft.rfft(signal)
    freqs = torch.arange(spec.shape[-1], dtype=torch.float64, device=dev) / n
    shifted = spec * torch.exp(-2j * math.pi * freqs * delay[..., None])
    # DC and Nyquist read as real, on every device
    shifted[..., 0] = shifted[..., 0].real
    if n % 2 == 0:
        shifted[..., -1] = shifted[..., -1].real
    return amplitude * torch.fft.irfft(shifted, n=n)


def frame_pool(config: dict, traffic: dict, seed: int, device) -> list:
    """``pool_batches`` batches of ``frames_per_call`` frames [B, M, N]
    float32, one source a frame, noise of ``noise_rms``."""
    p = config["pipeline"]
    mics = np.asarray(config["mic_positions_m"], np.float32)
    n = 1 << p["frame_size_bits"]
    fs, c = float(p["sample_rate_hz"]), float(p["speed_of_sound_mps"])
    src = traffic["source"]
    b, batches = traffic["frames_per_call"], traffic["pool_batches"]
    gen = generator(seed, device)
    signal = chirp(n, fs, src, device)
    points = sphere_sources(gen, b * batches, tuple(src["plane_radius_m"]),
                            float(config["grid"]["height_m"]), device)
    pool = []
    for k in range(batches):
        out = torch.empty((b, mics.shape[0], n), dtype=torch.float32,
                          device=device)
        for b0 in range(0, b, SYNTH_BLOCK):
            b1 = min(b, b0 + SYNTH_BLOCK)
            out[b0:b1] = received(signal, points[k * b + b0:k * b + b1],
                                  mics, fs, c, src["amplitude"])
        noise = torch.randn(out.shape, dtype=torch.float32, device=device,
                            generator=gen)
        pool.append(out.add_(noise, alpha=float(traffic["noise_rms"])))
    return pool


def stream_pool(config: dict, traffic: dict, seed: int, device,
                n_streams: int) -> torch.Tensor:
    """``pool_chunks`` chunks of ``n_streams`` streams [C, S, M, chunk]
    float32 ADC counts: every stream idles at ``idle_counts`` (inclusive),
    every ``burst_every``-th holds one burst (with its own noise) at its own
    offset, ``burst_gain`` counts a unit, rounded and clipped to 0-255."""
    p = config["pipeline"]
    mics = np.asarray(config["mic_positions_m"], np.float32)
    n = 1 << p["frame_size_bits"]
    fs, c = float(p["sample_rate_hz"]), float(p["speed_of_sound_mps"])
    chunk = config["stream"]["chunk_size"]
    n_chunks = traffic["pool_chunks"]
    t_len = n_chunks * chunk
    m = mics.shape[0]
    src = traffic["source"]
    gen = generator(seed, device)
    lo, hi = traffic["idle_counts"]
    x = torch.randint(lo, hi + 1, (n_streams, m, t_len), device=device,
                      generator=gen).to(torch.float32)
    planted = torch.arange(0, n_streams, traffic["burst_every"], device=device)
    points = sphere_sources(gen, planted.numel(),
                            tuple(src["plane_radius_m"]),
                            float(config["grid"]["height_m"]), device)
    offsets = torch.randint(0, t_len - n + 1, (planted.numel(),),
                            device=device, generator=gen)
    signal = chirp(n, fs, src, device)
    for b0 in range(0, planted.numel(), SYNTH_BLOCK):
        sel = slice(b0, b0 + SYNTH_BLOCK)
        burst = received(signal, points[sel], mics, fs, c, src["amplitude"])
        burst = burst + float(traffic["burst_noise_rms"]) * torch.randn(
            burst.shape, dtype=torch.float64, device=device, generator=gen)
        rows = x[planted[sel]]
        idx = offsets[sel, None, None] + torch.arange(n, device=device)
        rows.scatter_add_(-1, idx.expand(-1, m, -1),
                          (traffic["burst_gain"] * burst).to(torch.float32))
        x[planted[sel]] = torch.clamp(torch.round(rows), 0.0, 255.0)
    return x.view(n_streams, m, n_chunks, chunk).permute(2, 0, 1, 3) \
        .contiguous()
