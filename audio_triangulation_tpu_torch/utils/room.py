"""Shoebox (rectangular-room) image-source acoustic simulator.

Counterpart of ``audio_triangulation_tpu.utils.room``: the Allen & Berkley
image-source method (ISM) for a rectangular room with per-wall reflection
coefficients, the data source of the reverberant scenes that
dereverberation (``ops.dereverb``) and reflector mapping
(``models.mapping``) are tested and driven on.

Two implementations share one image enumeration:

- :func:`simulate`: numpy, float64, for tests and small scenes (the
  reference's own numpy code, copied).
- :func:`simulate_batch`: torch float32 on an explicit device, batched over
  sources.  Images are affine in the source coordinate, so the enumeration
  is done once on the host and the positions are formed on the device; the
  transfer function is the reference's real cos / sin contraction over the
  images.  Its [B, M, K, F] phase tensors are the large part: a batch is cut
  into slices whose three such tensors stay under ``SLICE_BYTES``.

Conventions match :func:`..utils.synth.synth_scene`: delays are taken
relative to the source-to-array-center distance, so the direct wavefront
lands where the anechoic generator puts it, and the direct path has gain
``amplitude`` (images are attenuated by their reflection products and by
relative 1/r spreading).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops._device import irfft, pin_fp32_for

# the bytes the phase, cosine and sine tensors of one batch slice may take
SLICE_BYTES = 16e9


@dataclasses.dataclass(frozen=True)
class ShoeboxRoom:
    """Rectangular room [0, Lx] x [0, Ly] x [0, Lz].

    absorption: scalar alpha for all six walls, or a 6-sequence
    (x0, x1, y0, y1, z0, z1); energy absorption coefficient in (0, 1].
    max_order: maximum total reflection count per image (Allen & Berkley
    truncation).
    """

    size: tuple[float, float, float] = (6.0, 5.0, 3.0)
    absorption: float | tuple[float, ...] = 0.3
    max_order: int = 4

    def wall_reflections(self) -> np.ndarray:
        """Pressure reflection coefficients beta = sqrt(1 - alpha), [6]."""
        a = np.asarray(
            self.absorption
            if np.ndim(self.absorption) else [self.absorption] * 6,
            np.float64)
        if a.shape != (6,):
            raise ValueError(f"absorption must be scalar or 6 values, "
                             f"got shape {a.shape}")
        if np.any(a <= 0) or np.any(a > 1):
            raise ValueError(f"absorption must be in (0, 1], got {a}")
        return np.sqrt(1.0 - a)

    @property
    def volume(self) -> float:
        lx, ly, lz = self.size
        return lx * ly * lz

    @property
    def surface_areas(self) -> np.ndarray:
        """Areas of the six walls (x0, x1, y0, y1, z0, z1)."""
        lx, ly, lz = self.size
        return np.asarray(
            [ly * lz, ly * lz, lx * lz, lx * lz, lx * ly, lx * ly])


def rt60_sabine(room: ShoeboxRoom, *, speed_of_sound: float = 343.0) -> float:
    """Sabine reverberation time 24 ln(10) V / (c sum S_i alpha_i) seconds
    (the familiar 0.161 V / A at c = 343 m/s)."""
    a = np.asarray(
        room.absorption
        if np.ndim(room.absorption) else [room.absorption] * 6, np.float64)
    sabine_area = float(np.sum(room.surface_areas * a))
    return 24.0 * np.log(10.0) * room.volume / (speed_of_sound * sabine_area)


def absorption_for_rt60(size: tuple[float, float, float], rt60: float,
                        *, speed_of_sound: float = 343.0) -> float:
    """Uniform wall absorption giving the requested Sabine RT60."""
    room = ShoeboxRoom(size=size, absorption=0.5)
    alpha = (24.0 * np.log(10.0) * room.volume
             / (speed_of_sound * rt60 * float(np.sum(room.surface_areas))))
    if alpha >= 1.0:
        raise ValueError(
            f"room {size} cannot be that dead: RT60 {rt60} s needs "
            f"alpha {alpha:.2f} >= 1")
    return float(alpha)


def image_sources(
    source_xyz: np.ndarray,
    room: ShoeboxRoom,
) -> tuple[np.ndarray, np.ndarray]:
    """All image-source positions [K, 3] and pressure gains [K] up to
    ``room.max_order`` total reflections.

    Per dimension d with length L, source coordinate s, integer n and
    parity q in {0, 1}, the image coordinate is (-1)^q s + 2 n L with
    |n - q| reflections off the wall at 0 and |n| off the wall at L.  A 3-D
    image is a product over dimensions, kept if its total reflection count
    is <= max_order.  The q = 0, n = 0 triple is the direct source with
    gain 1, first in the order.
    """
    src = np.asarray(source_xyz, np.float64).reshape(3)
    beta = room.wall_reflections()  # [6] as (x0, x1, y0, y1, z0, z1)
    per_dim = []
    n_max = room.max_order // 2 + 1
    for d in range(3):
        length = room.size[d]
        if not 0.0 <= src[d] <= length:
            raise ValueError(
                f"source coordinate {d} = {src[d]} outside room "
                f"[0, {length}]")
        coords, gains, counts = [], [], []
        for n in range(-n_max, n_max + 1):
            for q in (0, 1):
                r_lo = abs(n - q)
                r_hi = abs(n)
                if r_lo + r_hi > room.max_order:
                    continue
                coords.append((1 - 2 * q) * src[d] + 2 * n * length)
                gains.append(beta[2 * d] ** r_lo * beta[2 * d + 1] ** r_hi)
                counts.append(r_lo + r_hi)
        per_dim.append(
            (np.asarray(coords), np.asarray(gains),
             np.asarray(counts, np.int64)))

    (cx, gx, rx), (cy, gy, ry), (cz, gz, rz) = per_dim
    total = (rx[:, None, None] + ry[None, :, None] + rz[None, None, :])
    keep = total <= room.max_order
    ix, iy, iz = np.nonzero(keep)
    pos = np.stack([cx[ix], cy[iy], cz[iz]], axis=-1)  # [K, 3]
    gain = gx[ix] * gy[iy] * gz[iz]                    # [K]
    order = np.lexsort((gain * -1.0, total[keep]))
    return pos[order], gain[order]


def _transfer_accumulate_np(sig_spec, freqs, delays, gains):
    """Y_m(f) = S(f) * sum_k g_mk e^{-2 pi i f d_mk}; numpy complex path.
    freqs in cycles/sample, delays in samples."""
    phase = np.exp(-2j * np.pi * freqs[None, None, :]
                   * delays[..., None])          # [M, K, F]
    h = np.einsum("mk,mkf->mf", gains, phase)    # [M, F]
    return sig_spec[None, :] * h


def _mics3(mic_positions, dtype) -> np.ndarray:
    mics = np.asarray(mic_positions, np.float64)
    mic3 = np.zeros((mics.shape[0], 3), dtype)
    mic3[:, : mics.shape[1]] = mics
    return mic3


def _signal(signal, n: int, fs: float, dtype) -> np.ndarray:
    from . import synth

    if signal is None:
        signal = synth.chirp_burst(n, fs)
    sig = np.zeros(n, dtype)
    sig[: len(signal)] = signal[:n]
    return sig


def simulate(
    source_xyz: np.ndarray,
    mic_positions: np.ndarray,
    room: ShoeboxRoom,
    *,
    n: int = 1024,
    fs: float = 50_000.0,
    speed_of_sound: float = 343.0,
    signal: np.ndarray | None = None,
    amplitude: float = 0.8,
    noise_rms: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    """Per-mic received frames [1, M, N] float64 for one source in the room.

    The signal (default: ``synth.chirp_burst``) propagates from every image
    source; image k at distance d reaches mic m delayed by (d_mk - d_ref)/c
    and scaled by g_k * d_ref/d_mk.  Energy arriving after n/fs seconds
    wraps circularly (FFT convolution), so pick n >= fs * (RT60 + direct
    delay) for clean tails.
    """
    src = np.asarray(source_xyz, np.float64).reshape(3)
    mic3 = _mics3(mic_positions, np.float64)
    sig = _signal(signal, n, fs, np.float64)

    pos, gain = image_sources(src, room)          # [K, 3], [K]
    d = np.linalg.norm(pos[None, :, :] - mic3[:, None, :], axis=-1)  # [M, K]
    d_ref = float(np.linalg.norm(src - mic3.mean(axis=0)))
    delays = (d - d_ref) / speed_of_sound * fs    # samples
    g = amplitude * gain[None, :] * (d_ref / np.maximum(d, 1e-6))

    spec = np.fft.rfft(sig)
    freqs = np.fft.rfftfreq(n)  # cycles/sample
    y_spec = _transfer_accumulate_np(spec, freqs, delays, g)
    out = np.fft.irfft(y_spec, n=n, axis=-1)[None]  # [1, M, N]

    if noise_rms > 0:
        rng = np.random.default_rng(seed)
        out = out + rng.normal(0.0, noise_rms, out.shape)
    return out


def image_affine(room: ShoeboxRoom) -> tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
    """(sign [K, 3], offset [K, 3], gain [K]) with image k of a source s at
    ``sign[k] * s + offset[k]``: the reference's decomposition, read off
    the images of a probe at the room's center."""
    probe = np.asarray([s / 2 for s in room.size])
    pos_probe, gain = image_sources(probe, room)
    sign = np.ones_like(pos_probe)
    offset = np.zeros_like(pos_probe)
    for d in range(3):
        # pos - 2 n L is +-probe, and probe_d > 0 tells the two apart
        rem = np.mod(pos_probe[:, d], 2 * room.size[d])
        is_pos = np.isclose(rem, probe[d])
        sign[:, d] = np.where(is_pos, 1.0, -1.0)
        offset[:, d] = pos_probe[:, d] - sign[:, d] * probe[d]
    if not np.allclose(sign * probe[None, :] + offset, pos_probe):
        raise AssertionError("image affine decomposition failed")
    return sign, offset, gain


def slice_sources(n_mics: int, n_images: int, n_bins: int,
                  budget: float = SLICE_BYTES) -> int:
    """Sources a slice of :func:`simulate_batch`: its phase, cosine and
    sine tensors [slice, M, K, F] float32 take at most ``budget`` bytes."""
    return max(1, int(budget // (3 * 4 * n_mics * n_images * n_bins)))


def simulate_batch(
    source_xyz,
    mic_positions: np.ndarray,
    room: ShoeboxRoom,
    *,
    device,
    n: int = 1024,
    fs: float = 50_000.0,
    speed_of_sound: float = 343.0,
    signal: np.ndarray | None = None,
    amplitude: float = 0.8,
) -> torch.Tensor:
    """Batched ISM on ``device``: sources [B, 3] (or [3]) -> frames
    [B, M, N] float32, the reference's float32 arithmetic.  Slices of
    :func:`slice_sources` sources run one after the other."""
    mic3 = _mics3(mic_positions, np.float32)
    sig = _signal(signal, n, fs, np.float32)
    spec = np.fft.rfft(sig.astype(np.float64))
    sign, offset, gain = image_affine(room)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    spec_re, spec_im = t(np.real(spec)), t(np.imag(spec))  # [F]
    freqs = t(np.fft.rfftfreq(n))
    sign, offset, gain, mics = t(sign), t(offset), t(gain), t(mic3)
    pin_fp32_for(mics)
    center = mics.mean(dim=0)
    src = torch.as_tensor(source_xyz, dtype=torch.float32,
                          device=device).reshape(-1, 3)  # [B, 3]
    step = slice_sources(mics.shape[0], gain.shape[0], freqs.shape[0])
    out = []
    for s in src.split(step):
        pos = sign * s[:, None, :] + offset  # [b, K, 3]
        d = torch.linalg.vector_norm(
            pos[:, None, :, :] - mics[None, :, None, :], dim=-1)  # [b, M, K]
        d_ref = torch.linalg.vector_norm(s - center, dim=-1)[:, None, None]
        delays = (d - d_ref) / speed_of_sound * fs  # samples
        g = amplitude * gain * (d_ref / d.clamp_min(1e-6))  # [b, M, K]
        ang = (2.0 * np.pi) * delays[..., None] * freqs  # [b, M, K, F]
        # H = sum_k g (cos - i sin), contracted over the images
        h_re = torch.matmul(g[..., None, :], torch.cos(ang))[..., 0, :]
        h_im = -torch.matmul(g[..., None, :], torch.sin(ang))[..., 0, :]
        del ang
        y_re = spec_re * h_re - spec_im * h_im  # [b, M, F]
        y_im = spec_re * h_im + spec_im * h_re
        out.append(irfft(torch.complex(y_re, y_im), n))
    return torch.cat(out).float()
