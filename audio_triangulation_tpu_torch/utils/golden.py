"""Golden model: NumPy port of the reference firmware's exact C semantics.

The port's own copy of ``audio_triangulation_tpu.utils.golden`` (numpy
only; the code below is the same), so that the integer path can be held
to its oracle on a machine without JAX.  It reproduces, bit for bit, the
fixed-point integer behavior of the reference DSP chain (int16 samples,
int32 products, int64 accumulators, arithmetic shifts, float32 scale
factors truncated back to int64):

- rolling ring buffer + O(1) half-window variance detector
  (reference ``src/components/rolling_buffer.c:3-85``)
- frame write-out with DC removal (``rolling_buffer.c:43-71``)
- <<8 gain (the live path of ``buffer_normalize_range``, ``buffer.c:13-18``)
  and the proper full-range normalizer (the dead code at ``buffer.c:20-48``)
- Q15 DPSS windowing (``buffer.c:4-11``, table from ``window.ipynb``)
- time-domain int64 cross-correlation + argmax + Gaussian peak taper
  (``correlations.c:4-36``)
- correlogram EMA (``correlations.c:38-63``)
- heatmap lag LUT + SRP scoring + 4-level color quantization
  (``vga_heatmap.h:48-133``)
- the full event pipeline (``sample_compute.h:45-150``)

Deliberately scalar/NumPy, clarity over speed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

BUFFER_SIZE_BITS = 10
BUFFER_SIZE = 1 << BUFFER_SIZE_BITS
BUFFER_HALF = BUFFER_SIZE >> 1
BUFFER_HALF_SIZE_BITS = BUFFER_SIZE_BITS - 1
MAX_SHIFT_SAMPLES = 50_000 * 32 // 34300  # == 46
CORRELATION_BUFFER_SIZE = 2 * MAX_SHIFT_SAMPLES + 1
POWER_THRESHOLD = 2 << (2 * BUFFER_HALF_SIZE_BITS)
SAMPLE_RATE_HZ = 50_000
SPEED_OF_SOUND_MPS = np.float32(343.0)


# ----------------------------------------------------------------------
# Window table (window.ipynb cells 2-4)
# ----------------------------------------------------------------------

def window_table_q15(length: int = BUFFER_SIZE, nw: float = 2.0) -> np.ndarray:
    """Q15 DPSS window table, the exact ``WINDOW_FUNCTION`` generation recipe:
    dpss(N, NW) -> /max -> round(x * 32767) -> int32."""
    from scipy.signal import windows

    w = windows.dpss(length, nw)
    w = w / np.max(w)
    w = w / np.max(np.abs(w))  # to_int16 re-normalizes (window.ipynb cell 3)
    return np.round(w * 32767).astype(np.int32)


# ----------------------------------------------------------------------
# Rolling buffer (rolling_buffer.c)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class RollingBuffer:
    """Parametric ring: the C supports any power-of-two BUFFER_SIZE_BITS
    (buffer.h:5-6; the window indexing at buffer.c:8 strides the 1024-entry
    table accordingly).  Defaults to the firmware's 1024."""

    size_bits: int = BUFFER_SIZE_BITS
    head: int = 0
    incoming_power: int = 0
    incoming_total: int = 0
    outgoing_power: int = 0
    outgoing_total: int = 0
    is_full: bool = False
    buffer: np.ndarray = None

    def __post_init__(self):
        if self.buffer is None:
            self.buffer = np.zeros(1 << self.size_bits, dtype=np.int16)

    @property
    def size(self) -> int:
        return 1 << self.size_bits

    def push(self, sample: int) -> None:
        sample = np.int16(sample)
        middle_index = self.head - (self.size >> 1)
        if middle_index < 0:
            middle_index += self.size
        middle = int(self.buffer[middle_index])
        old = int(self.buffer[self.head])

        self.outgoing_total += middle - old
        self.outgoing_power += middle * middle - old * old
        self.incoming_total += int(sample) - middle
        self.incoming_power += int(sample) * int(sample) - middle * middle

        self.buffer[self.head] = sample
        self.head += 1
        if self.head >= self.size:
            self.head = 0
            self.is_full = True

    def get_incoming_power(self) -> int:
        return ((self.incoming_power << (self.size_bits - 1))
                - self.incoming_total * self.incoming_total)

    def get_outgoing_power(self) -> int:
        return ((self.outgoing_power << (self.size_bits - 1))
                - self.outgoing_total * self.outgoing_total)

    def write_out(self) -> tuple[np.ndarray, int]:
        """Unroll oldest->newest, remove DC (total >> bits), return
        (frame, power)."""
        frame = np.concatenate(
            [self.buffer[self.head:], self.buffer[: self.head]]
        ).astype(np.int64)
        total = int(frame.sum())
        offset = total >> self.size_bits  # C arithmetic shift (floor)
        frame = (frame - offset).astype(np.int16)
        power = int((frame.astype(np.int64) ** 2).sum())
        return frame, power


# ----------------------------------------------------------------------
# Frame conditioning (buffer.c)
# ----------------------------------------------------------------------

def normalize_shift8(frame: np.ndarray) -> np.ndarray:
    """The live reference behavior: int16 <<= 8 with int16 wraparound."""
    return (frame.astype(np.int32) << 8).astype(np.int16)


def normalize_full_range(frame: np.ndarray) -> np.ndarray:
    """The reference's dead peak-normalization code (buffer.c:20-48)."""
    m = int(np.abs(frame.astype(np.int32)).max())
    if m <= 0:
        return np.zeros_like(frame)
    scale = (32767 << 15) // m
    tmp = (frame.astype(np.int64) * scale) >> 15
    return np.clip(tmp, -32768, 32767).astype(np.int16)


def apply_window(frame: np.ndarray, table: np.ndarray) -> np.ndarray:
    """buffer_window: x = int16((int32(x) * W[i << (10 - bits)]) >> 15)."""
    n = frame.shape[0]
    stride = 1024 // n
    w = table[np.arange(n) * stride]
    tmp = frame.astype(np.int32) * w
    return (tmp >> 15).astype(np.int16)


# ----------------------------------------------------------------------
# Cross-correlation (correlations.c)
# ----------------------------------------------------------------------

def xcorr_init(a: np.ndarray, b: np.ndarray,
               max_shift: int = MAX_SHIFT_SAMPLES,
               taper: bool = True) -> tuple[np.ndarray, int]:
    """Time-domain int cross-correlation over the overlap, argmax (first max
    wins), then Gaussian taper with float32 scale truncated back to int64.

    Returns (correlogram[int64, 2K+1], best_shift)."""
    n = a.shape[0]
    a64 = a.astype(np.int64)
    b64 = b.astype(np.int64)
    corr = np.zeros(2 * max_shift + 1, dtype=np.int64)
    best_score = None
    best_shift = 0
    for s in range(-max_shift, max_shift + 1):
        if s < 0:
            score = int((a64[-s:] * b64[: n + s]).sum())
        else:
            score = int((a64[: n - s] * b64[s:]).sum())
        corr[s + max_shift] = score
        if best_score is None or score > best_score:
            best_score = score
            best_shift = s

    if taper:
        for s in range(-max_shift, max_shift + 1):
            diff = (s - best_shift) ** 2
            # C: exp(-diff / 36.f) -- float32 argument, double exp, float result
            arg = np.float32(-diff) / np.float32(36.0)
            scale = np.float32(np.exp(np.float64(arg)))
            # C: int64 * float -> float32 multiply, truncated on assignment
            v = np.float32(np.float32(corr[s + max_shift]) * scale)
            corr[s + max_shift] = np.int64(np.trunc(v))
    return corr, best_shift


def xcorr_average(estimate: np.ndarray, new: np.ndarray,
                  dt_s: float) -> tuple[np.ndarray, int]:
    """correlations_average: per-bin float32 EMA with decay 1 - exp(-dt/0.5),
    truncated back to int64; then re-argmax.  Returns (updated, best_shift)."""
    arg = -np.float32(dt_s) / np.float32(0.5)
    decay = np.float32(np.float64(1.0) - np.exp(np.float64(arg)))
    out = estimate.copy()
    for i in range(out.shape[0]):
        est = out[i]
        delta = np.float32(np.float32(new[i] - est) * decay)
        v = np.float32(np.float32(est) + delta)
        out[i] = np.int64(np.trunc(v))
    best = int(np.argmax(out))  # first max wins, matches strict > scan
    return out, best - (out.shape[0] // 2)


# ----------------------------------------------------------------------
# Geometry (microphones.c) -- float32 exactly as the firmware computes it
# ----------------------------------------------------------------------

def mic_locations(d_ab=np.float32(0.132), d_bc=np.float32(0.15),
                  d_ca=np.float32(0.20), mirror=True, rotate=False) -> np.ndarray:
    f = np.float32
    d_ab, d_bc, d_ca = f(d_ab), f(d_bc), f(d_ca)
    x_c = (d_ab * d_ab + d_ca * d_ca - d_bc * d_bc) / (f(2.0) * d_ab)
    y_c = np.sqrt(np.maximum(f(0.0), d_ca * d_ca - x_c * x_c))
    p = np.array([[f(0), f(0)],
                  [d_ab, f(0)],
                  [x_c, y_c * (f(-1.0) if mirror else f(1.0))]], dtype=np.float32)
    c = np.array([p[:, 0].sum() / f(3.0), p[:, 1].sum() / f(3.0)], dtype=np.float32)
    p = p - c
    if rotate:
        theta = np.arctan2(p[0, 1], p[0, 0])
        co, si = np.cos(-theta, dtype=np.float32), np.sin(-theta, dtype=np.float32)
        p = np.stack([p[:, 0] * co - p[:, 1] * si,
                      p[:, 0] * si + p[:, 1] * co], axis=-1)
    return p.astype(np.float32)


# ----------------------------------------------------------------------
# Heatmap / SRP (vga_heatmap.h)
# ----------------------------------------------------------------------

HEAT_HALF_W = 50
HEAT_HALF_H = 50
HEAT_W = 2 * HEAT_HALF_W + 1
HEAT_H = 2 * HEAT_HALF_H + 1
POS_SCALE = np.float32(24.0)
HEIGHT_M = np.float32(1.2)


def heatmap_luts(mics: np.ndarray) -> np.ndarray:
    """[3, H, W] uint8 lag LUT, exactly vga_init_heatmap (vga_heatmap.h:48-93)."""
    f = np.float32
    out = np.zeros((3, HEAT_H, HEAT_W), dtype=np.uint8)
    for y in range(HEAT_H):
        for x in range(HEAT_W):
            x_m = f(x - HEAT_HALF_W) / POS_SCALE
            y_m = f(HEAT_HALF_H - y) / POS_SCALE
            z_m = HEIGHT_M
            scale = HEIGHT_M / np.sqrt(z_m * z_m + x_m * x_m + y_m * y_m)
            x_m, y_m, z_m = x_m * scale, y_m * scale, z_m * scale
            ds = []
            for m in range(3):
                dx = x_m - mics[m, 0]
                dy = y_m - mics[m, 1]
                ds.append(np.sqrt(z_m * z_m + dx * dx + dy * dy))
            dA, dB, dC = ds
            for p, (di, dj) in enumerate(((dA, dB), (dA, dC), (dB, dC))):
                dt = (dj - di) / SPEED_OF_SOUND_MPS
                # C roundf: round half away from zero
                v = dt * f(SAMPLE_RATE_HZ)
                s = int(np.trunc(v + np.copysign(np.float32(0.5), v)))
                s = max(-MAX_SHIFT_SAMPLES, min(MAX_SHIFT_SAMPLES, s))
                out[p, y, x] = np.uint8(s + MAX_SHIFT_SAMPLES)
    return out


def srp_scores(luts: np.ndarray, corr_ab: np.ndarray, corr_ac: np.ndarray,
               corr_bc: np.ndarray) -> np.ndarray:
    """[H, W] int64 cell scores = sum of the 3 correlogram values at the
    cell's expected lags (vga_draw_heatmap:99-108)."""
    return (corr_ab[luts[0]] + corr_ac[luts[1]] + corr_bc[luts[2]]).astype(np.int64)


def heatmap_colors(scores: np.ndarray) -> np.ndarray:
    """4-level color quantization (vga_draw_heatmap:111-127).
    0=black, 1=blue, 2=red, 3=green, 4=white."""
    highest = int(scores.max())
    t_white = (highest * 63) >> 6
    t_green = (highest * 31) >> 5
    t_red = (highest * 15) >> 4
    t_blue = (highest * 7) >> 3
    out = np.zeros(scores.shape, dtype=np.uint8)
    out[scores >= t_blue] = 1
    out[scores >= t_red] = 2
    out[scores >= t_green] = 3
    out[scores >= t_white] = 4
    return out


# ----------------------------------------------------------------------
# Full event pipeline (sample_compute.h)
# ----------------------------------------------------------------------

@dataclasses.dataclass
class GoldenPipeline:
    """Sequential reference pipeline over 8-bit sample streams.

    ``detect_index`` consumes per-mic sample streams exactly like the 50 kHz
    protothread loop (push each sample, check the variance trigger once all
    rings are full); ``process_event`` then runs the capture burst:
    write-out -> <<8 -> window -> xcorr -> shift gate -> EMA.
    """

    window: np.ndarray = dataclasses.field(default_factory=window_table_q15)
    taper: bool = True

    def __post_init__(self):
        self.rings = [RollingBuffer() for _ in range(3)]
        self.corr = [np.zeros(CORRELATION_BUFFER_SIZE, dtype=np.int64)
                     for _ in range(3)]
        self.best = [0, 0, 0]
        self.frames = None
        self.events = []

    def detect_index(self, streams: np.ndarray) -> int | None:
        """First trigger index (sample position) in streams [3, T], or None."""
        t_len = streams.shape[1]
        for r in self.rings:
            r.__init__()
        for t in range(t_len):
            for m in range(3):
                self.rings[m].push(streams[m, t])
            if all(r.is_full for r in self.rings):
                outp = sum(r.get_outgoing_power() for r in self.rings)
                inp = sum(r.get_incoming_power() for r in self.rings)
                if outp > POWER_THRESHOLD + inp:
                    return t
        return None

    def process_event(self, dt_s: float = 0.1) -> dict:
        """Post-trigger processing of whatever is in the rings now."""
        frames = []
        for r in self.rings:
            frame, power = r.write_out()
            frame = normalize_shift8(frame)
            frame = apply_window(frame, self.window)
            frames.append(frame)
        self.frames = np.stack(frames)

        new_corr = []
        best = []
        for i, j in ((0, 1), (0, 2), (1, 2)):
            c, s = xcorr_init(frames[i], frames[j], taper=self.taper)
            new_corr.append(c)
            best.append(s)

        gate = sum(s * s for s in best) > 4
        if gate:
            for p in range(3):
                self.corr[p], self.best[p] = xcorr_average(
                    self.corr[p], new_corr[p], dt_s)
        return {
            "new_corr": np.stack(new_corr),
            "new_best": np.array(best),
            "gate": gate,
            "corr": np.stack(self.corr),
            "best": np.array(self.best),
            "frames": self.frames,
        }
