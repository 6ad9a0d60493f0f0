"""The plain reference that decides ``correct``: the frame-batch chain and
the streaming step, written from the configuration's definitions in plain
torch, in float64, with no code of the program under test.

Frame batch (``localize``): DC removal, the shift8 gain and the unit-peak
DPSS window; the real DFT of the kept bins (the band, or all bins) as a
product with cos / -sin matrices, zero padding to the FFT length implicit;
PHAT whitening per mic; the cross-power of each pair; the +-K lags
synthesised from the kept bins (Hermitian weights 1 at DC and Nyquist,
else 2); the first-max integer peak, the 3-point parabolic sub-sample peak
of the raw correlogram and the Gaussian taper around the integer peak; SRP
scores as the sum over pairs of the tapered correlogram at each cell's lag
(the firmware's float32 lag table, rounded half away from zero); the
first-max grid cell; five damped Gauss-Newton steps on the 1.2 m sphere
from that cell.

Streaming (``StreamReference``): the firmware's variance trigger on exact
integer sums (the summed outgoing half-frame variance exceeds the
threshold plus the summed incoming one), one event a chunk with a
frame-long hold-off, the captured frame through the chain above, the shift
gate, the EMA of the tapered correlograms with the real time between
accepted events, its integer peak and parabolic TDOAs, SRP over the whole
grid with the quadratic sub-cell fit, and the same solve.

``Precision.below()`` is the control: the same chain in float32 with every
matrix product's operands rounded to TF32 (10 mantissa bits, the step
below float32 with TF32 off), and the SRP product's correlogram operand
rounded one step below the configuration's scoring type (TF32 below
float32, fp8 e4m3 below bfloat16).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


# ----------------------------------------------------------------------
# precision
# ----------------------------------------------------------------------

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = x.contiguous().view(torch.int32)
    odd = (i >> 13) & 1
    return ((i + 0xFFF + odd) & ~0x1FFF).view(torch.float32)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 after a power-of-two scale a row (exact),
    which keeps each row's largest value in range."""
    amax = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    scale = torch.exp2(torch.floor(torch.log2(448.0 / amax)))
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


@dataclasses.dataclass(frozen=True)
class Precision:
    """The reference's arithmetic: float64 throughout, or the control."""

    dtype: torch.dtype = torch.float64
    control: bool = False

    @staticmethod
    def below() -> "Precision":
        return Precision(torch.float32, True)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """A matrix product at this precision (TF32 operands, float32
        sums, in the control)."""
        if self.control:
            return torch.matmul(tf32_round(a), tf32_round(b))
        return torch.matmul(a, b)

    def srp_operand(self, x: torch.Tensor, srp_dtype: str) -> torch.Tensor:
        if not self.control:
            return x
        return fp8_round(x) if srp_dtype == "bfloat16" else tf32_round(x)


# ----------------------------------------------------------------------
# configuration
# ----------------------------------------------------------------------

def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class Settings:
    """What the chain needs of a configuration file, derived once."""

    mics: np.ndarray  # [M, 2] float32, as given
    fs: float
    c: float
    n: int
    k: int
    fft_length: int
    gain: float
    window_nw: float
    phat: bool
    phat_eps: float
    band: tuple | None
    taper_denom: float
    srp_dtype: str
    half_x: int
    half_y: int
    cells_per_m: float
    height: float
    sphere_grid: bool
    iterations: int
    damping: float
    sphere_solve: bool
    ema_tau_s: float
    shift_gate: int
    threshold: int
    chunk: int

    @property
    def pairs(self) -> np.ndarray:
        m = self.mics.shape[0]
        return np.array([(i, j) for i in range(m) for j in range(i + 1, m)],
                        dtype=np.int64)

    @property
    def num_lags(self) -> int:
        return 2 * self.k + 1

    @property
    def grid_shape(self) -> tuple:
        return 2 * self.half_y + 1, 2 * self.half_x + 1


def settings(config: dict, *, full_grid: bool = False) -> Settings:
    """Settings of a configuration file's dict.  The grid is coarsened by
    ``init_grid_stride`` unless ``full_grid`` (the streaming step scores
    the whole grid)."""
    p, g, s = config["pipeline"], config["grid"], config["solver"]
    n = 1 << p["frame_size_bits"]
    k = p["max_shift_samples"]
    if p["fft_pad_mode"] == "circular":
        fft_length = n
    elif p["fft_pad_mode"] == "linear":
        fft_length = _next_pow2(n + k)
    else:
        raise ValueError(f"fft_pad_mode {p['fft_pad_mode']!r}")
    if p["normalize_mode"] != "shift8" or p["subsample_method"] != "parabolic":
        raise ValueError("the reference writes the shift8 gain and the "
                         "parabolic sub-sample peak only")
    if p.get("trigger_mode", "absolute") != "absolute":
        raise ValueError("the reference writes the absolute trigger only")
    stride = 1 if full_grid else config.get("init_grid_stride", 1)
    if g["projection"] not in ("sphere", "plane"):
        raise ValueError(f"projection {g['projection']!r}")
    band = p.get("band_hz")
    return Settings(
        mics=np.asarray(config["mic_positions_m"], np.float32),
        fs=float(p["sample_rate_hz"]), c=float(p["speed_of_sound_mps"]),
        n=n, k=k, fft_length=fft_length, gain=256.0,
        window_nw=float(p["window_nw"]), phat=bool(p["phat"]),
        phat_eps=float(p["phat_eps"]),
        band=None if band is None else (float(band[0]), float(band[1])),
        taper_denom=float(p["taper_denom"]), srp_dtype=p["srp_dtype"],
        half_x=g["half_cells_x"] // stride, half_y=g["half_cells_y"] // stride,
        cells_per_m=float(g["cells_per_m"]) / stride,
        height=float(g["height_m"]), sphere_grid=g["projection"] == "sphere",
        iterations=int(s["iterations"]), damping=float(s["damping"]),
        sphere_solve=bool(s["constrain_to_sphere"]),
        ema_tau_s=float(p["ema_tau_s"]), shift_gate=int(p["shift_gate"]),
        threshold=int(p["power_threshold"]),
        chunk=int(config.get("stream", {}).get("chunk_size", 0)))


def dpss_window(n: int, nw: float) -> np.ndarray:
    """The unit-peak DPSS (Slepian) window, float64."""
    from scipy.signal import windows

    w = windows.dpss(n, nw)
    return w / np.max(w)


def kept_bins(st: Settings) -> np.ndarray:
    """The rFFT bins the chain keeps: those inside the band, or all."""
    f = st.fft_length // 2 + 1
    bins = np.arange(f)
    if st.band is None:
        return bins
    freqs = bins * (st.fs / st.fft_length)
    return bins[(freqs >= st.band[0]) & (freqs <= st.band[1])]


def lag_table(st: Settings) -> np.ndarray:
    """The firmware's lag table [P, G] (lag index 0 .. 2K): each cell's
    expected TDOA in samples, computed in float32, rounded half away from
    zero, clamped to +-K."""
    f32 = np.float32
    xs = (np.arange(2 * st.half_x + 1, dtype=f32) - st.half_x) / f32(
        st.cells_per_m)
    ys = (st.half_y - np.arange(2 * st.half_y + 1, dtype=f32)) / f32(
        st.cells_per_m)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    pts = np.stack([gx, gy, np.full_like(gx, f32(st.height))], axis=-1)
    if st.sphere_grid:
        r = np.sqrt((pts * pts).sum(-1, keepdims=True, dtype=f32))
        pts = (pts * (f32(st.height) / r)).astype(f32)
    mic3 = np.zeros((st.mics.shape[0], 3), f32)
    mic3[:, :2] = st.mics[:, :2]
    diff = pts[..., None, :] - mic3
    dist = np.sqrt((diff * diff).sum(-1))
    pairs = st.pairs
    dt = ((dist[..., pairs[:, 1]] - dist[..., pairs[:, 0]]) / f32(st.c)).astype(
        f32)
    v = dt * f32(st.fs)
    shifts = np.trunc(v + np.copysign(f32(0.5), v)).astype(np.int64)
    shifts = np.clip(shifts, -st.k, st.k) + st.k
    return shifts.reshape(-1, pairs.shape[0]).T.copy()


# ----------------------------------------------------------------------
# the frame-batch chain
# ----------------------------------------------------------------------

class Chain:
    """The reference chain of one configuration on one device."""

    def __init__(self, st: Settings, device, precision=Precision()):
        self.st = st
        self.pr = precision
        dt = precision.dtype
        self.device = torch.device(device)

        def t(a, dtype=dt):
            return torch.as_tensor(a, dtype=dtype, device=self.device)

        n, l_fft, k = st.n, st.fft_length, st.k
        self.window = t(dpss_window(n, st.window_nw))
        bins = kept_bins(st)
        ang = 2.0 * np.pi * np.outer(np.arange(n), bins) / l_fft
        self.cos, self.msin = t(np.cos(ang)), t(-np.sin(ang))
        lags = np.arange(-k, k + 1)
        w = np.where((bins == 0) | (2 * bins == l_fft), 1.0, 2.0)[:, None]
        ang = 2.0 * np.pi * np.outer(bins, lags) / l_fft
        self.syn_c = t(w * np.cos(ang) / l_fft)
        self.syn_s = t(-w * np.sin(ang) / l_fft)
        self.pairs = t(st.pairs, torch.long)
        self.lags = t(lags)
        lut = lag_table(st)
        self.lut = t(lut, torch.long)
        onehot = np.zeros((lut.shape[0], st.num_lags, lut.shape[1]))
        onehot[np.arange(lut.shape[0])[:, None], lut,
               np.arange(lut.shape[1])[None, :]] = 1.0
        self.onehot = t(onehot.reshape(-1, lut.shape[1]))
        mic3 = np.zeros((st.mics.shape[0], 3))
        mic3[:, :2] = st.mics[:, :2].astype(np.float64)
        self.mic3 = t(mic3)

    # --- correlation ---------------------------------------------------
    def correlograms(self, frames: torch.Tensor) -> torch.Tensor:
        """Raw frames [B, M, N] -> raw correlograms [B, P, 2K+1]."""
        x = frames.to(self.pr.dtype)
        x = (x - x.mean(dim=-1, keepdim=True)) * self.st.gain * self.window
        re, im = self.pr.mm(x, self.cos), self.pr.mm(x, self.msin)
        if self.st.phat:
            if self.st.mics.shape[0] < 3:
                raise ValueError("the reference whitens per mic (3+ mics)")
            inv = torch.rsqrt(re * re + im * im + self.st.phat_eps ** 2)
            re, im = re * inv, im * inv
        i, j = self.pairs[:, 0], self.pairs[:, 1]
        ri, ii, rj, ij = re[:, i], im[:, i], re[:, j], im[:, j]
        rr = ri * rj + ii * ij
        jj = ri * ij - ii * rj
        return self.pr.mm(rr, self.syn_c) + self.pr.mm(jj, self.syn_s)

    def integer_peak(self, corr: torch.Tensor) -> torch.Tensor:
        """First-max lag in [-K, K]."""
        return corr.argmax(dim=-1) - self.st.k

    def parabolic(self, corr: torch.Tensor) -> torch.Tensor:
        """3-point parabolic sub-sample peak in samples (interior peaks
        only, offset clipped to +-0.5)."""
        n_lags = corr.shape[-1]
        p = corr.argmax(dim=-1)
        pc = p.clamp(1, n_lags - 2)
        cm = corr.gather(-1, (pc - 1)[..., None])[..., 0]
        c0 = corr.gather(-1, pc[..., None])[..., 0]
        cp = corr.gather(-1, (pc + 1)[..., None])[..., 0]
        den = cm - 2.0 * c0 + cp
        delta = torch.where(den.abs() > 1e-20, 0.5 * (cm - cp) / den,
                            torch.zeros_like(den))
        interior = (p >= 1) & (p <= n_lags - 2)
        delta = torch.where(interior, delta, torch.zeros_like(delta))
        return (p - self.st.k).to(corr.dtype) + delta.clamp(-0.5, 0.5)

    def taper(self, corr: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
        d = self.lags - shift[..., None].to(corr.dtype)
        return corr * torch.exp(-(d * d) / self.st.taper_denom)

    # --- scoring and solve ---------------------------------------------
    def scores(self, corr_t: torch.Tensor) -> torch.Tensor:
        """SRP scores [B, G] of tapered correlograms [B, P, L]."""
        flat = corr_t.reshape(corr_t.shape[0], -1)
        return self.pr.mm(self.pr.srp_operand(flat, self.st.srp_dtype),
                          self.onehot)

    def cell_xy(self, cell: torch.Tensor, dx=0.0, dy=0.0) -> torch.Tensor:
        w = 2 * self.st.half_x + 1
        row, col = cell // w, cell % w
        x = (col.to(self.pr.dtype) + dx - self.st.half_x) / self.st.cells_per_m
        y = (self.st.half_y - (row.to(self.pr.dtype) + dy)) / \
            self.st.cells_per_m
        return torch.stack([x, y], dim=-1)

    def grid_peak(self, scores: torch.Tensor, refine: bool):
        """(first-max cell [B], its xy [B, 2]), with the 3-point quadratic
        sub-cell fit along each axis when ``refine``."""
        cell = scores.argmax(dim=-1)
        if not refine:
            return cell, self.cell_xy(cell)
        h, w = self.st.grid_shape
        row, col = cell // w, cell % w

        def frac(center, axis_len, stride):
            base = cell + (center.clamp(1, axis_len - 2) - center) * stride
            vm, v0, vp = (scores.gather(-1, (base + o * stride)[:, None])[:, 0]
                          for o in (-1, 0, 1))
            den = vm - 2.0 * v0 + vp
            d = torch.where(den.abs() > 1e-20, 0.5 * (vm - vp) / den,
                            torch.zeros_like(den))
            inside = (center >= 1) & (center <= axis_len - 2)
            return torch.where(inside, d, torch.zeros_like(d)).clamp(-0.5, 0.5)

        return cell, self.cell_xy(cell, frac(col, w, 1), frac(row, h, w))

    def solve(self, tau_s: torch.Tensor, init_xy: torch.Tensor):
        """Damped Gauss-Newton from ``init_xy``: (xy [B, 2], rms [B] m)."""
        st = self.st
        x, y = init_xy[:, 0], init_xy[:, 1]
        i, j = self.pairs[:, 0], self.pairs[:, 1]
        target = tau_s * st.c
        for it in range(st.iterations + 1):
            v = torch.stack([x, y, torch.full_like(x, st.height)], dim=-1)
            if st.sphere_solve:
                nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
                vh = v / nv
                s = st.height * vh
                eye = torch.eye(3, 2, dtype=v.dtype, device=v.device)
                jac = (st.height / nv)[..., None] * (
                    eye - vh[..., :, None] * vh[..., None, :2])
            else:
                s = v
                jac = torch.eye(3, 2, dtype=v.dtype,
                                device=v.device).expand(v.shape[0], 3, 2)
            diff = s[:, None, :] - self.mic3
            d = torch.linalg.vector_norm(diff, dim=-1)
            g = torch.einsum("bmi,bij->bmj", diff / d[..., None], jac)
            r = d[:, j] - d[:, i] - target
            if it == st.iterations:
                return torch.stack([x, y], dim=-1), torch.sqrt(
                    (r * r).mean(dim=-1))
            jp = g[:, j] - g[:, i]
            a00 = (jp[..., 0] ** 2).sum(-1) + st.damping
            a11 = (jp[..., 1] ** 2).sum(-1) + st.damping
            a01 = (jp[..., 0] * jp[..., 1]).sum(-1)
            b0 = (jp[..., 0] * r).sum(-1)
            b1 = (jp[..., 1] * r).sum(-1)
            det = a00 * a11 - a01 * a01
            det = torch.where(det.abs() > 1e-20, det, torch.full_like(det,
                                                                      1e-20))
            x, y = (x - (a11 * b0 - a01 * b1) / det,
                    y - (a00 * b1 - a01 * b0) / det)
        raise AssertionError("unreachable")

    def localize(self, frames: torch.Tensor, block: int = 2048,
                 peak_clear: float = 0.0, grid_clear: float = 0.0) -> dict:
        """The frame-batch chain on frames [B, M, N], ``block`` frames at a
        time: 'tdoa_samples' [B, P], 'scores' [B, G], 'cell' [B],
        'xy_grid' and 'xy' [B, 2], 'clear' [B]: whether every pair's
        integer peak (the taper's centre, so the scores' and the grid
        cell's) lies ``peak_clear`` of the peak above the runner-up, and
        'grid_clear' [B]: whether the best cell's score does so by
        ``grid_clear`` (the solve starts from it)."""
        outs = []
        for b0 in range(0, frames.shape[0], block):
            corr = self.correlograms(frames[b0:b0 + block])
            shift = self.integer_peak(corr)
            tdoa = self.parabolic(corr)
            scores = self.scores(self.taper(corr, shift))
            cell, xy_grid = self.grid_peak(scores, refine=False)
            xy, _ = self.solve(tdoa / self.st.fs, xy_grid)
            outs.append(dict(tdoa_samples=tdoa, scores=scores, cell=cell,
                             xy_grid=xy_grid, xy=xy,
                             clear=peak_is_clear(corr, peak_clear).all(-1),
                             grid_clear=peak_is_clear(scores, grid_clear)))
        return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


def peak_is_clear(x: torch.Tensor, margin: float) -> torch.Tensor:
    """Whether the largest value along the last axis exceeds the runner-up
    by more than ``margin`` of it: where it does not, the first maximum is
    a near-tie that rounding in the program's precision may decide the
    other way.  Values equal to the largest (to 1e-12 of it: grid cells
    with the same lags score the same sum) are not runners-up; the first
    of them wins on both sides."""
    best = x.amax(dim=-1, keepdim=True)
    below = torch.where(x < best - 1e-12 * best.abs(), x,
                        torch.full_like(x, -math.inf))
    gap = best[..., 0] - below.amax(dim=-1)
    return gap > margin * best[..., 0].abs()


# ----------------------------------------------------------------------
# the streaming step
# ----------------------------------------------------------------------

def detector_stats(window: torch.Tensor, n: int) -> torch.Tensor:
    """Exact outgoing minus incoming variance statistic, summed over mics,
    at every position of integer windows [S, M, W] (int64 [S, W])."""
    half = n // 2
    x = window.to(torch.int64)

    def windowed(a):
        c = torch.cumsum(a, dim=-1)
        return c - torch.nn.functional.pad(c[..., :-half], (half, 0))

    s1, s2 = windowed(x), windowed(x * x)
    inc = half * s2 - s1 * s1
    out = torch.nn.functional.pad(inc, (half, 0))[..., :x.shape[-1]]
    return (out - inc).sum(dim=-2)


class StreamReference:
    """The streaming step of a sample of streams, from their raw chunks.

    ``step(chunks)`` takes integer-valued chunks [S', M, C], updates the
    state in place (so that the step can be captured as a CUDA graph) and
    returns (events [S'] bool, best_shift [S', P] long, xy [S', 2], ema
    [S', P, L], accepted so far [S'] long, trigger margin [S'], event clear
    [S'], grid clear [S']): the margin is how far from the threshold,
    relative to the size of the sums, the trigger statistic came at the
    decisive positions (the first that fired, and every earlier armed one),
    an accepted event is clear when its correlograms' integer peaks (the
    taper's centres) are (:func:`peak_is_clear`), and the grid is clear when
    the smoothed scores' best cell (the solve's start) is, so that a
    decision a float32 program could round the other way can be told from
    a clear one."""

    def __init__(self, st: Settings, n_streams: int, device,
                 precision=Precision(), peak_clear: float = 0.0,
                 grid_clear: float = 0.0):
        if st.chunk <= 0:
            raise ValueError("the configuration names no stream chunk size")
        self.st = st
        self.peak_clear = peak_clear
        self.grid_clear = grid_clear
        self.chain = Chain(st, device, precision)
        dev, dt = self.chain.device, precision.dtype
        m, p = st.mics.shape[0], st.pairs.shape[0]
        n = st.n

        def zeros(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.context = zeros(n_streams, m, n - 1)
        self.ema = zeros(n_streams, p, st.num_lags, dtype=dt)
        self.best = zeros(n_streams, p)
        self.last_event = zeros(n_streams, dtype=torch.float64)
        self.suppress = torch.full((n_streams,), n - 1, dtype=torch.long,
                                   device=dev)
        self.accepted = zeros(n_streams)
        self.count = zeros()

    def state(self) -> list:
        return [self.context, self.ema, self.best, self.last_event,
                self.suppress, self.accepted, self.count]

    def step(self, chunks: torch.Tensor):
        st, ch = self.st, self.chain
        n, c_len = st.n, chunks.shape[-1]
        window = torch.cat([self.context, chunks.to(torch.int64)], dim=-1)
        w_len = window.shape[-1]
        stat = detector_stats(window, n).to(torch.float64)
        scale = detector_scale(window, n)
        pos = torch.arange(w_len, device=window.device)
        armed = ((pos - (n - 1)) >= 0) & (
            (pos - (n - 1)) >= self.suppress[:, None])
        fire = armed & (stat > st.threshold)
        found = fire.any(dim=-1)
        t_rel = fire.to(torch.uint8).argmax(dim=-1)
        # the decisive positions: the first firing one and every armed one
        # before it (all armed ones when none fires)
        upto = torch.where(found, t_rel, torch.full_like(t_rel, w_len - 1))
        decisive = armed & (pos <= upto[:, None])
        rel = (stat - st.threshold).abs() / scale
        margin = torch.where(decisive, rel, torch.full_like(rel, math.inf))
        margin = margin.amin(dim=-1)

        start = (t_rel - (n - 1)).clamp(0, w_len - n)
        idx = start[:, None, None] + torch.arange(n, device=window.device)
        frames = window.gather(-1, idx.expand(*window.shape[:-1], n))
        corr = ch.correlograms(frames)
        shifts = ch.integer_peak(corr)
        corr_t = ch.taper(corr, shifts)
        accept = found & ((shifts * shifts).sum(dim=-1) > st.shift_gate)
        event_clear = ~accept | peak_is_clear(corr, self.peak_clear).all(-1)

        time_s = self.count.to(torch.float64) * (c_len / st.fs)
        trig = time_s + (t_rel - (n - 1) + 1).to(torch.float64) / st.fs
        dt_s = (trig - self.last_event).clamp_min(0.0)
        decay = (1.0 - torch.exp(-dt_s / st.ema_tau_s)).to(self.ema.dtype)
        ema_new = self.ema + (corr_t - self.ema) * decay[:, None, None]
        self.ema.copy_(torch.where(accept[:, None, None], ema_new, self.ema))
        self.last_event.copy_(torch.where(accept, trig, self.last_event))
        self.best.copy_(torch.where(accept[:, None],
                                    ch.integer_peak(self.ema), self.best))
        self.accepted.add_(accept.long())

        tdoa = ch.parabolic(self.ema)
        scores = ch.scores(self.ema)
        _, xy_grid = ch.grid_peak(scores, refine=True)
        xy, _ = ch.solve(tdoa / st.fs, xy_grid)

        hold = torch.where(found, t_rel - (n - 1) + n, self.suppress)
        self.suppress.copy_((hold - c_len).clamp_min(0))
        self.context.copy_(window[..., -(n - 1):])
        self.count.add_(1)
        return (accept, self.best, xy, self.ema, self.accepted, margin,
                event_clear, peak_is_clear(scores, self.grid_clear))


def detector_scale(window: torch.Tensor, n: int) -> torch.Tensor:
    """The size of the sums behind the trigger statistic [S, W]: half a
    frame times the summed squares of both half windows, over mics.  A
    float32 program's statistic is good to a few parts in 1e6 of it."""
    half = n // 2
    x = window.to(torch.int64)
    c = torch.cumsum(x * x, dim=-1)
    s2 = c - torch.nn.functional.pad(c[..., :-half], (half, 0))
    both = s2 + torch.nn.functional.pad(s2, (half, 0))[..., :x.shape[-1]]
    return (half * both).sum(dim=-2).to(torch.float64).clamp_min(1.0)
