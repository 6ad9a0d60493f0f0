"""Configuration dataclasses of the PyTorch port.

Field for field the same as ``audio_triangulation_tpu.core.config``
(``PipelineConfig``, ``GridConfig``, ``VolumeConfig``, ``SolverConfig``,
``StreamConfig``): the same names,
defaults, validation and derived properties, so a configuration saved by
either package loads in the other.  The reference module is numpy-only,
but importing it runs the JAX package's ``__init__``, so it is copied here.

Several fields steer TPU dispatch only (``fused_kernel``, ``fused_tile_b``,
``fused_sub_tiles``, ``dft_precision``).  The port accepts them and they
change nothing, as ``models.localizer`` states; likewise
``StreamConfig.batch_chunk_streams`` (``models.streaming``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Signal-chain configuration (windowing, correlation, smoothing)."""

    # --- sampling / physics ---
    sample_rate_hz: int = 50_000
    speed_of_sound_mps: float = 343.0

    # --- frame geometry: frame = 1 << frame_size_bits samples ---
    frame_size_bits: int = 10

    # --- correlation search; None -> sample_rate * 32 // 34300 ---
    max_shift_samples: Optional[int] = None

    # --- event detection ---
    power_threshold: Optional[int] = None
    shift_gate: int = 4
    trigger_mode: str = "absolute"
    trigger_ratio: float = 4.0

    # --- conditioning: 'shift8' (x256 gain) | 'full_range' | 'none' ---
    normalize_mode: str = "shift8"
    window_nw: float = 2.0  # DPSS time-halfbandwidth
    window_enabled: bool = True
    window_mode: str = "direct"  # 'direct' | 'strided'

    # --- correlation engine ---
    xcorr_mode: str = "mxu"  # 'mxu' | 'fft' | 'time'
    matmul_dtype: str = "float32"
    fused_kernel: str = "auto"
    fused_tile_b: int = 64
    fused_srp: str = "off"
    srp_big_matmul_budget_bytes: int = 1024 * 1024 * 1024
    fused_sub_tiles: int = 1
    srp_dtype: str = "float32"  # SRP scoring operands: float32 | bfloat16
    pair_chunk: Optional[int] = None
    phat: bool = False
    phat_eps: float = 1e-12
    weighting: str = "auto"  # auto | none | phat | scot | roth | ml
    coherence_bins: int = 16
    phat_beta: float = 1.0
    band_hz: Optional[tuple] = None  # (lo_hz, hi_hz) | 'auto' | None
    auto_band_rel: float = 0.5
    auto_band_floor: float = 0.15
    auto_band_min_bins: int = 8
    band_crop: bool = False
    dft_precision: str = "default"
    fft_pad_mode: str = "linear"  # 'linear' | 'circular'
    fft_size: Optional[int] = None

    # --- peak post-processing ---
    taper_enabled: bool = True
    taper_denom: float = 36.0  # exp(-(s - s_best)^2 / taper_denom)
    subsample_peak: bool = True
    subsample_method: str = "parabolic"  # parabolic | phase | hybrid
    hybrid_coherence_min: float = 0.5

    # --- temporal smoothing ---
    ema_tau_s: float = 0.5

    # --- numerics ---
    dtype: str = "float32"
    nan_guard: bool = False  # zero non-finite input samples

    # ------------------------------------------------------------------
    @property
    def frame_size(self) -> int:
        return 1 << self.frame_size_bits

    @property
    def max_shift(self) -> int:
        if self.max_shift_samples is not None:
            return self.max_shift_samples
        return self.sample_rate_hz * 32 // 34300

    @property
    def num_lags(self) -> int:
        return 2 * self.max_shift + 1

    @property
    def detect_threshold(self) -> int:
        if self.power_threshold is not None:
            return self.power_threshold
        return 2 << (2 * (self.frame_size_bits - 1))

    @property
    def band_auto(self) -> bool:
        """True when per-event data-driven band selection is configured."""
        return isinstance(self.band_hz, str)

    @property
    def effective_weighting(self) -> str:
        """The resolved GCC weighting: 'auto' maps to 'phat' iff ``phat``."""
        if self.weighting == "auto":
            return "phat" if self.phat else "none"
        return self.weighting

    @property
    def fft_length(self) -> int:
        if self.fft_size is not None:
            return self.fft_size
        if self.fft_pad_mode == "circular":
            return self.frame_size
        # linear correlation needs length >= N + max_shift
        return _next_pow2(self.frame_size + self.max_shift)

    def __post_init__(self):
        _check = {
            "normalize_mode": ("shift8", "full_range", "none"),
            "xcorr_mode": ("mxu", "fft", "time"),
            "matmul_dtype": ("float32", "bfloat16"),
            "fused_kernel": ("auto", "on", "off"),
            "fused_srp": ("on", "off"),
            "srp_dtype": ("float32", "bfloat16"),
            "fft_pad_mode": ("linear", "circular"),
            "weighting": ("auto", "none", "phat", "scot", "roth", "ml"),
            "subsample_method": ("parabolic", "phase", "hybrid"),
            "dft_precision": ("default", "highest"),
        }
        for field, allowed in _check.items():
            v = getattr(self, field)
            if v not in allowed:
                raise ValueError(f"{field}={v!r} not in {allowed}")
        if not 0.0 < self.phat_beta <= 1.0:
            raise ValueError(f"phat_beta={self.phat_beta} not in (0, 1]")
        if isinstance(self.band_hz, str):
            if self.band_hz != "auto":
                raise ValueError(
                    f"band_hz={self.band_hz!r}: the only string value is "
                    "'auto' (else pass a (lo_hz, hi_hz) tuple or None)")
            if self.band_crop:
                raise ValueError(
                    "band_crop needs a static (lo, hi) band; "
                    "band_hz='auto' selects bins per event")
            if not 0.0 < self.auto_band_rel <= 1.0:
                raise ValueError(
                    f"auto_band_rel={self.auto_band_rel} not in (0, 1]")
            if not 0.0 <= self.auto_band_floor < 1.0:
                raise ValueError(
                    f"auto_band_floor={self.auto_band_floor} not in [0, 1)")
        elif self.band_hz is not None:
            lo, hi = self.band_hz
            if not 0.0 <= lo < hi <= self.sample_rate_hz / 2:
                raise ValueError(
                    f"band_hz={self.band_hz} must satisfy "
                    f"0 <= lo < hi <= nyquist")
        if self.band_hz is not None and self.xcorr_mode == "time":
            raise ValueError(
                "band_hz is a spectral-domain control; the time-domain "
                "correlator (xcorr_mode='time') cannot honor it")
        if self.band_crop and self.band_hz is None:
            raise ValueError("band_crop requires band_hz")
        if not 0.0 <= self.hybrid_coherence_min <= 1.0:
            raise ValueError(
                f"hybrid_coherence_min={self.hybrid_coherence_min} "
                "not in [0, 1]")
        if self.dft_precision == "highest" and self.matmul_dtype != "float32":
            raise ValueError(
                "dft_precision='highest' requires matmul_dtype='float32'")
        # weighting='phat' turns whitening on, any other explicit weighting
        # turns the phat flag off ('auto' keeps it)
        if self.weighting == "phat" and not self.phat:
            object.__setattr__(self, "phat", True)
        elif self.weighting not in ("auto", "phat") and self.phat:
            object.__setattr__(self, "phat", False)

    def lag_axis(self):
        """Integer lags [-max_shift .. max_shift] as a Python range."""
        return range(-self.max_shift, self.max_shift + 1)


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """SRP localization grid: (2*half_cells+1)^2 cells on the radius-height
    sphere ('sphere') or the z = height plane ('plane')."""

    half_cells_x: int = 50
    half_cells_y: int = 50
    cells_per_m: float = 24.0
    height_m: float = 1.2
    projection: str = "sphere"
    # quadratic sub-cell refinement; 'auto' skips it when the solver runs
    refine_peak: str = "auto"  # 'auto' | 'on' | 'off'

    def __post_init__(self):
        if self.projection not in ("sphere", "plane"):
            raise ValueError(f"projection={self.projection!r}")
        if self.refine_peak not in ("auto", "on", "off"):
            raise ValueError(f"refine_peak={self.refine_peak!r}")

    @property
    def width(self) -> int:
        return 2 * self.half_cells_x + 1

    @property
    def height(self) -> int:
        return 2 * self.half_cells_y + 1

    @property
    def num_cells(self) -> int:
        return self.width * self.height


@dataclasses.dataclass(frozen=True)
class VolumeConfig:
    """Volumetric (3-D) SRP grid: (2*half_cells_x+1) x (2*half_cells_y+1)
    x z_cells points, x / y centred on the array as in ``GridConfig``, z
    spanning [z_min_m, z_max_m] inclusive."""

    half_cells_x: int = 20
    half_cells_y: int = 20
    cells_per_m: float = 10.0
    z_min_m: float = 0.2
    z_max_m: float = 2.2
    z_cells: int = 21

    def __post_init__(self):
        if self.z_cells < 1:
            raise ValueError("z_cells must be >= 1")
        if self.z_max_m < self.z_min_m:
            raise ValueError("z_max_m < z_min_m")

    @property
    def width(self) -> int:
        return 2 * self.half_cells_x + 1

    @property
    def height(self) -> int:
        return 2 * self.half_cells_y + 1

    @property
    def depth(self) -> int:
        return self.z_cells

    @property
    def num_cells(self) -> int:
        return self.width * self.height * self.depth

    @property
    def z_step_m(self) -> float:
        if self.z_cells == 1:
            return 0.0
        return (self.z_max_m - self.z_min_m) / (self.z_cells - 1)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Damped Gauss-Newton TDOA solver, with optional Huber/Cauchy IRLS."""

    iterations: int = 5
    damping: float = 1e-3
    constrain_to_sphere: bool = True
    robust: str = "none"  # 'none' | 'huber' | 'cauchy'
    robust_scale_m: float = 0.0  # 0 = adaptive 1.4826*MAD
    irls_iterations: int = 2


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming ingest / event-detection configuration.

    The streaming step extracts up to ``max_events_per_chunk`` triggers per
    chunk (masked, statically unrolled), each followed by a full-frame
    refill holdoff plus ``refractory_samples``.  With chunk_size <
    frame_size the default of 1 loses nothing: the refill outlasts the
    chunk."""

    chunk_size: int = 256  # samples consumed per stream step
    max_events_per_chunk: int = 1  # events extracted per step (masked)
    refractory_samples: int = 0  # extra post-trigger holdoff
    # > 1 resolves simultaneous sources per event into 'multi_*' outputs
    n_sources: int = 1
    multi_min_separation_m: float = 0.4  # top-K NMS suppression radius
    multi_assoc_window_samples: float = 3.0  # TDOA re-measurement gate
    # step_many sub-batch size of the reference (a limit of its compiler's
    # fast memory); accepted here, where one batched step runs at any size
    batch_chunk_streams: Optional[int] = 1024
    # free-(x, y, z) solve of each step's smoothed TDOAs
    solve_xyz: bool = False
    xyz_z_inits: tuple = (0.4, 1.2, 2.0)
    # per-event instantaneous velocity via the delay-Doppler CAF
    solve_velocity: bool = False
    velocity_v_max: float = 8.0
    velocity_n_scales: int = 33
    # fault-tolerant live solve: per-mic TDOA cycle-consistency scores
    # become per-pair weights on the SRP scoring and the GN solve.
    # health_ratio is the Cauchy scale in units of the median mic score,
    # health_floor_s bounds that scale from below (seconds)
    health_weighting: bool = False
    health_ratio: float = 3.0
    health_floor_s: float = 1e-5


# Reference mic geometry: AB, BC, CA in meters
REFERENCE_DISTANCES = (0.132, 0.15, 0.20)
REFERENCE_MIRROR = True
REFERENCE_ROTATE = False
