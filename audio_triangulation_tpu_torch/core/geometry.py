"""Microphone-array geometry (numpy, set-up time only).

The same functions as ``audio_triangulation_tpu.core.geometry``, copied so
the port needs no JAX: array builders, pair enumeration and distances, the
lag window of an array, SRP grid points, expected TDOAs, the integer lag LUT
(C ``roundf`` semantics) and the one-hot steering matrix.  Outputs are
byte-equal to the reference's.
"""

from __future__ import annotations

import numpy as np

from .config import GridConfig, PipelineConfig, VolumeConfig


def triangle_from_distances(
    d_ab: float,
    d_bc: float,
    d_ca: float,
    *,
    mirror: bool = True,
    rotate: bool = False,
    dtype=np.float32,
) -> np.ndarray:
    """3-mic positions [3, 2] from pairwise distances: law of cosines,
    optional Y-mirror, centroid centering, optional rotate-A-to-+X."""
    d_ab = dtype(d_ab)
    d_bc = dtype(d_bc)
    d_ca = dtype(d_ca)

    x_c = (d_ab * d_ab + d_ca * d_ca - d_bc * d_bc) / (dtype(2.0) * d_ab)
    y_c = np.sqrt(np.maximum(dtype(0.0), d_ca * d_ca - x_c * x_c))
    if mirror:
        y_c = -y_c

    pts = np.array([[0.0, 0.0], [d_ab, 0.0], [x_c, y_c]], dtype=dtype)
    pts = pts - pts.mean(axis=0, dtype=dtype)

    if rotate:
        theta = np.arctan2(pts[0, 1], pts[0, 0])
        c, s = np.cos(-theta, dtype=dtype), np.sin(-theta, dtype=dtype)
        rot = np.array([[c, -s], [s, c]], dtype=dtype)
        pts = pts @ rot.T

    return pts.astype(dtype)


def circular_array(n_mics: int, radius_m: float, *, phase_deg: float = 0.0,
                   dtype=np.float32) -> np.ndarray:
    """Uniform circular array [n, 2]."""
    ang = np.deg2rad(phase_deg) + 2 * np.pi * np.arange(n_mics) / n_mics
    return np.stack([radius_m * np.cos(ang), radius_m * np.sin(ang)],
                    axis=-1).astype(dtype)


def square_array(side_m: float, *, dtype=np.float32) -> np.ndarray:
    """4-mic square array [4, 2] centered at the origin."""
    h = side_m / 2.0
    return np.array([[-h, -h], [h, -h], [h, h], [-h, h]], dtype=dtype)


def grid_array(nx: int, ny: int, pitch_m: float, *,
               dtype=np.float32) -> np.ndarray:
    """nx x ny rectangular grid array [nx * ny, 2] (the 64-mic array)."""
    xs = (np.arange(nx) - (nx - 1) / 2.0) * pitch_m
    ys = (np.arange(ny) - (ny - 1) / 2.0) * pitch_m
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(dtype)


def tetrahedral_array(radius_m: float, *, dtype=np.float32) -> np.ndarray:
    """Regular-tetrahedron array [4, 3] with vertices ``radius_m`` from the
    centroid: the smallest non-coplanar array."""
    v = np.array([[1.0, 1.0, 1.0], [1.0, -1.0, -1.0],
                  [-1.0, 1.0, -1.0], [-1.0, -1.0, 1.0]])
    return (v / np.sqrt(3.0) * radius_m).astype(dtype)


def reference_array(dtype=np.float32) -> np.ndarray:
    """The 3-mic triangle of the original firmware."""
    from .config import REFERENCE_DISTANCES, REFERENCE_MIRROR, REFERENCE_ROTATE

    d_ab, d_bc, d_ca = REFERENCE_DISTANCES
    return triangle_from_distances(
        d_ab, d_bc, d_ca, mirror=REFERENCE_MIRROR, rotate=REFERENCE_ROTATE,
        dtype=dtype)


def mic_pairs(n_mics: int) -> np.ndarray:
    """All unordered pairs (i, j), i < j, as int32 [P, 2]."""
    idx = [(i, j) for i in range(n_mics) for j in range(i + 1, n_mics)]
    return np.asarray(idx, dtype=np.int32)


def pair_distances(positions: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Euclidean distance per pair [P]."""
    d = positions[pairs[:, 1]] - positions[pairs[:, 0]]
    return np.linalg.norm(d, axis=-1)


def max_lag_for_array(positions: np.ndarray, pipeline: PipelineConfig,
                      margin: int = 1) -> int:
    """Smallest lag window (samples) covering the array's aperture."""
    pairs = mic_pairs(positions.shape[0])
    aperture = float(pair_distances(positions, pairs).max())
    return int(np.ceil(aperture / pipeline.speed_of_sound_mps
                       * pipeline.sample_rate_hz)) + margin


def grid_points(grid: GridConfig, dtype=np.float32) -> np.ndarray:
    """Candidate source points [H, W, 3] in meters: x = (col - half_w) /
    cells_per_m, y = (half_h - row) / cells_per_m, z = height, scaled onto
    the radius-height sphere under ``projection='sphere'``."""
    xs = (np.arange(grid.width, dtype=dtype)
          - grid.half_cells_x) / dtype(grid.cells_per_m)
    ys = (grid.half_cells_y
          - np.arange(grid.height, dtype=dtype)) / dtype(grid.cells_per_m)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    gz = np.full_like(gx, dtype(grid.height_m))
    pts = np.stack([gx, gy, gz], axis=-1)

    if grid.projection == "sphere":
        r = np.sqrt((pts * pts).sum(-1, keepdims=True, dtype=dtype))
        pts = pts * (dtype(grid.height_m) / r)
    return pts.astype(dtype)


def expected_tdoas(
    points: np.ndarray,
    positions: np.ndarray,
    pairs: np.ndarray,
    speed_of_sound: float,
) -> np.ndarray:
    """Expected TDOA in seconds per (point, pair): (d_j - d_i) / c, for
    points [..., 3] and mics [M, 2 or 3] (z = 0 if 2-D).  Returns [..., P]."""
    pos3 = np.zeros((positions.shape[0], 3), dtype=points.dtype)
    pos3[:, : positions.shape[1]] = positions
    diff = points[..., None, :] - pos3
    dists = np.sqrt((diff * diff).sum(-1))
    dt = dists[..., pairs[:, 1]] - dists[..., pairs[:, 0]]
    return (dt / points.dtype.type(speed_of_sound)).astype(points.dtype)


def lag_lut(
    grid: GridConfig,
    positions: np.ndarray,
    pairs: np.ndarray,
    pipeline: PipelineConfig,
) -> np.ndarray:
    """Integer lag-index LUT [P, H, W]: expected TDOA in samples, rounded
    half away from zero (C ``roundf``), clamped to +-max_shift and offset by
    +max_shift so it indexes a [num_lags] correlogram."""
    pts = grid_points(grid)
    dt = expected_tdoas(pts, positions, pairs, pipeline.speed_of_sound_mps)
    v = dt * np.float32(pipeline.sample_rate_hz)
    shifts = np.trunc(v + np.copysign(np.float32(0.5), v)).astype(np.int32)
    k = pipeline.max_shift
    shifts = np.clip(shifts, -k, k)
    return np.transpose(shifts + k, (2, 0, 1)).astype(np.int32)


def volume_points(vol: VolumeConfig, dtype=np.float32) -> np.ndarray:
    """Candidate source points [D, H, W, 3] of the volumetric grid: x / y
    as in :func:`grid_points`, z over [z_min_m, z_max_m] in ``z_cells``
    steps (no sphere or plane projection)."""
    xs = (np.arange(vol.width, dtype=dtype)
          - vol.half_cells_x) / dtype(vol.cells_per_m)
    ys = (vol.half_cells_y
          - np.arange(vol.height, dtype=dtype)) / dtype(vol.cells_per_m)
    zs = (np.float64(vol.z_min_m)
          + np.arange(vol.depth, dtype=np.float64) * vol.z_step_m)
    gz, gy, gx = np.meshgrid(zs.astype(dtype), ys, xs, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).astype(dtype)


def volume_lag_lut(
    vol: VolumeConfig,
    positions: np.ndarray,
    pairs: np.ndarray,
    pipeline: PipelineConfig,
) -> np.ndarray:
    """Integer lag-index LUT [P, D, H, W] of the volumetric grid, with
    :func:`lag_lut`'s rounding, clamp and offset."""
    pts = volume_points(vol)
    dt = expected_tdoas(pts, positions, pairs, pipeline.speed_of_sound_mps)
    v = dt * np.float32(pipeline.sample_rate_hz)
    shifts = np.trunc(v + np.copysign(np.float32(0.5), v)).astype(np.int32)
    k = pipeline.max_shift
    shifts = np.clip(shifts, -k, k)
    return np.transpose(shifts + k, (3, 0, 1, 2)).astype(np.int32)


def lag_onehot(lut: np.ndarray, num_lags: int, dtype=np.float32) -> np.ndarray:
    """One-hot steering matrix [P * num_lags, G] for matmul-form SRP:
    scores[B, G] = corr[B, P*L] @ onehot[P*L, G]."""
    p, h, w = lut.shape
    g = h * w
    flat = lut.reshape(p, g)
    out = np.zeros((p, num_lags, g), dtype=dtype)
    pp = np.repeat(np.arange(p), g)
    ll = flat.ravel()
    gg = np.tile(np.arange(g), p)
    out[pp, ll, gg] = 1.0
    return out.reshape(p * num_lags, g)
