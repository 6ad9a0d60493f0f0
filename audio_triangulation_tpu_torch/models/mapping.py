"""Acoustic reflector mapping: estimate wall positions from echoes.

Counterpart of ``audio_triangulation_tpu.models.mapping``.  Given events
from a few source positions, the mapper recovers the geometry of nearby
acoustic reflectors (walls):

1. localize the direct source (the port's ``Localizer``: its GCC kernel
   and, where its route takes it, the GN kernel);
2. measure each mic's echo delay (the lag of the reflected arrival behind
   the direct one) from its band-limited autocorrelation (``ops.echo``);
3. convert delays to per-mic ranges of the mirror image source
   (``range_k = |src - mic_k| + c * delay_k``) and multilaterate the image
   position (:func:`solve_image_from_ranges`);
4. the wall is the perpendicular bisector of (source, image);
5. wall hypotheses from all events and echoes are clustered (normal
   direction + distance) into the map with per-wall support counts.

Steps 1-3 run on the localizer's device; the image solves of every event
are one batched call (the reference makes one compiled call per
hypothesis; the rows are the same).  The association of step 3 and steps
4-5 are host numpy on a handful of numbers per event, copied from the
reference, in its order, so the wall list comes out the same.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import PipelineConfig
from ..ops import echo as echo_ops
from ..ops._device import pin_fp32_for


# ---------------------------------------------------------------- solves
def solve_image_from_ranges(
    mic_xy: torch.Tensor,  # [M, 2]
    ranges: torch.Tensor,  # [..., M] meters (mic -> image, 3-D)
    weights: torch.Tensor,  # [..., M] presence/confidence (0 = ignore mic)
    dz: float = 0.0,  # source-plane height above the mic plane
    *,
    n_angles: int = 72,
    iterations: int = 8,
):
    """Multilaterate a (mirror-image) source from per-mic ranges.

    Minimizes ``sum_k w_k (sqrt(|p - m_k|^2 + dz^2) - d_k)^2`` over the
    in-plane position p.  Init: bearing scan at the weighted mean range
    (ranges give the radius almost directly; the scan resolves the
    direction), then damped Gauss-Newton.  Returns (p [..., 2],
    rms [...] meters, weighted by ``weights``) on ``ranges``' device.
    """
    pin_fp32_for(ranges)
    dt = ranges.dtype
    dev = ranges.device
    mic_xy = mic_xy.to(device=dev, dtype=dt)
    w = weights.to(device=dev, dtype=dt)
    wsum = w.sum(dim=-1, keepdim=True).clamp_min(1e-12)
    rbar = (w * ranges).sum(dim=-1, keepdim=True) / wsum  # [..., 1]
    rho = (rbar * rbar - dz * dz).clamp_min(1e-6).sqrt()  # in-plane
    ang = torch.arange(n_angles, device=dev, dtype=dt) * (
        2.0 * np.pi / n_angles)
    cand = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)  # [A, 2]
    p0 = rho[..., None] * cand  # [..., A, 2]

    # cost of every candidate: [..., A]
    d = ((p0[..., None, :] - mic_xy) ** 2).sum(dim=-1) + dz * dz
    r = d.sqrt() - ranges[..., None, :]
    best = (w[..., None, :] * r * r).sum(dim=-1).argmin(dim=-1)  # [...]
    p = torch.take_along_dim(
        p0, best[..., None, None].expand(*best.shape, 1, 2), dim=-2)[..., 0, :]

    eye = 1e-6 * torch.eye(2, dtype=dt, device=dev)
    for _ in range(iterations):
        diff = p[..., None, :] - mic_xy  # [..., M, 2]
        d = ((diff * diff).sum(dim=-1) + dz * dz).sqrt()  # [..., M]
        r = d - ranges  # [..., M]
        jmat = diff / d.clamp_min(1e-9)[..., None]  # [..., M, 2]
        a = torch.einsum("...mi,...mj,...m->...ij", jmat, jmat, w) + eye
        g = torch.einsum("...mi,...m,...m->...i", jmat, w, r)
        det = a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
        inv = torch.stack([
            torch.stack([a[..., 1, 1], -a[..., 0, 1]], dim=-1),
            torch.stack([-a[..., 1, 0], a[..., 0, 0]], dim=-1),
        ], dim=-2) / det.clamp_min(1e-18)[..., None, None]
        p = p - torch.einsum("...ij,...j->...i", inv, g)

    diff = p[..., None, :] - mic_xy
    d = ((diff * diff).sum(dim=-1) + dz * dz).sqrt()
    rms = ((w * (d - ranges) ** 2).sum(dim=-1) / wsum[..., 0]).sqrt()
    return p, rms


def wall_from_image(src_xy: np.ndarray, img_xy: np.ndarray):
    """Perpendicular-bisector wall of a (source, mirror image) pair.

    Returns (normal [2] unit, distance float): the wall line is
    ``normal . x = distance``, with the normal pointing from the source
    toward the wall."""
    src = np.asarray(src_xy, np.float64)
    img = np.asarray(img_xy, np.float64)
    v = img - src
    nv = np.linalg.norm(v)
    n = v / max(nv, 1e-12)
    mid = 0.5 * (src + img)
    return n, float(n @ mid)


@dataclasses.dataclass
class WallEstimate:
    """One mapped reflector: the line ``normal . x = distance`` (array
    frame; normal points from the sources toward the wall)."""

    normal: np.ndarray  # [2] unit
    distance: float  # meters from the array origin along the normal
    support: int  # wall hypotheses merged into this estimate
    rms_m: float  # mean image-multilateration residual of its hypotheses


def cluster_walls(
    hypotheses,  # iterable of (normal [2], distance, rms)
    *,
    angle_tol_deg: float = 10.0,
    dist_tol_m: float = 0.3,
    min_support: int = 1,
):
    """Greedy merge of per-event wall hypotheses into wall estimates."""
    cos_tol = np.cos(np.deg2rad(angle_tol_deg))
    clusters = []  # list of [list of (n, d, rms)]
    for n, d, rms in hypotheses:
        placed = False
        for c in clusters:
            n0, d0 = c[0][0], c[0][1]
            if n @ n0 >= cos_tol and abs(d - d0) <= dist_tol_m:
                c.append((n, d, rms))
                placed = True
                break
        if not placed:
            clusters.append([(n, d, rms)])
    walls = []
    for c in clusters:
        if len(c) < min_support:
            continue
        ns = np.stack([h[0] for h in c])
        nbar = ns.mean(axis=0)
        nbar /= max(np.linalg.norm(nbar), 1e-12)
        walls.append(WallEstimate(
            normal=nbar,
            distance=float(np.mean([h[1] for h in c])),
            support=len(c),
            rms_m=float(np.mean([h[2] for h in c])),
        ))
    walls.sort(key=lambda w: -w.support)
    return walls


def _hough_associate(
    cand,  # list of (mic_index, range_3d_m, amp)
    mic_xy: np.ndarray,  # [M, 2]
    dz: float,
    *,
    n_angles: int,
    r_bin: float,
    min_mics: int,
):
    """Group per-mic image-range measurements into image hypotheses.

    Polar Hough accumulator over the image's in-plane (bearing, range):
    a measurement ``r`` from mic k predicts, at bearing theta, center
    range ``R ~ r_ip + u(theta) . m_k`` (first-order far-field).  Cells
    where >= ``min_mics`` distinct mics vote become hypotheses; each takes,
    per mic, the candidate nearest its prediction.  Returns a list of
    {mic: range_3d} dicts, strongest cells first.
    """
    if not cand:
        return []
    m = mic_xy.shape[0]
    ang = np.linspace(0.0, 2.0 * np.pi, n_angles, endpoint=False)
    u = np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # [A, 2]
    proj = u @ mic_xy.T  # [A, M]
    r3 = np.array([r for _, r, _ in cand])
    r_ip = np.sqrt(np.maximum(r3 * r3 - dz * dz, 1e-6))  # in-plane range
    mi_idx = np.array([mi for mi, _, _ in cand])
    rp = r_ip[:, None] + proj[:, mi_idx].T  # [C, A] predicted center range
    n_r = int(np.ceil(rp.max() / r_bin)) + 2
    presence = np.zeros((n_angles, n_r, m), bool)
    rb = np.clip(np.round(rp / r_bin).astype(int), 0, n_r - 1)  # [C, A]
    for ci in range(len(cand)):
        presence[np.arange(n_angles), rb[ci], mi_idx[ci]] = True
        # absorb binning edges
        presence[np.arange(n_angles),
                 np.clip(rb[ci] + 1, 0, n_r - 1), mi_idx[ci]] = True
    votes = presence.sum(-1)  # [A, n_r]

    groups = []
    votes_work = votes.copy()
    while True:
        a, rbn = np.unravel_index(np.argmax(votes_work), votes_work.shape)
        if votes_work[a, rbn] < min_mics:
            break
        center_r = rbn * r_bin
        # per-mic nearest candidate to this cell's prediction
        pred = center_r - proj[a]  # [M] expected in-plane range per mic
        per_mic = {}
        for mi in range(m):
            best, err = None, 1.5 * r_bin
            for ci in range(len(cand)):
                if mi_idx[ci] != mi:
                    continue
                e = abs(r_ip[ci] - pred[mi])
                if e < err:
                    best, err = ci, e
            if best is not None:
                per_mic[mi] = float(r3[best])
        if len(per_mic) >= min_mics:
            groups.append(per_mic)
        # suppress the cell neighborhood (wrapping in angle)
        da = max(2, n_angles // 24)
        for aa in range(a - da, a + da + 1):
            votes_work[aa % n_angles,
                       max(0, rbn - 3): rbn + 4] = 0
    return groups


# ---------------------------------------------------------------- mapper
@dataclasses.dataclass(frozen=True)
class ReflectorMapper:
    """End-to-end mapping around an existing port ``Localizer`` (whose
    grid / solver configs define the source-plane geometry: use a
    ``projection='plane'`` grid for in-plane scenes).

    >>> mapper = ReflectorMapper(loc)
    >>> result = mapper.map(frames)          # [E, M, N] event frames
    >>> result["walls"][0].distance
    """

    localizer: object
    n_echoes: int = 2
    q_min: int = 40  # min echo lag (samples; excludes the source mainlobe)
    q_max: int = 512  # max echo lag (samples; keep within the clean frame)
    min_separation: int = 16  # NMS window between echoes of one mic
    amp_min: float = 0.05  # min normalized autocorrelation peak amplitude
    # Hough association: per-mic range measurements vote in a polar
    # (bearing, range) accumulator; >= min_mics distinct mics agreeing in
    # one cell is an image hypothesis
    hough_angles: int = 72
    hough_r_bin_m: float = 0.1
    min_mics: int = 4  # mics required to multilaterate an image
    band_hz: tuple | None = None  # autocorrelation band (None -> cfg's)

    @property
    def _cfg(self) -> PipelineConfig:
        return self.localizer.pipeline

    def echo_delays(self, frames: torch.Tensor):
        """Per-mic echo candidates: (delays [..., M, K] samples,
        amps [..., M, K])."""
        prof = echo_ops.echo_profile(frames, self._cfg, band_hz=self.band_hz)
        return echo_ops.top_delays(
            prof, q_min=self.q_min, q_max=self.q_max,
            n_echoes=self.n_echoes, min_separation=self.min_separation)

    def map(self, frames: torch.Tensor) -> dict:
        """frames [E, M, N] (one detected event each) -> wall map.

        Returns {'walls': [WallEstimate...] (strongest support first),
        'source_xy': [E, 2], 'images': list of per-event image arrays}.
        """
        loc = self.localizer
        out = loc(frames)
        delays, amps = self.echo_delays(frames)
        src_xy = out["xy"].double().cpu().numpy()  # [E, 2]
        delays = delays.double().cpu().numpy()  # [E, M, K]
        amps = amps.double().cpu().numpy()
        mic_t = loc.params.mic_positions[:, :2]
        mic_xy = mic_t.double().cpu().numpy()
        cfg = self._cfg
        fs, c = float(cfg.sample_rate_hz), float(cfg.speed_of_sound_mps)
        dz = (0.0 if loc.grid.projection == "plane"
              and loc.grid.height_m == 0.0 else float(loc.grid.height_m))
        e, m, _ = delays.shape

        found = []  # (event, per-mic ranges) in the reference's order
        for ei in range(e):
            # direct ranges from the localized source
            d_dir = np.sqrt(
                np.sum((src_xy[ei] - mic_xy) ** 2, axis=-1) + dz * dz)
            # (mic, image-range) candidates above the amplitude floor,
            # associated across mics by Hough voting
            cand = [(mi, d_dir[mi] + c * delays[ei, mi, k] / fs,
                     amps[ei, mi, k])
                    for mi in range(m) for k in range(delays.shape[-1])
                    if amps[ei, mi, k] >= self.amp_min]
            found += [(ei, per_mic) for per_mic in _hough_associate(
                cand, mic_xy, dz, n_angles=self.hough_angles,
                r_bin=self.hough_r_bin_m, min_mics=self.min_mics)]
        img, rms = np.zeros((0, 2)), np.zeros(0)
        if found:
            w = np.zeros((len(found), m))
            rng = np.zeros((len(found), m))
            for row, (_, per_mic) in enumerate(found):
                for mi, rg in per_mic.items():
                    w[row, mi] = 1.0
                    rng[row, mi] = rg
            f32 = dict(dtype=torch.float32, device=mic_t.device)
            img, rms = solve_image_from_ranges(
                mic_t.float(), torch.as_tensor(rng, **f32),
                torch.as_tensor(w, **f32), dz)
            img, rms = img.double().cpu().numpy(), rms.double().cpu().numpy()

        hypotheses, images = [], [[] for _ in range(e)]
        for row, (ei, _) in enumerate(found):
            nvec, dist = wall_from_image(src_xy[ei], img[row])
            hypotheses.append((nvec, dist, float(rms[row])))
            images[ei].append(img[row])
        walls = cluster_walls(hypotheses)
        return {"walls": walls, "source_xy": src_xy,
                "images": [np.asarray(x).reshape(-1, 2) for x in images]}
