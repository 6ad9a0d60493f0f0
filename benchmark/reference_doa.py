"""The plain reference of the far-field DoA estimator, which decides
``correct`` in the DoA cells: written from the configuration's
definitions in plain torch, in float64, with no code of the program under
test.

The correlograms, the first-max integer peak, the parabolic sub-sample
peak and the Gaussian taper are ``reference.Chain``'s (DC removal, the
shift8 gain, the unit-peak DPSS window, the real DFT as a product, PHAT
per mic, the cross-power of each pair, the +-K lag synthesis).  Then, over
``n_azimuths`` bearings u(a) = (cos a, sin a), a = 2 pi i / A:

- the lag table: tau_p(a) = -(m_j - m_i) . u(a) / c in samples, rounded
  half away from zero, clipped to +-K;
- the scores: the sum over pairs of the tapered correlogram at each
  bearing's lag;
- the first-max azimuth and its circular 3-point parabolic refinement
  (offset clipped to +-0.5 of a bin);
- the least-squares far-field bearing: the unit vector along the u that
  minimises sum_p ((m_j - m_i) . u + c tau_p)^2, from the parabolic TDOAs.

``reference.Precision.below()`` is the control: the same chain in float32
with every product's operands rounded to TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

# frames a block of the float64 chain
BLOCK = 2048


def settings(config: dict) -> reference.Settings:
    """``reference.Settings`` of a DoA configuration's dict.  A DoA
    configuration has no grid, solver or stream: the chain's grid is one
    unused cell."""
    p = config["pipeline"]
    n = 1 << p["frame_size_bits"]
    k = p["max_shift_samples"]
    if p["fft_pad_mode"] == "circular":
        fft_length = n
    elif p["fft_pad_mode"] == "linear":
        fft_length = 1 << (n + k - 1).bit_length()
    else:
        raise ValueError(f"fft_pad_mode {p['fft_pad_mode']!r}")
    if p.get("fft_size") is not None:
        raise ValueError("the reference takes the FFT length from the padding")
    if (p["normalize_mode"] != "shift8" or p["subsample_method"] != "parabolic"
            or not p["taper_enabled"] or not p["subsample_peak"]
            or not p["window_enabled"] or p["window_mode"] != "direct"):
        raise ValueError("the reference writes the shift8 gain, the direct "
                         "DPSS window, the taper and the parabolic sub-sample "
                         "peak only")
    if p["phat"] and p["phat_beta"] != 1.0:
        raise ValueError("the reference writes PHAT at beta 1 only")
    if p["weighting"] not in ("auto", "phat" if p["phat"] else "none"):
        raise ValueError(f"weighting {p['weighting']!r}")
    if p["srp_dtype"] != "float32" or config.get("smp", False):
        raise ValueError("the reference scores in float32 without SMP only")
    band = p.get("band_hz")
    return reference.Settings(
        mics=np.asarray(config["mic_positions_m"], np.float32),
        fs=float(p["sample_rate_hz"]), c=float(p["speed_of_sound_mps"]),
        n=n, k=k, fft_length=fft_length, gain=256.0,
        window_nw=float(p["window_nw"]), phat=bool(p["phat"]),
        phat_eps=float(p["phat_eps"]),
        band=None if band is None else (float(band[0]), float(band[1])),
        taper_denom=float(p["taper_denom"]), srp_dtype=p["srp_dtype"],
        half_x=0, half_y=0, cells_per_m=1.0, height=1.0, sphere_grid=False,
        iterations=0, damping=0.0, sphere_solve=False,
        ema_tau_s=float(p["ema_tau_s"]), shift_gate=int(p["shift_gate"]),
        threshold=0, chunk=0)


def azimuth_lag_table(st: reference.Settings, n_azimuths: int) -> np.ndarray:
    """Lag indices [P, A] (0 .. 2K) of each pair at each bearing."""
    mics = st.mics.astype(np.float64)
    ang = 2.0 * np.pi * np.arange(n_azimuths) / n_azimuths
    u = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    pairs = st.pairs
    d = mics[pairs[:, 1]] - mics[pairs[:, 0]]
    v = -(d @ u.T) / st.c * st.fs
    shifts = np.trunc(v + np.copysign(0.5, v)).astype(np.int64)
    return np.clip(shifts, -st.k, st.k) + st.k


class DoaChain(reference.Chain):
    """The reference DoA chain of one configuration on one device."""

    def __init__(self, config: dict, device,
                 precision=reference.Precision()):
        # float32 products stay float32 (the control rounds its operands to
        # TF32 itself)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__(settings(config), device, precision)
        st = self.st
        self.n_azimuths = int(config["n_azimuths"])
        lut = azimuth_lag_table(st, self.n_azimuths)
        onehot = np.zeros((lut.shape[0], st.num_lags, lut.shape[1]))
        onehot[np.arange(lut.shape[0])[:, None], lut,
               np.arange(lut.shape[1])[None, :]] = 1.0
        self.onehot_az = torch.as_tensor(onehot.reshape(-1, lut.shape[1]),
                                         dtype=precision.dtype,
                                         device=self.device)
        mics = torch.as_tensor(st.mics.astype(np.float64), device=self.device)
        self.disp = (mics[self.pairs[:, 1]] - mics[self.pairs[:, 0]]).to(
            precision.dtype)

    def azimuth_scores(self, corr_t: torch.Tensor) -> torch.Tensor:
        """Scores [B, A] of tapered correlograms [B, P, L]."""
        flat = corr_t.reshape(corr_t.shape[0], -1)
        return self.pr.mm(self.pr.srp_operand(flat, self.st.srp_dtype),
                          self.onehot_az)

    def refine(self, scores: torch.Tensor) -> torch.Tensor:
        """The first-max azimuth refined by the circular 3-point parabola,
        in degrees [0, 360)."""
        a_n = self.n_azimuths
        a = scores.argmax(dim=-1)
        sm, s0, sp = (scores.gather(-1, ((a + o) % a_n)[:, None])[:, 0]
                      for o in (-1, 0, 1))
        den = sm - 2.0 * s0 + sp
        delta = torch.where(den.abs() > 1e-20, 0.5 * (sm - sp) / den,
                            torch.zeros_like(den)).clamp(-0.5, 0.5)
        return ((a.to(scores.dtype) + delta) * (360.0 / a_n)) % 360.0

    def bearing(self, tdoa_samples: torch.Tensor) -> torch.Tensor:
        """The least-squares far-field unit bearing [B, 2] of TDOAs [B, P]
        in samples."""
        d = self.disp
        rhs = -self.st.c * tdoa_samples / self.st.fs  # [B, P]
        u = torch.linalg.solve(d.T @ d, (rhs @ d).T).T
        return u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)

    def weak_bins(self, frames: torch.Tensor, floor: float) -> torch.Tensor:
        """[B, P]: whether a kept bin of either mic of the pair has a
        magnitude below ``floor`` of that mic's rms bin magnitude.  PHAT
        weighs every bin alike, so the phase of such a bin, which float32
        rounding of the DFT cannot resolve, moves the pair's correlogram by
        up to 2 / L (a few thousandths of its peak)."""
        x = frames.to(torch.float64)
        x = (x - x.mean(dim=-1, keepdim=True)) * self.st.gain * \
            self.window.to(torch.float64)
        mag2 = (torch.matmul(x, self.cos.to(torch.float64)) ** 2
                + torch.matmul(x, self.msin.to(torch.float64)) ** 2)
        weak = (mag2 < floor * floor * mag2.mean(dim=-1, keepdim=True)).any(
            dim=-1)  # [B, M]
        return weak[:, self.pairs[:, 0]] | weak[:, self.pairs[:, 1]]

    def estimate(self, frames: torch.Tensor, peak_clear: float = 0.0,
                 azimuth_clear: float = 0.0,
                 phase_floor: float = 0.0) -> dict:
        """The DoA chain on frames [B, M, N], ``BLOCK`` frames at a time:
        'tdoa_samples' [B, P], 'scores' [B, A], 'index' [B] (the first-max
        azimuth), 'azimuth_deg' [B], 'bearing' [B, 2], 'pair_clear'
        [B, P]: whether the pair's integer peak (the parabola's and the
        taper's centre) lies ``peak_clear`` of the peak above the
        runner-up and no bin of its mics lies below ``phase_floor``
        (:meth:`weak_bins`), 'clear' [B]: whether every pair is (so the
        scores and the bearing), and 'azimuth_clear' [B]: whether the
        best azimuth's score lies ``azimuth_clear`` above the runner-up."""
        outs = []
        for b0 in range(0, frames.shape[0], BLOCK):
            corr = self.correlograms(frames[b0:b0 + BLOCK])
            tdoa = self.parabolic(corr)
            scores = self.azimuth_scores(
                self.taper(corr, self.integer_peak(corr)))
            pair_clear = reference.peak_is_clear(corr, peak_clear) & \
                ~self.weak_bins(frames[b0:b0 + BLOCK], phase_floor)
            outs.append(dict(
                tdoa_samples=tdoa, scores=scores,
                index=scores.argmax(dim=-1), azimuth_deg=self.refine(scores),
                bearing=self.bearing(tdoa), pair_clear=pair_clear,
                clear=pair_clear.all(-1),
                azimuth_clear=reference.peak_is_clear(scores,
                                                      azimuth_clear)))
        return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
