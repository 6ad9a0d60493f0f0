"""The port's far-field ``DoaEstimator`` against the benchmark's float64
DoA reference (``benchmark/reference_doa.py``) on the CPU, at a small size:
the lag table, and per frame the TDOAs, the argmax azimuth, the refined
azimuth and the bearing, on seeded plane-wave scenes and seeded random
frames of the benchmark's 8-mic circle and of a 4-mic circle.  The
control (the reference at the precision below, float32 with TF32 product
operands) fails the same tolerances.  No JAX here."""

import copy

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch.core import geometry
from audio_triangulation_tpu_torch.models.doa import DoaEstimator
from benchmark import reference, reference_doa, scenes, spec as spec_mod
from benchmark.kinds import doa as doa_kind

SPEC = spec_mod.load_spec()
CELL = spec_mod.workload(SPEC, "circ8_doa.batch16k")
CIRC8 = spec_mod.config_of(SPEC, CELL)
FRAMES = 32
# the cell's decision margins: where the float64 peaks are closer to a tie,
# or a bin weaker, than these, float32 may decide them either way, and the
# outputs resting on them are not compared
MARGINS = spec_mod.limits_of(CELL)[1]

# Tolerances.  The CPU port computes the GCC in plain float32 (TF32 off);
# under PHAT its correlograms sit about 1e-6 of scale from float64.
# - TDOA (samples): the parabola divides by the peak's curvature, so the
#   error grows tenfold and more; at most 3.1e-5 measured, 1e-3 allowed.
TDOA_TOL = 1e-3
# - argmax azimuth: exact where the best azimuth is clear.
# - refined azimuth (degrees): float32 holds an azimuth to 2e-5 degrees
#   near 360; at most 1.9e-5 measured, 1e-3 allowed.
AZIMUTH_TOL = 1e-3
# - bearing (norm of the difference of unit vectors): the least-squares
#   solve over 28 (6) pairs averages the TDOA errors; at most 4.4e-7
#   measured, 1e-5 allowed.
BEARING_TOL = 1e-5


def _circ4():
    """A 4-mic circle of radius 0.2 m at the cell's settings, its lag window
    widened to its aperture as ``DoaEstimator.create`` widens it."""
    config = copy.deepcopy(CIRC8)
    mics = geometry.circular_array(4, 0.2)
    config["mic_positions_m"] = mics.tolist()
    config["pipeline"]["max_shift_samples"] = geometry.max_lag_for_array(
        mics, doa_kind.pipeline_of(config))
    return config


CONFIGS = {"circ8": CIRC8, "circ4": _circ4()}


def _frames(config, scene, seed):
    if scene == "plane":
        traffic = dict(spec_mod.traffic_of(CELL), frames_per_call=FRAMES,
                       pool_batches=1)
        return doa_kind.plane_wave_pool(config, traffic, seed, "cpu")[0]
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((FRAMES, len(config["mic_positions_m"]), 1024),
                       generator=gen)


def _estimator(config):
    return DoaEstimator.create(doa_kind.mics_of(config),
                               doa_kind.pipeline_of(config),
                               config["n_azimuths"], device="cpu")


def _gaps(out: dict, ref: dict) -> dict:
    """The largest gap of each compared output where its decisions are
    clear, and the count of argmax azimuths that differ."""
    out = {k: v.double() for k, v in out.items()}
    pc, clear = ref["pair_clear"], ref["clear"]
    az_clear = clear & ref["azimuth_clear"]
    tdoa = (out["tdoa_samples"] - ref["tdoa_samples"]).abs()[pc]
    az = doa_kind.circular_gap_deg(out["azimuth_deg"], ref["azimuth_deg"])
    bearing = torch.linalg.vector_norm(out["bearing"] - ref["bearing"],
                                       dim=-1)
    return {"tdoa": float(tdoa.max()),
            "argmax": int((out["scores"].argmax(-1)
                           != ref["index"])[az_clear].sum()),
            "azimuth": float(az[az_clear].max()),
            "bearing": float(bearing[clear].max())}


def _within(g: dict) -> dict:
    return {"tdoa": g["tdoa"] <= TDOA_TOL, "argmax": g["argmax"] == 0,
            "azimuth": g["azimuth"] <= AZIMUTH_TOL,
            "bearing": g["bearing"] <= BEARING_TOL}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lag_table_equals_the_programs(name):
    config = CONFIGS[name]
    st = reference_doa.settings(config)
    lut = reference_doa.azimuth_lag_table(st, config["n_azimuths"])
    assert np.array_equal(lut, _estimator(config).lut_flat.numpy())


@pytest.mark.parametrize("scene", ["plane", "random"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_estimator_matches_the_reference(name, scene):
    config = CONFIGS[name]
    frames = _frames(config, scene, seed=230 + len(name))
    ref = reference_doa.DoaChain(config, "cpu").estimate(frames, **MARGINS)
    # most decisions are clear, so the comparison is not empty
    assert ref["pair_clear"].float().mean() > 0.95
    assert (ref["clear"] & ref["azimuth_clear"]).float().mean() > 0.6
    g = _gaps(_estimator(config)(frames), ref)
    assert all(_within(g).values()), g


def test_estimator_finds_the_plane_waves():
    """The scene's convention is the estimator's: the refined azimuth lies
    within a few degrees of the drawn one."""
    traffic = dict(spec_mod.traffic_of(CELL), frames_per_call=FRAMES,
                   pool_batches=1)
    frames = doa_kind.plane_wave_pool(CIRC8, traffic, 7, "cpu")[0]
    truth = 360.0 * torch.rand(FRAMES, dtype=torch.float64,
                               generator=scenes.generator(7, "cpu"))
    az = _estimator(CIRC8)(frames)["azimuth_deg"].double()
    gap = doa_kind.circular_gap_deg(az, truth)
    assert gap.median() < 1.0 and gap.max() < 3.0


def test_weak_bins_are_per_mic_and_relative_to_its_rms():
    """A pair is flagged when a bin of either of its mics lies below the
    floor of that mic's rms bin magnitude: every spectrum has bins below
    its rms, none below 0, and a mic made 1e4 times louder flags the same
    pairs as before (the floor scales with it)."""
    chain = reference_doa.DoaChain(CIRC8, "cpu")
    frames = _frames(CIRC8, "plane", seed=250)
    assert chain.weak_bins(frames, 1.0).all()
    assert not chain.weak_bins(frames, 0.0).any()
    floor = 3e-4
    base = chain.weak_bins(frames, floor)
    assert base.any() and not base.all()
    loud = frames.clone()
    loud[:, 2] *= 1e4
    assert torch.equal(chain.weak_bins(loud, floor), base)
    # a pair is flagged exactly when one of its mics is
    m_n = frames.shape[1]
    by_mic = torch.stack([chain.weak_bins(frames[:, [m] * m_n], floor)[:, 0]
                          for m in range(m_n)], dim=-1)
    pairs = chain.pairs
    assert torch.equal(base, by_mic[:, pairs[:, 0]] | by_mic[:, pairs[:, 1]])


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_control_fails_the_tolerances(name):
    """The reference at the precision below the configuration's, in the
    port's place, fails at least one tolerance."""
    config = CONFIGS[name]
    frames = _frames(config, "plane", seed=240)
    ref = reference_doa.DoaChain(config, "cpu").estimate(frames, **MARGINS)
    ctl = reference_doa.DoaChain(config, "cpu", reference.Precision.below())
    within = _within(_gaps(ctl.estimate(frames), ref))
    assert not all(within.values()), within
