"""The benchmark's DoA cell (``benchmark/kinds/doa.py``) run whole on the
CPU at a small size, its look for a chip skipped: correct when sound, and
not correct with the timed path's outputs broken where they are produced
(every azimuth moved by one bin, every TDOA by 0.05 samples).  No JAX
here."""

import time

import pytest

from audio_triangulation_tpu_torch.models.doa import DoaEstimator
from benchmark import run as run_mod, spec as spec_mod

SPEC = spec_mod.load_spec()
CELL = "circ8_doa.batch16k"
SMALL = {"frames_per_call": 64, "pool_batches": 2, "trace_calls": 2}


def _result(seed=8675309123):
    run = run_mod.make_run(SPEC, CELL, seed, 1.0, False, "cpu",
                           time.perf_counter(), SMALL)
    out = run_mod.execute(run)
    return run_mod.result_line(run, out), out


def test_sound_doa_run_is_correct():
    line, out = _result()
    assert line["correct"], line["checks"]
    assert line["route"].startswith("gcc_kernel without peaks")
    assert out.end_to_end["frames_per_s"] > 0
    # the check takes 4 of the window's calls (all of them, if fewer)
    b = SMALL["frames_per_call"]
    assert out.checks.extra["frames"] == min(4, out.attempted // b) * b


def _moved(key, by):
    orig = DoaEstimator.forward

    def forward(self, frames):
        out = dict(orig(self, frames))
        step = 360.0 / self.n_azimuths if key == "azimuth_deg" else 1.0
        out[key] = out[key] + by * step
        return out
    return forward


@pytest.mark.parametrize("key,by", [("azimuth_deg", 1.0),
                                    ("tdoa_samples", 0.05)])
def test_broken_doa_run_is_not_correct(key, by, monkeypatch):
    monkeypatch.setattr(DoaEstimator, "forward", _moved(key, by))
    line, _ = _result()
    assert not line["correct"], line["checks"]
