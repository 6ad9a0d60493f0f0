"""The benchmark's DoA cell (``benchmark/kinds/doa.py``) run whole on the
CPU at a small size, its look for a chip skipped: correct when sound, and
not correct with the timed path's outputs broken where they are produced
(every azimuth moved by one bin, every TDOA by 0.05 samples).  No JAX
here."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import time

import pytest

from audio_triangulation_tpu_torch.models.doa import DoaEstimator
from benchmark import run as run_mod, spec as spec_mod
from benchmark.kinds import doa as doa_kind

SPEC = spec_mod.load_spec()
CELL = "circ8_doa.batch16k"
SMALL = {"frames_per_call": 64, "pool_batches": 2, "trace_calls": 2}
SEED = 8675309123


def _run(seconds):
    return run_mod.make_run(SPEC, CELL, SEED, seconds, False, "cpu",
                            time.perf_counter(), SMALL)


def _result(seconds=1.0):
    run = _run(seconds)
    out = run_mod.execute(run)
    return run_mod.result_line(run, out), out


def _window_s():
    """A window that holds several calls of the small run, whatever the
    machine's load: 8 times a timed warm call, at least 1 s.  The first
    reading lands once ``in_flight`` (2) calls have finished."""
    est, pool = doa_kind.build(_run(1.0))
    est(pool[0])
    t0 = time.perf_counter()
    est(pool[1 % len(pool)])
    return max(1.0, 8 * (time.perf_counter() - t0))


def test_sound_doa_run_is_correct():
    line, out = _result(_window_s())
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
