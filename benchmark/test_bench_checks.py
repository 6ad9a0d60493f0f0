"""``correct`` can come out false.

The control (the reference at the precision below the configuration's, in
the program's place) fails a cell's limits: on the CPU at a size a test run
holds, and, on a card (``gpu``), at the cell's own size on three seeds.
And a whole run, its look for a chip skipped, on the CPU at a small size,
comes out correct when sound and not correct with the timed path broken
underneath: half of the batch left out (its answers taken from the other
half), one answer altered where it is produced, and for the streams a step
that returns its state unchanged and half of the streams left out.
"""

import time

import pytest
import torch

from benchmark import readings, run as run_mod, spec as spec_mod

SPEC = spec_mod.load_spec()
SMALL = {
    "batch": {"frames_per_call": 256, "pool_batches": 2, "check_calls": 2,
              "trace_calls": 2},
    "stream": {"streams": 32, "pool_chunks": 8, "check_streams": 32,
               "trace_steps": 2, "control_steps": 140},
}
BATCH_CELLS = ["square4_bandcrop.batch16k", "ref3_firmware.batch16k"]
STREAM_CELLS = ["ref3_firmware.stream4k"]


def small_run(cell, seed=424242, seconds=1.0, device="cpu", overrides=None):
    kind = spec_mod.traffic_of(spec_mod.workload(SPEC, cell))["kind"]
    ov = dict(SMALL[kind]) if device == "cpu" else {}
    ov.update(overrides or {})
    return run_mod.make_run(SPEC, cell, seed, seconds, False, device,
                            time.perf_counter(), ov)


def fails(run, numbers: dict) -> list:
    """The numbers over the cell's limits."""
    return [n for n, v in numbers.items()
            if n in run.limits and not v <= run.limits[n]]


@pytest.mark.parametrize("cell", BATCH_CELLS + ["ref3_firmware.stream4k"])
def test_control_fails_on_the_cpu(cell):
    run = small_run(cell)
    assert fails(run, readings.control_numbers(run))


@pytest.mark.gpu
@pytest.mark.parametrize("cell", BATCH_CELLS + STREAM_CELLS)
def test_control_fails_at_the_cells_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (4101, 4102, 4103):
        run = small_run(cell, seed=seed, seconds=SPEC["run_seconds"],
                        device="cuda")
        assert fails(run, readings.control_numbers(run)), seed


def correct(run) -> bool:
    out = run_mod.execute(run)
    return run_mod.result_line(run, out)["correct"]


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_sound_batch_run_is_correct(cell):
    assert correct(small_run(cell))


def _half_batch(orig):
    def forward(self, frames):
        out = orig(self, frames[: frames.shape[0] // 2])
        return {k: torch.cat([v, v]) for k, v in out.items()}
    return forward


def _altered_answer(orig):
    def forward(self, frames):
        out = dict(orig(self, frames))
        out["xy"] = out["xy"].clone()
        out["xy"][0] += 0.05
        return out
    return forward


@pytest.mark.parametrize("cell", BATCH_CELLS)
@pytest.mark.parametrize("fault", [_half_batch, _altered_answer])
def test_broken_batch_run_is_not_correct(cell, fault, monkeypatch):
    from audio_triangulation_tpu_torch import Localizer

    monkeypatch.setattr(Localizer, "forward", fault(Localizer.forward))
    assert not correct(small_run(cell))


def test_sound_stream_run_is_correct():
    assert correct(small_run("ref3_firmware.stream4k", seconds=2.0))


def _state_unchanged(self, chunks):
    return self.sl.step_many(self.states, chunks)[1]


def _half_streams(self, chunks):
    """The second half of the streams left out: their states stay put."""
    import dataclasses

    new, out = self.sl.step_many(self.states, chunks)
    h = chunks.shape[0] // 2
    self.states = type(new)(**{
        f.name: torch.cat([getattr(new, f.name)[:h],
                           getattr(self.states, f.name)[h:]])
        for f in dataclasses.fields(new)})
    return out


def _altered_stream_answer(self, chunks):
    self.states, out = self.sl.step_many(self.states, chunks)
    out = dict(out)
    out["xy"] = out["xy"].clone()
    out["xy"][0] += 0.05
    return out


@pytest.mark.parametrize("fault", [_state_unchanged, _half_streams,
                                   _altered_stream_answer])
def test_broken_stream_run_is_not_correct(fault, monkeypatch):
    from benchmark.kinds import stream

    monkeypatch.setattr(stream.EagerStep, "__call__", fault)
    assert not correct(small_run("ref3_firmware.stream4k", seconds=2.0))


def test_open_loop_stream_run_is_correct():
    """The open loop of the parked live cell (``traffic/live.json``, not in
    ``BENCHMARK.json``): every chunk due in the window is stepped once, on
    its schedule."""
    cell = {"name": "ref3_firmware.live", "config": "ref3_firmware",
            "traffic": "live", "chips": 1}
    run = run_mod.make_run(SPEC, cell["name"], 515151, 0.5, False, "cpu",
                           time.perf_counter(), SMALL["stream"], cell)
    out = run_mod.execute(run)
    assert run_mod.result_line(run, out)["correct"]
    lat = out.readings.host["latency_ms"]
    assert len(lat) == int(0.5 / (512 / 50000))
    assert out.end_to_end["chunk_latency_p95_ms"] > 0
