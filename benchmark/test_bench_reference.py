"""The plain reference against the program's CPU path at a tiny size, and
the harness's own arithmetic (TF32 rounding, the trace reader)."""

import numpy as np
import pytest
import torch

from benchmark import reference, scenes, spec as spec_mod, trace
from benchmark.harness import mics_of, port_configs

SPEC = spec_mod.load_spec()
BATCH_CELLS = ["square4_bandcrop.batch16k", "ref3_firmware.batch16k"]


def _cell(name):
    w = spec_mod.workload(SPEC, name)
    return spec_mod.config_of(SPEC, w), dict(spec_mod.traffic_of(w))


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_lag_table_equals_the_programs(cell):
    from audio_triangulation_tpu_torch import Localizer

    config, _ = _cell(cell)
    pipeline, grid, solver = port_configs(config)
    loc = Localizer.create(mics_of(config), pipeline, grid, solver,
                           device="cpu",
                           init_grid_stride=config["init_grid_stride"])
    lut = reference.lag_table(reference.settings(config))
    assert np.array_equal(lut, loc.lut_flat.numpy())


@pytest.mark.parametrize("cell", BATCH_CELLS)
def test_batch_chain_matches_the_programs_cpu_path(cell):
    from audio_triangulation_tpu_torch import Localizer

    config, traffic = _cell(cell)
    traffic.update(frames_per_call=128, pool_batches=1)
    frames = scenes.frame_pool(config, traffic, 20240601, "cpu")[0]
    pipeline, grid, solver = port_configs(config)
    loc = Localizer.create(mics_of(config), pipeline, grid, solver,
                           device="cpu",
                           init_grid_stride=config["init_grid_stride"])
    out = loc(frames)
    ref = reference.Chain(reference.settings(config), "cpu").localize(frames)
    assert (out["tdoa_samples"].double() - ref["tdoa_samples"]).abs().max() \
        < 1e-3
    assert torch.linalg.vector_norm(out["xy"].double() - ref["xy"],
                                     dim=-1).max() < 1e-4
    agree = (torch.linalg.vector_norm(out["xy_grid"].double()
                                      - ref["xy_grid"], dim=-1) < 1e-6)
    assert agree.float().mean() > 0.95


def test_stream_step_matches_the_programs_cpu_path():
    from audio_triangulation_tpu_torch import StreamConfig, StreamingLocalizer

    config, traffic = _cell("ref3_firmware.stream4k")
    traffic.update(pool_chunks=12)
    n_streams = 16
    pool = scenes.stream_pool(config, traffic, 77, "cpu", n_streams)
    pipeline, grid, solver = port_configs(config)
    sl = StreamingLocalizer.create(
        mics_of(config), pipeline, grid, solver,
        StreamConfig(chunk_size=config["stream"]["chunk_size"]), device="cpu")
    states = sl.init_states(n_streams)
    ref = reference.StreamReference(reference.settings(config, full_grid=True),
                                    n_streams, "cpu")
    seen = 0
    for k in range(pool.shape[0]):
        states, out = sl.step_many(states, pool[k])
        ev, best, xy, _, accepted, _, _, _ = ref.step(
            pool[k].to(torch.int64))
        assert torch.equal(out["events"][:, 0], ev)
        assert torch.equal(out["best_shift"].long(), best)
        had = accepted > 0
        seen += int(ev.sum())
        if had.any():
            gap = torch.linalg.vector_norm(out["xy"].double() - xy, dim=-1)
            assert gap[had].max() < 1e-4
    assert seen >= n_streams // traffic["burst_every"]


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = reference.tf32_round(x)
    assert torch.all((r.view(torch.int32) & 0x1FFF) == 0)
    assert ((r - x).abs() <= x.abs() * 2.0 ** -11).all()
    assert not torch.equal(r, x)


def test_trace_reader():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.ITER,
         "ts": 0.0, "dur": 60.0},
        {"ph": "X", "cat": "user_annotation", "name": trace.ITER,
         "ts": 60.0, "dur": 40.0},
        {"ph": "X", "cat": "user_annotation", "name": "bench.readback",
         "ts": 40.0, "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "gcc_kernel<false>", "ts": 10.0,
         "dur": 30.0},
        {"ph": "X", "cat": "kernel", "name": "gemm", "ts": 20.0, "dur": 10.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 80.0,
         "dur": 10.0},
    ]
    t = trace.parse(ev, iterations=2)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s() == pytest.approx(40e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["bench.readback"] == pytest.approx(40e-6)
    assert gaps[trace.ITER] == pytest.approx(20e-6)
    assert t.top_ops()[0][0] == "gcc_kernel<false>"
