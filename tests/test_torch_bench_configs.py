"""PyTorch port, ``tools/bench_configs`` (the five ``BASELINE.json``
configurations, seven records) on the CPU at a cut batch, against the JAX
package's same calls on the same inputs: ``mxu_fft.xcorr_mxu`` +
``xcorr.subsample_peak`` (record 1), ``Localizer`` (records 2, 4, 5-5c)
and ``framing.frame_multichannel_lanes`` with its order (record 3).

Tolerances: tdoa 1e-3 samples (measured 0), xy 2e-4 m (the Localizer
tests'; measured at most 1.3e-4, the 64-mic auto band), xy of record 3's
noise frames only on frames whose decisions are 1e-3 of scale clear of a
near tie (``bench_accuracy.clear_of_ties``), at least 3 in 4 of them: best
shifts and grid cells equal, tdoa 1e-3 samples, xy 2e-4 m plus 5e-4 of its
size (a noise frame's solve lands metres out, where range is
ill-conditioned: measured 3.8e-4 of it)."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import GridConfig, Localizer, PipelineConfig
from audio_triangulation_tpu.core import geometry as jgeo
from audio_triangulation_tpu.ops import framing as jframing
from audio_triangulation_tpu.ops import mxu_fft as jmxu
from audio_triangulation_tpu.ops import xcorr as jxcorr
from audio_triangulation_tpu_torch.tools import bench_accuracy, bench_configs

NAMES = [name for name, _ in bench_configs.RECORDS]
CUT = {name: (4 if name.startswith("5") else 64) for name in NAMES}
BENCH = dict(phat=True, fft_pad_mode="circular", srp_dtype="bfloat16")


def _reference(name, frames: np.ndarray) -> np.ndarray:
    """The JAX package's output of record ``name`` on the same frames (the
    stream for record 3): tdoa [B, 1] or xy [B, 2]; for record 3 every
    output in lane order, and the order."""
    if name == NAMES[0]:
        cfg = PipelineConfig(phat=True, fft_pad_mode="circular")
        corr = jmxu.xcorr_mxu(jnp.asarray(frames),
                              jnp.asarray([[0, 1]], jnp.int32), cfg)
        return np.asarray(jxcorr.subsample_peak(corr, cfg.max_shift)[0])
    if name == NAMES[1]:
        loc = Localizer.create(jgeo.reference_array(),
                               PipelineConfig(fft_pad_mode="circular"))
    elif name == NAMES[2]:
        loc = Localizer.create(jgeo.square_array(0.3),
                               PipelineConfig(**BENCH), init_grid_stride=3)
        lanes, order = jframing.frame_multichannel_lanes(
            jnp.asarray(frames), 1024, bench_configs.HOP)
        out = {k: np.asarray(v) for k, v in loc(lanes).items()}
        return out, np.asarray(order)
    elif name == NAMES[3]:
        loc = Localizer.create(
            jgeo.circular_array(8, 0.15), PipelineConfig(**BENCH),
            GridConfig(half_cells_x=32, half_cells_y=32, cells_per_m=24.0),
            init_grid_stride=2)
    else:
        mics = jgeo.grid_array(8, 8, 0.05)
        band = {NAMES[4]: {}, NAMES[5]: dict(band_hz=(800.0, 6000.0),
                                            band_crop=True),
                NAMES[6]: dict(band_hz="auto")}[name]
        cfg = PipelineConfig(
            frame_size_bits=12, max_shift_samples=jgeo.max_lag_for_array(
                mics, PipelineConfig()), **BENCH, **band)
        loc = Localizer.create(
            mics, cfg, GridConfig(half_cells_x=31, half_cells_y=31,
                                  cells_per_m=16.0), init_grid_stride=2)
    return np.asarray(loc(jnp.asarray(frames))["xy"])


@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name):
    c = bench_configs.make_config(name, "cpu", CUT[name])
    got = c.call()
    ref = _reference(name, c.frames.numpy())
    if name == NAMES[0]:
        np.testing.assert_allclose(got["tdoa_samples"].numpy(), ref,
                                   atol=1e-3)
        assert abs(float(ref[0, 0]) - 7.3) < 0.2  # the planted delay
        return
    xy = got["xy"].numpy()
    if name == NAMES[2]:  # noise frames, in lane order: off near ties
        ref, order = ref
        lanes, order_t = bench_configs.framing.frame_multichannel_lanes(
            c.frames, 1024, bench_configs.HOP)
        np.testing.assert_array_equal(order_t, order)
        out = {k: v.numpy() for k, v in c.loc(lanes).items()}
        np.testing.assert_array_equal(xy, out["xy"][order])  # time order
        clear = bench_accuracy.clear_of_ties(
            torch.from_numpy(out["correlograms"]),
            torch.from_numpy(out["scores"])).numpy()
        assert clear.mean() >= 0.75, clear.mean()
        np.testing.assert_array_equal(out["best_shift"][clear],
                                      ref["best_shift"][clear])
        np.testing.assert_allclose(out["tdoa_samples"][clear],
                                   ref["tdoa_samples"][clear], atol=1e-3)
        np.testing.assert_array_equal(out["xy_grid"][clear],
                                      ref["xy_grid"][clear])
        # the solve of a noise frame lands metres out, where range is
        # ill-conditioned: 2e-4 m plus 5e-4 of the distance (measured
        # 3.8e-4 of it at 6 m)
        np.testing.assert_allclose(out["xy"][clear], ref["xy"][clear],
                                   atol=2e-4, rtol=5e-4)
        return
    assert xy.shape == ref.shape == (CUT[name], 2)
    np.testing.assert_allclose(xy, ref, atol=2e-4)
    assert np.abs(xy - [0.7, 0.4]).max() < 0.01  # the source's plane point


def test_records_names_keys_and_no_file(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    recs = bench_configs.main(["--device", "cpu", "--trials", "1",
                               "--max-frames", "4"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[:-1] == recs
    assert lines[-1] == {"summary": "ok", "configs": 7}
    assert [r["config"] for r in recs] == NAMES
    common = {"config", "frames_per_sec", "iqr", "trials", "batch", "route",
              "device", "power_limit_w"}
    for r in recs:
        assert common <= set(r), r
        assert "resident_batches" not in r and "vs_baseline" not in r
        assert r["frames_per_sec"] > 0 and r["batch"] == 4
        assert (r["device"], r["power_limit_w"]) == ("cpu", None)
    assert recs[1]["single_frame_latency_us"] > 0
    assert recs[2]["framing"] == "lanes" and recs[2]["init_grid_stride"] == 3
    assert recs[3]["init_grid_stride"] == 2 and "srp_form" in recs[3]
    for r in recs[4:]:
        assert r["pairs"] == 2016 and r["time_for_10k_frames_s"] > 0
    assert recs[5]["band_hz"] == [800.0, 6000.0]
    assert recs[6]["band_hz"] == "auto"
    # the CPU routes: no card, so each kernel's plain version
    assert recs[0]["route"].startswith("unfused matmul GCC")
    assert recs[1]["route"] == "gcc_kernel + gn_kernel"
    assert all(r["route"].startswith("gcc_large_kernel") for r in recs[4:])
    assert os.listdir(tmp_path) == []


def test_replicated_frames_are_c_order():
    """The tools' replicated frames are laid out as the reference's device
    arrays (C order): numpy's astype of the broadcast view kept the batch
    axis fastest, and each call paid a transposing copy (7-25% of the
    4-mic lines on an H100)."""
    from audio_triangulation_tpu_torch.tools import bench

    for frames in (bench.bench_frames(8, "cpu"),
                   bench_configs.make_config(NAMES[1], "cpu", 8).frames):
        assert frames.is_contiguous() and frames.shape[0] == 8
        assert torch.equal(frames, frames[:1].expand_as(frames))
