"""PyTorch port, its measurement tools at a CPU size: ``tools/bench``
(the three frame-batch lines), ``tools/bench_accuracy`` (a subset of the
sweep, scene by scene against the JAX package's ``Localizer`` on the same
frames; the whole sweep, ``slow``, against the JAX package's rows) and
``tools/soak_streaming`` (its JSON and gates).  None writes a file without
``--out``."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import importlib.util
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg
from audio_triangulation_tpu_torch.core import geometry
from audio_triangulation_tpu_torch.tools import (bench, bench_accuracy,
                                                 soak_streaming)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CARD_KEYS = {"device", "power_limit_w"}


def _printed(capsys) -> list:
    return [json.loads(ln) for ln in
            capsys.readouterr().out.strip().splitlines()]


def test_bench_lines(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    recs = bench.main(["--device", "cpu", "--batch", "8", "--trials", "1"])
    assert _printed(capsys) == recs
    assert [r["metric"] for r in recs] == [
        bench.METRIC + s for s in ("_fullband", "_handsfree_auto_hybrid", "")]
    for r in recs:
        assert set(r) == {"metric", "value", "unit", "iqr", "trials",
                          "batch"} | CARD_KEYS  # no vs_baseline
        assert r["unit"] == "frames/s" and r["value"] > 0
        assert r["iqr"][0] <= r["value"] <= r["iqr"][1]
        assert (r["device"], r["power_limit_w"]) == ("cpu", None)
        assert (r["trials"], r["batch"]) == (1, 8)
    assert os.listdir(tmp_path) == []


def test_frames_per_s_counts_frames_over_time():
    calls = []
    med, q1, q3 = bench.frames_per_s(lambda: calls.append(1), 100, 5, "cpu",
                                     warmup=2)
    assert len(calls) == 7 and q1 <= med <= q3 and med > 0


def test_bench_accuracy_subset_matches_reference():
    """32 scenes at SNR 40 and 10 dB, the five methods at stride 3 and the
    8-bit ADC row: each scene's xy within 2e-4 m and tdoa within 1e-3
    samples of the JAX package's Localizer on the same frames, off near
    ties (a best lag or grid cell less than 1e-3 of scale clear of the
    next), which are counted and must be few."""
    mics = geometry.square_array(0.3)
    n_points, ties = 0, 0
    for row, out, frames, loc, stride in bench_accuracy.points(
            32, (40, 10), (3,), "cpu"):
        kw = bench_accuracy.METHODS.get(row.get("method"), {})
        ref = JLocalizer.create(
            mics, jcfg.PipelineConfig(fft_pad_mode="circular", **kw),
            init_grid_stride=stride)
        r = {k: np.array(v) for k, v in ref(jnp.asarray(frames)).items()}
        clear = bench_accuracy.clear_of_ties(
            torch.from_numpy(r["correlograms"]),
            torch.from_numpy(r["scores"])).numpy()
        ties += int((~clear).sum())
        np.testing.assert_allclose(out["xy"].numpy()[clear], r["xy"][clear],
                                   atol=2e-4, err_msg=str(row))
        np.testing.assert_allclose(out["tdoa_samples"].numpy()[clear],
                                   r["tdoa_samples"][clear], atol=1e-3)
        assert row["scenes"] == 32
        n_points += 1
    assert n_points == 11 and ties <= 0.05 * 32 * 11, ties


def test_bench_accuracy_rows_and_out(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--device", "cpu", "--scenes", "8", "--snrs", "40", "--strides",
            "3"]
    rows = bench_accuracy.main(argv)
    assert _printed(capsys) == rows and os.listdir(tmp_path) == []
    with open(os.path.join(ROOT, "BENCH_ACCURACY.json")) as f:
        ref = json.load(f)
    assert [set(r) for r in rows] == [set(ref[0]) | CARD_KEYS] * 5 + [
        set(ref[-1]) | CARD_KEYS]
    assert [bench_accuracy.row_key(r) for r in rows] == [
        (40, m, 3) for m in bench_accuracy.METHODS] + [("8bit_adc", None,
                                                        None)]
    out = tmp_path / "rows.json"
    assert bench_accuracy.main(argv + ["--out", str(out)]) == rows
    assert json.loads(out.read_text()) == rows


def test_bench_accuracy_reference_rows_cover_the_sweep():
    """The committed JAX rows name every point of the full sweep in its
    order, and a row off by more than the tolerance is reported."""
    with open(bench_accuracy.REFERENCE_ROWS) as f:
        ref = json.load(f)
    keys = [(s, m, k) for s in bench_accuracy.SNRS
            for m in bench_accuracy.METHODS for k in bench_accuracy.STRIDES]
    assert [bench_accuracy.row_key(r) for r in ref] == keys + [
        ("8bit_adc", None, None)]
    assert bench_accuracy.off_reference(ref) == []
    moved = dict(ref[3], xy_err_median_cm=ref[3]["xy_err_median_cm"] + 0.06)
    assert [k for _, k, *_ in bench_accuracy.off_reference([moved])] == [
        "xy_err_median_cm"]


@pytest.mark.slow
def test_bench_accuracy_full_sweep_holds_reference_rows(tmp_path,
                                                        monkeypatch):
    """The committed reference rows are the JAX package's: the root
    ``bench_accuracy.py``, run in a temporary directory, writes exactly
    them; and the port's full sweep lies within the tolerance of them."""
    spec = importlib.util.spec_from_file_location(
        "root_bench_accuracy", os.path.join(ROOT, "bench_accuracy.py"))
    root_sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_sweep)
    monkeypatch.chdir(tmp_path)
    root_sweep.main()
    with open(tmp_path / "BENCH_ACCURACY.json") as f:
        jax_rows = json.load(f)
    with open(bench_accuracy.REFERENCE_ROWS) as f:
        assert json.load(f) == jax_rows
    rows = [row for row, *_ in bench_accuracy.points(device="cpu")]
    assert bench_accuracy.off_reference(rows) == []


def test_soak_progress_lines(capsys, monkeypatch):
    """Every ``PROGRESS_S`` seconds the soak reports on standard error, so
    a run cut before its end still says how far it got; its one result
    line stays alone on standard output."""
    monkeypatch.setattr(soak_streaming, "PROGRESS_S", 1e-9)
    res = soak_streaming.main(["--device", "cpu", "--streams", "2",
                               "--steps", "6"])
    out, err = capsys.readouterr()
    assert [json.loads(ln) for ln in out.strip().splitlines()] == [res]
    progress = [json.loads(ln)["progress"] for ln in err.strip().splitlines()]
    assert [p["steps"] for p in progress] == list(range(6))
    assert set(progress[0]) == {"steps", "wall_s", "events_detected",
                                "xy_err_max_m", "xy_err_max_post_fault_m",
                                "vm_rss_mb", "step_ms_last"}


def test_soak_tracked_fault(capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = soak_streaming.main(["--device", "cpu", "--streams", "4",
                               "--steps", "24", "--track", "--fault-at",
                               "0.5"])
    assert _printed(capsys) == [res] and os.listdir(tmp_path) == []
    for k in ("metric", "streams", "steps", "chunk", "tracked", "fault_at",
              "events_detected", "xy_err_max_m", "step_ms_p50",
              "step_ms_p99", "step_ms_p50_first_half",
              "step_ms_p50_second_half", "rss_growth_mb", "rss_curve_mb",
              "device_mem_growth_mb", "wall_s", "xy_err_max_post_fault_m",
              "track_ids_pre_fault", "track_ids_post_fault", "graphed",
              "gates", "ok", *CARD_KEYS):
        assert k in res, k
    assert (res["streams"], res["steps"], res["tracked"]) == (4, 24, True)
    assert res["graphed"] is False and res["device"] == "cpu"
    assert set(res["gates"]) == {"events", "xy_err", "rss", "step_time",
                                 "xy_err_post_fault", "track_ids"}
    # a burst in chunks 4 and 6 of every eight, on every stream
    assert res["events_detected"] == 6 * 4
    assert res["ok"] is True and all(res["gates"].values())
    assert res["track_ids_pre_fault"] and res["xy_err_max_post_fault_m"] < 0.15


def test_soak_plain_out(tmp_path):
    out = tmp_path / "soak.json"
    res = soak_streaming.main(["--device", "cpu", "--streams", "2",
                               "--steps", "9", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert res["ok"] is True and "track_ids_pre_fault" not in res
    assert set(res["gates"]) == {"events", "xy_err", "rss", "step_time"}
