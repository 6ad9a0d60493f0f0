"""PyTorch port, the root tools on the CPU against the JAX package's:
``tools/bench_latency`` (keys and the real-time rule at a few chunks),
``tools/bench_robustness`` (a subset of scenes and methods against the
JAX tool's construction of the same scenes), ``tools/int8_dft_accuracy``
(its line against the JAX tool's, run in a subprocess since it sets the
JAX platform at import; the int32 products exact), ``tools/soak_transport``
(a few blocks through the native runtime) and ``tools/make_eval_dataset``
(against the committed ``tests/data/eval``).  No tool run touches a
committed record.  The ``gpu`` case holds row 8's int8 mode at the tool's
padded shape to numpy's int32 product on a card."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import glob
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch.ops.cuda import dft_matmul
from audio_triangulation_tpu_torch.tools import (bench_latency,
                                                 bench_robustness,
                                                 int8_dft_accuracy,
                                                 make_eval_dataset,
                                                 soak_transport)
from audio_triangulation_tpu_torch.utils import io as audio_io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL = os.path.join(ROOT, "tests", "data", "eval")
# the committed records a JAX tool writes over; the port's tools never do
COMMITTED = sorted(
    glob.glob(os.path.join(ROOT, "BENCH_*.json"))
    + [os.path.join(ROOT, "SOAK_TRANSPORT.json")]
    + glob.glob(os.path.join(EVAL, "*")))


def _digests() -> dict:
    return {p: hashlib.sha256(open(p, "rb").read()).hexdigest()
            for p in COMMITTED}


@pytest.fixture(scope="module")
def committed_before():
    return _digests()


# ---------------------------------------------------------------- latency
def test_bench_latency_keys(capsys, committed_before):
    res = bench_latency.main(["--device", "cpu", "--single-chunks", "8",
                              "--load-chunks", "6", "--load-streams", "4",
                              "--traced-steps", "2"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert [list(ln)[0] for ln in lines[:2]] == ["single_stream",
                                                 "load_4_streams"]
    for tag, n, t_chunks in (("single_stream", 1, 8),
                             ("load_4_streams", 4, 6)):
        point = res[tag]
        assert lines[0 if n == 1 else 1][tag] == point
        assert point["streams"] == n
        assert point["device_step_ms"] is point["span_step_ms"] is \
            point["scan_kernels_traced"] is None  # no card
        sync = point["synchronized"]
        assert set(sync) == {"p50_ms", "p90_ms", "p99_ms", "max_ms", "n",
                             "realtime_ok"}
        # the reference's skips (20, 10), at most half of the chunks
        assert sync["n"] == t_chunks - t_chunks // 2
        assert sync["p50_ms"] <= sync["p90_ms"] <= sync["p99_ms"] \
            <= sync["max_ms"]
        assert sync["realtime_ok"] == (sync["p99_ms"] < 10.24)
    assert res["chunk_ms"] == 10.24 and res["device"] == "cpu"
    assert lines[-1]["value"] == res["single_stream"]["synchronized"][
        "p50_ms"]
    assert "vs_baseline" not in lines[-1]


def test_realtime_rule_and_chunks():
    assert bench_latency.realtime_ok({"p99_ms": 10.23})
    assert not bench_latency.realtime_ok({"p99_ms": 10.24})
    chunks = list(bench_latency.gen_chunks(2, 17, seed=1))
    assert [c.shape for c in chunks] == [(2, 3, 512)] * 17
    loud = [t for t, c in enumerate(chunks) if c.max() > 140]
    assert loud == [4, 16]  # a burst in chunk 4 and every 12th after
    assert all(c.dtype == np.float32 and 0 <= c.min() and c.max() <= 255
               for c in chunks)


# ------------------------------------------------------------- robustness
ROBUST_SCENES = 16
ROBUST_METHODS = ("plain", "phat_band", "scot", "phase", "band_auto")


def _jax_rows(methods, n_scenes):
    """The JAX tool's rows for ``methods`` on its construction at
    ``n_scenes`` scenes; its Localizer takes the Pallas kernel (interpret
    mode) where the port's routes to its kernel, as the tool on its TPU."""
    import jax.numpy as jnp
    from audio_triangulation_tpu import Localizer, PipelineConfig, geometry
    from audio_triangulation_tpu.utils import room as room_mod
    from audio_triangulation_tpu.utils import synth
    from audio_triangulation_tpu_torch.core.config import (
        PipelineConfig as TConfig)
    from audio_triangulation_tpu_torch.models.localizer import kernel_route

    mics = geometry.square_array(0.3)
    h = 1.2
    rng = np.random.default_rng(11)
    planes = rng.uniform(-1.0, 1.0, (n_scenes, 2))
    sources = np.stack([np.array([x, y, h]) * (h / np.linalg.norm([x, y, h]))
                        for x, y in planes])
    noise = 0.8 / (10 ** (10 / 20.0)) / np.sqrt(2)
    conds = {"anechoic_10db": synth.synth_scene(
        sources, mics, noise_rms=noise, seed=1).astype(np.float32)}
    size = (6.0, 5.0, 3.0)
    r = room_mod.ShoeboxRoom(
        size=size, absorption=room_mod.absorption_for_rt60(size, 0.25),
        max_order=5)
    shift = np.array([3.0, 2.5, 0.8])
    mics3 = np.concatenate([mics, np.zeros((mics.shape[0], 1))], -1) + shift
    rev = np.asarray(room_mod.simulate_batch(
        jnp.asarray(sources + shift, jnp.float32), mics3, r))
    conds["reverb_rt60_0.25"] = (rev + rng.normal(0, 0.01, rev.shape).astype(
        np.float32)).astype(np.float32)
    rows, xys = [], []
    for method in methods:
        kw = bench_robustness.METHODS[method]
        fused = "on" if kernel_route(TConfig(**kw)) else "off"
        loc = Localizer.create(mics, PipelineConfig(
            **kw, fused_kernel=fused, fused_tile_b=8))
        for cond, frames in conds.items():
            xy = np.asarray(loc(jnp.asarray(frames))["xy"])
            rows.append(bench_robustness.row(cond, method, xy, planes))
            xys.append(xy)
    return rows, xys, conds


def test_bench_robustness_subset_matches_reference():
    """16 scenes, five methods (rows 1 and 5, the unfused SCOT route, the
    stats mode's phase slope and auto band): each row's hit rate equal to
    the JAX tool's, medians and p90 within 0.01 cm (measured 1e-4), each
    scene's xy within 2e-4 m (measured 5.3e-6; the reverberant frames are
    simulated by each package, within 3e-5 of scale)."""
    ref_rows, ref_xys, ref_conds = _jax_rows(ROBUST_METHODS, ROBUST_SCENES)
    planes, conds = bench_robustness.conditions(ROBUST_SCENES, "cpu")
    for cond, frames in conds.items():
        scale = np.abs(ref_conds[cond]).max()
        assert np.abs(frames.numpy() - ref_conds[cond]).max() <= 3e-5 * scale
    got = list(bench_robustness.points(ROBUST_SCENES, "cpu",
                                       ROBUST_METHODS))
    assert len(got) == len(ref_rows) == 2 * len(ROBUST_METHODS)
    worst = 0.0
    for (row, xy, route), ref, rxy in zip(got, ref_rows, ref_xys):
        assert (row["condition"], row["method"]) == (ref["condition"],
                                                     ref["method"])
        assert row["hit_rate_lt_10cm"] == ref["hit_rate_lt_10cm"], row
        np.testing.assert_allclose(xy, rxy, atol=2e-4)
        for k in ("xy_err_median_cm", "xy_err_p90_cm"):
            worst = max(worst, abs(row[k] - ref[k]))
        assert route == {"scot": "unfused GCC (torch) + gn_kernel",
                         "phase": "gcc_stats_kernel + gn_kernel",
                         "band_auto": "gcc_stats_kernel + gn_kernel"}.get(
            row["method"], "gcc_kernel + gn_kernel"), route
    assert worst <= 0.01, worst


# -------------------------------------------------------------- int8 DFT
def test_int8_dft_accuracy_matches_reference_tool(capsys):
    """The line's keys and integers equal to the JAX tool's, each error
    within 1.5e-5 samples (one unit of its fifth decimal: the two packages'
    float32 PHAT and irfft round apart; measured one unit on f32_median);
    both int8 products equal numpy's int32 products."""
    proc = subprocess.run(
        [sys.executable, os.path.join("tools", "int8_dft_accuracy.py")],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    line = int8_dft_accuracy.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip()) == line
    assert list(line) == list(ref)
    for k, v in ref.items():
        if isinstance(v, float):
            assert abs(line[k] - v) <= 1.5e-5, (k, line[k], v)
        else:
            assert line[k] == v, k
    _, prod = int8_dft_accuracy.measure("cpu")
    assert int8_dft_accuracy.products_exact(prod)
    assert prod["re"].shape == (64 * 8, 513)


def test_int8_product_pads_columns():
    rng = np.random.default_rng(3)
    x8 = rng.integers(-127, 128, (40, 64)).astype(np.int8)
    q = rng.integers(-127, 128, (64, 21)).astype(np.int8)
    got = int8_dft_accuracy.int8_product(x8, q, "cpu")
    assert got.dtype == np.int32 and got.shape == (40, 21)
    np.testing.assert_array_equal(got, x8.astype(np.int32)
                                  @ q.astype(np.int32))


@pytest.mark.gpu
def test_cuda_int8_dft_products_bit_equal():
    """Row 8's int8 mode at the tool's shape ([512, 1,024] @ [1,024, 528],
    F = 513 padded): each product bit-equal to numpy's int32 product, one
    launch each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    before = dft_matmul.launches["int8"]
    _, prod = int8_dft_accuracy.measure("cuda")
    assert dft_matmul.launches["int8"] == before + 2
    assert int8_dft_accuracy.products_exact(prod)


# ------------------------------------------------------------------ soak
def test_soak_transport_blocks():
    from audio_triangulation_tpu_torch.runtime import native_rt

    if not native_rt.native_available():
        pytest.skip("the native runtime needs g++")
    res = soak_transport.main(["--device", "cpu", "--minutes", "0.05"])
    assert res["ok"], res
    assert res["blocks"] >= 2 and res["events"] == res["blocks"]
    assert res["reconnects"] >= res["blocks"] - 1 and not res["stalled"]
    assert res["max_err_m"] < 0.3 and res["device"] == "cpu"


# ------------------------------------------------------------- dataset
def test_make_eval_dataset_matches_committed(tmp_path):
    """The manifest equal, every sample within one ADC count (measured:
    all equal)."""
    out = str(tmp_path / "eval")
    entries = make_eval_dataset.main(["--out", out, "--device", "cpu"])
    with open(os.path.join(EVAL, "manifest.json")) as f:
        assert entries == json.load(f)
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == entries
    for e in entries:
        got, fs = audio_io.read_wav(os.path.join(out, e["wav"]))
        ref, fs_ref = audio_io.read_wav(os.path.join(EVAL, e["wav"]))
        assert fs == fs_ref == make_eval_dataset.FS
        assert got.shape == ref.shape == (3, make_eval_dataset.STREAM_LEN)
        assert np.abs(got.astype(np.int64) - ref.astype(np.int64)).max() <= 1


def test_make_eval_dataset_needs_out():
    with pytest.raises(SystemExit):
        make_eval_dataset.main(["--device", "cpu"])


def test_no_tool_run_touched_committed_records(committed_before):
    """Runs last in this file (file order): every committed record the JAX
    tools write is byte-identical to its state before the tools above
    ran."""
    assert len(committed_before) >= 25
    assert _digests() == committed_before
