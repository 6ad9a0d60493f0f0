"""PyTorch port, the two tool kernels and the tools.

``dft_matmul_reference`` (the plain version of ``csrc/dft_matmul.cu``)
against the kernel body of the JAX package's ``tools/int8_microbench.py``,
loaded by path and run through ``pl.pallas_call(..., interpret=True)``:
int8 bit-equal, f32 and bf16 within 1e-5 of the output scale (a 128-term
fp32 sum in another order); ``dft_matmul_split_reference``, the f32
kernel's split-fp32 arithmetic, against the same and against float64.  The pipelined GCC wrapper's CPU path against
``gcc_reference`` (equal) and the Pallas GCC kernel in interpret mode
(the reference probe's own tolerances: correlograms 2e-5, tdoa 1e-4).  The
port's three tools at a tiny size on the CPU.  ``gpu`` cases hold the two
kernels on a card and skip without one."""

import functools
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from audio_triangulation_tpu.core import config as jcfg
from audio_triangulation_tpu.ops.pallas import gcc_kernel as jgcc
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops.cuda import dft_matmul, gcc_kernel
from audio_triangulation_tpu_torch.tools import (bench_streaming,
                                                 emit_pipeline_probe,
                                                 int8_microbench)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROWS, N, F, GRID = 8, 128, 128, 2
JAX_TYPES = {"f32": (jnp.float32, jnp.float32), "bf16": (jnp.bfloat16,
                                                         jnp.float32),
             "int8": (jnp.int8, jnp.int32)}


@pytest.fixture(scope="module")
def reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_int8_microbench", ROOT / "tools" / "int8_microbench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_call(mod, name, x, w1, w2, s):
    in_dt, acc = JAX_TYPES[name]
    call = pl.pallas_call(
        functools.partial(mod._kernel, acc_dtype=acc),
        grid=(GRID,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)),
                  pl.BlockSpec((ROWS, N), lambda i: (i, 0)),
                  pl.BlockSpec((N, F), lambda i: (0, 0)),
                  pl.BlockSpec((N, F), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((ROWS, F), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((GRID * ROWS, F), acc),
        interpret=True)
    return np.asarray(call(jnp.asarray(s), jnp.asarray(x, in_dt),
                           jnp.asarray(w1, in_dt), jnp.asarray(w2, in_dt)))


def _inputs(name, seed=0):
    """numpy x, w1, w2 and the scalars to try.  int8 spans the whole range,
    so x + s wraps for the larger scalars."""
    rng = np.random.default_rng(seed)
    if name == "int8":
        x = rng.integers(-128, 128, (GRID * ROWS, N)).astype(np.int8)
        w1 = rng.integers(-128, 128, (N, F)).astype(np.int8)
        w2 = rng.integers(-128, 128, (N, F)).astype(np.int8)
        return x, w1, w2, [np.array([v], np.int32) for v in (0, 2, 100, -77)]
    x = rng.standard_normal((GRID * ROWS, N)).astype(np.float32)
    w1 = rng.standard_normal((N, F)).astype(np.float32)
    w2 = rng.standard_normal((N, F)).astype(np.float32)
    return x, w1, w2, [np.array([v], np.float32) for v in (0.0, 2.0, 1.3)]


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_dft_matmul_reference_matches_reference_kernel_body(reference_tool,
                                                            name):
    x, w1, w2, scalars = _inputs(name)
    in_dt, acc_dt, _ = dft_matmul.TYPE_SETS[name]
    tx, tw1, tw2 = (torch.from_numpy(a).to(in_dt) for a in (x, w1, w2))
    for s in scalars:
        ref = _reference_call(reference_tool, name, x, w1, w2, s)
        got = dft_matmul.dft_matmul(tx, tw1, tw2, torch.from_numpy(s))
        assert got.dtype == acc_dt and got.shape == ref.shape
        if name == "int8":
            np.testing.assert_array_equal(got.numpy(), ref)
        else:
            scale = np.abs(ref).max()
            np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                       atol=1e-5)


@pytest.mark.parametrize("sv", [0.0, 1.0, 2.0])
def test_dft_matmul_split_reference_against_float64(sv):
    """The f32 kernel's arithmetic in plain PyTorch (TF32 parts, lo lo
    dropped, f32 sums flushed every 16 steps) stays within the kernel's
    tolerance, 1e-5 of the output scale of a float64 evaluation, at the
    tool's row tile (256 x 1,024 x 512)."""
    x, w1, _ = int8_microbench.make_inputs("f32", 256, 1024, 512, 1, "cpu")
    w2 = w1.flip(0).contiguous()
    s = torch.full((1,), sv)
    got = dft_matmul.dft_matmul_split_reference(x, w1, w2, s)
    xs = (x + s).double()
    r64 = xs @ w1.double() + xs @ w2.double()
    assert got.dtype == torch.float32 and got.shape == (256, 512)
    assert float((got.double() - r64).abs().max()) <= 1e-5 * float(
        r64.abs().max())


def test_dft_matmul_split_reference_matches_reference_kernel_body(
        reference_tool):
    x, w1, w2, scalars = _inputs("f32")
    tx, tw1, tw2 = (torch.from_numpy(a) for a in (x, w1, w2))
    for s in scalars:
        ref = _reference_call(reference_tool, "f32", x, w1, w2, s)
        got = dft_matmul.dft_matmul_split_reference(tx, tw1, tw2,
                                                    torch.from_numpy(s))
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy() / scale, ref / scale,
                                   atol=1e-5)


def test_int8_add_wraps_as_twos_complement():
    x = torch.tensor([[127, -128, 5, 0] * 16], dtype=torch.int8)
    w = torch.eye(64, dtype=torch.int8)[:, :16].contiguous()
    out = dft_matmul.dft_matmul_reference(
        x, w, torch.zeros_like(w), torch.tensor([3], dtype=torch.int32))
    assert out[0, :4].tolist() == [-126, -125, 8, 3]


def test_dft_matmul_refuses_what_it_does_not_take():
    x = torch.zeros((8, 64))
    w = torch.zeros((64, 16))
    s = torch.zeros(1)
    with pytest.raises(ValueError, match="one dtype"):
        dft_matmul.dft_matmul(x, w.to(torch.bfloat16), w, s)
    with pytest.raises(ValueError, match="s must be one"):
        dft_matmul.dft_matmul(x, w, w, s.to(torch.int32))
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        dft_matmul.dft_matmul(x.double(), w.double(), w.double(), s)
    with pytest.raises(ValueError, match="CUDA"):
        dft_matmul.launch(x, w, w, s)  # never a silent CPU fallback


def test_carry_has_the_divisors_sign():
    """The chained scalar is jnp's ``%``: non-negative for divisor 3."""
    out = torch.tensor([[-7.5, 1.0], [2.0, 2.0]])
    ref = np.asarray(jnp.asarray(out.numpy())[:1, 0] % jnp.asarray(
        3, jnp.float32))
    np.testing.assert_allclose(int8_microbench.carry(out).numpy(), ref)
    outi = torch.tensor([[-7, 1]], dtype=torch.int32)
    assert int8_microbench.carry(outi).tolist() == [2]
    assert int8_microbench.carry(outi).dtype == torch.int32


def test_chained_loop_matches_reference_loop(reference_tool):
    """Three chained calls (each scalar from the last output) end on the
    scalar the JAX loop ends on, in int8 where every step is exact."""
    x, w1, _, _ = _inputs("int8", seed=3)
    x = (x // 2).astype(np.int8)  # the tool's range: |x| <= 64
    s = np.zeros((1,), np.int32)
    for _ in range(3):
        out = _reference_call(reference_tool, "int8", x, w1, w1, s)
        s = (out[:1, 0] % 3).astype(np.int32)
    got = int8_microbench.chained(torch.from_numpy(x), torch.from_numpy(w1),
                                  torch.int32, 3)
    assert got.tolist() == s.tolist()


def test_int8_microbench_tool_runs_on_cpu(capsys):
    int8_microbench.main(["--device", "cpu", "--rows", "8", "--n", "128",
                          "--f", "128", "--grid", "2", "--iters", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [ln.split(":")[0].strip() for ln in lines] == ["f32", "bf16",
                                                          "int8"]
    assert all("ms/iter" in ln for ln in lines)


def test_int8_microbench_tool_does_not_swallow_failures(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(dft_matmul, "dft_matmul", boom)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        int8_microbench.main(["--device", "cpu", "--rows", "8", "--n", "64",
                              "--f", "16", "--grid", "1", "--iters", "1"])


def test_pipelined_cpu_path_matches_plain_and_pallas_interpret():
    frames, window, pairs, cfg = emit_pipeline_probe.scene(8, "cpu")
    frames = frames + torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.01, frames.shape).astype(np.float32))
    got = gcc_kernel.fused_gcc_pipelined(frames, window, pairs, cfg)
    base = gcc_kernel.fused_gcc(frames, window, pairs, cfg, with_peaks=True)
    assert all(torch.equal(a, b) for a, b in zip(got, base))
    jc = jcfg.PipelineConfig(phat=True, fft_pad_mode="circular",
                             band_hz=(800.0, 6000.0), band_crop=True)
    ref = jgcc.fused_gcc_peaks(jnp.asarray(frames.numpy()),
                               jnp.asarray(window.numpy()), pairs.numpy(),
                               jc, tile_b=8, interpret=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               rtol=1e-4, atol=1e-4)


def test_pipelined_refuses_the_stats_mode():
    frames, window, pairs, _ = emit_pipeline_probe.scene(2, "cpu")
    with pytest.raises(ValueError, match="base mode only"):
        gcc_kernel.fused_gcc_pipelined(
            frames, window, pairs, tcfg.PipelineConfig(band_hz="auto"))
    with pytest.raises(ValueError, match="f32"):
        gcc_kernel.fused_gcc_pipelined(frames.double(), window, pairs,
                                       tcfg.PipelineConfig())


def test_emit_pipeline_probe_tool_runs_on_cpu(capsys):
    emit_pipeline_probe.main(["--device", "cpu", "--batch", "4", "--iters",
                              "2"])
    out = capsys.readouterr().out
    assert "outputs equal" in out
    assert out.count("Mframes/s") == 2


def test_bench_streaming_tool_runs_on_cpu(capsys):
    recs = bench_streaming.main(["--device", "cpu", "--trials", "2",
                                 "--steps", "1", "--streams", "2"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == recs
    assert [(r["mode"], r["streams"]) for r in recs] == [
        ("default", 1), ("default", 2), ("band_crop_phat", 2),
        ("band_auto_phat", 2)]
    assert all(r["device"] == "cpu" and r["step_ms"] > 0
               and r.get("graphed", False) is False for r in recs)
    # a CUDA graph exists only on the card: asked for on the CPU, it raises
    with pytest.raises(ValueError, match="CUDA"):
        bench_streaming.main(["--device", "cpu", "--trials", "1", "--steps",
                              "1", "--streams", "2", "--graph"])


def test_bench_streaming_tracked_modes_run_on_cpu(capsys):
    """The tracked modes' lines at a CPU size: one chunk a step and four a
    call (per chunk step, with the four chunks' reporting latency)."""
    recs = bench_streaming.main(["--device", "cpu", "--trials", "2",
                                 "--steps", "2", "--streams", "4",
                                 "--modes", "tracked_fused",
                                 "tracked_fused_scan4"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == recs
    assert [(r["mode"], r["streams"], r["graphed"]) for r in recs] == [
        ("tracked_fused", 4, False), ("tracked_fused_scan4", 4, False)]
    for r in recs:
        assert r["device"] == "cpu" and r["step_ms"] > 0
        assert r["step_ms_iqr"][0] <= r["step_ms"] <= r["step_ms_iqr"][1]
        assert r["realtime_capacity_streams"] == int(
            10.24 / r["step_ms"] * 4)
    assert "reporting_latency_ms" not in recs[0]
    assert recs[1]["reporting_latency_ms"] == pytest.approx(40.96)


# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
# ragged and whole tiles, and the tool's own row count (several waves of
# blocks)
@pytest.mark.parametrize("rows", [1000, 257, 1024, 65536])
@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_cuda_dft_matmul_matches_plain_version(cuda_device, name, rows):
    x, w, acc_dt = int8_microbench.make_inputs(
        name, 256, 1024, 512, max(4, rows // 256), cuda_device)
    w2 = w.flip(0).contiguous()
    s = torch.full((1,), 2, dtype=acc_dt, device=cuda_device)
    before = dft_matmul.launches[name]
    got = dft_matmul.dft_matmul(x[:rows], w, w2, s)
    assert dft_matmul.launches[name] == before + 1
    ref = dft_matmul.dft_matmul_reference(x[:rows], w, w2, s)
    if name == "int8":
        assert torch.equal(got, ref)
    else:
        xs = (x[:rows] + s.to(x.dtype)).double()
        r64 = xs @ w.double() + xs @ w2.double()
        assert float((got.double() - r64).abs().max()
                     / r64.abs().max()) < 1e-5


@pytest.mark.gpu
# ragged row counts: inside one tile, across tiles, a tile's edge
@pytest.mark.parametrize("rows", [3, 257, 4005, 4096])
def test_cuda_dft_matmul_f32_matches_split_reference(cuda_device, rows):
    """The f32 kernel within 1e-5 of scale of float64 and of its arithmetic
    in plain PyTorch, and its split K-major copies equal to theirs."""
    x, w, _ = int8_microbench.make_inputs("f32", rows, 1024, 512, 1,
                                          cuda_device, seed=5)
    w2 = w.flip(0).contiguous()
    s = torch.full((1,), 2.0, device=cuda_device)
    got = dft_matmul.launch(x, w, w2, s)
    split = dft_matmul.dft_matmul_split_reference(x, w, w2, s)
    xs = (x + s).double()
    r64 = xs @ w.double() + xs @ w2.double()
    scale = float(r64.abs().max())
    assert float((got.double() - r64).abs().max()) <= 1e-5 * scale
    assert float((got - split).abs().max()) <= 1e-5 * scale
    assert torch.equal(dft_matmul.split_k_major(w, w2),
                       dft_matmul.split_k_major_reference(w, w2))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_cuda_dft_matmul_narrow_shapes(cuda_device, name):
    """The smallest shapes the wgmma type sets take (N = 64, F = 16) and an
    N that is no multiple of a 128-byte stage of int8 (192)."""
    for rows, n, f in ((3, 64, 16), (300, 192, 144)):
        x, w, acc_dt = int8_microbench.make_inputs(name, rows, n, f, 1,
                                                   cuda_device, seed=3)
        w2 = w.flip(0).contiguous()
        s = torch.full((1,), 1, dtype=acc_dt, device=cuda_device)
        got = dft_matmul.dft_matmul(x, w, w2, s)
        ref = dft_matmul.dft_matmul_reference(x, w, w2, s)
        if name == "int8":
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [1023, 4096])
def test_cuda_pipelined_bit_equal_to_base_kernel(cuda_device, batch):
    frames, window, pairs, cfg = emit_pipeline_probe.scene(batch,
                                                           cuda_device)
    frames = frames + 0.01 * torch.randn_like(frames)
    base = gcc_kernel.fused_gcc(frames, window, pairs, cfg, with_peaks=True)
    pipe = gcc_kernel.fused_gcc_pipelined(frames, window, pairs, cfg)
    assert all(torch.equal(a, b) for a, b in zip(base, pipe))
