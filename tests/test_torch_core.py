"""PyTorch port, core layer: configs, geometry, window, conditioning and
the matmul GCC engine held against the JAX package; the port's package
imports no JAX; its kernel build has no silent fallback."""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import conditioning as jcond
from audio_triangulation_tpu.ops import mxu_fft as jmxu, window as jwin
from audio_triangulation_tpu.ops import xcorr as jxcorr
from audio_triangulation_tpu_torch.core import config as tcfg, geometry as tgeo
from audio_triangulation_tpu_torch.ops import conditioning as tcond
from audio_triangulation_tpu_torch.ops import mxu_fft as tmxu, window as twin
from audio_triangulation_tpu_torch.ops import xcorr as txcorr
from audio_triangulation_tpu_torch.ops.cuda import _build

PKG = pathlib.Path(__file__).resolve().parents[1] / "audio_triangulation_tpu_torch"
ARRAYS = {
    "reference": jgeo.reference_array,
    "square": lambda: jgeo.square_array(0.3),
    "circular8": lambda: jgeo.circular_array(8, 0.2, phase_deg=10.0),
}


@pytest.mark.parametrize("name", ["PipelineConfig", "GridConfig",
                                  "SolverConfig", "StreamConfig"])
def test_config_fields_and_defaults_match(name):
    ref, port = getattr(jcfg, name), getattr(tcfg, name)
    rf = [(f.name, f.default) for f in dataclasses.fields(ref)]
    pf = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert pf == rf
    assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


@pytest.mark.parametrize("kw", [
    {}, {"fft_pad_mode": "circular"}, {"weighting": "phat"},
    {"weighting": "scot", "phat": True}, {"band_hz": (800.0, 6000.0)},
    {"max_shift_samples": 30, "frame_size_bits": 9},
])
def test_pipeline_derived_properties_match(kw):
    ref, port = jcfg.PipelineConfig(**kw), tcfg.PipelineConfig(**kw)
    for prop in ("frame_size", "max_shift", "num_lags", "fft_length",
                 "band_auto", "effective_weighting", "detect_threshold"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.phat == ref.phat


@pytest.mark.parametrize("kw", [
    {"normalize_mode": "loud"}, {"phat_beta": 0.0},
    {"band_hz": "manual"}, {"band_crop": True},
    {"band_hz": "auto", "band_crop": True},
    {"band_hz": (10.0, 30_000.0)},
    {"dft_precision": "highest", "matmul_dtype": "bfloat16"},
])
def test_pipeline_validation_matches(kw):
    with pytest.raises(ValueError):
        jcfg.PipelineConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.PipelineConfig(**kw)


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_array_builders_byte_equal(name):
    ref = ARRAYS[name]()
    port = {"reference": tgeo.reference_array,
            "square": lambda: tgeo.square_array(0.3),
            "circular8": lambda: tgeo.circular_array(
                8, 0.2, phase_deg=10.0)}[name]()
    assert port.dtype == ref.dtype and port.tobytes() == ref.tobytes()
    t = tgeo.triangle_from_distances(0.1, 0.12, 0.14, mirror=False,
                                     rotate=True)
    r = jgeo.triangle_from_distances(0.1, 0.12, 0.14, mirror=False,
                                     rotate=True)
    assert t.tobytes() == r.tobytes()


@pytest.mark.parametrize("name", sorted(ARRAYS))
@pytest.mark.parametrize("grid_kw", [
    {}, {"half_cells_x": 16, "half_cells_y": 16, "cells_per_m": 8.0},
    {"projection": "plane", "half_cells_x": 10, "half_cells_y": 7},
])
def test_pairs_lut_onehot_byte_equal(name, grid_kw):
    mics = ARRAYS[name]()
    m = mics.shape[0]
    assert tgeo.mic_pairs(m).tobytes() == jgeo.mic_pairs(m).tobytes()
    pairs = jgeo.mic_pairs(m)
    pipe_r, pipe_t = jcfg.PipelineConfig(), tcfg.PipelineConfig()
    g_r, g_t = jcfg.GridConfig(**grid_kw), tcfg.GridConfig(**grid_kw)
    assert (tgeo.grid_points(g_t).tobytes()
            == jgeo.grid_points(g_r).tobytes())
    lut_r = jgeo.lag_lut(g_r, mics, pairs, pipe_r)
    lut_t = tgeo.lag_lut(g_t, mics, pairs, pipe_t)
    assert lut_t.dtype == lut_r.dtype and lut_t.tobytes() == lut_r.tobytes()
    if g_r.num_cells <= 33 * 33:
        oh_r = jgeo.lag_onehot(lut_r, pipe_r.num_lags)
        oh_t = tgeo.lag_onehot(lut_t, pipe_t.num_lags)
        assert oh_t.shape == oh_r.shape and oh_t.tobytes() == oh_r.tobytes()


@pytest.mark.parametrize("kw", [{}, {"window_mode": "strided",
                                     "frame_size_bits": 9},
                                {"window_nw": 3.0}])
def test_dpss_window_equal(kw):
    r = jwin.window_for(jcfg.PipelineConfig(**kw))
    t = twin.window_for(tcfg.PipelineConfig(**kw))
    assert t.dtype == r.dtype and t.tobytes() == r.tobytes()


@pytest.mark.parametrize("mode", ["shift8", "full_range", "none"])
def test_conditioning_matches(rng, mode):
    x = (rng.normal(size=(3, 4, 256)) * 40 + 128).astype(np.float32)
    ref = np.asarray(jcond.normalize(jcond.dc_remove(jnp.asarray(x)), mode))
    got = tcond.normalize(tcond.dc_remove(torch.from_numpy(x)), mode).numpy()
    scale = np.abs(ref).max()  # mean rounding differs by an ulp of 128
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-6)
    w = twin.dpss_window(256)
    np.testing.assert_array_equal(
        twin.apply_window(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
        np.asarray(jwin.apply_window(jnp.asarray(x), jnp.asarray(w))))


@pytest.mark.parametrize("kw", [
    {"fft_pad_mode": "circular"},
    {"band_hz": (800.0, 6000.0), "band_crop": True},
    {"band_hz": (800.0, 6000.0)},
])
def test_matmul_builders_equal(kw):
    r, t = jcfg.PipelineConfig(**kw), tcfg.PipelineConfig(**kw)
    n, fl, k = r.frame_size, r.fft_length, r.max_shift
    for a, b in zip(tmxu.dft_matrices(n, fl), jmxu.dft_matrices(n, fl)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(tmxu.lag_synthesis_matrices(fl, k),
                    jmxu.lag_synthesis_matrices(fl, k)):
        assert a.tobytes() == b.tobytes()
    for a, b in zip(tmxu.masked_synthesis(t), jmxu.masked_synthesis(r)):
        assert a.tobytes() == b.tobytes()
    assert tmxu.crop_bins(t) == jmxu.crop_bins(r)
    mask_r, mask_t = jxcorr.band_mask(r), txcorr.band_mask(t)
    assert (mask_r is None) == (mask_t is None)
    if mask_r is not None:
        assert mask_t.tobytes() == mask_r.tobytes()
    if r.band_crop:
        lo, hi = jmxu.crop_bins(r)
        for a, b in zip(tmxu.dft_matrices_band(n, fl, lo, hi),
                        jmxu.dft_matrices_band(n, fl, lo, hi)):
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("m,kw", [
    (3, {}), (4, {"phat": True, "fft_pad_mode": "circular"}),
    (2, {"phat": True, "phat_eps": 1e-9}),
    (4, {"phat": True, "band_hz": (800.0, 6000.0), "band_crop": True}),
])
def test_xcorr_mxu_matches(rng, m, kw):
    x = (rng.normal(size=(4, m, 1024)) * 2000).astype(np.float32)
    pairs = jgeo.mic_pairs(m)
    ref = np.asarray(jmxu.xcorr_mxu(jnp.asarray(x), jnp.asarray(pairs),
                                    jcfg.PipelineConfig(**kw)))
    got = tmxu.xcorr_mxu(torch.from_numpy(x), torch.from_numpy(pairs),
                         tcfg.PipelineConfig(**kw)).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got / scale, ref / scale, atol=1e-5)


def test_peak_ops_match(rng):
    k = 46
    c = rng.normal(size=(5, 6, 2 * k + 1)).astype(np.float32)
    c[0, 0, 0] = 9.0   # edge peak: no interpolation
    c[1, 2, 10] = c[1, 2, 20] = 9.0  # tie: the first maximum wins
    cj, ct = jnp.asarray(c), torch.from_numpy(c)
    np.testing.assert_array_equal(txcorr.best_lag(ct, k).numpy(),
                                  np.asarray(jxcorr.best_lag(cj, k)))
    tr, pr = jxcorr.subsample_peak(cj, k)
    tt, pt = txcorr.subsample_peak(ct, k)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tr), atol=1e-6)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pr))
    np.testing.assert_allclose(txcorr.peak_taper(ct, k, 36.0).numpy(),
                               np.asarray(jxcorr.peak_taper(cj, k, 36.0)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(txcorr.peak_confidence(ct, k).numpy(),
                               np.asarray(jxcorr.peak_confidence(cj, k)),
                               rtol=1e-6)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    bad = [(f.name, mod) for f in files for mod in _imports(f)
           if mod.split(".")[0] in ("jax", "jaxlib", "audio_triangulation_tpu")]
    assert bad == []


def test_port_import_leaves_jax_unloaded():
    code = ("import sys, audio_triangulation_tpu_torch as p; "
            "import audio_triangulation_tpu_torch.models.localizer; "
            "import audio_triangulation_tpu_torch.utils.convert; "
            "import audio_triangulation_tpu_torch.models.streaming; "
            "import audio_triangulation_tpu_torch.tools.int8_microbench; "
            "import audio_triangulation_tpu_torch.tools.emit_pipeline_probe; "
            "import audio_triangulation_tpu_torch.tools.bench_streaming; "
            "import audio_triangulation_tpu_torch.runtime.server; "
            "import audio_triangulation_tpu_torch.runtime.feeder; "
            "import audio_triangulation_tpu_torch.runtime.transport; "
            "import audio_triangulation_tpu_torch.utils.serving; "
            "import audio_triangulation_tpu_torch.utils.checkpoint; "
            "import audio_triangulation_tpu_torch.utils.profiling; "
            "print(sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('audio_triangulation_tpu.')"
            " or m == 'audio_triangulation_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=PKG.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build, "CUDA_HOME_DEFAULT", str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(build_dir=tmp_path / "build")
    assert not list((tmp_path).glob("build/*.so"))


def test_build_reports_compiler_failure(tmp_path, monkeypatch):
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text("#!/bin/sh\necho 'error: no card here' >&2\nexit 3\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="no card here"):
        _build.build(build_dir=tmp_path / "build")
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    """One nvcc per csrc/*.cu (started together), then one link into the
    library; nothing of the build is left beside it."""
    log = tmp_path / "calls"
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text(
        "#!/bin/sh\necho \"$@\" >> " + str(log) + "\n"
        "while [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then touch \"$2\"; fi; shift\ndone\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    out = _build.build(build_dir=tmp_path / "build")
    calls = log.read_text().splitlines()
    cu = [s for s in _build.sources() if s.suffix == ".cu"]
    assert len(calls) == len(cu) + 1
    assert sorted(c.split()[-1] for c in calls[:-1]) == sorted(map(str, cu))
    assert all(" -c " in c for c in calls[:-1])
    assert " -shared " in calls[-1] and "-c" not in calls[-1].split()
    assert out.exists() and list((tmp_path / "build").iterdir()) == [out]


def test_device_constant_copies_once_per_array_and_device():
    """Off the CPU a numpy constant is copied to the device once and the
    copy kept by the array's identity (the "meta" device stands in for a
    card here); on the CPU nothing is kept."""
    from audio_triangulation_tpu_torch.ops import _device

    a = np.arange(6, dtype=np.float64).reshape(2, 3)
    b = a.copy()
    ta = _device.device_constant(a, "meta")
    assert ta.device.type == "meta" and ta.dtype == torch.float32
    assert _device.device_constant(a, torch.device("meta")) is ta
    assert _device.device_constant(b, "meta") is not ta  # another array
    assert _device.device_constant(a, "meta", torch.int64) is not ta
    cpu = _device.device_constant(a, "cpu")
    assert cpu.dtype == torch.float32 and cpu.tolist() == a.tolist()
    assert _device.device_constant(a, "cpu") is not cpu
    for i in range(_device.MAX_ENTRIES + 3):  # the oldest entries go
        _device.device_constant(np.zeros(1) + i, "meta")
    assert len(_device._cache) == _device.MAX_ENTRIES
    assert _device.device_constant(a, "meta") is not ta

