"""PyTorch port, the frame-batch Localizer end to end against the JAX
package's Localizer, on the same synthetic frames: through the reference's
fused Pallas path (interpret mode) and its unfused path."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.utils import synth

BENCH = dict(phat=True, fft_pad_mode="circular", srp_dtype="bfloat16")
CONFIGS = {
    # (mics, PipelineConfig kwargs, Localizer.create kwargs)
    "bench_headline": ("square", dict(BENCH, band_hz=(800.0, 6000.0),
                                      band_crop=True),
                       dict(init_grid_stride=3)),
    "bench_fullband": ("square", BENCH, dict(init_grid_stride=3)),
    "bench_handsfree": ("square", dict(BENCH, band_hz="auto",
                                       subsample_method="hybrid"),
                        dict(init_grid_stride=3)),
    "readme_quickstart": ("reference", dict(phat=True), {}),
}
MICS = {"square": lambda: geometry.square_array(0.3),
        "reference": geometry.reference_array}


def _frames(rng, mics, b=8, noise=0.01):
    xy = rng.uniform(-0.9, 0.9, (b, 2))
    v = np.concatenate([xy, np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, noise_rms=noise,
                             seed=int(rng.integers(1 << 30))).astype(
                                 np.float32)


def _pair(name, fused):
    arr, kw, create_kw = CONFIGS[name]
    mics = MICS[arr]()
    ref = JLocalizer.create(
        mics, jcfg.PipelineConfig(**kw, fused_kernel=fused, fused_tile_b=8),
        **create_kw)
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw), device="cpu",
                            **create_kw)
    return mics, ref, port


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_localizer_matches_reference(rng, name, fused):
    mics, ref, port = _pair(name, fused)
    frames = _frames(rng, mics)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    assert sorted(g) == sorted(r)
    for k in r:
        assert g[k].shape == r[k].shape, k
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"])
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=1e-3)
    scale = np.abs(r["correlograms"]).max()
    np.testing.assert_allclose(g["correlograms"] / scale,
                               r["correlograms"] / scale, atol=1e-4)
    np.testing.assert_allclose(g["rms_m"], r["rms_m"], atol=1e-5)
    if port.pipeline.srp_dtype == "float32":
        # the same cell: the cell-to-meters division may differ by an ulp
        np.testing.assert_allclose(g["xy_grid"], r["xy_grid"], atol=1e-6)
    else:  # bf16 scoring: the init cell may move by rounding, not the basin
        np.testing.assert_allclose(g["xy_grid"], r["xy_grid"], atol=0.25)


@pytest.mark.parametrize("kw", [
    dict(taper_enabled=False), dict(subsample_peak=False),
    dict(nan_guard=True, window_mode="strided"),
], ids=["no_taper", "no_subsample", "nan_guard_strided"])
def test_unfused_peak_branch_matches_reference(rng, kw):
    mics = jgeo.reference_array()
    grid = dict(half_cells_x=12, half_cells_y=12, cells_per_m=6.0)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(phat=True, **kw),
                            jcfg.GridConfig(**grid))
    port = Localizer.create(mics, tcfg.PipelineConfig(phat=True, **kw),
                            tcfg.GridConfig(**grid), device="cpu")
    frames = _frames(rng, mics, b=4)
    if kw.get("nan_guard"):
        frames[1, 0, 5] = np.nan
        frames[2, 2, 9] = np.inf
    r = ref(jnp.asarray(frames))
    g = port(torch.from_numpy(frames))
    assert bool(torch.isfinite(g["xy"]).all())
    np.testing.assert_allclose(g["xy"].numpy(), np.asarray(r["xy"]),
                               atol=2e-4)
    np.testing.assert_array_equal(g["best_shift"].numpy(),
                                  np.asarray(r["best_shift"]))
    np.testing.assert_allclose(g["tdoa_samples"].numpy(),
                               np.asarray(r["tdoa_samples"]), atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(phat=True, fft_pad_mode="circular"),
    dict(normalize_mode="full_range", band_hz=(500.0, 9000.0)),
], ids=["phat_circular", "full_range_band"])
def test_condition_and_correlate_match_reference(rng, kw):
    from audio_triangulation_tpu.models import localizer as jloc
    from audio_triangulation_tpu_torch.models import localizer as tloc
    from audio_triangulation_tpu_torch.ops import window as twin

    mics = jgeo.reference_array()
    frames = _frames(rng, mics, b=3)
    jc, tc = jcfg.PipelineConfig(**kw), tcfg.PipelineConfig(**kw)
    win = twin.window_for(tc)
    ref_x = jloc.condition_frames(jnp.asarray(frames), jnp.asarray(win), jc)
    got_x = tloc.condition_frames(torch.from_numpy(frames),
                                  torch.from_numpy(win), tc)
    scale = float(np.abs(np.asarray(ref_x)).max())
    np.testing.assert_allclose(got_x.numpy() / scale,
                               np.asarray(ref_x) / scale, atol=1e-6)
    pairs = jgeo.mic_pairs(3)
    ref_c = np.asarray(jloc.correlate_frames(
        ref_x, jloc.LocalizerParams(None, jnp.asarray(pairs), None, None,
                                    None), jc))
    got_c = tloc.correlate_frames(
        got_x, tloc.LocalizerParams(None, torch.from_numpy(pairs), None,
                                    None, None), tc).numpy()
    scale = np.abs(ref_c).max()
    np.testing.assert_allclose(got_c / scale, ref_c / scale, atol=1e-5)


def test_heatmap_and_no_solver_match_reference(rng):
    mics = jgeo.square_array(0.3)
    grid = dict(half_cells_x=15, half_cells_y=15, cells_per_m=8.0)
    kw = dict(with_solver=False, with_heatmap=True)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(phat=True),
                            jcfg.GridConfig(**grid), **kw)
    port = Localizer.create(mics, tcfg.PipelineConfig(phat=True),
                            tcfg.GridConfig(**grid), device="cpu", **kw)
    frames = _frames(rng, mics, b=4)
    r = ref(jnp.asarray(frames))
    g = port(torch.from_numpy(frames))
    assert "xy_cov" not in g
    np.testing.assert_array_equal(g["heat_levels"].numpy(),
                                  np.asarray(r["heat_levels"]))
    np.testing.assert_allclose(g["xy"].numpy(), np.asarray(r["xy"]),
                               atol=1e-5)  # refined grid peak
    np.testing.assert_array_equal(g["rms_m"].numpy(), np.zeros(4, np.float32))


def test_reference_params_convert_byte_equal(rng):
    from audio_triangulation_tpu_torch.utils.convert import (
        params_from_reference)

    mics = jgeo.square_array(0.3)
    kw = dict(BENCH, band_hz=(800.0, 6000.0), band_crop=True)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**kw),
                            init_grid_stride=3)
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw), device="cpu",
                            init_grid_stride=3)
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in vars(ref.params).items()}
    conv = params_from_reference(arrays, "cpu")
    for name, t in conv.items():
        mine = getattr(port, name)
        if t is None:
            assert mine is None, name
            continue
        assert t.dtype == mine.dtype and t.shape == mine.shape, name
        assert t.numpy().tobytes() == mine.numpy().tobytes(), name
    twin = Localizer.from_reference_params(
        arrays, port.pipeline, tcfg.GridConfig(**dataclasses.asdict(
            ref.grid)), port.solver, device="cpu", srp_form=ref.srp_form)
    frames = torch.from_numpy(_frames(rng, mics, b=2))
    a, b = port(frames), twin(frames)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("pairs", [[[0, 4]], [[-1, 1]], [[0, 1, 2]], []],
                         ids=["past_last_mic", "negative", "not_2_wide",
                              "empty"])
def test_reference_params_reject_bad_pairs(pairs):
    """The GCC kernel indexes mics by the pairs unchecked, so the converter
    refuses pairs that are not indices of the mics."""
    from audio_triangulation_tpu_torch.utils.convert import (
        params_from_reference)

    arrays = {"mic_positions": geometry.square_array(0.3),
              "pairs": np.asarray(pairs, np.int32)}
    with pytest.raises(ValueError, match="pairs"):
        params_from_reference(arrays, "cpu")


def test_save_load_across_packages(tmp_path, rng):
    mics = jgeo.reference_array()
    kw = dict(phat=True, band_hz=(500.0, 9000.0))
    frames = _frames(rng, mics, b=2)

    port = Localizer.create(mics, tcfg.PipelineConfig(**kw), device="cpu",
                            init_grid_stride=2)
    path = port.save(str(tmp_path / "port"))
    ref_loaded = JLocalizer.load(path)
    assert ref_loaded.pipeline == jcfg.PipelineConfig(**kw)
    assert dataclasses.asdict(ref_loaded.grid) == dataclasses.asdict(
        port.grid)
    np.testing.assert_allclose(
        np.asarray(ref_loaded(jnp.asarray(frames))["xy"]),
        port(torch.from_numpy(frames))["xy"].numpy(), atol=2e-4)

    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**kw),
                            jcfg.GridConfig(projection="plane"),
                            jcfg.SolverConfig(constrain_to_sphere=False,
                                              iterations=7),
                            init_grid_stride=3)
    path = ref.save(str(tmp_path / "ref.json"))
    loaded = Localizer.load(path, device="cpu")
    assert loaded.pipeline == tcfg.PipelineConfig(**kw)
    assert loaded.solver == tcfg.SolverConfig(constrain_to_sphere=False,
                                              iterations=7)
    assert dataclasses.asdict(loaded.grid) == dataclasses.asdict(ref.grid)
    again = Localizer.load(loaded.save(str(tmp_path / "again")),
                           device="cpu")
    assert again.pipeline == loaded.pipeline and again.grid == loaded.grid
    np.testing.assert_allclose(
        loaded(torch.from_numpy(frames))["xy"].numpy(),
        np.asarray(ref(jnp.asarray(frames))["xy"]), atol=2e-4)


FORMERLY_REFUSED = [
    dict(band_hz="auto"), dict(subsample_method="phase"),
    dict(subsample_method="hybrid"), dict(weighting="scot"),
    dict(weighting="roth"), dict(weighting="ml"),
    dict(phat=True, phat_beta=0.5), dict(normalize_mode="full_range"),
    dict(xcorr_mode="fft"), dict(xcorr_mode="time"),
    dict(matmul_dtype="bfloat16"),
]


@pytest.mark.parametrize("kw", FORMERLY_REFUSED,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_unported_configs_raise(rng, kw):
    """The configurations the port once refused now match the JAX
    Localizer on the reference array (default linear pad, F = 1,025).  The
    reference runs them through its Pallas kernel (interpret mode) where it
    routes them there, else unfused; the port routes the same way.  The
    'hybrid' case without a band is held against the kernel's gate, which
    leaves Nyquist out (the unfused gate counts it)."""
    from audio_triangulation_tpu_torch.models.localizer import kernel_route

    cfg = tcfg.PipelineConfig(**kw)
    fused = "on" if kernel_route(cfg) else "off"
    assert fused == ("on" if ("band_hz" in kw or "subsample_method" in kw
                              or "matmul_dtype" in kw) else "off")
    mics = jgeo.reference_array()
    grid = dict(half_cells_x=12, half_cells_y=12, cells_per_m=6.0)
    ref = JLocalizer.create(
        mics, jcfg.PipelineConfig(**kw, fused_kernel=fused, fused_tile_b=8),
        jcfg.GridConfig(**grid))
    port = Localizer.create(mics, cfg, tcfg.GridConfig(**grid), device="cpu")
    frames = _frames(rng, mics)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"])
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=1e-3)
    scale = np.abs(r["correlograms"]).max()
    # 'ml' divides by 1 - g2 >= 1e-4, which amplifies f32 rounding
    tol = 2e-3 if kw.get("weighting") == "ml" else 1e-4
    np.testing.assert_allclose(g["correlograms"] / scale,
                               r["correlograms"] / scale, atol=tol)


HANDSFREE = dict(BENCH, band_hz="auto", subsample_method="hybrid")


def test_handsfree_save_load_round_trip(tmp_path, rng):
    mics = jgeo.square_array(0.3)
    port = Localizer.create(mics, tcfg.PipelineConfig(**HANDSFREE),
                            device="cpu", init_grid_stride=3)
    path = port.save(str(tmp_path / "handsfree"))
    again = Localizer.load(path, device="cpu")
    assert again.pipeline == port.pipeline and again.pipeline.band_auto
    assert again.grid == port.grid
    ref = JLocalizer.load(path)
    assert ref.pipeline == jcfg.PipelineConfig(**HANDSFREE)
    frames = _frames(rng, mics, b=4)
    a, b = port(torch.from_numpy(frames)), again(torch.from_numpy(frames))
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_handsfree_from_reference_params(rng):
    """A hands-free Localizer from the JAX package's own parameters (the
    stats mode adds none) matches the port's and the reference's."""
    mics = jgeo.square_array(0.3)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**HANDSFREE),
                            init_grid_stride=3)
    arrays = {k: None if v is None else np.asarray(v)
              for k, v in vars(ref.params).items()}
    port = Localizer.create(mics, tcfg.PipelineConfig(**HANDSFREE),
                            device="cpu", init_grid_stride=3)
    twin = Localizer.from_reference_params(
        arrays, port.pipeline, tcfg.GridConfig(**dataclasses.asdict(
            ref.grid)), port.solver, device="cpu", srp_form=ref.srp_form)
    frames = _frames(rng, mics, b=4)
    a, b = port(torch.from_numpy(frames)), twin(torch.from_numpy(frames))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    r = ref(jnp.asarray(frames))
    np.testing.assert_allclose(b["xy"].numpy(), np.asarray(r["xy"]),
                               atol=2e-4)


def test_accepted_tpu_knobs_change_nothing(rng):
    mics = geometry.square_array(0.3)
    base = Localizer.create(mics, tcfg.PipelineConfig(**BENCH),
                            device="cpu", init_grid_stride=3)
    knobs = Localizer.create(
        mics, tcfg.PipelineConfig(**BENCH, fused_sub_tiles=2,
                                  fused_kernel="off", fused_tile_b=64,
                                  dft_precision="highest"),
        device="cpu", init_grid_stride=3)
    frames = torch.from_numpy(_frames(rng, mics, b=3))
    a, b = base(frames), knobs(frames)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _spy(monkeypatch, calls, mod, name):
    def spy(*a, _f=getattr(mod, name), **k):
        calls.append(name)
        return _f(*a, **k)
    monkeypatch.setattr(mod, name, spy)


@pytest.mark.parametrize("name", ["bench_headline", "bench_fullband",
                                  "readme_quickstart"])
def test_fused_srp_matches_reference(rng, monkeypatch, name):
    """``fused_srp='on'``: scoring and the grid argmax run inside the GCC
    kernel's SRP mode, as in the reference with its kernel on (interpret
    mode), and the init cell and the scores come from it: the scoring
    product outside is not called."""
    from audio_triangulation_tpu_torch.ops import srp as tsrp
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    arr, kw, create_kw = CONFIGS[name]
    kw = dict(kw, srp_dtype="bfloat16", fused_srp="on")
    mics = MICS[arr]()
    grid = dict(half_cells_x=16, half_cells_y=16, cells_per_m=8.0)
    ref = JLocalizer.create(
        mics, jcfg.PipelineConfig(**kw, fused_kernel="on", fused_tile_b=8),
        jcfg.GridConfig(**grid), **create_kw)
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw),
                            tcfg.GridConfig(**grid), device="cpu",
                            **create_kw)
    calls = []
    _spy(monkeypatch, calls, gcc_kernel, "fused_gcc_srp")
    _spy(monkeypatch, calls, gcc_kernel, "fused_gcc")
    _spy(monkeypatch, calls, tsrp, "srp_scores_matmul")
    frames = _frames(rng, mics)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    assert calls == ["fused_gcc_srp"]
    assert sorted(g) == sorted(r)
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"])
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=1e-3)
    # a correlogram value that differs in its last f32 bits can round to
    # the next bf16 (2^-8 of it) before it is summed into a score
    smax = np.abs(r["scores"]).max()
    np.testing.assert_allclose(g["scores"] / smax, r["scores"] / smax,
                               atol=2e-3)
    # the same cell, or a neighbour whose bf16 score ties with it
    np.testing.assert_allclose(g["xy_grid"], r["xy_grid"], atol=0.25)
    assert (np.abs(g["xy_grid"] - r["xy_grid"]).max(-1) < 1e-6).mean() >= 0.75
    # the same dict as without the knob: the in-kernel argmax picks the
    # cell the outside argmax picks
    off = Localizer.create(
        mics, tcfg.PipelineConfig(**dict(kw, fused_srp="off")),
        tcfg.GridConfig(**grid), device="cpu", **create_kw)
    o = off(torch.from_numpy(frames))
    assert calls == ["fused_gcc_srp", "fused_gcc", "srp_scores_matmul"]
    assert sorted(o) == sorted(g)
    for k in o:
        assert o[k].shape == g[k].shape and o[k].numpy().dtype == g[k].dtype
        if k == "scores":
            # the same six fp32 adds of bf16 values, in pair order here and
            # in the product's order there
            np.testing.assert_allclose(o[k].numpy() / smax, g[k] / smax,
                                       atol=1e-6)
        else:
            np.testing.assert_array_equal(o[k].numpy(), g[k], err_msg=k)


@pytest.mark.parametrize("why,kw,create_kw", [
    ("auto_band", dict(band_hz="auto"), dict(init_grid_stride=3)),
    ("hybrid", dict(subsample_method="hybrid"), dict(init_grid_stride=3)),
    ("f32_scoring", dict(srp_dtype="float32"), dict(init_grid_stride=3)),
    ("gather_form", {}, dict(init_grid_stride=3, srp_form="gather")),
    ("refined_peak", {}, dict(with_solver=False)),
    ("no_taper", dict(taper_enabled=False), dict(init_grid_stride=3)),
], ids=lambda v: v if isinstance(v, str) else "")
def test_fused_srp_gate(rng, monkeypatch, why, kw, create_kw):
    """Outside the reference's conditions the knob changes nothing."""
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    mics = geometry.square_array(0.3)
    calls = []
    _spy(monkeypatch, calls, gcc_kernel, "fused_gcc_srp")
    cfg = dict(BENCH, **kw)
    grid = tcfg.GridConfig(half_cells_x=16, half_cells_y=16, cells_per_m=8.0)
    on = Localizer.create(mics, tcfg.PipelineConfig(**cfg, fused_srp="on"),
                          grid, device="cpu", **create_kw)
    off = Localizer.create(mics, tcfg.PipelineConfig(**cfg), grid,
                           device="cpu", **create_kw)
    frames = torch.from_numpy(_frames(rng, mics, b=3))
    a, b = on(frames), off(frames)
    assert calls == []
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_fused_srp_gate_score_bias(rng, monkeypatch):
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    mics = geometry.square_array(0.3)
    calls = []
    _spy(monkeypatch, calls, gcc_kernel, "fused_gcc_srp")
    loc = Localizer.create(mics, tcfg.PipelineConfig(**BENCH, fused_srp="on"),
                           device="cpu", init_grid_stride=3)
    frames = torch.from_numpy(_frames(rng, mics, b=2))
    loc(frames)
    assert calls == ["fused_gcc_srp"]
    loc.score_bias = torch.zeros(loc.grid.num_cells)
    loc(frames)
    assert calls == ["fused_gcc_srp"]  # a bias keeps scoring outside


@pytest.mark.parametrize("srp_form", ["gather", "matmul"])
def test_pair_chunk_takes_the_pair_blocked_routes(rng, monkeypatch,
                                                   srp_form):
    """``pair_chunk`` below the pair count: the unfused matmul engine and
    the gather-form scoring go a chunk of pairs at a time, as in the
    reference, on a configuration the GCC kernel does not take."""
    from audio_triangulation_tpu_torch.models import localizer as tloc
    from audio_triangulation_tpu_torch.ops import mxu_fft

    mics = jgeo.circular_array(6, 0.25)  # 15 pairs, chunks of 4
    kw = dict(phat=True, fft_pad_mode="circular",
              normalize_mode="full_range", pair_chunk=4)
    grid = dict(half_cells_x=12, half_cells_y=12, cells_per_m=6.0)
    ref = JLocalizer.create(mics, jcfg.PipelineConfig(**kw),
                            jcfg.GridConfig(**grid), srp_form=srp_form)
    port = Localizer.create(mics, tcfg.PipelineConfig(**kw),
                            tcfg.GridConfig(**grid), device="cpu",
                            srp_form=srp_form)
    calls = []
    _spy(monkeypatch, calls, mxu_fft, "xcorr_mxu_pairblocked")
    _spy(monkeypatch, calls, tloc.srp, "srp_scores_matmul_blocked")
    frames = _frames(rng, mics, b=4)
    r = {k: np.asarray(v) for k, v in ref(jnp.asarray(frames)).items()}
    g = {k: v.numpy() for k, v in port(torch.from_numpy(frames)).items()}
    assert calls == ["xcorr_mxu_pairblocked"] + (
        ["srp_scores_matmul_blocked"] if srp_form == "gather" else [])
    np.testing.assert_allclose(g["xy"], r["xy"], atol=2e-4)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"])
    smax = np.abs(r["scores"]).max()
    np.testing.assert_allclose(g["scores"] / smax, r["scores"] / smax,
                               atol=1e-4)
    calls.clear()
    whole = Localizer.create(
        mics, tcfg.PipelineConfig(**dict(kw, pair_chunk=None)),
        tcfg.GridConfig(**grid), device="cpu", srp_form=srp_form)
    w = whole(torch.from_numpy(frames))
    assert calls == []
    np.testing.assert_allclose(w["xy"].numpy(), g["xy"], atol=1e-5)


def test_leading_dims_and_device_rules(rng):
    mics = geometry.square_array(0.3)
    loc = Localizer.create(mics, tcfg.PipelineConfig(**BENCH), device="cpu",
                           init_grid_stride=3)
    frames = torch.from_numpy(_frames(rng, mics, b=6))
    flat = loc(frames)
    nested = loc(frames.reshape(2, 3, 4, 1024))
    assert nested["xy"].shape == (2, 3, 2)
    assert nested["correlograms"].shape == (2, 3, 6, 93)
    torch.testing.assert_close(nested["xy"].reshape(6, 2), flat["xy"])
    with pytest.raises(ValueError, match="mics"):
        loc(frames[:, :3])
    with pytest.raises(TypeError):
        loc(frames.numpy())
    meta = Localizer.create(mics, tcfg.PipelineConfig(**BENCH),
                            device="meta", init_grid_stride=3)
    with pytest.raises(ValueError, match="meta"):
        meta(frames)  # never copied across devices silently


def test_synth_copy_matches_reference():
    mics = jgeo.square_array(0.3)
    src = np.array([0.3, -0.2, 1.1])
    np.testing.assert_array_equal(
        synth.synth_scene(src, mics, noise_rms=0.01, seed=4),
        jsynth.synth_scene(src, mics, noise_rms=0.01, seed=4))


@pytest.mark.gpu
@pytest.mark.parametrize("stats", [False, True], ids=["bandcrop",
                                                      "handsfree"])
def test_cuda_localizer_matches_cpu_path(rng, stats):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel, gn_kernel

    mics = geometry.square_array(0.3)
    cfg = tcfg.PipelineConfig(**(HANDSFREE if stats else dict(
        BENCH, band_hz=(800.0, 6000.0), band_crop=True)))
    cpu = Localizer.create(mics, cfg, device="cpu", init_grid_stride=3)
    gpu = Localizer.create(mics, cfg, device="cuda", init_grid_stride=3)
    frames = _frames(rng, mics, b=256)

    def counts():
        return (gcc_kernel.launches, gcc_kernel.stats_launches,
                gn_kernel.launches)

    before = counts()
    g = gpu(torch.from_numpy(frames).cuda())
    assert counts() == (before[0] + (not stats), before[1] + stats,
                        before[2] + 1)
    c = cpu(torch.from_numpy(frames))
    assert torch.equal(g["best_shift"].cpu(), c["best_shift"])
    assert float((g["xy"].cpu() - c["xy"]).abs().max()) < 2e-4
