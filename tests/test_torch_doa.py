"""PyTorch port, ``models/doa`` against the JAX package's, on the same
seeded numpy inputs.

Held exactly: the azimuth and spherical lag LUTs, ``merge_pairs``, the
Fibonacci lattice, the azimuth steering, ``circular_peaks`` and the best
shifts.  ``DoaEstimator`` (8-mic circle, PHAT, full band and band-crop;
``smp=True`` on an 8-mic line, taper on and off) and ``Doa3dEstimator``
(the CLI's tetrahedron and a coplanar circle), each through the JAX
package's unfused path and its Pallas GCC kernel in interpret mode, and
each built by ``create`` and from the JAX package's constants
(``utils.convert``): azimuth and elevation within 1e-3 degrees, bearings
within 1e-5, TDOAs within 1e-3 samples, scores within 1e-4 of their
scale.  The one exception is the CLI's spherical configuration (PHAT
over the full band of unwindowed frames), whose scores are held within
3e-3 of their scale: PHAT whitens bins where the chirp has no energy,
and both packages' fp32 correlograms lie 1.9e-3 of scale from float64
there (worst port-to-reference gap measured 2.2e-3).  An estimator built
from the reference's constants has the same buffers as one built by
``create`` and gives the same outputs within 1e-6 (BLAS may take another
path for other memory).  The MUSIC azimuth spectrum of one source within
``tests/test_torch_srp_freq.py``'s MUSIC tolerance (1e-3 relative, or
its reciprocal within 1e-5).  Two sources over the full band (the azimuth
steering takes every bin, and the weaker source's subspace is ill defined
where its bins are weak or the bearings close, so any rounding moves
cells by more than 1e-3) are held as that file's degenerate scene: the reciprocal within 2e-3 (worst measured 4.5e-4) and the
bearings equal where the spectrum's peak is 1e-3 of scale clear.  Every
estimator also finds the planted bearing within the JAX package's own
test bound."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import doa as jdoa
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import doa
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

MICS8 = jgeo.circular_array(8, 0.15)
TETRA = jgeo.tetrahedral_array(0.3)
FS, C = 50_000.0, 343.0


def _line(n=8, pitch=0.04):
    mics = np.zeros((n, 2), np.float32)
    mics[:, 0] = (np.arange(n) - (n - 1) / 2) * pitch
    return mics


def _bearing(az_deg, el_deg=0.0):
    az, el = np.radians(az_deg), np.radians(el_deg)
    return np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                     np.sin(el)])


def _plane_wave(mics, az_deg, el_deg=0.0, seed=0, noise=0.003):
    """[1, M, 1024] f32: a chirp from bearing (az, el), per-mic delays
    -m.u/c (tests/test_doa3d.py's scene)."""
    m3 = np.zeros((mics.shape[0], 3))
    m3[:, :mics.shape[1]] = mics
    tau = -(m3 @ _bearing(az_deg, el_deg)) / C * FS
    out = jsynth.fractional_delay(
        np.broadcast_to(jsynth.chirp_burst(1024, FS), (mics.shape[0], 1024)),
        tau)
    rng = np.random.default_rng(seed)
    return (out + rng.normal(0, noise, out.shape))[None].astype(np.float32)


def _farfield(az_list, mics=MICS8, noise=0.005):
    """[B, M, 1024] f32: a source 60 m away at each azimuth
    (tests/test_doa_multisource.py's scene)."""
    return np.concatenate([jsynth.synth_scene(
        60.0 * np.array([np.cos(np.radians(a)), np.sin(np.radians(a)), 0.0]),
        mics, noise_rms=noise, seed=i) for i, a in enumerate(az_list)]
    ).astype(np.float32)


def _ang_err(a, b):
    return np.abs((np.asarray(a) - np.asarray(b) + 180.0) % 360.0 - 180.0)


def _compare(r, g, where, scale_tol=1e-4):
    assert sorted(g) == sorted(r), where
    g = {k: v.numpy() for k, v in g.items()}
    for k in r:
        assert g[k].shape == np.shape(r[k]), (where, k)
    np.testing.assert_array_equal(g["best_shift"], r["best_shift"],
                                  err_msg=where)
    np.testing.assert_allclose(g["tdoa_samples"], r["tdoa_samples"],
                               atol=1e-3, err_msg=where)
    np.testing.assert_allclose(g["bearing"], r["bearing"], atol=1e-5,
                               err_msg=where)
    scale = np.abs(r["scores"]).max()
    np.testing.assert_allclose(g["scores"] / scale, r["scores"] / scale,
                               atol=scale_tol, err_msg=where)
    for k in ("azimuth_deg", "elevation_deg"):
        if k in r:
            assert _ang_err(g[k], r[k]).max() < 1e-3, (where, k, g[k], r[k])
    if "bearing_grid" in r:
        np.testing.assert_array_equal(g["bearing_grid"], r["bearing_grid"],
                                      err_msg=where)


def _np(out):
    return {k: np.asarray(v) for k, v in out.items()}


def _same_estimator(conv, port, g2, g):
    """An estimator built from the reference's constants against one built
    by ``create``: equal buffers, outputs within 1e-6 of their scale."""
    for name, buf in port.named_buffers():
        assert torch.equal(getattr(conv, name), buf), name
    for k in g:
        scale = max(float(g[k].abs().max()), 1e-30)
        assert float((g2[k] - g[k]).abs().max()) <= 1e-6 * scale, k


def _spy_row2(monkeypatch):
    calls = []
    real = gcc_kernel.fused_gcc

    def spy(*args, **kwargs):
        calls.append(kwargs["with_peaks"])
        return real(*args, **kwargs)

    monkeypatch.setattr(gcc_kernel, "fused_gcc", spy)
    return calls


def _doa_arrays(est):
    """A JAX DoaEstimator's constants as numpy arrays."""
    arrays = {k: np.asarray(v) for k, v in vars(est.params).items()
              if v is not None}
    arrays["onehot_az"] = np.asarray(est.onehot_az)
    arrays["merge"] = None if est.merge is None else np.asarray(est.merge)
    arrays["disp"] = est.disp
    return arrays


# ----------------------------------------------------------------------
# constants
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mics", ["circle8", "line8", "tetra"])
def test_lags_merges_and_lattice_equal_reference(mics):
    m = {"circle8": MICS8, "line8": _line(), "tetra": TETRA}[mics]
    pairs = jgeo.mic_pairs(m.shape[0])
    cfg_kw = dict(max_shift_samples=jgeo.max_lag_for_array(
        m, jcfg.PipelineConfig()))
    jc, tc = jcfg.PipelineConfig(**cfg_kw), tcfg.PipelineConfig(**cfg_kw)
    if m.shape[1] == 2:
        for n_az in (360, 97):
            np.testing.assert_array_equal(
                doa.azimuth_lag_lut(m, pairs, tc, n_az),
                jdoa.azimuth_lag_lut(m, pairs, jc, n_az))
        for a, b in zip(doa.merge_pairs(m, pairs),
                        jdoa.merge_pairs(m, pairs)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(doa.azimuth_steering_vectors(m, tc, 90),
                        jdoa.azimuth_steering_vectors(m, jc, 90)):
            np.testing.assert_array_equal(a, b)
    for n, hemi in ((512, False), (333, True)):
        dirs = doa.sphere_directions(n, hemisphere=hemi)
        np.testing.assert_array_equal(dirs,
                                      jdoa.sphere_directions(n, hemi))
        np.testing.assert_array_equal(
            doa.sphere_lag_lut(m, pairs, tc, dirs),
            jdoa.sphere_lag_lut(m, pairs, jc, dirs))


def test_circular_peaks_equal_reference():
    rng = np.random.default_rng(2)
    for n_peaks, sep in ((1, 5), (2, 10), (4, 3)):
        s = rng.normal(size=360)
        s[2], s[359], s[180] = 10.0, 9.0, 8.0  # the first hides the second
        np.testing.assert_array_equal(doa.circular_peaks(s, n_peaks, sep),
                                      jdoa.circular_peaks(s, n_peaks, sep))


# ----------------------------------------------------------------------
# DoaEstimator
# ----------------------------------------------------------------------

DOA_CONFIGS = {"phat": dict(phat=True),
               "bandcrop_phat": dict(phat=True, band_hz=(800.0, 6000.0),
                                     band_crop=True)}


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("name", sorted(DOA_CONFIGS))
def test_doa_estimator_matches_reference(name, fused, monkeypatch):
    """Four sources 60 m away; the port takes row 2 (the GCC kernel
    without peaks), built both ways."""
    kw = DOA_CONFIGS[name]
    truth = (0.0, 37.0, 123.4, 250.0)
    frames = _farfield(truth)
    ref = jdoa.DoaEstimator.create(MICS8, jcfg.PipelineConfig(
        **kw, fused_kernel=fused, fused_tile_b=4))
    port = doa.DoaEstimator.create(MICS8, tcfg.PipelineConfig(**kw),
                                   device="cpu")
    assert port.pipeline.max_shift == ref.pipeline.max_shift == 45
    conv = doa.DoaEstimator.from_reference_params(
        _doa_arrays(ref), port.pipeline, 360, device="cpu")
    calls = _spy_row2(monkeypatch)
    r = _np(ref(jnp.asarray(frames)))
    g = port(torch.from_numpy(frames))
    g2 = conv(torch.from_numpy(frames))
    assert calls == [False, False]
    _compare(r, g, name)
    _same_estimator(conv, port, g2, g)
    assert _ang_err(g["azimuth_deg"].numpy(), truth).max() < 3.0


def test_doa_estimator_leading_dims_and_refusals():
    frames = _farfield((40.0, 200.0, 300.0, 10.0)).reshape(2, 2, 8, 1024)
    ref = jdoa.DoaEstimator.create(MICS8, n_azimuths=180)
    port = doa.DoaEstimator.create(MICS8, n_azimuths=180, device="cpu")
    r = _np(ref(jnp.asarray(frames)))
    g = port(torch.from_numpy(frames))
    assert g["scores"].shape == (2, 2, 180)
    _compare(r, g, "leading dims")
    with pytest.raises(ValueError, match="mics"):
        port(torch.zeros(1, 7, 1024))
    with pytest.raises(ValueError, match="samples"):
        port(torch.zeros(1, 8, 512))
    with pytest.raises(TypeError):
        port(np.zeros((1, 8, 1024), np.float32))
    explicit = doa.DoaEstimator.create(
        MICS8, tcfg.PipelineConfig(max_shift_samples=50), device="cpu")
    assert explicit.pipeline.max_shift == 50


@pytest.mark.parametrize("kw", [dict(phat=True, taper_enabled=False),
                                dict(phat=True),
                                dict(phat=True, band_hz=(800.0, 6000.0),
                                     band_crop=True)],
                         ids=["taper_off", "taper_on", "bandcrop"])
def test_smp_matches_reference(kw):
    """The merged path (28 pairs -> 7 groups) on its unfused spectra."""
    mics = _line()
    frames = np.concatenate([_plane_wave(mics, az, seed=int(az))
                             for az in (40.0, 120.0, 75.0)])
    ref = jdoa.DoaEstimator.create(mics, jcfg.PipelineConfig(**kw),
                                   smp=True)
    port = doa.DoaEstimator.create(mics, tcfg.PipelineConfig(**kw),
                                   smp=True, device="cpu")
    conv = doa.DoaEstimator.from_reference_params(
        _doa_arrays(ref), port.pipeline, 360, device="cpu")
    r = _np(ref(jnp.asarray(frames)))
    g = port(torch.from_numpy(frames))
    assert g["tdoa_samples"].shape == (3, 7)
    _compare(r, g, str(kw))
    _same_estimator(conv, port, conv(torch.from_numpy(frames)), g)
    # a line cannot tell a bearing from its mirror image
    got = g["azimuth_deg"].numpy()
    err = np.minimum(_ang_err(got, [40.0, 120.0, 75.0]),
                     _ang_err(got, [-40.0, -120.0, -75.0]))
    assert err.max() < 4.0, got


def test_smp_scores_equal_unmerged_with_taper_off():
    mics = _line()
    cfg = tcfg.PipelineConfig(phat=True, taper_enabled=False)
    frames = torch.from_numpy(_plane_wave(mics, 60.0))
    s0 = doa.DoaEstimator.create(mics, cfg, 180, device="cpu")(
        frames)["scores"]
    s1 = doa.DoaEstimator.create(mics, cfg, 180, smp=True, device="cpu")(
        frames)["scores"]
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=1e-4,
                               atol=1e-4 * float(s0.abs().max()))


def test_smp_refusals_match_reference():
    mics = _line()
    for kw, match in ((dict(weighting="scot"), "weighting"),
                      (dict(xcorr_mode="fft"), "xcorr_mode")):
        with pytest.raises(ValueError, match=match):
            jdoa.DoaEstimator.create(mics, jcfg.PipelineConfig(**kw),
                                     smp=True)
        with pytest.raises(ValueError, match=match):
            doa.DoaEstimator.create(mics, tcfg.PipelineConfig(**kw),
                                    smp=True, device="cpu")


# ----------------------------------------------------------------------
# Doa3dEstimator
# ----------------------------------------------------------------------

def _doa3d_arrays(est):
    arrays = {k: np.asarray(v) for k, v in vars(est.params).items()
              if v is not None}
    arrays["dirs"] = np.asarray(est.dirs)
    arrays["onehot_sph"] = np.asarray(est.onehot_sph)
    return arrays


@pytest.mark.parametrize("fused", ["on", "off"],
                         ids=["pallas_interpret", "unfused"])
@pytest.mark.parametrize("name", ["cli_tetra", "windowed_band_tetra",
                                  "coplanar6"])
def test_doa3d_matches_reference(name, fused, monkeypatch):
    """The CLI's tetrahedron (PHAT, window off: ``cli/main.py:825``), the
    same array windowed in the chirp's band, and a coplanar circle on the
    upper hemisphere; 512 bearings."""
    if name == "coplanar6":
        mics = jgeo.circular_array(6, 0.12)
        kw, truth = dict(phat=True, window_enabled=False), [(120.0, 30.0)]
    else:
        mics = TETRA
        kw = (dict(phat=True, window_enabled=False) if name == "cli_tetra"
              else dict(phat=True, band_hz=(700.0, 7000.0)))
        truth = [(40.0, 25.0), (200.0, -15.0), (310.0, 60.0)]
    frames = np.concatenate([_plane_wave(mics, az, el, seed=i + 1)
                             for i, (az, el) in enumerate(truth)])
    ref = jdoa.Doa3dEstimator.create(mics, jcfg.PipelineConfig(
        **kw, fused_kernel=fused, fused_tile_b=2), n_dirs=512)
    port = doa.Doa3dEstimator.create(mics, tcfg.PipelineConfig(**kw),
                                     n_dirs=512, device="cpu")
    assert port.coplanar == (name == "coplanar6")
    assert port.pipeline.max_shift == ref.pipeline.max_shift
    conv = doa.Doa3dEstimator.from_reference_params(
        _doa3d_arrays(ref), port.pipeline, device="cpu")
    calls = _spy_row2(monkeypatch)
    r = _np(ref(jnp.asarray(frames)))
    g = port(torch.from_numpy(frames))
    g2 = conv(torch.from_numpy(frames))
    assert calls == [False, False]
    _compare(r, g, name, scale_tol=3e-3 if name != "windowed_band_tetra"
             else 1e-4)
    _same_estimator(conv, port, g2, g)
    az, el = np.array(truth).T
    assert _ang_err(g["azimuth_deg"].numpy(), az).max() < 3.0
    if name != "coplanar6":
        assert np.abs(g["elevation_deg"].numpy() - el).max() < 3.0


def test_doa3d_default_config_widens_lag_window():
    port = doa.Doa3dEstimator.create(TETRA, device="cpu")
    ref = jdoa.Doa3dEstimator.create(TETRA)
    assert port.pipeline.max_shift == ref.pipeline.max_shift == 73
    assert port.onehot_sph.shape == (6 * 147, 2048)
    explicit = doa.Doa3dEstimator.create(
        TETRA, tcfg.PipelineConfig(max_shift_samples=50), device="cpu")
    assert explicit.pipeline.max_shift == 50


# ----------------------------------------------------------------------
# MUSIC azimuth
# ----------------------------------------------------------------------

def _music_snaps(az_list, n_snap=12, noise=0.02, seed=0, mics=MICS8,
                 cutoff_hz=1500.0):
    """tests/test_doa_multisource.py's MUSIC scene: independent colored
    bursts per source and snapshot, 60 m away."""
    rng = np.random.default_rng(seed)
    frames = []
    for s in range(n_snap):
        acc = np.zeros((mics.shape[0], 1024))
        for k, az in enumerate(az_list):
            sig = jsynth.colored_burst(1024, 50_000.0, cutoff_hz=cutoff_hz,
                                       seed=seed + 1000 * (k + 1) + s)
            ang = np.radians(az)
            src = np.array([60.0 * np.cos(ang), 60.0 * np.sin(ang), 0.0])
            acc = acc + jsynth.synth_scene(src, mics, signal=sig,
                                           noise_rms=0.0, seed=0)[0]
        frames.append(acc + rng.normal(0, noise, acc.shape))
    return np.stack(frames).astype(np.float32)


@pytest.mark.parametrize("case", ["one", "two_close", "auto"])
def test_estimate_doa_music_matches_reference(case):
    """One source (tests/test_doa_multisource.py), two 25 degrees apart,
    and two counted by MDL first."""
    if case == "one":
        truth, kw = [137.0], dict(n_sources=1)
        frames = _music_snaps(truth, seed=137)
    elif case == "two_close":
        truth, kw = [90.0, 115.0], dict(n_sources=2, min_separation_deg=10.0)
        frames = _music_snaps(truth, n_snap=16, seed=3)
    else:
        truth, kw = [60.0, 200.0], dict(n_sources="auto")
        frames = _music_snaps(truth, n_snap=20, seed=9, cutoff_hz=4000.0)
    r = jdoa.estimate_doa_music(jnp.asarray(frames), MICS8,
                                jcfg.PipelineConfig(), **kw)
    g = doa.estimate_doa_music(torch.from_numpy(frames), MICS8,
                               tcfg.PipelineConfig(), **kw)
    assert sorted(g) == sorted(r)
    assert g["n_sources"] == r["n_sources"] == len(truth)
    if case == "auto":
        assert g["n_sources_estimated"] == r["n_sources_estimated"] == 2
    rs, gs = np.asarray(r["scores"], np.float64), g["scores"].numpy()
    if case == "one":
        assert (np.abs(gs - rs) <= 1e-3 * rs + 1e-5 * rs * rs).all()
    else:
        np.testing.assert_allclose(1.0 / gs, 1.0 / rs, atol=2e-3, rtol=0)
    top2 = np.sort(rs)[-2:]
    assert top2[1] - top2[0] > 1e-3 * rs.max()
    np.testing.assert_array_equal(g["azimuth_deg"], r["azimuth_deg"])
    err = [_ang_err(g["azimuth_deg"], t).min() for t in truth]
    assert max(err) < 6.0, (g["azimuth_deg"], truth)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["doa", "smp", "doa3d"])
def test_estimators_card_match_cpu(cuda_device, what):
    """The card (row 2 for 'doa' and 'doa3d') against the CPU path."""
    if what == "doa3d":
        mics, kw = TETRA, dict(phat=True, window_enabled=False)
        frames = np.concatenate([_plane_wave(TETRA, az, el, seed=i)
                                 for i, (az, el) in enumerate(
                                     [(40.0, 25.0), (200.0, -15.0)])])
        make = doa.Doa3dEstimator.create
    else:
        mics = MICS8 if what == "doa" else _line()
        kw = dict(phat=True)
        frames = _farfield((37.0, 250.0), mics)
        make = _doa_maker(what)
    cpu = make(mics, tcfg.PipelineConfig(**kw), device="cpu")
    card = make(mics, tcfg.PipelineConfig(**kw), device=cuda_device)
    r = _np(cpu(torch.from_numpy(frames)))
    g = card(torch.from_numpy(frames).to(cuda_device))
    _compare(r, {k: v.cpu() for k, v in g.items()}, what,
             scale_tol=3e-3 if what == "doa3d" else 1e-4)


def _doa_maker(what):
    def make(mics, cfg, device):
        return doa.DoaEstimator.create(mics, cfg, smp=what == "smp",
                                       device=device)
    return make


def test_reference_dataclass_fields_carried():
    """Every array field of the JAX estimators has a place in the
    conversion (a new field there would be dropped silently)."""
    est = jdoa.DoaEstimator.create(MICS8)
    fields = {f.name for f in dataclasses.fields(est)}
    assert fields == {"pipeline", "n_azimuths", "params", "onehot_az",
                      "merge", "disp"}
    est3 = jdoa.Doa3dEstimator.create(TETRA, n_dirs=64)
    assert {f.name for f in dataclasses.fields(est3)} == {
        "pipeline", "dirs", "params", "onehot_sph"}
