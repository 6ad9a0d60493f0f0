"""PyTorch port, source extraction against the JAX package's on the same
numpy inputs: ``ops/beamform`` (``source_delays``, ``extract_das``,
``extract_mvdr``), ``Localizer.extract``, ``models/extraction``
(``StreamingExtractor``) and the two-rate localizer's ``with_audio``.

Tolerances: delays within 1e-9 s; waveforms within 1e-5 of their scale
where both packages steer at the same position (the DAS sum and the
MVDR's smoothed covariance, loading and per-bin solve, in float32 on both
sides).  Where each package steers at its own localized position
(``Localizer.extract`` with ``xy`` omitted, the two-rate ``audio``) the
positions agree within 1e-4 m (``tests/test_torch_stream.py``'s ``xy``
tolerance) and the waveforms within 1e-4 of scale.  Held exactly: the
two-rate slot order (``stream_idx``), ``accepted`` and ``triggered``.  The
JAX tests' properties hold on the port: DAS's SNR gain over one mic, MVDR
over DAS on a 3x interferer and distortionless on the target alone, a
moving steer's glide beating a frozen one, the zero-delay WOLA
reconstruction, chunk-size invariance, ``step_many`` equal to a loop."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import extraction as jex
from audio_triangulation_tpu.models import streaming as jstream
from audio_triangulation_tpu.ops import beamform as jbf
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import extraction as tex
from audio_triangulation_tpu_torch.models import streaming as tstream
from audio_triangulation_tpu_torch.models.localizer import Localizer
from audio_triangulation_tpu_torch.ops import beamform as tbf
from audio_triangulation_tpu_torch.utils import convert

MICS = jgeo.circular_array(6, 0.25)
JCFG, TCFG = jcfg.PipelineConfig(), tcfg.PipelineConfig()
HEIGHT = 1.2


def _place(x, y):
    p = np.array([x, y, HEIGHT])
    return p * (HEIGHT / np.linalg.norm(p))


def _corr(a, b):
    """Alignment-free similarity: normalized cross-correlation peak."""
    a = a - a.mean()
    b = b - b.mean()
    c = np.correlate(a, b, mode="full")
    return np.max(np.abs(c)) / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() <= rel * scale, (
        what, np.abs(got - ref).max() / scale)


def _two_sources(noise=0.01, gain_b=3.0, seed=13):
    """tests/test_beamform.py's scene: a chirp at A, a colored burst at B
    (3x), white noise; returns (mix [M, N], A alone, A's signal, pa)."""
    sig_a = jsynth.chirp_burst(1024, JCFG.sample_rate_hz)
    sig_b = jsynth.colored_burst(1024, JCFG.sample_rate_hz, seed=7)
    pa, pb = _place(0.7, 0.2), _place(-0.5, -0.6)
    fa = jsynth.synth_scene(pa, MICS, signal=sig_a, noise_rms=0.0, seed=3)[0]
    fb = jsynth.synth_scene(pb, MICS, signal=sig_b, noise_rms=0.0, seed=4)[0]
    noise = np.random.default_rng(seed).normal(0, noise, fa.shape)
    return ((fa + gain_b * fb + noise).astype(np.float32),
            fa.astype(np.float32), sig_a, pa)


@pytest.mark.parametrize("pos,sphere", [
    ((0.4, -0.5), True), ((0.4, -0.5), False), ((0.3, 0.2, 0.9), True)])
def test_source_delays_match_reference(pos, sphere):
    pos = np.asarray(pos, np.float32)
    batch = np.stack([pos, pos * 0.5, -pos])
    for p in (pos, batch):
        ref = jbf.source_delays(jnp.asarray(p), MICS, JCFG, height=1.1,
                                constrain_sphere=sphere)
        got = tbf.source_delays(torch.from_numpy(p), MICS, TCFG, height=1.1,
                                constrain_sphere=sphere)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-9)
    # mics as a tensor, as the localizers pass them
    got = tbf.source_delays(torch.from_numpy(pos),
                            torch.as_tensor(MICS, dtype=torch.float32), TCFG)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jbf.source_delays(jnp.asarray(pos), MICS, JCFG)), atol=1e-9)


@pytest.mark.parametrize("method,kw", [
    ("das", {}), ("mvdr", {}), ("mvdr", dict(smooth_bins=4,
                                             diagonal_loading=1e-1))])
def test_extract_matches_reference(method, kw):
    """Two frames of the interferer scene at batch shape [2, M, N]."""
    mix, _, _, pa = _two_sources()
    frames = np.stack([mix, mix[:, ::-1].copy()])
    delays = np.asarray(jbf.source_delays(jnp.asarray(pa), MICS, JCFG))
    delays = np.stack([delays, delays[::-1].copy()]).astype(np.float32)
    jfn = {"das": jbf.extract_das, "mvdr": jbf.extract_mvdr}[method]
    tfn = {"das": tbf.extract_das, "mvdr": tbf.extract_mvdr}[method]
    ref = jfn(jnp.asarray(frames), jnp.asarray(delays), JCFG, **kw)
    got = tfn(torch.from_numpy(frames), torch.from_numpy(delays), TCFG, **kw)
    _close(got, ref, 1e-5, method)


def test_das_snr_gain_and_mvdr_null_on_the_port():
    """tests/test_beamform.py's properties, on the port's outputs."""
    sig = jsynth.chirp_burst(1024, TCFG.sample_rate_hz)
    pos = _place(0.6, 0.3)
    clean = jsynth.synth_scene(pos, MICS, signal=sig, noise_rms=0.0,
                               seed=11)[0]
    noisy = clean + np.random.default_rng(11).normal(0, 0.2, clean.shape)
    delays = tbf.source_delays(torch.from_numpy(pos), MICS, TCFG)

    def das(x):
        return tbf.extract_das(torch.as_tensor(x, dtype=torch.float32),
                               delays, TCFG).numpy()

    y = das(noisy)
    c_single = max(_corr(noisy[m], sig) for m in range(len(MICS)))
    assert _corr(y, sig) > c_single + 0.03
    gain_db = 10 * np.log10(np.var(noisy[0] - clean[0])
                            / np.var(y - das(clean)))
    assert gain_db > 4.0, gain_db

    mix, fa, sig_a, pa = _two_sources()
    delays = tbf.source_delays(torch.from_numpy(pa), MICS, TCFG)
    mv = tbf.extract_mvdr(torch.from_numpy(mix), delays, TCFG).numpy()
    d = tbf.extract_das(torch.from_numpy(mix), delays, TCFG).numpy()
    assert _corr(mv, sig_a) > 0.6
    assert _corr(mv, sig_a) > _corr(d, sig_a) + 0.15
    mv_clean = tbf.extract_mvdr(torch.from_numpy(fa), delays, TCFG).numpy()
    assert _corr(mv_clean, sig_a) > 0.98
    ref = tbf.extract_das(torch.from_numpy(fa), delays, TCFG).numpy()

    def resid(v):
        return float(np.var(v - ref * (np.dot(v, ref) / np.dot(ref, ref))))

    assert resid(mv) < 0.6 * resid(d)


@pytest.mark.parametrize("method", ["das", "mvdr"])
def test_localizer_extract_matches_reference(method):
    """``xy`` omitted: each package localizes, then steers at the solver's
    lift; and at a given ``xy``, the same steer."""
    sig = jsynth.chirp_burst(1024, JCFG.sample_rate_hz)
    frames = np.concatenate([jsynth.synth_scene(
        _place(x, y), MICS, signal=sig, noise_rms=0.02, seed=31 + i)
        for i, (x, y) in enumerate(((0.5, 0.4), (-0.3, 0.6)))]).astype(
            np.float32)
    jloc = JLocalizer.create(MICS, JCFG)
    tloc = Localizer.create(MICS, TCFG, device="cpu")
    ref = jloc.extract(jnp.asarray(frames), method=method)
    got = tloc.extract(torch.from_numpy(frames), method=method)
    _close(got, ref, 1e-4, "xy omitted")
    assert _corr(got.numpy()[0], sig) > (0.95 if method == "das" else 0.9)
    xy = np.array([[0.5, 0.4], [-0.3, 0.6]], np.float32)
    _close(tloc.extract(torch.from_numpy(frames), xy, method=method),
           jloc.extract(jnp.asarray(frames), jnp.asarray(xy), method=method),
           1e-5, "xy given")
    with pytest.raises(ValueError, match="device"):
        tloc.extract(frames, xy)


def _moving_scene(mics, path_xy, t_total, fs=50_000.0, c=343.0, seed=0,
                  noise=0.05):
    """tests/test_extraction_streaming.py's piecewise-static moving
    source (band-limited noise, per-segment fractional delays)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal(t_total).astype(np.float32)
    spec = np.fft.rfft(src)
    f = np.fft.rfftfreq(t_total, 1 / fs)
    spec[(f < 300) | (f > 8000)] = 0
    src = np.fft.irfft(spec, t_total).astype(np.float32)
    m = mics.shape[0]
    out = np.zeros((m, t_total), np.float32)
    seg = t_total // len(path_xy)
    for s, xy in enumerate(path_xy):
        pos = np.array([xy[0], xy[1], 1.0], np.float32)
        d = np.linalg.norm(pos - mics, axis=-1)
        tau = (d - d.mean()) / c * fs
        sl = slice(s * seg, (s + 1) * seg if s < len(path_xy) - 1
                   else t_total)
        block = src[sl]
        bspec = np.fft.rfft(block)
        fr = np.fft.rfftfreq(block.shape[0])
        for mi in range(m):
            out[mi, sl] += np.fft.irfft(
                bspec * np.exp(-2j * np.pi * fr * tau[mi]), block.shape[0])
    out += noise * rng.standard_normal(out.shape).astype(np.float32)
    return src, out


def _snr_db(ref, x):
    ref = ref - ref.mean()
    x = x - x.mean()
    g = np.dot(x, ref) / max(np.dot(ref, ref), 1e-30)
    err = x - g * ref
    return 10 * np.log10(np.dot(x, x) / max(np.dot(err, err), 1e-30))


SQ = np.asarray(jgeo.square_array(0.3), np.float32)
SQ3 = np.concatenate([SQ, np.zeros((4, 1), np.float32)], -1)
PATH = [(-0.5, -0.3), (-0.2, 0.1), (0.2, 0.3), (0.5, 0.5)]


@pytest.mark.parametrize("method,kw", [("das", {}),
                                       ("mvdr", dict(smooth_bins=5))])
def test_streaming_extractor_matches_reference(method, kw):
    """``run`` on the moving scene with a per-chunk steer, 8,192 samples
    in chunks of 512; then two steps from a mid-stream state carried across
    both ways (``utils.convert``)."""
    src, stream = _moving_scene(SQ3, PATH, 8192, noise=0.02)
    xys = np.asarray([PATH[min(i // 4, 3)] for i in range(17)], np.float32)
    jx = jex.StreamingExtractor.create(SQ, method=method, **kw)
    tx = tex.StreamingExtractor.create(SQ, method=method, device="cpu", **kw)
    ref = jx.run(stream, xys, chunk_size=512)
    got = tx.run(stream, xys, chunk_size=512)
    _close(got, ref, 1e-5, "run")
    jst = jx.init_state()
    for i in range(3):
        jst, _ = jx.step(jst, jnp.asarray(stream[:, i * 512:(i + 1) * 512]),
                         xys[i])
    tst = convert.extractor_state_from_reference(
        {k: np.asarray(getattr(jst, k))
         for k in ("in_tail", "out_tail", "delays")}, "cpu")
    for i in range(3, 5):
        c = stream[:, i * 512:(i + 1) * 512]
        jst, jy = jx.step(jst, jnp.asarray(c), xys[i])
        tst, ty = tx.step(tst, torch.from_numpy(c), torch.from_numpy(xys[i]))
        _close(ty, jy, 1e-5, f"step {i}")
    back = convert.extractor_state_to_numpy(tst)
    for k in ("in_tail", "out_tail", "delays"):
        _close(back[k], getattr(jst, k), 1e-5, k)


def test_streaming_extractor_properties():
    """The JAX tests' properties on the port: zero-delay reconstruction,
    chunk-size invariance, the moving steer's glide, MVDR over DAS on an
    interferer."""
    ex = tex.StreamingExtractor.create(SQ, device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal(4096).astype(np.float32)
    y = ex.run(np.broadcast_to(x, (4, 4096)).copy(), np.zeros(2),
               chunk_size=512)
    np.testing.assert_allclose(y[512:-512], x[512:-512], atol=2e-4)

    stream = rng.standard_normal((4, 4096)).astype(np.float32)
    xy = np.array([0.4, 0.3], np.float32)
    np.testing.assert_allclose(ex.run(stream, xy, chunk_size=256)[2048:],
                               ex.run(stream, xy, chunk_size=1024)[2048:],
                               atol=1e-5)

    src, stream = _moving_scene(SQ3, PATH, 16384, noise=0.02)
    xys = np.asarray([PATH[min(i // 8, 3)] for i in range(32)], np.float32)
    sl = slice(1024, 16384 - 1024)
    snr_track = _snr_db(src[sl], ex.run(stream, xys)[sl])
    snr_static = _snr_db(src[sl], ex.run(stream, xys[0])[sl])
    assert snr_track > snr_static + 3.0 and snr_track > 10.0

    src, s_stream = _moving_scene(SQ3, [(0.5, 0.4)], 4096, seed=4, noise=0.0)
    _, i_stream = _moving_scene(SQ3, [(-0.6, -0.5)], 4096, seed=5, noise=0.0)
    stream = s_stream + 3.0 * i_stream + 0.01 * np.random.default_rng(
        6).standard_normal(s_stream.shape).astype(np.float32)
    xy = np.array([0.5, 0.4], np.float32)
    sl = slice(1024, 4096 - 1024)
    snr_das = _snr_db(src[sl], ex.run(stream, xy)[sl])
    mv = tex.StreamingExtractor.create(SQ, method="mvdr", device="cpu")
    assert _snr_db(src[sl], mv.run(stream, xy)[sl]) > snr_das + 1.0


def test_extractor_step_many_matches_loop_and_validates():
    ex = tex.StreamingExtractor.create(SQ, device="cpu")
    rng = np.random.default_rng(3)
    chunks = torch.from_numpy(rng.standard_normal((3, 4, 512)).astype(
        np.float32))
    xys = torch.tensor([[0.1, 0.2], [-0.3, 0.4], [0.5, -0.1]])
    states, ys = ex.step_many(ex.init_states(3), chunks, xys)
    for i in range(3):
        st, y = ex.step(ex.init_state(), chunks[i], xys[i])
        np.testing.assert_allclose(ys[i].numpy(), y.numpy(), atol=1e-6)
        np.testing.assert_allclose(states.delays[i].numpy(),
                                   st.delays.numpy(), atol=1e-7)
    with pytest.raises(TypeError, match="das.*takes no extra"):
        tex.StreamingExtractor.create(SQ, method="das", smooth_bins=5,
                                      device="cpu")
    with pytest.raises(TypeError, match="unknown extract_mvdr"):
        tex.StreamingExtractor.create(SQ, method="mvdr", smooth_bin=5,
                                      device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        tex.StreamingExtractor.create(SQ, method="gsc", device="cpu")
    with pytest.raises(TypeError):
        tex.StreamingExtractor.create(SQ)
    tex.StreamingExtractor.create(SQ, method="mvdr", smooth_bins=5,
                                  device="cpu")
    long = tex.StreamingExtractor.create(SQ, frame=2048, hop=512,
                                         device="cpu")
    assert long.latency_samples == 1536
    x = rng.standard_normal(8192).astype(np.float32)
    y = long.run(np.broadcast_to(x, (4, 8192)).copy(), np.zeros(2))
    assert y.shape == (8192,)
    np.testing.assert_allclose(y[2048:-2048], x[2048:-2048], atol=2e-4)


TR_CFG = dict(fft_pad_mode="circular")


def _tworate_streams(n_streams=4, t=4096, burst_streams=(1, 2), seed=5):
    """tests/test_tworate.py's scene: quiet streams, a burst in some."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n_streams, 4, t)).astype(np.float32) * 0.001
    src = np.array([0.5, -0.4, 1.2])
    src = src / np.linalg.norm(src) * 1.2
    frame = jsynth.synth_scene(src, SQ, noise_rms=0.01, seed=3)[0]
    for i, s in enumerate(burst_streams):
        at = 1500 + 300 * i
        base[s, :, at:at + 1024] += frame * 30
    return base


@pytest.mark.parametrize("with_solver", [True, False])
def test_tworate_with_audio_matches_reference(with_solver):
    """Event audio [E, N] on the triggered slots against the JAX
    package's, the slot order equal; the burst recovered (correlation with
    the emitted chirp over 0.8, the JAX test's bound)."""
    streams = _tworate_streams()
    kw = dict(stream=jcfg.StreamConfig(chunk_size=512), event_capacity=2,
              with_solver=with_solver, with_audio=True)
    jtr = jstream.TwoRateStreamingLocalizer.create(
        SQ, jcfg.PipelineConfig(**TR_CFG), **kw)
    kw["stream"] = tcfg.StreamConfig(chunk_size=512)
    ttr = tstream.TwoRateStreamingLocalizer.create(
        SQ, tcfg.PipelineConfig(**TR_CFG), device="cpu", **kw)
    jst, tst = jtr.init_states(4), ttr.init_states(4)
    sig = jsynth.chirp_burst(1024, 50_000.0)
    n_acc = 0
    for i in range(0, streams.shape[-1], 512):
        c = streams[:, :, i:i + 512]
        jst, jdet = jtr.detect_many(jst, jnp.asarray(c))
        tst, tdet = ttr.detect_many(tst, torch.from_numpy(c))
        trig = np.asarray(jdet["triggered"])
        np.testing.assert_array_equal(tdet["triggered"].numpy(), trig)
        if not trig.any():
            continue
        jst, jev = jtr.localize_triggered(jst, jdet)
        tst, tev = ttr.localize_triggered(tst, tdet)
        for k in ("stream_idx", "accepted", "triggered"):
            np.testing.assert_array_equal(tev[k].numpy(), np.asarray(jev[k]))
        assert tev["audio"].shape == (2, 1024)
        on = np.asarray(jev["triggered"])
        pos = "xy" if with_solver else "xy_grid"
        np.testing.assert_allclose(tev[pos].numpy()[on],
                                   np.asarray(jev[pos])[on], atol=1e-4)
        _close(tev["audio"].numpy()[on], np.asarray(jev["audio"])[on], 1e-4,
               "audio")
        for slot in np.nonzero(np.asarray(jev["accepted"]))[0]:
            assert _corr(tev["audio"].numpy()[slot], sig) > 0.8
            n_acc += 1
    assert n_acc == 2


def test_irfft_reads_the_edge_bins_as_real():
    """``ops._device.irfft`` reads the DC and Nyquist bins as real, as
    numpy's (and the CPU's) transform does, on a spectrum that is not
    Hermitian there; the input is not written."""
    from audio_triangulation_tpu_torch.ops._device import irfft

    rng = np.random.default_rng(8)
    spec = (rng.normal(size=(3, 2, 513)) + 1j * rng.normal(size=(3, 2, 513))
            ).astype(np.complex64)
    t = torch.from_numpy(spec.copy())
    for n in (1024, 1025):
        got = irfft(t, n)
        np.testing.assert_allclose(got.numpy(), np.fft.irfft(spec, n=n),
                                   atol=1e-6)
    np.testing.assert_array_equal(t.numpy(), spec)


@pytest.mark.gpu
def test_irfft_card_matches_cpu_at_large_batch():
    """4,096 non-Hermitian spectra of 513 bins: the card within 1e-6 of
    scale of the CPU (cuFFT's batched complex-to-real transform alone adds
    the edge bins' imaginary parts: 2% of scale)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from audio_triangulation_tpu_torch.ops._device import irfft

    g = torch.Generator().manual_seed(9)
    spec = torch.randn(4096, 513, dtype=torch.complex64, generator=g)
    cpu = irfft(spec, 1024)
    _close(irfft(spec.cuda(), 1024).cpu(), cpu.numpy(), 1e-6, "irfft")
