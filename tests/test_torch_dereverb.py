"""PyTorch port, ``ops/dereverb`` against the JAX package's, on the same
numpy inputs: 3 mics in a reverberant room (``utils.room``, RT60 0.45 s,
``max_order=2``), frames of 256, 3 taps.

Tolerances, each relative to the output's scale (its largest magnitude):
``sqrt_hann`` and ``_tap_stack`` exactly; the STFT, the iSTFT and their
non-dividing-hop fallback within 1e-5 (the iSTFT divides by the small
window sums of the edge samples: measured 2.5e-6); block WPE (``wpe_stft``,
``wpe``) of one pass within 1e-5, of two and three passes placed in
float64 (``test_block_wpe_matches_reference``); the RLS path (``wpe_rls_step`` on a seeded mid-stream state,
``wpe_rls``, ``StreamingDereverb.step`` / ``step_many`` / ``run`` and a
stream continued from the JAX package's state through ``utils.convert``)
within 1e-4 over at most 8 STFT frames, but ``wpe_rls``'s carried state,
placed in float64 (``test_wpe_rls_matches_reference_and_carries_state``).  Over longer runs the RLS inverse,
updated by a difference and never re-symmetrised, lets both packages'
float32 drift from float64 alike: ``test_rls_drift_is_float32_rounding``
holds each package within 1e-3 of float64 over 61 frames, and the two
within 1e-3 of each other.  The JAX tests' properties hold on the port:
the STFT round trip, WPE near a no-op on anechoic input (every TDOA
kept), the stream equal to one long ``wpe_rls`` and to itself at any
chunk size, ``step_many`` equal to a loop of ``step``."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.ops import dereverb as jdr
from audio_triangulation_tpu.utils import room as jroom
from audio_triangulation_tpu_torch.ops import dereverb as tdr
from audio_triangulation_tpu_torch.utils import convert

FS = 50_000.0
KW = dict(frame=256, hop=64, taps=3, delay=2)


def _bursty_band_noise(n, seed=3, lo=300.0, hi=8000.0):
    """tests/test_dereverb.py's band noise with a speech-like on/off
    envelope."""
    rng = np.random.default_rng(seed)
    spec = np.fft.rfft(rng.normal(size=n))
    f = np.fft.rfftfreq(n, 1.0 / FS)
    spec[(f < lo) | (f > hi)] = 0
    sig = np.fft.irfft(spec, n)
    env = (np.sin(2 * np.pi * np.arange(n) / FS / 0.065) > 0.1).astype(float)
    k = int(0.002 * FS)
    win = np.hanning(2 * k + 1)
    sig = sig * np.convolve(env, win / win.sum(), mode="same")
    return sig / np.abs(sig).max()


def _reverb_scene(n=4096, n_mics=3, seed=3):
    """[M, n] float32: the band noise at (4.2, 3.4, 1.2) in a 6 x 5 x 3 m
    room of RT60 0.45 s, heard by ``n_mics`` of a 0.25 m circle."""
    size = (6.0, 5.0, 3.0)
    rm = jroom.ShoeboxRoom(size=size, absorption=jroom.absorption_for_rt60(
        size, 0.45), max_order=2)
    ang = 2 * np.pi * np.arange(n_mics) / n_mics
    mic3 = np.stack([3.0 + 0.25 * np.cos(ang), 2.5 + 0.25 * np.sin(ang),
                     np.full(n_mics, 1.2)], -1)
    out = jroom.simulate([4.2, 3.4, 1.2], mic3, rm, n=n,
                         signal=_bursty_band_noise(n, seed), noise_rms=2e-3,
                         seed=seed)[0]
    return out.astype(np.float32)


def _close(got, ref, rel, what):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rel * scale, (what, err / scale)


def test_window_and_tap_stack_equal():
    for frame in (256, 300, 1024):
        np.testing.assert_array_equal(tdr.sqrt_hann(frame),
                                      jdr.sqrt_hann(frame))
    rng = np.random.default_rng(0)
    y = (rng.normal(size=(5, 2, 9)) + 1j * rng.normal(size=(5, 2, 9))
         ).astype(np.complex64)
    for taps, delay in ((3, 2), (4, 1), (2, 8)):
        np.testing.assert_array_equal(
            tdr._tap_stack(torch.from_numpy(y), taps, delay).numpy(),
            np.asarray(jdr._tap_stack(jnp.asarray(y), taps, delay)))


@pytest.mark.parametrize("frame,hop", [(256, 64), (512, 128), (300, 100)])
def test_stft_istft_match_reference(frame, hop):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 2048)).astype(np.float32)
    window = None
    if frame % hop:  # the non-dividing-hop fallback, a COLA-ish window
        window = np.sqrt(np.hanning(frame)).astype(np.float32)
    spec = tdr.stft(torch.from_numpy(x), frame, hop, window=window)
    ref = jdr.stft(jnp.asarray(x), frame, hop, window=window)
    _close(spec, ref, 1e-5, "stft")
    y = tdr.istft(spec, frame, hop, window=window)
    _close(y, jdr.istft(ref, frame, hop, window=window), 1e-5, "istft")
    # the round trip: the interior is exact
    inner = slice(frame, 2048 - frame)
    np.testing.assert_allclose(y.numpy()[..., inner], x[..., inner],
                               atol=2e-4 if window is not None else 2e-5)


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_block_wpe_matches_reference(iters):
    """One pass within 1e-5 of scale.  Each further pass reweights by the
    last estimate and compounds float32 rounding: at 2-3 passes each
    package lies up to 4.6e-5 of scale from the float64 recursion
    (measured), so both are held within 1e-4 of float64 and of each
    other."""
    x = _reverb_scene()
    spec = np.moveaxis(np.array(jdr.stft(jnp.asarray(x), 256, 64)), -1, -3)
    kw = dict(taps=3, delay=2, iters=iters)
    for what, fn, arg, arg64, ref in (
            ("wpe", lambda a: tdr.wpe(a, **KW, iters=iters),
             torch.from_numpy(x), torch.from_numpy(x).double(),
             jdr.wpe(jnp.asarray(x), **KW, iters=iters)),
            ("wpe_stft", lambda a: tdr.wpe_stft(a, **kw),
             torch.from_numpy(spec),
             torch.from_numpy(spec.astype(np.complex128)),
             jdr.wpe_stft(jnp.asarray(spec), **kw))):
        got = fn(arg)
        if iters == 1:
            _close(got, ref, 1e-5, what)
            continue
        f64 = fn(arg64).numpy()
        _close(got, f64, 1e-4, f"{what}: port vs float64")
        _close(np.asarray(ref), f64, 1e-4, f"{what}: reference vs float64")
        _close(got, ref, 1e-4, what)


def _gcc_tdoa(x, pairs, lo=300.0, hi=8000.0, max_lag=80):
    """tests/test_dereverb.py's band-limited GCC-PHAT integer TDOA."""
    x = np.asarray(x, np.float64)
    n = x.shape[-1]
    spec = np.fft.rfft(x, 2 * n)
    f = np.fft.rfftfreq(2 * n, 1.0 / FS)
    mask = (f >= lo) & (f <= hi)
    est = []
    for i, j in pairs:
        c = spec[i] * np.conj(spec[j])
        lagd = np.fft.irfft(c / np.maximum(np.abs(c), 1e-12) * mask, 2 * n)
        idx = np.concatenate([np.arange(0, max_lag + 1),
                              np.arange(2 * n - max_lag, 2 * n)])
        k = idx[np.argmax(lagd[idx])]
        est.append(float(k if k <= max_lag else k - 2 * n))
    return np.array(est)


def test_wpe_anechoic_is_near_noop():
    """Pure delays + noise: WPE passes the direct path through and keeps
    every TDOA (the JAX test's property, on 8,192 samples)."""
    sig = _bursty_band_noise(8192, seed=0)
    rng = np.random.default_rng(7)
    x = np.stack([sig, np.roll(sig, 17), np.roll(sig, -9)])
    x = (x + rng.normal(size=x.shape) * 1e-3).astype(np.float32)
    y = tdr.wpe(torch.from_numpy(x), frame=512, hop=128, taps=4, delay=4,
                iters=2).numpy()
    pairs = [(0, 1), (0, 2)]
    np.testing.assert_array_equal(_gcc_tdoa(y, pairs), _gcc_tdoa(x, pairs))
    for m in range(3):
        assert np.corrcoef(y[m, 1000:7000], x[m, 1000:7000])[0, 1] > 0.97


def _random_wpe_state(rng, f=9, m=2, taps=3, delay=2):
    """A seeded mid-stream RLS state: Hermitian positive kinv, a filter
    and a history."""
    mk = m * taps
    a = rng.normal(size=(f, mk, mk)) + 1j * rng.normal(size=(f, mk, mk))
    kinv = (a @ a.conj().transpose(0, 2, 1) / mk + np.eye(mk) * 5.0)
    g = 0.1 * (rng.normal(size=(f, mk, m)) + 1j * rng.normal(size=(f, mk, m)))
    hist = rng.normal(size=(f, m, taps + delay - 1)) + 1j * rng.normal(
        size=(f, m, taps + delay - 1))
    return {k: v.astype(np.complex64) for k, v in
            dict(kinv=kinv, g=g, hist=hist).items()}


def test_wpe_rls_init_and_step_match_reference():
    ref0 = jdr.wpe_rls_init(9, 2, taps=3, delay=2)
    got0 = tdr.wpe_rls_init(9, 2, device="cpu", taps=3, delay=2)
    for k in ("kinv", "g", "hist"):
        np.testing.assert_array_equal(getattr(got0, k).numpy(),
                                      np.asarray(getattr(ref0, k)))
    rng = np.random.default_rng(2)
    arrays = _random_wpe_state(rng)
    jst = jdr.WpeState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = tdr.WpeState(**{k: torch.from_numpy(v) for k, v in arrays.items()})
    for _ in range(8):
        y = (rng.normal(size=(9, 2)) + 1j * rng.normal(size=(9, 2))
             ).astype(np.complex64)
        jst, je = jdr.wpe_rls_step(jst, jnp.asarray(y), alpha=0.99)
        tst, te = tdr.wpe_rls_step(tst, torch.from_numpy(y), alpha=0.99)
        _close(te, je, 1e-4, "e")
        for k in ("kinv", "g", "hist"):
            _close(getattr(tst, k), getattr(jst, k), 1e-4, k)
    with pytest.raises(ValueError):
        tdr.wpe_rls_init(9, 2, device="cpu", taps=4, delay=0)


def test_wpe_rls_matches_reference_and_carries_state():
    """Two blocks of 8 frames, as the reference's streaming usage: the
    second continues the first's state, both packages (and a float64 run)
    from the reference's.  The outputs within 1e-4 of scale (measured
    4.8e-6).  The carried inverse and filter are placed in float64: each
    package's within 2e-4 of scale of the float64 recursion's (measured
    up to 6.9e-5 over these 16 frames), the two within 2e-4 of each other
    (measured 1.1e-4)."""
    x = _reverb_scene(n=2 * (256 + 7 * 64))
    half = x.shape[-1] // 2
    st, st64 = None, None
    jst = None
    for blk in (x[:, :half], x[:, half:]):
        jy, jst = jdr.wpe_rls(jnp.asarray(blk), **KW, state=jst)
        ty, tst = tdr.wpe_rls(torch.from_numpy(blk), **KW, state=st)
        _, st64 = tdr.wpe_rls(torch.from_numpy(blk).double(), **KW,
                              state=st64)
        _close(ty, jy, 1e-4, "output")
        for k in ("kinv", "g"):
            f64 = getattr(st64, k).numpy()
            _close(getattr(tst, k), f64, 2e-4, f"{k}: port vs float64")
            _close(np.asarray(getattr(jst, k)), f64, 2e-4,
                   f"{k}: reference vs float64")
            _close(getattr(tst, k), getattr(jst, k), 2e-4, k)
        _close(tst.hist, jst.hist, 1e-5, "hist")  # STFT frames
        ref = {k: np.asarray(getattr(jst, k)) for k in ("kinv", "g", "hist")}
        st = tdr.WpeState(**{k: torch.from_numpy(v) for k, v in ref.items()})
        st64 = tdr.WpeState(**{k: torch.from_numpy(v.astype(np.complex128))
                               for k, v in ref.items()})
    assert tst.g.shape == (129, 9, 3)
    assert float(tst.g.abs().max()) > 0.0


def test_rls_drift_is_float32_rounding():
    """61 frames of the RLS on the room scene: the inverse is updated by a
    difference, so float32 drifts from float64; each package stays within
    1e-3 of scale of the float64 recursion, and within 1e-3 of the other."""
    x = _reverb_scene(n=256 + 60 * 64)
    jy, _ = jdr.wpe_rls(jnp.asarray(x), **KW)
    ty, _ = tdr.wpe_rls(torch.from_numpy(x), **KW)
    y64, _ = tdr.wpe_rls(torch.from_numpy(x).double(), **KW)
    _close(ty, y64.numpy(), 1e-3, "port vs float64")
    _close(np.asarray(jy), y64.numpy(), 1e-3, "reference vs float64")
    _close(ty, jy, 1e-3, "port vs reference")


def _sd(mod, **kw):
    args = dict(frame=256, hop=128, taps=3, delay=2, alpha=0.997)
    args.update(kw)
    if mod is tdr:
        args["device"] = "cpu"
    return mod.StreamingDereverb(3, **args)


def test_streaming_dereverb_matches_reference():
    """``run`` over 1,024 samples (8 STFT frames with the latency flush),
    and two steps from a mid-stream state carried across both ways."""
    x = _reverb_scene(n=1024)
    _close(_sd(tdr).run(x, chunk_size=256), _sd(jdr).run(x, chunk_size=256),
           1e-4, "run")
    jsd, tsd = _sd(jdr), _sd(tdr)
    jst = jsd.init_state()
    for i in range(2):  # into the stream on the reference, then hand over
        jst, _ = jsd.step(jst, jnp.asarray(x[:, i * 256:(i + 1) * 256]))
    tst = convert.dereverb_state_from_reference(
        {"wpe": {k: np.asarray(getattr(jst.wpe, k))
                 for k in ("kinv", "g", "hist")},
         "in_tail": np.asarray(jst.in_tail),
         "out_tail": np.asarray(jst.out_tail)}, "cpu")
    for i in range(2, 4):
        c = x[:, i * 256:(i + 1) * 256]
        jst, jy = jsd.step(jst, jnp.asarray(c))
        tst, ty = tsd.step(tst, torch.from_numpy(c))
        _close(ty, jy, 1e-4, f"step {i}")
    back = convert.dereverb_state_to_numpy(tst)
    for k in ("kinv", "g", "hist"):
        _close(back["wpe"][k], getattr(jst.wpe, k), 1e-4, k)
    _close(back["in_tail"], jst.in_tail, 1e-6, "in_tail")
    _close(back["out_tail"], jst.out_tail, 1e-4, "out_tail")


def test_streaming_equals_oneshot_and_is_chunk_invariant():
    """The JAX test's properties on the port: 256- and 1,024-sample chunks
    give the same samples, equal to one long ``wpe_rls`` over the
    lead-padded stream."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 4096)).astype(np.float32)
    kw = dict(frame=256, hop=64, taps=3, delay=2, alpha=0.997)
    y1 = _sd(tdr, **kw).run(x, chunk_size=256)
    y2 = _sd(tdr, **kw).run(x, chunk_size=1024)
    np.testing.assert_allclose(y1, y2, atol=1e-5)
    lat = kw["frame"] - kw["hop"]
    full, _ = tdr.wpe_rls(torch.from_numpy(np.pad(x, [(0, 0), (lat, 0)])),
                          **kw)
    full = full.numpy()[:, lat:]
    scale = np.abs(full).max()
    np.testing.assert_allclose(y1[:, :4096 - 256] / scale,
                               full[:, :4096 - 256] / scale, atol=1e-6)


def test_step_many_matches_per_stream_steps():
    rng = np.random.default_rng(4)
    sd = _sd(tdr)
    chunks = torch.from_numpy(rng.normal(size=(3, 3, 512)).astype(np.float32))
    states, ys = sd.step_many(sd.init_states(3), chunks)
    states, ys = sd.step_many(states, chunks.flip(-1))
    for i in range(3):
        st, _ = sd.step(sd.init_state(), chunks[i])
        st, y = sd.step(st, chunks[i].flip(-1))
        np.testing.assert_allclose(ys[i].numpy(), y.numpy(), atol=1e-6)
        np.testing.assert_allclose(states.wpe.g[i].numpy(), st.wpe.g.numpy(),
                                   atol=1e-6)
    assert dataclasses.asdict(sd.init_states(2).wpe)["kinv"].shape == (
        2, 129, 9, 9)


def test_streaming_dereverb_validates():
    with pytest.raises(ValueError, match="COLA"):
        tdr.StreamingDereverb(2, frame=512, hop=512, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        tdr.StreamingDereverb(2, frame=512, hop=100, device="cpu")
    with pytest.raises(TypeError):
        tdr.StreamingDereverb(2, frame=512, hop=128)
    sd = _sd(tdr)
    with pytest.raises(ValueError, match="mics"):
        sd.step(sd.init_state(), torch.zeros(2, 256))
    with pytest.raises(ValueError, match="multiple of hop"):
        sd.step(sd.init_state(), torch.zeros(3, 200))
    with pytest.raises(TypeError, match="Tensor"):
        sd.step(sd.init_state(), np.zeros((3, 256), np.float32))


@pytest.mark.gpu
def test_streaming_dereverb_card_matches_cpu():
    """The CLI's configuration (frame 1,024, hop 256, taps 10, delay 4) on
    the card against the CPU path over 6 chunks of 512 on 4 streams of the
    room scene: outputs within 1e-4 of scale, TF32 off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = np.stack([_reverb_scene(n=3072, seed=s) for s in range(4)])
    outs = []
    for dev in ("cpu", "cuda"):
        sd = tdr.StreamingDereverb(3, frame=1024, hop=256, device=dev)
        st, ys = sd.init_states(4), []
        for i in range(6):
            st, y = sd.step_many(st, torch.from_numpy(
                x[..., i * 512:(i + 1) * 512]).to(dev))
            ys.append(y.cpu())
        outs.append(torch.cat(ys, -1).numpy())
    assert not torch.backends.cuda.matmul.allow_tf32
    _close(outs[1], outs[0], 1e-4, "card vs CPU")
