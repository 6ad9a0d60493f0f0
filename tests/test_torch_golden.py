"""PyTorch port, the bit-exact integer path: ``utils/golden`` (the port's
copy) against the JAX package's module, and every integer op,
``localize_frames_int`` and ``localize_stream`` against the JAX package's
functions and the golden model on the same inputs.  Integer outputs are
compared with ``torch.equal`` (dtype included), never with a tolerance:
wraparound, negative shifts, saturated frames, 8- and 10-bit frame sizes.
``gpu`` cases hold the card to the CPU path bit for bit."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import localizer as jloc
from audio_triangulation_tpu.ops import (conditioning as jcond, srp as jsrp,
                                         window as jwin, xcorr as jx)
from audio_triangulation_tpu.utils import golden as jgold, synth as jsynth
from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import localizer as tloc
from audio_triangulation_tpu_torch.ops import (conditioning as tcond,
                                               srp as tsrp, window as twin,
                                               xcorr as tx)
from audio_triangulation_tpu_torch.utils import golden as tgold
from audio_triangulation_tpu_torch.utils.golden_event import golden_event

K = 46
PAIRS = np.asarray([[0, 1], [0, 2], [1, 2]], np.int32)
GOLDEN_PAIRS = ((0, 1), (0, 2), (1, 2))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _eq(got: torch.Tensor, ref) -> None:
    """``got`` equals ``ref`` (a JAX or numpy array) in dtype and bits."""
    ref = _t(ref)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert torch.equal(got.cpu(), ref)


def _u8_frames(rng, b=2, m=3, n=1024):
    """Frames like a ring's contents after a trigger (8-bit ADC, DC near
    128, a burst in the middle)."""
    base = rng.integers(100, 156, size=(b, m, n))
    t = np.arange(n)
    burst = (80 * np.sin(np.linspace(0, 60, n))
             * np.exp(-((t - n / 2) / (0.15 * n)) ** 2))
    return np.clip(base + burst, 0, 255).astype(np.uint8)


def _saturated_u8(b=2, m=3, n=1024):
    """The largest sums: square waves between the rails, 0 / 255, with
    each mic a few samples later than the one before."""
    t = np.arange(n)
    out = np.zeros((b, m, n), np.uint8)
    for i in range(b):
        for j in range(m):
            out[i, j] = np.where(((t + 3 * j + i) // (7 + i)) % 2, 255, 0)
    return out


def _saturated_i16(n=1024):
    """int16 frames at the rails, +32,767 / -32,768, and one all at
    -32,768: the largest products the correlation can sum."""
    t = np.arange(n)
    a = np.where((t // 5) % 2, 32767, -32768).astype(np.int16)
    b = np.roll(a, 9)
    return np.stack([a, b, np.full(n, -32768, np.int16)])[None]


# ----------------------------------------------------------------------
# utils/golden: the port's copy against the JAX package's module
# ----------------------------------------------------------------------

def _golden_case(mod, name, rng):
    """One function of a golden module on seeded inputs -> numpy outputs."""
    if name == "window_table_q15":
        return [mod.window_table_q15(), mod.window_table_q15(256, 3.0)]
    if name == "RollingBuffer":
        out = []
        for bits in (8, 10):
            r = mod.RollingBuffer(size_bits=bits)
            x = rng.integers(0, 256, 3 * (1 << bits))
            for v in x:
                r.push(int(v))
                out.append([r.get_incoming_power(), r.get_outgoing_power()])
            frame, power = r.write_out()
            out += [frame, power, r.head, r.is_full]
        return out
    if name == "xcorr_init":
        a = rng.integers(-20000, 20000, 1024).astype(np.int16)
        b = np.roll(a, 7).astype(np.int16)
        return [*mod.xcorr_init(a, b), *mod.xcorr_init(a, b, taper=False)]
    if name == "xcorr_average":
        est = rng.integers(-10**12, 10**12, 93).astype(np.int64)
        new = rng.integers(-10**12, 10**12, 93).astype(np.int64)
        return [v for dt in (0.05, 0.5, 3.0)
                for v in mod.xcorr_average(est, new, dt)]
    if name == "mic_locations":
        return [mod.mic_locations(), mod.mic_locations(mirror=False),
                mod.mic_locations(rotate=True),
                mod.mic_locations(0.2, 0.25, 0.3)]
    if name == "heatmap_luts":
        return [mod.heatmap_luts(mod.mic_locations())]
    if name == "srp_scores":
        luts = mod.heatmap_luts(mod.mic_locations())
        c = [rng.integers(-10**9, 10**9, 93) for _ in range(3)]
        return [mod.srp_scores(luts, *c)]
    if name == "heatmap_colors":
        return [mod.heatmap_colors(rng.integers(-10**9, 10**9, (101, 101))),
                mod.heatmap_colors(np.zeros((4, 4), np.int64))]
    if name == "GoldenPipeline":
        frame = jsynth.synth_scene(np.array([0.4, 0.3, 1.1]),
                                   mod.mic_locations(), noise_rms=0.0,
                                   seed=5)[0]
        s = rng.integers(127, 130, (3, 3000)).astype(np.float64)
        s[:, 1200:2224] += 110.0 * frame
        s = np.clip(np.round(s), 0, 255).astype(np.int64)
        gp = mod.GoldenPipeline()
        t = gp.detect_index(s)
        ev = gp.process_event(0.1)
        ev2 = gp.process_event(0.3)
        return [t, *ev.values(), *ev2.values()]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "window_table_q15", "RollingBuffer", "xcorr_init", "xcorr_average",
    "mic_locations", "heatmap_luts", "srp_scores", "heatmap_colors",
    "GoldenPipeline"])
def test_golden_copy_matches_reference(name):
    ours = _golden_case(tgold, name, np.random.default_rng(3))
    ref = _golden_case(jgold, name, np.random.default_rng(3))
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b)


def test_golden_copy_imports_no_jax():
    imports = [ln.split() for ln in open(tgold.__file__)
               if ln.startswith(("import ", "from "))]
    assert all(w[1].split(".")[0] not in ("jax", "audio_triangulation_tpu")
               for w in imports), imports


# ----------------------------------------------------------------------
# the integer ops
# ----------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 10])
def test_dc_remove_int(rng, bits):
    n = 1 << bits
    frames = _u8_frames(rng, n=n).astype(np.int16)
    # negative sums: the offset is a floor (an arithmetic shift)
    neg = rng.integers(-300, 40, size=(2, 3, n)).astype(np.int16)
    for x in (frames, neg):
        got = tcond.dc_remove_int(_t(x), bits)
        _eq(got, jcond.dc_remove_int(jnp.asarray(x), bits))
        for b in range(x.shape[0]):
            for m in range(x.shape[1]):
                r = tgold.RollingBuffer(size_bits=bits)
                r.buffer[:] = x[b, m]
                _eq(got[b, m], r.write_out()[0])


def test_normalize_shift8_int_wraps(rng):
    """|x| >= 128 wraps in int16, as the firmware's ``x << 8`` does."""
    x = rng.integers(-300, 300, size=(4, 1024)).astype(np.int16)
    x[:, :6] = [-255, -129, -128, 127, 128, 255]
    got = tcond.normalize_shift8_int(_t(x))
    _eq(got, jcond.normalize_shift8_int(jnp.asarray(x)))
    _eq(got, np.stack([tgold.normalize_shift8(f) for f in x]))
    assert got[0, :6].tolist() == [256, 32512, -32768, 32512, -32768, -256]


def test_normalize_full_range_int(rng):
    x = rng.integers(-3000, 3000, size=(5, 1024)).astype(np.int16)
    x[3] = 0  # silent frame: scale 0
    x[4, :] = -5
    x[4, 7] = -32768  # |x| = 2^15: scale (32767 << 15) // 32768
    got = tcond.normalize_full_range_int(_t(x))
    _eq(got, jcond.normalize_full_range_int(jnp.asarray(x)))
    _eq(got, np.stack([tgold.normalize_full_range(f) for f in x]))


def test_frame_power(rng):
    x = _u8_frames(rng).astype(np.int16)
    _eq(tcond.frame_power_int(_t(x)), jcond.frame_power_int(jnp.asarray(x)))
    # float frames of small integers: every partial sum exact, any order
    xf = rng.integers(-64, 64, size=(3, 4, 1024)).astype(np.float32)
    _eq(tcond.frame_power(_t(xf)), jcond.frame_power(jnp.asarray(xf)))


def test_q15_window(rng):
    w = twin.dpss_window(1024)
    q = twin.q15_quantize(w)
    np.testing.assert_array_equal(q, jwin.q15_quantize(w))
    np.testing.assert_array_equal(q, tgold.window_table_q15())
    assert q.dtype == np.int32
    x = rng.integers(-32768, 32768, size=(3, 1024)).astype(np.int16)
    x[0, :4] = [-32768, 32767, -1, 1]
    got = twin.apply_window_q15(_t(x), _t(q))
    _eq(got, jwin.apply_window_q15(jnp.asarray(x), jnp.asarray(q)))
    _eq(got, np.stack([tgold.apply_window(f, q) for f in x]))
    # an 8-bit frame takes every fourth entry of the 1,024-entry table
    x8 = x[:, :256]
    _eq(twin.apply_window_q15(_t(x8), _t(q[::4])),
        np.stack([tgold.apply_window(f, q) for f in x8]))


def _xcorr_inputs(rng, kind):
    if kind == "random":
        a = rng.integers(-20000, 20000, size=1024).astype(np.int16)
        b = (np.roll(a, 7) + rng.integers(-500, 500, size=1024)).astype(
            np.int16)
        return np.stack([a, b, np.roll(a, -5)])[None]
    if kind == "saturated":
        return _saturated_i16()
    if kind == "bits8":
        return rng.integers(-32768, 32768, size=(2, 3, 256)).astype(np.int16)
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["random", "saturated", "bits8"])
def test_xcorr_time_int_and_taper(rng, kind):
    x = _xcorr_inputs(rng, kind)
    raw = tx.xcorr_time_int(_t(x), _t(PAIRS), K)
    jraw = jx.xcorr_time_int(jnp.asarray(x), jnp.asarray(PAIRS), K)
    _eq(raw, jraw)
    shifts = tx.best_lag(raw, K)
    _eq(shifts, jx.best_lag(jraw, K))
    tap = tx.peak_taper_int(raw, K)
    _eq(tap, jx.peak_taper_int(jraw, K))
    for b in range(x.shape[0]):
        for p, (i, j) in enumerate(GOLDEN_PAIRS):
            c, s = tgold.xcorr_init(x[b, i], x[b, j], taper=False)
            _eq(raw[b, p], c)
            assert int(shifts[b, p]) == s
            _eq(tap[b, p], tgold.xcorr_init(x[b, i], x[b, j])[0])
    if kind == "saturated":  # the sums reach 2^40's order
        assert int(raw.abs().max()) > 1 << 39


def test_xcorr_time_int_chunks(rng, monkeypatch):
    """A chunk of frames at a time gives what one pass gives."""
    x = rng.integers(-32768, 32768, size=(5, 3, 256)).astype(np.int16)
    whole = tx.xcorr_time_int(_t(x), _t(PAIRS), K)
    monkeypatch.setattr(tx, "XCORR_INT_CHUNK_BYTES", 1)
    _eq(tx.xcorr_time_int(_t(x), _t(PAIRS), K), whole)
    with pytest.raises(TypeError, match="int16"):
        tx.xcorr_time_int(_t(x.astype(np.int64)), _t(PAIRS), K)


def test_best_lag_int64_tie_takes_first():
    corr = np.zeros((2, 93), np.int64)
    corr[1, 10] = corr[1, 50] = 1000
    _eq(tx.best_lag(_t(corr), K), np.asarray([-46, 10 - 46], np.int32))


@pytest.mark.parametrize("dt", [0.05, 0.1, 0.5, 3.0])
def test_ema_update_int(rng, dt):
    est = rng.integers(-10**12, 10**12, size=(2, 93)).astype(np.int64)
    new = rng.integers(-10**12, 10**12, size=(2, 93)).astype(np.int64)
    got = tx.ema_update_int(_t(est), _t(new), dt)
    _eq(got, jx.ema_update_int(jnp.asarray(est), jnp.asarray(new), dt))
    for b in range(2):
        ref, best = tgold.xcorr_average(est[b], new[b], dt)
        _eq(got[b], ref)
        assert int(tx.best_lag(got[b], K)) == best


def test_srp_scores_int_and_levels(rng):
    mics = tgold.mic_locations()
    luts = tgold.heatmap_luts(mics)
    lut_flat = luts.reshape(3, -1).astype(np.int32)
    corr = rng.integers(-10**12, 10**12, size=(2, 3, 93)).astype(np.int64)
    got = tsrp.srp_scores_int(_t(corr), _t(lut_flat))
    _eq(got, jsrp.srp_scores_int(jnp.asarray(corr), jnp.asarray(lut_flat)))
    levels = tsrp.quantize_heatmap(got)
    _eq(levels, jsrp.quantize_heatmap(jsrp.srp_scores_int(
        jnp.asarray(corr), jnp.asarray(lut_flat))))
    for b in range(2):
        ref = tgold.srp_scores(luts, *corr[b])
        _eq(got[b].reshape(101, 101), ref)
        _eq(levels[b].reshape(101, 101), tgold.heatmap_colors(ref))
    neg = -got.abs()  # all scores negative: the thresholds shift down
    _eq(tsrp.quantize_heatmap(neg),
        jsrp.quantize_heatmap(jnp.asarray(neg.numpy())))


# ----------------------------------------------------------------------
# the event burst end to end
# ----------------------------------------------------------------------

def _burst_inputs(bits):
    n = 1 << bits
    table = tgold.window_table_q15()
    luts = tgold.heatmap_luts(tgold.mic_locations())
    return (table[:: 1024 // n], luts.reshape(3, -1).astype(np.int32), luts,
            tcfg.PipelineConfig(frame_size_bits=bits),
            jcfg.PipelineConfig(frame_size_bits=bits))


@pytest.mark.parametrize("kind,bits", [("burst", 10), ("burst", 8),
                                       ("saturated", 10)])
def test_localize_frames_int(rng, kind, bits):
    n = 1 << bits
    frames = (_u8_frames(rng, b=3, n=n) if kind == "burst"
              else _saturated_u8(n=n))
    table, lut_flat, luts, tc, jc = _burst_inputs(bits)
    got = tloc.localize_frames_int(_t(frames), _t(PAIRS), _t(table),
                                   _t(lut_flat), tc)
    ref = jloc.localize_frames_int(
        jnp.asarray(frames), jnp.asarray(PAIRS), jnp.asarray(table),
        jnp.asarray(lut_flat), jc)
    assert sorted(got) == sorted(ref)
    for k in ref:
        _eq(got[k], ref[k])
    for b in range(frames.shape[0]):
        ev = golden_event(frames[b], luts, bits)
        assert sorted(ev) == sorted(got)
        for k in ("frames_conditioned", "correlograms", "correlograms_raw",
                  "scores", "heat_levels"):
            _eq(got[k][b], ev[k])
        assert got["best_shift"][b].tolist() == ev["best_shift"].tolist()
        assert bool(got["gate"][b]) == (
            int((ev["best_shift"].astype(np.int64) ** 2).sum()) > 4)
        assert bool(got["gate"][b]) == bool(ev["gate"])


def test_golden_pipeline_event_equals_localize_frames_int(rng):
    """The golden pipeline's detect-then-burst on a stream: its frames are
    the ring's contents at the trigger, and the port's path on them gives
    its correlograms, shifts and gate."""
    mics = tgold.mic_locations()
    frame = jsynth.synth_scene(np.array([0.3, -0.4, 1.0]), mics,
                               noise_rms=0.0, seed=11)[0]
    s = rng.integers(127, 130, (3, 4000)).astype(np.float64)
    s[:, 2000:3024] += 110.0 * frame
    s = np.clip(np.round(s), 0, 255).astype(np.int64)
    gp = tgold.GoldenPipeline()
    t = gp.detect_index(s)
    ev = gp.process_event(0.1)
    table, lut_flat, _, tc, _ = _burst_inputs(10)
    window = s[:, t - 1023: t + 1].astype(np.uint8)[None]
    got = tloc.localize_frames_int(_t(window), _t(PAIRS), _t(table),
                                   _t(lut_flat), tc)
    _eq(got["frames_conditioned"][0], ev["frames"])
    _eq(got["correlograms"][0], ev["new_corr"])
    assert got["best_shift"][0].tolist() == ev["new_best"].tolist()
    assert bool(got["gate"][0]) == ev["gate"]


# ----------------------------------------------------------------------
# localize_stream
# ----------------------------------------------------------------------

def _e2e_stream():
    """``tests/test_e2e.py``'s stream: three bursts in idle ADC noise."""
    rng = np.random.default_rng(71)
    mics = jgeo.reference_array()
    stream = rng.integers(127, 130, size=(3, 20000)).astype(np.float64)
    for i, at in enumerate((3000, 9000, 15000)):
        p = np.array([0.4 - 0.3 * i, 0.5, 1.2])
        src = p * (1.2 / np.linalg.norm(p))
        fr = jsynth.synth_scene(src, mics, noise_rms=0.0, seed=70 + i)[0]
        stream[:, at: at + 1024] += 110.0 * fr
    return np.clip(np.round(stream), 0, 255)


def test_localize_stream_matches_reference():
    stream = _e2e_stream()
    ref = jloc.localize_stream(JLocalizer.create(jgeo.reference_array()),
                               jnp.asarray(stream), max_events=8)
    loc = Localizer.create(geometry.reference_array(), device="cpu")
    got = tloc.localize_stream(loc, _t(stream), max_events=8)
    assert sorted(got) == sorted([*ref])
    _eq(got["trigger_idx"], ref["trigger_idx"])
    _eq(got["valid"], ref["valid"])
    assert int(got["valid"].sum()) == 3
    v = got["valid"].numpy()
    np.testing.assert_allclose(got["xy"].numpy()[v], np.asarray(ref["xy"])[v],
                               atol=2e-4)
    # a float stream with fractions: the detector truncates it to int64
    frac = stream + 0.75
    ref2 = jloc.localize_stream(JLocalizer.create(jgeo.reference_array()),
                                jnp.asarray(frac), max_events=8,
                                refractory=3000)
    got2 = tloc.localize_stream(loc, _t(frac), max_events=8,
                                refractory=3000)
    _eq(got2["trigger_idx"], ref2["trigger_idx"])
    _eq(got2["valid"], ref2["valid"])


def test_localize_stream_refuses_another_device():
    loc = Localizer.create(geometry.reference_array(), device="cpu")
    with pytest.raises(ValueError, match="localizer lives on"):
        tloc.localize_stream(loc, torch.zeros(3, 4096, device="meta"))


# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gpu_case(name, rng):
    """(function, CPU inputs) of one op, run on both devices."""
    if name == "shift8_wrap":
        x = rng.integers(-300, 300, size=(4, 1024)).astype(np.int16)
        return tcond.normalize_shift8_int, (_t(x),)
    if name == "dc_remove":
        return (lambda x: tcond.dc_remove_int(x, 10),
                (_t(_u8_frames(rng).astype(np.int16) - 200),))
    if name == "full_range":
        x = rng.integers(-3000, 3000, size=(4, 1024)).astype(np.int16)
        x[1] = 0
        return tcond.normalize_full_range_int, (_t(x),)
    if name == "window_q15":
        x = rng.integers(-32768, 32768, size=(3, 1024)).astype(np.int16)
        return twin.apply_window_q15, (_t(x), _t(tgold.window_table_q15()))
    if name == "xcorr_saturated":
        return (lambda x: tx.xcorr_time_int(x, _t(PAIRS).to(x.device), K),
                (_t(_saturated_i16()),))
    if name == "taper":
        x = _xcorr_inputs(rng, "random")
        return (lambda c: tx.peak_taper_int(c, K),
                (tx.xcorr_time_int(_t(x), _t(PAIRS), K),))
    if name == "ema":
        est = rng.integers(-10**12, 10**12, size=(4, 93)).astype(np.int64)
        new = rng.integers(-10**12, 10**12, size=(4, 93)).astype(np.int64)
        return lambda a, b: tx.ema_update_int(a, b, 0.1), (_t(est), _t(new))
    if name == "best_lag_tie":
        return lambda c: tx.best_lag(c, K), (torch.zeros(3, 93,
                                                         dtype=torch.int64),)
    if name == "burst":
        table, lut_flat, _, tc, _ = _burst_inputs(10)
        frames = np.concatenate([_u8_frames(rng, b=6), _saturated_u8()])
        return (lambda f, p, w, lut: tloc.localize_frames_int(f, p, w, lut,
                                                              tc),
                (_t(frames), _t(PAIRS), _t(table), _t(lut_flat)))
    raise KeyError(name)


@pytest.mark.gpu
@pytest.mark.parametrize("name", [
    "shift8_wrap", "dc_remove", "full_range", "window_q15",
    "xcorr_saturated", "taper", "ema", "best_lag_tie", "burst"])
def test_integer_ops_card_equal_cpu(cuda_device, rng, name):
    fn, args = _gpu_case(name, rng)
    cpu = fn(*args)
    card = fn(*[a.to(cuda_device) for a in args])
    if isinstance(cpu, dict):
        assert sorted(cpu) == sorted(card)
        for k in cpu:
            assert card[k].is_cuda and torch.equal(card[k].cpu(), cpu[k]), k
    else:
        assert card.is_cuda and card.dtype == cpu.dtype
        assert torch.equal(card.cpu(), cpu)


@pytest.mark.gpu
def test_localize_stream_card_equal_cpu(cuda_device):
    """Card against CPU, and no read back to the host inside the call
    (after a first call has put the constants on the card)."""
    stream = _t(_e2e_stream())
    cpu = tloc.localize_stream(
        Localizer.create(geometry.reference_array(), device="cpu"), stream,
        max_events=8)
    loc = Localizer.create(geometry.reference_array(), device=cuda_device)
    on_card = stream.to(cuda_device)
    tloc.localize_stream(loc, on_card, max_events=8)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = tloc.localize_stream(loc, on_card, max_events=8)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(card["trigger_idx"].cpu(), cpu["trigger_idx"])
    assert torch.equal(card["valid"].cpu(), cpu["valid"])
    v = cpu["valid"]
    assert float((card["xy"].cpu()[v] - cpu["xy"][v]).abs().max()) <= 2e-4
