"""PyTorch port, the streaming path: the same numpy streams through the JAX
package's ``StreamingLocalizer`` / ``TwoRateStreamingLocalizer`` and the
port's, chunk by chunk, with planted events.

Held exactly: trigger flags and positions, ``events``, ``event_shifts``,
``best_shift``, event counts and the carried countdown.  Float tolerances:
``ema_corr`` and the context within 1e-5 of scale, ``tdoa_samples`` within
1e-3 lags (2e-3 where the phase slope runs: its arctangents differ in the
last bits), ``xy`` / ``xy_grid`` within 1e-4 m, ``rms_m`` within 1e-5 m,
the consistency outputs within 2e-8 s (1e-3 lags), ``xy_cov`` 1e-3
relative; the health weights (Cauchy functions of residual ratios) 5e-3
relative.  The free 3-D position ``xyz`` is held in measurement space:
its float64 predicted TDOAs within 3e-7 s of the reference's, ``xyz_rms_m``
within 5e-5 m (the 30 cm array's range is ill-conditioned; each package's
float32 solve is up to 1.2e-7 s and 2.4e-5 m from the float64 solution,
``tests/test_torch_solver_xyz.py``).  The outputs of ``n_sources=2`` and
``solve_velocity`` are held on accepted events only (elsewhere they are
read off idle noise): ``multi_valid`` exactly, ``multi_xy`` within 1e-4
m, ``multi_tdoa_samples`` within 5e-3 lags, ``multi_score`` within 2e-3
of its scale, ``multi_rms_m`` within 1e-5 m, ``multi_xy_cov`` 1e-3
relative, ``velocity`` and ``pair_rel_speed`` within 1e-3 m/s."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import streaming as jstream
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import streaming as tstream
from audio_triangulation_tpu_torch.utils import convert
from test_torch_multi import two_source_frames

EXACT = ("event", "triggered", "trigger_abs", "events", "events_found",
         "event_trigger_abs", "event_shifts", "best_shift", "event_count",
         "multi_valid")
# key -> (rtol, atol)
FLOAT = {"event_time_s": (0, 1e-6), "tdoa_samples": (0, 1e-3),
         "xy_grid": (0, 1e-4), "xy": (0, 1e-4), "rms_m": (0, 1e-5),
         "xy_cov": (1e-3, 1e-9), "consistency_rms": (0, 2e-8),
         "mic_consistency": (0, 2e-8), "pair_weight": (5e-3, 1e-5),
         "mic_weight": (5e-3, 1e-5), "xyz_rms_m": (0, 5e-5)}
# the simultaneous-source and velocity outputs: key -> (rtol, atol), held on
# accepted events only (``multi_score``'s atol is relative to its scale)
SOURCE_FLOAT = {"multi_xy": (0, 1e-4), "multi_tdoa_samples": (0, 5e-3),
                "multi_score": (0, 2e-3), "multi_rms_m": (0, 1e-5),
                "multi_xy_cov": (1e-3, 1e-10), "velocity": (0, 1e-3),
                "pair_rel_speed": (0, 1e-3)}


def _source(i):
    p = np.array([0.5 - 0.25 * i, 0.4 - 0.1 * i, 1.2])
    return p * (1.2 / np.linalg.norm(p))


def _streams(mics, n_streams, t_len, events, seed=0, dead=None,
             burst=None):
    """[S, M, T] f32 ADC counts: idle level +-1 with chirp events planted;
    ``events[s]`` lists the start samples of stream s (none: silent).
    ``burst(s, i, seed)`` gives event i of stream s as [M, 1024] (default:
    one chirp from ``_source(s + i)``)."""
    rng = np.random.default_rng(seed)
    m = mics.shape[0]
    x = rng.integers(127, 130, size=(n_streams, m, t_len)).astype(np.float64)
    for s, starts in enumerate(events):
        for i, at in enumerate(starts):
            if burst is not None:
                fr = burst(s, i, seed + 10 * s + i)
            else:
                fr = jsynth.synth_scene(_source(s + i), mics,
                                        noise_rms=0.005,
                                        seed=seed + 10 * s + i)[0]
            if dead is not None and s == dead[0]:
                fr[dead[1]] = rng.normal(0, 0.3, fr.shape[-1])
            x[s, :, at:at + 1024] += 110.0 * fr
    return np.clip(np.round(x), 0, 255).astype(np.float32)


# name -> (mics, pipeline kw, stream kw, create kw, chunk, events/stream)
MICS3 = jgeo.reference_array()
MICS6 = jgeo.circular_array(6, 0.25)
TETRA = jgeo.tetrahedral_array(0.3)
EV4 = [(700,), (1500, 3300), (), (2900,)]
CASES = {
    "default": (MICS3, {}, {}, {}, 512, EV4),
    "bandcrop_phat": (MICS3, dict(phat=True, band_hz=(800.0, 6000.0),
                                  band_crop=True), {}, {}, 512, EV4),
    "auto_band": (MICS3, dict(phat=True, band_hz="auto"), {}, {}, 512, EV4),
    "hybrid": (MICS3, dict(phat=True, subsample_method="hybrid"), {}, {},
               512, EV4),
    "phase_static_band": (MICS3, dict(phat=True, band_hz=(800.0, 6000.0),
                                      subsample_method="phase"), {}, {},
                          512, EV4),
    "relative_trigger": (MICS3, dict(trigger_mode="relative"), {}, {}, 512,
                         EV4),
    # two events inside one 2,560-sample chunk, 1,300 apart (the holdoff is
    # a frame plus the refractory: 1,124)
    "two_events_refractory": (
        MICS3, {}, dict(max_events_per_chunk=2, refractory_samples=100), {},
        2560, [(2700, 4000), (300, 1800, 4400), (), (5200, 6600)]),
    "health6": (MICS6, dict(phat=True), dict(health_weighting=True), {},
                1024, [(700, 3000), (1500, 4000), (), (900, 3500)]),
    "gather": (MICS3, {}, {}, dict(srp_form="gather"), 512, EV4),
    "matmul_no_solver": (MICS3, dict(phat=True), {},
                         dict(srp_form="matmul", with_solver=False), 512,
                         EV4),
    # lag window widened to the tetrahedron's 0.49 m baselines
    "tetra_solve_xyz": (TETRA, dict(max_shift_samples=jgeo.max_lag_for_array(
        TETRA, jcfg.PipelineConfig())), dict(solve_xyz=True), {}, 512, EV4),
}


def _predicted_tdoas(xyz, mics):
    """float64 TDOAs [..., P] (seconds) of positions [..., 3]."""
    pairs = jgeo.mic_pairs(mics.shape[0])
    mic3 = np.zeros((mics.shape[0], 3))
    mic3[:, :mics.shape[1]] = mics
    d = np.linalg.norm(np.asarray(xyz, np.float64)[..., None, :] - mic3,
                       axis=-1)
    return (d[..., pairs[:, 1]] - d[..., pairs[:, 0]]) / 343.0


def _pair(name, cases=CASES):
    mics, pkw, skw, ckw, chunk = cases[name][:5]
    skw = dict(chunk_size=chunk, **skw)
    jsl = jstream.StreamingLocalizer.create(
        mics, jcfg.PipelineConfig(**pkw), stream=jcfg.StreamConfig(**skw),
        **ckw)
    tsl = tstream.StreamingLocalizer.create(
        mics, tcfg.PipelineConfig(**pkw), stream=tcfg.StreamConfig(**skw),
        device="cpu", **ckw)
    assert tsl.srp_form == jsl.srp_form
    return jsl, tsl


def _state_np(jstate):
    return {f.name: np.asarray(getattr(jstate, f.name))
            for f in dataclasses.fields(jstate)}


def _compare_out(ref, got, where, mics=MICS3):
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, (where, k, g.shape, r.shape)
        if k in SOURCE_FLOAT:
            compare_source_key(ref, k, g, where)
        elif k == "xyz":
            np.testing.assert_allclose(
                _predicted_tdoas(g, mics), _predicted_tdoas(r, mics),
                atol=3e-7, err_msg=f"{where} {k}")
        elif k in EXACT:
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")
        else:
            rtol, atol = FLOAT[k]
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=f"{where} {k}")


def compare_source_key(ref, k, got, where):
    """A simultaneous-source or velocity output held where it means
    something: on the slots and sources of accepted events (elsewhere it
    is read off idle noise)."""
    held = np.asarray(ref["multi_valid" if k.startswith("multi_")
                          else "event"])
    r, g = np.asarray(ref[k])[held], got[held]
    rtol, atol = SOURCE_FLOAT[k]
    if k == "multi_score":
        atol *= max(np.abs(r).max(initial=0.0), 1e-30)
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                               err_msg=f"{where} {k}")


def _compare_state(jstate, tstate, where):
    ref = _state_np(jstate)
    got = convert.stream_state_to_numpy(tstate)
    for k in ("best_shift", "suppress", "abs_sample", "event_count"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=f"{where} {k}")
    for k in ("time_s", "last_event_s"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-6)
    np.testing.assert_array_equal(got["context"], ref["context"])
    scale = max(np.abs(ref["ema_corr"]).max(), 1e-30)
    np.testing.assert_allclose(got["ema_corr"] / scale,
                               ref["ema_corr"] / scale, atol=1e-5,
                               err_msg=f"{where} ema_corr")


@pytest.mark.parametrize("name", sorted(CASES))
def test_step_many_matches_reference(name):
    """4 stacked streams over 6 or more chunks: every output of every step,
    and the carried state."""
    mics, _, skw, _, chunk, events = CASES[name]
    n_chunks = max(6, -(-8200 // chunk))
    dead = (1, 3) if name == "health6" else None
    x = _streams(mics, 4, n_chunks * chunk, events, dead=dead)
    jsl, tsl = _pair(name)
    jst, tst = jsl.init_states(4), tsl.init_states(4)
    n_events = np.zeros(4, int)
    most_in_a_chunk = 0
    for i in range(n_chunks):
        c = x[:, :, i * chunk:(i + 1) * chunk]
        jst, jout = jsl.step_many(jst, jnp.asarray(c))
        tst, tout = tsl.step_many(tst, torch.from_numpy(c))
        _compare_out(jout, tout, f"{name} chunk {i}", mics)
        n_events += tout["events"].numpy().sum(axis=-1)
        most_in_a_chunk = max(most_in_a_chunk,
                              int(tout["events"].sum(dim=-1).max()))
    _compare_state(jst, tst, name)
    # the planted events were seen, the silent stream saw none
    assert n_events.tolist() == [len(e) for e in events]
    assert most_in_a_chunk == skw.get("max_events_per_chunk", 1)
    if name == "health6":  # the dead channel of stream 1 is found
        assert int(tout["mic_weight"][1].argmin()) == 3


MICS8 = jgeo.circular_array(8, 0.15)
MICS6W = jgeo.circular_array(6, 0.35)
# the moving-source scene's array given as [M, 3] at z = 1 m: coplanar, so
# its velocity is solved in the plane
MICS6W_3D = np.concatenate([MICS6W, np.ones((6, 1), np.float32)], axis=1)
MULTI_XY = ((0.9, 0.3), (-0.7, -0.6))
MOVING_V = np.array([2.5, -1.5, 0.0])


def two_source_burst(s, i, seed):
    """Two simultaneous sources (``MULTI_XY``), 0.6 of full amplitude."""
    return 0.6 * two_source_frames(MICS8, *MULTI_XY, seed=seed)[0]


def moving_burst(mics, z=0.0):
    """A source at (0.45, 0.30) on the 1.2 m plane (``z`` above the mics'
    own plane) moving at ``MOVING_V``."""
    def burst(s, i, seed):
        return jsynth.synth_moving_scene(np.array([0.45, 0.30, 1.2 + z]),
                                         MOVING_V, mics, seed=seed)[0]
    return burst


def _velocity_kw(mics, band_crop):
    return dict(phat=True, window_enabled=False, band_hz=(700.0, 9500.0),
                band_crop=band_crop, max_shift_samples=jgeo.max_lag_for_array(
                    mics, jcfg.PipelineConfig()))


# name -> CASES' fields and the burst of an event
SOURCE_CASES = {
    "multi2": (MICS8, dict(phat=True), dict(n_sources=2), {}, 512, EV4,
               two_source_burst),
    # two event slots a chunk, and the gather form of the scoring
    "multi2_two_slots_gather": (
        MICS8, dict(phat=True), dict(n_sources=2, max_events_per_chunk=2,
                                     refractory_samples=100),
        dict(srp_form="gather"), 2560,
        [(2700, 4000), (300, 1800, 4400), (), (5200, 6600)],
        two_source_burst),
    # the spectral fold of the resampling operator
    "velocity_bandcrop": (MICS6W, _velocity_kw(MICS6W, True),
                          dict(solve_velocity=True, velocity_n_scales=9), {},
                          2048, EV4, moving_burst(MICS6W)),
    # the time-domain operator, on a planar array given as [M, 3]
    "velocity_planar_as_3d": (
        MICS6W_3D, _velocity_kw(MICS6W_3D, False),
        dict(solve_velocity=True, velocity_n_scales=9), {}, 2048, EV4,
        moving_burst(MICS6W_3D, z=1.0)),
}


@pytest.mark.parametrize("name", sorted(SOURCE_CASES))
def test_multi_and_velocity_match_reference(name):
    """``n_sources=2`` and ``solve_velocity``: 4 stacked streams over 6 or
    more chunks, every output of every step (the new ones on accepted
    events) and the carried state; the sources found within 10 cm, and the
    band-cropped velocity within 1.5 m/s of the truth."""
    mics, _, skw, _, chunk, events, burst = SOURCE_CASES[name]
    n_chunks = max(6, -(-8200 // chunk))
    x = _streams(mics, 4, n_chunks * chunk, events, burst=burst)
    jsl, tsl = _pair(name, SOURCE_CASES)
    jst, tst = jsl.init_states(4), tsl.init_states(4)
    n_events = np.zeros(4, int)
    for i in range(n_chunks):
        c = x[:, :, i * chunk:(i + 1) * chunk]
        jst, jout = jsl.step_many(jst, jnp.asarray(c))
        tst, tout = tsl.step_many(tst, torch.from_numpy(c))
        _compare_out(jout, tout, f"{name} chunk {i}", mics)
        n_events += tout["events"].numpy().sum(axis=-1)
        if "multi_xy" in tout:
            valid = tout["multi_valid"].numpy()
            assert tout["multi_xy"].shape == (4, skw.get(
                "max_events_per_chunk", 1), 2, 2)
            for target in MULTI_XY:
                err = np.linalg.norm(tout["multi_xy"].numpy()
                                     - np.asarray(target), axis=-1).min(-1)
                assert (err[valid[..., 0]] < 0.1).all(), (i, target, err)
        else:
            ev = tout["event"].numpy()
            assert tout["velocity"].shape == (4, 2)  # in the plane
            err = np.linalg.norm(tout["velocity"].numpy()[ev] - MOVING_V[:2],
                                 axis=-1)
            # at 9 scales (2 m/s steps) the band-cropped CAF resolves it;
            # the full band's whitened out-of-band bins blur it to ~2 m/s
            assert name != "velocity_bandcrop" or (err < 1.5).all(), (i, err)
    _compare_state(jst, tst, name)
    assert n_events.tolist() == [len(e) for e in events]


def test_two_rate_accepts_and_ignores_sources_and_velocity():
    """The two-rate localizer with ``n_sources=2`` and ``solve_velocity``
    set gives what it gives with the default StreamConfig, in both
    packages (the reference's two-rate path reads neither field)."""
    ev = [(700,), (700, 2900), (), (700,)]
    x = _streams(MICS3, 4, 8 * 512, ev)
    both = dict(n_sources=2, solve_velocity=True, velocity_n_scales=5)
    runs = {}
    for pkg, cfgs, kw in ((jstream, jcfg, {}), (tstream, tcfg,
                                                dict(device="cpu"))):
        for name, skw in (("default", {}), ("both", both)):
            tr = pkg.TwoRateStreamingLocalizer.create(
                MICS3, cfgs.PipelineConfig(phat=True),
                stream=cfgs.StreamConfig(chunk_size=512, **skw),
                event_capacity=3, **kw)
            st, outs = tr.init_states(4), []
            for i in range(8):
                c = x[:, :, i * 512:(i + 1) * 512]
                c = jnp.asarray(c) if pkg is jstream else torch.from_numpy(c)
                st, det = tr.detect_many(st, c)
                st, evs = tr.localize_triggered(st, det)
                outs.append({k: np.asarray(v) for k, v in evs.items()})
            runs[pkg.__name__, name] = outs
    for pkg in (jstream, tstream):
        for a, b in zip(runs[pkg.__name__, "default"],
                        runs[pkg.__name__, "both"]):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    n_acc = 0
    for a, b in zip(runs[jstream.__name__, "both"],
                    runs[tstream.__name__, "both"]):
        for k in ("stream_idx", "accepted", "triggered", "event_shifts"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_allclose(a["xy"], b["xy"], atol=1e-4)
        n_acc += int(b["accepted"].sum())
    assert n_acc == 4


def test_multi_source_refuses_a_3d_array():
    """The reference lifts every mic to z = 0 on this path."""
    with pytest.raises(ValueError, match=r"planar \[M, 2\]"):
        tstream.StreamingLocalizer.create(
            TETRA, stream=tcfg.StreamConfig(n_sources=2), device="cpu")


def test_single_stream_call_and_run_match_reference():
    """The single-stream call (no stream axis) and ``run`` over 8 chunks."""
    x = _streams(MICS3, 1, 8 * 512, [(1300,)])[0]
    jsl, tsl = _pair("default")
    _, jouts = jsl.run(x)
    tstate, touts = tsl.run(x)
    assert len(touts) == len(jouts) == 8
    for i, (jo, to) in enumerate(zip(jouts, touts)):
        _compare_out(jo, {k: torch.from_numpy(np.asarray(v))
                          for k, v in to.items()}, f"run chunk {i}")
    assert [bool(o["event"]) for o in touts].count(True) == 1
    assert tstate.context.shape == (3, 1023) and tstate.time_s.ndim == 0
    # the single-stream call is step_many's row
    st1, out1 = tsl(tsl.init_state(), torch.from_numpy(x[:, :512]))
    stm, outm = tsl.step_many(tsl.init_states(2),
                              torch.from_numpy(np.stack([x[:, :512]] * 2)))
    for k in out1:
        assert torch.equal(out1[k], outm[k][1]), k
    assert torch.equal(st1.context, stm.context[0])


def test_state_converted_midstream_continues_equal():
    """Three chunks in the JAX package, its state handed to the port, three
    more chunks in both; and the port's state handed back to the JAX
    package for the last chunk."""
    x = _streams(MICS3, 4, 7 * 512, [(300,), (700, 2400), (), (1900,)])
    jsl, tsl = _pair("bandcrop_phat")
    jst = jsl.init_states(4)
    for i in range(3):
        jst, _ = jsl.step_many(jst, jnp.asarray(x[:, :, i * 512:(i + 1) * 512]))
    tst = convert.stream_state_from_reference(_state_np(jst), "cpu")
    assert tst.best_shift.dtype == torch.int32
    for i in range(3, 6):
        c = x[:, :, i * 512:(i + 1) * 512]
        jst, jout = jsl.step_many(jst, jnp.asarray(c))
        tst, tout = tsl.step_many(tst, torch.from_numpy(c))
        _compare_out(jout, tout, f"converted chunk {i}")
    _compare_state(jst, tst, "converted")
    back = jstream.StreamState(**{
        k: jnp.asarray(v)
        for k, v in convert.stream_state_to_numpy(tst).items()})
    c = x[:, :, 6 * 512:]
    _, jout = jsl.step_many(back, jnp.asarray(c))
    _, tout = tsl.step_many(tst, torch.from_numpy(c))
    _compare_out(jout, tout, "handed back")
    with pytest.raises(ValueError, match="lacks"):
        convert.stream_state_from_reference({"context": x[0]}, "cpu")


def _tworate(pkg, cfgs, mics, **kw):
    return pkg.TwoRateStreamingLocalizer.create(
        mics, cfgs.PipelineConfig(phat=True),
        stream=cfgs.StreamConfig(chunk_size=512), event_capacity=3, **kw)


def test_two_rate_matches_reference_and_one_rate():
    """detect_many + localize_triggered against the JAX package's, and
    against the port's own one-rate step on the same streams.  Capacity 3 of
    5 streams, and chunk 2 holds four triggers: one overflows."""
    ev = [(700,), (700, 3300), (), (700,), (700,)]
    x = _streams(MICS3, 5, 9 * 512, ev)
    jtr = _tworate(jstream, jcfg, MICS3)
    ttr = _tworate(tstream, tcfg, MICS3, device="cpu")
    one = tstream.StreamingLocalizer.create(
        MICS3, tcfg.PipelineConfig(phat=True),
        stream=tcfg.StreamConfig(chunk_size=512), device="cpu")
    jst, tst, ost = jtr.init_states(5), ttr.init_states(5), one.init_states(5)
    overflow = 0
    for i in range(9):
        c = x[:, :, i * 512:(i + 1) * 512]
        jst, jdet = jtr.detect_many(jst, jnp.asarray(c))
        tst, tdet = ttr.detect_many(tst, torch.from_numpy(c))
        ost, oout = one.step_many(ost, torch.from_numpy(c))
        for k in ("triggered", "trigger_abs", "frame"):
            np.testing.assert_array_equal(tdet[k].numpy(), np.asarray(jdet[k]))
        np.testing.assert_allclose(tdet["trig_time"].numpy(),
                                   np.asarray(jdet["trig_time"]), atol=1e-6)
        assert torch.equal(tdet["triggered"], oout["triggered"])
        jst, jev = jtr.localize_triggered(jst, jdet)
        tst, tev = ttr.localize_triggered(tst, tdet)
        assert set(tev) == set(jev)
        for k in ("stream_idx", "accepted", "triggered", "event_shifts",
                  "overflow"):
            np.testing.assert_array_equal(tev[k].numpy(), np.asarray(jev[k]),
                                          err_msg=f"chunk {i} {k}")
        for k, atol in (("tdoa_samples", 1e-3), ("xy_grid", 1e-4),
                        ("xy", 1e-4), ("rms_m", 1e-5)):
            np.testing.assert_allclose(tev[k].numpy(), np.asarray(jev[k]),
                                       atol=atol, err_msg=f"chunk {i} {k}")
        # the PSR of a slot that captured no event is a ratio of rounding
        # noise: held on the triggered slots
        trig = tev["triggered"].numpy()
        np.testing.assert_allclose(tev["confidence"].numpy()[trig],
                                   np.asarray(jev["confidence"])[trig],
                                   rtol=1e-3)
        overflow += int(tev["overflow"])
        # an accepted slot carries the one-rate step's position
        for slot in torch.nonzero(tev["accepted"])[:, 0].tolist():
            s = int(tev["stream_idx"][slot])
            assert bool(oout["event"][s])
            np.testing.assert_allclose(tev["xy"][slot].numpy(),
                                       oout["xy"][s].numpy(), atol=1e-5)
    assert overflow == 1
    _compare_state(jst, tst, "two-rate")
    # streams that never overflowed carry the one-rate step's state
    assert tst.event_count.tolist() == [1, 2, 0, 1, 0]
    keep = [0, 1, 2, 3]
    scale = float(ost.ema_corr.abs().max())
    np.testing.assert_allclose(tst.ema_corr[keep].numpy() / scale,
                               ost.ema_corr[keep].numpy() / scale, atol=1e-6)
    assert torch.equal(tst.best_shift[keep], ost.best_shift[keep])
    assert torch.equal(tst.context, ost.context)


def test_two_rate_solve_xyz_matches_one_rate():
    """``solve_xyz`` in the two-rate localizer (the reference's has no 3-D
    solve): an accepted slot carries the one-rate step's xyz, held in
    measurement space (module docstring), on a tetrahedral array."""
    ev = [(700,), (700, 3300), (), (700,), (700,)]
    x = _streams(TETRA, 5, 9 * 512, ev)
    stream = tcfg.StreamConfig(chunk_size=512, solve_xyz=True)
    cfg = tcfg.PipelineConfig(**CASES["tetra_solve_xyz"][1])
    ttr = tstream.TwoRateStreamingLocalizer.create(
        TETRA, cfg, stream=stream, event_capacity=3, device="cpu")
    one = tstream.StreamingLocalizer.create(TETRA, cfg, stream=stream,
                                            device="cpu")
    tst, ost = ttr.init_states(5), one.init_states(5)
    n_acc = 0
    for i in range(9):
        c = torch.from_numpy(x[:, :, i * 512:(i + 1) * 512])
        tst, det = ttr.detect_many(tst, c)
        ost, oout = one.step_many(ost, c)
        tst, tev = ttr.localize_triggered(tst, det)
        assert tev["xyz"].shape == (3, 3) and tev["xyz_rms_m"].shape == (3,)
        for slot in torch.nonzero(tev["accepted"])[:, 0].tolist():
            s = int(tev["stream_idx"][slot])
            np.testing.assert_allclose(
                _predicted_tdoas(tev["xyz"][slot].numpy(), TETRA),
                _predicted_tdoas(oout["xyz"][s].numpy(), TETRA), atol=3e-7)
            np.testing.assert_allclose(tev["xyz_rms_m"][slot].numpy(),
                                       oout["xyz_rms_m"][s].numpy(),
                                       atol=5e-5)
            n_acc += 1
    assert n_acc == 4  # one of the five triggers of chunk 2 overflows


def test_with_audio_returns_event_audio_and_device_is_required():
    """``with_audio=True`` builds, and ``localize_triggered`` returns the
    event audio [E, N] (held to the JAX package's in
    ``tests/test_torch_beamform.py``)."""
    x = _streams(MICS3, 4, 4 * 512, [(700,), (), (), (900,)])
    tr = tstream.TwoRateStreamingLocalizer.create(
        MICS3, device="cpu", event_capacity=3, with_audio=True)
    st, n_ev = tr.init_states(4), 0
    for i in range(4):
        st, det = tr.detect_many(
            st, torch.from_numpy(x[:, :, i * 512:(i + 1) * 512]))
        st, ev = tr.localize_triggered(st, det)
        assert ev["audio"].shape == (3, 1024)
        assert bool(torch.isfinite(ev["audio"]).all())
        n_ev += int(ev["accepted"].sum())
    assert n_ev == 2
    with pytest.raises(TypeError):
        tstream.StreamingLocalizer.create(MICS3)
    sl = tstream.StreamingLocalizer.create(MICS3, device="cpu")
    with pytest.raises(ValueError, match="mics"):
        sl.step_many(sl.init_states(2), torch.zeros(2, 4, 256))
    with pytest.raises(TypeError, match="Tensor"):
        sl.step_many(sl.init_states(2), np.zeros((2, 3, 256), np.float32))


def test_batch_chunk_streams_changes_nothing():
    """The reference's sub-batch size is accepted without effect."""
    x = _streams(MICS3, 4, 4 * 512, [(700,), (300,), (), (900,)])
    outs = []
    for cs in (1024, 2, None):
        sl = tstream.StreamingLocalizer.create(
            MICS3, stream=tcfg.StreamConfig(chunk_size=512,
                                            batch_chunk_streams=cs),
            device="cpu")
        st = sl.init_states(4)
        for i in range(4):
            st, out = sl.step_many(
                st, torch.from_numpy(x[:, :, i * 512:(i + 1) * 512]))
        outs.append((st, out))
    for st, out in outs[1:]:
        assert torch.equal(st.ema_corr, outs[0][0].ema_corr)
        assert torch.equal(out["xy"], outs[0][1]["xy"])


def test_graphed_step_refuses_cpu_tensors():
    """A CUDA graph exists only on the card: nothing falls back."""
    sl = tstream.StreamingLocalizer.create(MICS3, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        sl.graph_step_many(sl.init_states(2), torch.zeros(2, 3, 512))


@pytest.mark.gpu
def test_cuda_graphed_step_equals_eager_step():
    """The step replayed as a CUDA graph against the eager step on the
    card, 17 chunks with planted events: every output and the carried
    state bit-equal (the graph records the same ops)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    x = torch.from_numpy(_streams(MICS3, 4, 17 * 512, EV4)).cuda()
    sl = tstream.StreamingLocalizer.create(
        MICS3, tcfg.PipelineConfig(phat=True, band_hz="auto"),
        stream=tcfg.StreamConfig(chunk_size=512), device="cuda")
    st = sl.init_states(4)
    graphed = sl.graph_step_many(sl.init_states(4), x[:, :, :512])
    with pytest.raises(ValueError, match="captured shape"):
        graphed(x[:2, :, :512])
    n_events = 0
    for i in range(17):
        c = x[:, :, i * 512:(i + 1) * 512]
        st, out = sl.step_many(st, c)
        gout = graphed(c)
        assert set(gout) == set(out)
        for k in out:
            assert torch.equal(gout[k], out[k]), (i, k)
        n_events += int(out["events"].sum())
    assert n_events == sum(len(e) for e in EV4)
    for k in tstream.STATE_NAMES:
        assert torch.equal(getattr(graphed.states, k), getattr(st, k)), k


@pytest.mark.gpu
def test_cuda_graphed_step_solve_xyz_equals_eager_step():
    """The step with the free 3-D solve, captured with no host sync and
    replayed: xyz and xyz_rms_m bit-equal to the eager step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    x = torch.from_numpy(_streams(TETRA, 4, 9 * 512, EV4)).cuda()
    sl = tstream.StreamingLocalizer.create(
        TETRA, tcfg.PipelineConfig(**CASES["tetra_solve_xyz"][1]),
        stream=tcfg.StreamConfig(chunk_size=512, solve_xyz=True),
        device="cuda")
    st = sl.init_states(4)
    graphed = sl.graph_step_many(sl.init_states(4), x[:, :, :512])
    for i in range(9):
        c = x[:, :, i * 512:(i + 1) * 512]
        st, out = sl.step_many(st, c)
        gout = graphed(c)
        for k in ("xyz", "xyz_rms_m", "xy", "events"):
            assert torch.equal(gout[k], out[k]), (i, k)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["multi2", "velocity_bandcrop",
                                  "velocity_planar_as_3d"])
def test_cuda_graphed_multi_and_velocity_steps_equal_eager_step(name):
    """The ``n_sources=2`` and ``solve_velocity`` steps captured as a CUDA
    graph (no step waits for the host: the velocity's linear solve makes no
    check) and replayed: every output and the carried state bit-equal to
    the eager step's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    mics, pkw, skw, ckw, chunk, events, burst = SOURCE_CASES[name]
    n_chunks = max(6, -(-8200 // chunk))
    x = torch.from_numpy(_streams(mics, 4, n_chunks * chunk, events,
                                  burst=burst)).cuda()
    sl = tstream.StreamingLocalizer.create(
        mics, tcfg.PipelineConfig(**pkw),
        stream=tcfg.StreamConfig(chunk_size=chunk, **skw), device="cuda",
        **ckw)
    st = sl.init_states(4)
    graphed = sl.graph_step_many(sl.init_states(4), x[:, :, :chunk])
    n_events = 0
    for i in range(n_chunks):
        c = x[:, :, i * chunk:(i + 1) * chunk]
        st, out = sl.step_many(st, c)
        gout = graphed(c)
        assert set(gout) == set(out)
        for k in out:
            assert torch.equal(gout[k], out[k]), (i, k)
        n_events += int(out["events"].sum())
    assert n_events == sum(len(e) for e in events)
    for k in tstream.STATE_NAMES:
        assert torch.equal(getattr(graphed.states, k), getattr(st, k)), k
