"""PyTorch port, tracked streaming: the same numpy streams, 8 streams of the
reference array with three chirp bursts of one source in six of them,
through the JAX package's ``TrackedStreamingLocalizer.step_many`` and the
port's, chunk by chunk.

Held: the localization keys at ``test_torch_stream.py``'s tolerances
(``EXACT`` / ``FLOAT``); the tracker's integer and bool outputs and state
exactly, on sequences whose association decisions the test checks are
clear of their thresholds; ``track_xy`` within 2e-4 m, ``track_vel``
within 2e-3 m/s, ``model_prob`` within 1e-4, the bank covariance within
1e-3 relative (``xy_cov`` itself is held at 1e-3 relative).  Under
``solve_xyz`` the 3-D track positions are held in measurement space, as
``xyz`` is (its predicted TDOAs within 3e-7 s), within 3e-6 s: a track
blends measurements that lie centimetres apart along the array's
ill-conditioned range, where the two packages' solves differ, and a blend
of points on one surface of equal TDOAs leaves it by the surface's
curvature over that spread (about 1e-6 s here).  And the port's tracked
step against its own untracked step (bit-equal localization), its K-step
call, silent chunks, the refusals and ``utils/convert``.  The JPDA update
of two simultaneous sources (8 mics, one and two event slots a chunk) and
the fused delay-Doppler velocity of a moving source (6 mics) against the
JAX package's, their decisions checked clear of their thresholds; the association weights ``beta``
within 1e-4.  ``gpu`` cases hold the CUDA-graph forms to the eager step
on a card."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import tracked as jtracked
from audio_triangulation_tpu.models import tracking as jtr
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import streaming as tstream
from audio_triangulation_tpu_torch.models import tracked as ttracked
from audio_triangulation_tpu_torch.models import tracking as ttr
from audio_triangulation_tpu_torch.utils import convert
from test_torch_stream import (EXACT, FLOAT, MICS6W, MICS8, MOVING_V,
                               MULTI_XY, SOURCE_FLOAT, _predicted_tdoas,
                               _velocity_kw, compare_source_key,
                               two_source_burst)
from test_torch_tracking import _check_margins

MICS3 = jgeo.reference_array()
TETRA = jgeo.tetrahedral_array(0.3)
CHUNK, N_STREAMS, N_CHUNKS = 512, 8, 24
SILENT = (3, 7)
TRACK_TOL = {"track_xy": 2e-4, "track_vel": 2e-3, "model_prob": 1e-4,
             "beta": 1e-4}
BURST_GAP = 4100


def _scene(mics, n_streams=N_STREAMS, seed=0, burst=None, first=300,
           stagger=250, gaps=(BURST_GAP, BURST_GAP)):
    """[S, M, T] f32 ADC counts: idle level +-1, and in every stream but
    ``SILENT`` three bursts, the first at ``first + stagger * s``, then
    ``gaps`` samples apart (by default past the detector's hold-off): of
    one source on the 1.2 m sphere, or ``burst(s, i, seed)`` [M, 1024] for
    burst i of stream s."""
    rng = np.random.default_rng(seed)
    t_len = N_CHUNKS * CHUNK
    x = rng.integers(127, 130, (n_streams, mics.shape[0], t_len)).astype(
        np.float64)
    for s in range(n_streams):
        if s in SILENT:
            continue
        ang, rad = rng.uniform(0, 2 * np.pi), rng.uniform(0.3, 1.0)
        v = np.array([rad * np.cos(ang), rad * np.sin(ang), 1.2])
        starts = first + stagger * s + np.cumsum((0, *gaps))
        for i, at in enumerate(starts):
            if burst is not None:
                fr = burst(s, i, seed + 10 * s + i)
            else:
                fr = jsynth.synth_scene(v * 1.2 / np.linalg.norm(v), mics,
                                        noise_rms=0.005,
                                        seed=seed + 10 * s + i)[0]
            x[s, :, at:at + 1024] += 110.0 * fr
    return np.clip(np.round(x), 0, 255).astype(np.float32)


def moving_track_burst(s, i, seed):
    """Burst i of a source moving at ``MOVING_V`` from (0.3, 0.2) on the
    1.2 m plane, where it is at burst i's time."""
    at = np.array([0.3, 0.2, 1.2]) + MOVING_V * (i * BURST_GAP / 50_000.0)
    return jsynth.synth_moving_scene(at, MOVING_V, MICS6W, seed=seed)[0]


# name -> (mics, pipeline kw, stream kw, TrackerConfig kw or None)
CASES = {
    "nearest": (MICS3, {}, {}, None),
    "imm": (MICS3, dict(phat=True), {}, dict(imm_q=(0.05, 8.0))),
    # the free 3-D solve of a 30 cm array scatters in range by centimetres
    # between events, and between the packages: a 0.25 m measurement noise
    # keeps the gate's decisions clear of both
    "tetra_solve_xyz": (TETRA, dict(max_shift_samples=jgeo.max_lag_for_array(
        TETRA, jcfg.PipelineConfig())), dict(solve_xyz=True),
        dict(dim=3, gate_maha2=11.34, measurement_noise=0.25)),
}


# name -> CASES' fields, fuse_velocity, the burst of the scene and the
# scene's burst times (``_scene``'s keywords)
SOURCE_CASES = {
    # two simultaneous sources a burst: the JPDA update
    "jpda": (MICS8, dict(phat=True), dict(n_sources=2),
             dict(max_tracks=4, confirm_hits=2), False, two_source_burst,
             {}),
    # two event slots a 2,560-sample chunk: the first two bursts 1,300
    # samples apart (the hold-off is a frame plus the refractory: 1,124),
    # in one chunk in every planted stream but the last, whose second
    # burst ends past it; one JPDA update a slot at its trigger time
    "jpda_two_slots": (MICS8, dict(phat=True), dict(
        n_sources=2, max_events_per_chunk=2, refractory_samples=100,
        chunk_size=2560), dict(max_tracks=4, confirm_hits=2), False,
        two_source_burst, dict(first=2600, stagger=40, gaps=(1300, 4100))),
    # a moving source: its delay-Doppler velocity fused as a measurement
    "fuse_velocity": (MICS6W, _velocity_kw(MICS6W, True),
                      dict(solve_velocity=True, velocity_n_scales=9),
                      dict(velocity_noise=0.6), True, moving_track_burst,
                      {}),
}


def _case(name):
    """(mics, pipeline kw, stream kw, tracker kw, fuse_velocity, burst,
    scene kw)."""
    if name in SOURCE_CASES:
        return SOURCE_CASES[name]
    return (*CASES[name], False, None, {})


def _case_chunks(name, x):
    """(chunk size, chunks in the scene x) of a case."""
    chunk = _case(name)[2].get("chunk_size", CHUNK)
    return chunk, x.shape[-1] // chunk


@pytest.fixture(scope="module")
def localizers():
    """name -> (JAX localizer, port localizer), built once per module."""
    made = {}

    def get(name):
        if name not in made:
            mics, pkw, skw, trk, fuse = _case(name)[:5]
            skw = {"chunk_size": CHUNK, **skw}
            made[name] = (
                jtracked.TrackedStreamingLocalizer.create(
                    mics, jcfg.PipelineConfig(**pkw),
                    stream=jcfg.StreamConfig(**skw),
                    tracker_cfg=None if trk is None
                    else jtr.TrackerConfig(**trk), fuse_velocity=fuse),
                ttracked.TrackedStreamingLocalizer.create(
                    mics, tcfg.PipelineConfig(**pkw),
                    stream=tcfg.StreamConfig(**skw),
                    tracker_cfg=None if trk is None
                    else ttr.TrackerConfig(**trk), fuse_velocity=fuse,
                    device="cpu"))
        return made[name]

    return get


def _chunk(x, i, chunk=CHUNK):
    return x[:, :, i * chunk:(i + 1) * chunk]


def _compare_out(ref, got, where, mics):
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k in ref:
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.shape == r.shape, (where, k, g.shape, r.shape)
        if k in SOURCE_FLOAT:
            compare_source_key(ref, k, g, where)
        elif k == "xyz" or (k == "track_xy" and g.shape[-1] == 3):
            np.testing.assert_allclose(
                _predicted_tdoas(g, mics), _predicted_tdoas(r, mics),
                atol=3e-7 if k == "xyz" else 3e-6, err_msg=f"{where} {k}")
        elif k in EXACT or g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")
        elif k in TRACK_TOL:
            if k == "track_vel" and g.shape[-1] == 3:
                continue  # the 3-D positions' range is ill-conditioned
            np.testing.assert_allclose(g, r, rtol=0, atol=TRACK_TOL[k],
                                       err_msg=f"{where} {k}")
        else:
            rtol, atol = FLOAT[k]
            np.testing.assert_allclose(g, r, rtol=rtol, atol=atol,
                                       err_msg=f"{where} {k}")


def _compare_track(jtrack, ttrack, where):
    ref = {f.name: np.asarray(getattr(jtrack, f.name))
           for f in dataclasses.fields(jtrack)}
    got = convert.track_state_to_numpy(ttrack)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")
        elif k in ("p", "pm"):
            np.testing.assert_allclose(g, r, rtol=1e-3, atol=1e-9,
                                       err_msg=f"{where} {k}")
        elif k == "mu":
            np.testing.assert_allclose(g, r, atol=TRACK_TOL["model_prob"],
                                       err_msg=f"{where} {k}")
        elif k in ("x", "xm"):
            dim = g.shape[-1] // 2
            if dim == 2:
                np.testing.assert_allclose(g[..., :dim], r[..., :dim],
                                           atol=TRACK_TOL["track_xy"])
                np.testing.assert_allclose(g[..., dim:], r[..., dim:],
                                           atol=TRACK_TOL["track_vel"])
        else:
            np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{where} {k}")


def _margins(tsl, before, out, where):
    """The tracker's decisions in this chunk, recomputed by the port's
    bank on its own measurements, are clear of their thresholds (the
    JPDA update's slot by slot, each from the bank the slots before it
    left)."""
    cfg = tsl.tracker.cfg
    if not bool(out["event"].any()):
        return
    t = torch.where(out["event"], out["event_time_s"][:, 0], 0.0)
    if "multi_xy" in out:
        track = before.track
        for k in range(out["multi_xy"].shape[1]):
            ev_k, valid = out["events"][:, k], out["multi_valid"][:, k]
            t_k = torch.where(ev_k, out["event_time_s"][:, k], 0.0)
            new, _, terms = ttr._step_multi(
                track, out["multi_xy"][:, k], t_k, valid, cfg,
                out["multi_xy_cov"][:, k])
            _check_margins(terms, cfg, valid, f"{where} slot {k}")
            track = ttracked._keep_state(ev_k, new, track)
        return
    fn = ttr._step_imm if cfg.imm_q else ttr._step
    z = out["xyz"] if "xyz" in out else out["xy"]
    kw = {"z_vel": out["velocity"]} if tsl.fuse_velocity else {}
    _, _, terms = fn(before.track, z, t, out["event"], cfg,
                     z_cov=None if "xyz" in out else out["xy_cov"], **kw)
    _check_margins(terms, cfg, out["event"], where)


@pytest.mark.parametrize("name", sorted(CASES))
def test_tracked_matches_reference(name, localizers):
    """Every output of every chunk and the final state; the port's tracked
    step beside its untracked one; one confirmed track a planted stream."""
    mics = CASES[name][0]
    x = _scene(mics)
    jtsl, ttsl = localizers(name)
    jst, tst = jtsl.init_states(N_STREAMS), ttsl.init_states(N_STREAMS)
    ust = ttsl.sl.init_states(N_STREAMS)
    n_events = np.zeros(N_STREAMS, int)
    for i in range(N_CHUNKS):
        c = _chunk(x, i)
        before = tst
        jst, jout = jtsl.step_many(jst, jnp.asarray(c))
        tst, tout = ttsl.step_many(tst, torch.from_numpy(c))
        _margins(ttsl, before, tout, f"{name} chunk {i}")
        _compare_out(jout, tout, f"{name} chunk {i}", mics)
        # the equality contract: localization bit-equal to the untracked
        # step's
        ust, uout = ttsl.sl.step_many(ust, torch.from_numpy(c))
        for k, v in uout.items():
            assert torch.equal(tout[k], v), (i, k)
        n_events += tout["event"].numpy()
    _compare_track(jst.track, tst.track, name)
    for k in tstream.STATE_NAMES:
        assert torch.equal(getattr(tst.stream, k), getattr(ust, k)), k
    planted = np.setdiff1d(np.arange(N_STREAMS), SILENT)
    assert (n_events[planted] == 3).all() and (n_events[list(SILENT)] == 0
                                                ).all()
    active = tst.track.active.numpy()
    assert (active.sum(axis=-1) == (n_events > 0)).all()
    hits = (tst.track.hits.numpy() * active).sum(axis=-1)
    np.testing.assert_array_equal(hits, n_events)
    assert bool(tout["track_confirmed"][planted].any(dim=-1).all())


@pytest.mark.parametrize("name", sorted(SOURCE_CASES))
def test_tracked_sources_match_reference(name, localizers):
    """The JPDA update of two simultaneous sources and the fused velocity
    of a moving one: every output of every chunk and the final bank
    against the reference, the localization bit-equal to the untracked
    step's; at the end two confirmed tracks a planted stream within 10 cm
    of the sources (JPDA), or one whose velocity is within 1 m/s of the
    truth (fused velocity).  With two event slots, a chunk holds two
    accepted events."""
    mics, _, skw, _, _, burst, scene_kw = SOURCE_CASES[name]
    x = _scene(mics, burst=burst, **scene_kw)
    chunk, n_chunks = _case_chunks(name, x)
    jtsl, ttsl = localizers(name)
    jst, tst = jtsl.init_states(N_STREAMS), ttsl.init_states(N_STREAMS)
    ust = ttsl.sl.init_states(N_STREAMS)
    n_events = np.zeros(N_STREAMS, int)
    most_in_a_chunk = 0
    for i in range(n_chunks):
        c = _chunk(x, i, chunk)
        before = tst
        jst, jout = jtsl.step_many(jst, jnp.asarray(c))
        tst, tout = ttsl.step_many(tst, torch.from_numpy(c))
        _margins(ttsl, before, tout, f"{name} chunk {i}")
        _compare_out(jout, tout, f"{name} chunk {i}", mics)
        ust, uout = ttsl.sl.step_many(ust, torch.from_numpy(c))
        for k, v in uout.items():
            assert torch.equal(tout[k], v), (i, k)
        n_events += tout["events"].numpy().sum(axis=-1)
        most_in_a_chunk = max(most_in_a_chunk,
                              int(tout["events"].sum(dim=-1).max()))
    _compare_track(jst.track, tst.track, name)
    planted = np.setdiff1d(np.arange(N_STREAMS), SILENT)
    assert (n_events[planted] == 3).all() and (n_events[list(SILENT)] == 0
                                                ).all()
    assert most_in_a_chunk == skw.get("max_events_per_chunk", 1)
    conf = tout["track_confirmed"].numpy()
    assert not conf[list(SILENT)].any()
    if name.startswith("jpda"):
        assert tout["beta"].shape == (N_STREAMS, 2, 4)
        assert (conf[planted].sum(axis=-1) == 2).all()
        txy = tout["track_xy"].numpy()
        for s in planted:
            for target in MULTI_XY:
                err = np.linalg.norm(txy[s][conf[s]] - target, axis=-1)
                assert err.min() < 0.1, (s, target, err)
    else:
        assert (conf[planted].sum(axis=-1) == 1).all()
        vel = tout["track_vel"].numpy()[conf]
        assert (np.linalg.norm(vel - MOVING_V[:2], axis=-1) < 1.0).all(), vel


def test_silent_chunks_leave_state_untouched(localizers):
    """After the scene, idle chunks change no tracker state and report the
    carried tracks with no assignment."""
    _, tsl = localizers("nearest")
    x = _scene(MICS3)
    st = tsl.init_states(N_STREAMS)
    for i in range(N_CHUNKS):
        st, _ = tsl.step_many(st, torch.from_numpy(_chunk(x, i)))
    rng = np.random.default_rng(3)
    for _ in range(3):
        quiet = torch.from_numpy(rng.integers(
            127, 130, (N_STREAMS, 3, CHUNK)).astype(np.float32))
        before = st.track
        st, out = tsl.step_many(st, quiet)
        assert not bool(out["event"].any())
        assert bool((out["assigned"] == -1).all())
        for f in dataclasses.fields(before):
            assert torch.equal(getattr(st.track, f.name),
                               getattr(before, f.name)), f.name
        assert torch.equal(out["track_xy"], before.x[..., :2])
        assert torch.equal(out["track_vel"], before.x[..., 2:])
        assert torch.equal(out["track_confirmed"], before.active
                           & (before.hits >= 2))


def test_step_many_scan_equals_step_many(localizers):
    """K = 4 chunk steps in one call equal four step_many calls, and the
    single-stream call is a row of the batched one."""
    _, tsl = localizers("imm")
    x = _scene(MICS3)
    st_seq = st_scan = tsl.init_states(N_STREAMS)
    for j in range(0, N_CHUNKS, 4):
        outs = []
        for i in range(j, j + 4):
            st_seq, o = tsl.step_many(st_seq, torch.from_numpy(_chunk(x, i)))
            outs.append(o)
        if j == 4:
            st8 = st_seq
        chunks = torch.from_numpy(np.stack(
            [_chunk(x, i) for i in range(j, j + 4)], axis=1))
        st_scan, scan = tsl.step_many_scan(st_scan, chunks)
        for k, v in scan.items():
            assert v.shape[:2] == (4, N_STREAMS), k
            for i in range(4):
                assert torch.equal(v[i], outs[i][k]), (j + i, k)
    for a, b in zip(tstream.state_leaves(st_seq),
                    tstream.state_leaves(st_scan)):
        assert torch.equal(a, b)
    one = tsl.init_state()
    for i in range(8):
        one, o1 = tsl(one, torch.from_numpy(_chunk(x, i)[1]))
    row = tstream.map_state(lambda v: v[1], st8)
    for a, b in zip(tstream.state_leaves(one), tstream.state_leaves(row)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert set(o1) == set(outs[0]) and int(one.track.hits.sum()) == 1


def test_refusals_by_name_and_reference_value_errors():
    mk = ttracked.TrackedStreamingLocalizer.create
    # the reference's ValueErrors
    with pytest.raises(ValueError, match="dim must be 3"):
        mk(TETRA, stream=tcfg.StreamConfig(solve_xyz=True),
           tracker_cfg=ttr.TrackerConfig(dim=2), device="cpu")
    with pytest.raises(ValueError, match="IMM"):
        mk(MICS3, stream=tcfg.StreamConfig(n_sources=2),
           tracker_cfg=ttr.TrackerConfig(imm_q=(0.1, 4.0)), device="cpu")
    with pytest.raises(ValueError, match="solve_velocity"):
        mk(MICS3, fuse_velocity=True, device="cpu")
    with pytest.raises(ValueError, match="n_sources"):
        mk(MICS3, stream=tcfg.StreamConfig(n_sources=2, solve_velocity=True),
           fuse_velocity=True, device="cpu")
    with pytest.raises(ValueError, match="single-model"):
        mk(MICS3, stream=tcfg.StreamConfig(solve_velocity=True),
           tracker_cfg=ttr.TrackerConfig(imm_q=(0.1, 4.0)),
           fuse_velocity=True, device="cpu")
    with pytest.raises(TypeError):
        mk(MICS3)  # the device is not optional
    tsl = mk(MICS3, device="cpu")
    assert tsl.tracker.cfg == ttr.TrackerConfig()
    with pytest.raises(ValueError, match="CUDA"):
        tsl.graph_step_many(tsl.init_states(2), torch.zeros(2, 3, CHUNK))
    with pytest.raises(ValueError, match="CUDA"):
        tsl.graph_step_many_scan(tsl.init_states(2),
                                 torch.zeros(2, 4, 3, CHUNK))


def test_state_converted_midstream_continues_equal(localizers):
    """Twelve chunks in the JAX package, its tracked state handed to the
    port, twelve more in both; and the port's state handed back."""
    jtsl, ttsl = localizers("nearest")
    x = _scene(MICS3)
    jst = jtsl.init_states(N_STREAMS)
    for i in range(12):
        jst, _ = jtsl.step_many(jst, jnp.asarray(_chunk(x, i)))

    def leaves(s):
        return {f.name: np.asarray(getattr(s, f.name))
                for f in dataclasses.fields(s)}

    tst = convert.tracked_state_from_reference(
        {"stream": leaves(jst.stream), "track": leaves(jst.track)}, "cpu")
    assert tst.track.hits.dtype == torch.int32
    for i in range(12, N_CHUNKS):
        c = _chunk(x, i)
        jst, jout = jtsl.step_many(jst, jnp.asarray(c))
        tst, tout = ttsl.step_many(tst, torch.from_numpy(c))
        _compare_out(jout, tout, f"converted chunk {i}", MICS3)
    _compare_track(jst.track, tst.track, "converted")
    arrays = convert.tracked_state_to_numpy(tst)
    back = jtracked.TrackedStreamState(
        stream=type(jst.stream)(**{k: jnp.asarray(v) for k, v in
                                   arrays["stream"].items()}),
        track=jtr.TrackState(**{k: jnp.asarray(v) for k, v in
                                arrays["track"].items()}))
    c = _chunk(x, 0)
    _, jout = jtsl.step_many(back, jnp.asarray(c))
    _, tout = ttsl.step_many(tst, torch.from_numpy(c))
    _compare_out(jout, tout, "handed back", MICS3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["nearest", "imm", "jpda", "jpda_two_slots",
                                  "fuse_velocity"])
def test_cuda_graphed_forms_equal_eager_step(name):
    """On the card: the step replayed as a CUDA graph, one chunk a replay
    and four, against the eager step: every output and the carried state
    bit-equal (the JPDA and fused-velocity steps too: nothing in them waits
    for the host)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph has no CPU mode)")
    mics, pkw, skw, trk, fuse, burst, scene_kw = _case(name)
    tsl = ttracked.TrackedStreamingLocalizer.create(
        mics, tcfg.PipelineConfig(**pkw),
        stream=tcfg.StreamConfig(**{"chunk_size": CHUNK, **skw}),
        tracker_cfg=None if trk is None else ttr.TrackerConfig(**trk),
        fuse_velocity=fuse, device="cuda")
    x = torch.from_numpy(_scene(mics, burst=burst, **scene_kw)).cuda()
    chunk, n_chunks = _case_chunks(name, x)
    st = tsl.init_states(N_STREAMS)
    one = tsl.graph_step_many(tsl.init_states(N_STREAMS), x[:, :, :chunk])
    four = tsl.graph_step_many_scan(
        tsl.init_states(N_STREAMS),
        torch.stack([_chunk(x, i, chunk) for i in range(4)], dim=1))
    eager = []
    for i in range(n_chunks):
        st, out = tsl.step_many(st, _chunk(x, i, chunk))
        gout = one(_chunk(x, i, chunk))
        for k in out:
            assert torch.equal(gout[k], out[k]), (i, k)
        eager.append(out)
    for j in range(0, n_chunks, 4):
        gout = four(torch.stack([_chunk(x, i, chunk)
                                 for i in range(j, j + 4)], dim=1))
        for i in range(4):
            for k in eager[j + i]:
                assert torch.equal(gout[k][i], eager[j + i][k]), (j + i, k)
    for g in (one, four):
        for a, b in zip(tstream.state_leaves(g.states),
                        tstream.state_leaves(st)):
            assert torch.equal(a, b)
