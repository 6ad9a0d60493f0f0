"""PyTorch port, the tracker bank: the same event sequences, made from a
seed with numpy, through ``audio_triangulation_tpu.models.tracking`` (its
functions ``jax.vmap``ped over streams) and the port's batched functions.

Float state and outputs within rtol 1e-5 / atol 1e-6; integer fields, bool
flags and ``assigned`` exactly.  Every association decision is a threshold
on a float (the gate on maha2, the coast limit, b > 0.5, beta_0 > spawn_b0,
the nearest track); the two packages add in other orders, so the sequences
are built so that each decision lies at least 1e-3 (relative) clear of its
threshold, and each test checks that it does."""

import dataclasses
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.models import tracking as jtr
from audio_triangulation_tpu_torch.models import tracking as ttr
from audio_triangulation_tpu_torch.utils import convert

RTOL, ATOL = 1e-5, 1e-6
MARGIN = 1e-3


def _cfgs(**kw):
    return jtr.TrackerConfig(**kw), ttr.TrackerConfig(**kw)


def _spd(rng, lead, dim, lo, hi):
    """Random SPD matrices [*lead, dim, dim] with stds in [lo, hi]."""
    a = rng.normal(0, 1, (*lead, dim, dim)) * 0.3 + np.eye(dim)
    s = rng.uniform(lo, hi, (*lead, dim))
    m = a * s[..., None, :]
    return (m @ np.swapaxes(m, -1, -2)).astype(np.float32)


def _sequence(seed, n_streams, n_steps, dim, n_src=2, n_meas=None):
    """Measurements of ``n_src`` sources per stream moving at constant
    velocity, far apart, in turns: (z [T, S, (N,) d], t [T, S], valid
    [T, S (, N)]).  Event times step by 0.12-0.2 s with two gaps of 2.5-3 s
    (coast drops); one event in ten is invalid, one in eight is clutter far
    from every source.  ``n_meas`` (step_multi): N simultaneous
    measurements a step, the sources in order and clutter after them.

    Steps are short and measurement noise no smaller than 0.02 m because
    a Kalman update computes its posterior covariance as a difference,
    P- - K S K': where the prior exceeds the posterior a hundredfold, the
    float32 rounding of either package alone exceeds the tolerance."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, (n_streams, 1)) + np.arange(
        n_src) * 2 * np.pi / n_src
    p0 = np.zeros((n_streams, n_src, dim))
    p0[..., 0], p0[..., 1] = 0.8 * np.cos(ang), 0.8 * np.sin(ang)
    if dim == 3:
        p0[..., 2] = rng.uniform(0.5, 1.0, (n_streams, n_src))
    vel = rng.normal(0, 0.25, (n_streams, n_src, dim))
    dts = rng.uniform(0.12, 0.2, (n_steps, n_streams))
    for at in (n_steps // 3, 2 * n_steps // 3):
        dts[at] = rng.uniform(2.5, 3.0, n_streams)
    t = np.cumsum(dts, axis=0)
    pos = p0[None] + vel[None] * t[:, :, None, None]  # [T, S, src, d]
    noise = rng.normal(0, 0.01, pos.shape)
    if n_meas is None:
        pick = (np.arange(n_steps)[:, None]
                + rng.integers(0, n_src, n_streams)) % n_src
        z = np.take_along_axis(pos + noise, pick[..., None, None],
                               axis=2)[:, :, 0]
        clutter = rng.random((n_steps, n_streams)) < 0.125
        z[clutter] = rng.uniform(-3, 3, (int(clutter.sum()), dim)) + 5.0
        valid = rng.random((n_steps, n_streams)) >= 0.1
    else:
        z = np.concatenate([pos + noise, rng.uniform(-3, 3, (
            n_steps, n_streams, n_meas - n_src, dim)) + 5.0], axis=2)
        valid = rng.random((n_steps, n_streams, n_meas)) >= 0.1
    return z.astype(np.float32), t.astype(np.float32), valid


def _clear(v, threshold, where, mask=None):
    """Every value of v (where mask) lies at least MARGIN (relative) from
    the threshold."""
    v = v.detach().numpy()
    mask = np.isfinite(v) if mask is None else (mask.numpy() & np.isfinite(v))
    gap = np.abs(v - threshold)[mask]
    assert (gap > MARGIN * abs(threshold)).all(), (
        f"{where}: a decision lies {gap.min():.3e} from {threshold}")


def _distinct_best(v, where, mask):
    """The nearest finite value along the last axis is clear of the next."""
    top2 = torch.topk(-v, 2, dim=-1).values.neg()
    ok = torch.isfinite(top2[..., 1]) & mask
    gap = (top2[..., 1] - top2[..., 0])[ok]
    assert bool((gap > MARGIN * top2[..., 1][ok]).all()), where


def _check_margins(terms, cfg, valid, where):
    """The decisions of one step, from the values the port thresholded."""
    _clear(terms["coast"], cfg.max_coast_s, f"{where} coast",
           terms["active_before"])
    if "w_k" in terms:  # step_multi
        maha2, v = terms["maha2"], valid[..., :, None]
        _clear(maha2, cfg.gate_maha2, f"{where} gate", v.expand_as(maha2))
        _clear(terms["w_k"], 0.5, f"{where} w_k")
        _clear(terms["leftover"], cfg.spawn_b0, f"{where} leftover", valid)
        _clear(terms["beta"].amax(dim=-1), 0.5, f"{where} beta", valid)
        return
    maha2, v = terms["maha2"], valid[..., None].expand_as(terms["maha2"])
    _clear(maha2, cfg.gate_maha2, f"{where} gate", v)
    if cfg.association == "soft":
        _clear(terms["b"], 0.5, f"{where} b", v)
        _clear(terms["b0"], cfg.spawn_b0, f"{where} b0", valid)
    else:
        _distinct_best(maha2, f"{where} nearest", valid)


def _np_tree(x):
    if dataclasses.is_dataclass(x):
        return {f.name: np.asarray(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return {k: np.asarray(v) for k, v in x.items()}


def _compare(ref, got, where):
    ref, got = _np_tree(ref), _np_tree(got)
    assert set(got) == set(ref), (where, set(got) ^ set(ref))
    for k, r in ref.items():
        g = got[k]
        assert g.shape == r.shape, (where, k, g.shape, r.shape)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=f"{where} {k}")
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{where} {k}")


# name -> (TrackerConfig kwargs, measurement extras)
STEP_CASES = {
    "nearest_d2": (dict(), ()),
    "soft_d2_zcov": (dict(association="soft"), ("z_cov",)),
    "nearest_d3_zcov": (dict(dim=3, gate_maha2=11.34), ("z_cov",)),
    "soft_d3": (dict(dim=3, gate_maha2=11.34, association="soft"), ()),
    "nearest_zvel": (dict(), ("z_vel",)),
    "soft_zvel_vcov_zcov": (dict(association="soft"),
                            ("z_cov", "z_vel", "v_cov")),
    # three sources and clutter into two slots: spawns into a full bank
    "nearest_full_bank": (dict(max_tracks=2), ()),
    "imm_nearest": (dict(imm_q=(0.05, 8.0)), ()),
    "imm_soft_zcov": (dict(imm_q=(0.05, 8.0), association="soft"),
                      ("z_cov",)),
}
N_STREAMS, N_STEPS = 6, 24


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_step_matches_reference(name):
    """Every output and the whole state after every step, over 6 streams
    (the JAX step vmapped over them, the port's batched natively)."""
    kw, extras = STEP_CASES[name]
    jc, tc = _cfgs(**kw)
    imm = bool(kw.get("imm_q"))
    seed = sorted(STEP_CASES).index(name)
    z, t, valid = _sequence(seed, N_STREAMS, N_STEPS, tc.dim,
                            n_src=3 if tc.max_tracks == 2 else 2)
    rng = np.random.default_rng(100 + seed)
    ex = {}
    if "z_cov" in extras:
        ex["z_cov"] = _spd(rng, (N_STEPS, N_STREAMS), tc.dim, 0.02, 0.05)
    if "z_vel" in extras:
        ex["z_vel"] = rng.normal(0, 0.3, (N_STEPS, N_STREAMS, tc.dim)
                                 ).astype(np.float32)
    if "v_cov" in extras:
        ex["v_cov"] = _spd(rng, (N_STEPS, N_STREAMS), tc.dim, 0.1, 0.6)
    names = sorted(ex)
    jfn = jtr.step_imm if imm else jtr.step
    tfn = ttr._step_imm if imm else ttr._step

    def one(state, z_, t_, v_, *extra):
        return jfn(state, z_, t_, v_, jc, **dict(zip(names, extra)))

    jstep = jax.jit(jax.vmap(one))
    init = jtr.init_state_imm if imm else jtr.init_state
    jst = jax.tree.map(lambda v: jnp.broadcast_to(v, (N_STREAMS,) + v.shape),
                       init(jc))
    tst = (ttr.init_state_imm if imm else ttr.init_state)(
        tc, "cpu", (N_STREAMS,))
    _compare(jst, tst, "init")
    for i in range(N_STEPS):
        args = [z[i], t[i], valid[i]] + [ex[k][i] for k in names]
        jst, jout = jstep(jst, *[jnp.asarray(a) for a in args])
        tst, tout, terms = tfn(tst, *[torch.from_numpy(np.asarray(a))
                                      for a in args[:3]], tc,
                               **{k: torch.from_numpy(ex[k][i])
                                  for k in names})
        _check_margins(terms, tc, torch.from_numpy(valid[i]), f"{name} {i}")
        _compare(jout, tout, f"{name} step {i} outputs")
        _compare(jst, tst, f"{name} step {i} state")
    counts = {k: int(getattr(tst, k).sum())
              for k in ("next_id", "dropped", "unassigned")}
    # the sequences exercise the lifecycle: spawns, coast drops, and for the
    # full bank measurements with no free slot
    assert counts["next_id"] > 2 * N_STREAMS and counts["dropped"] > 0
    assert counts["unassigned"] > 0 or name != "nearest_full_bank"
    assert bool(tout["track_confirmed"].any())


MULTI_CASES = {
    "cheap": (dict(), False),
    "exact": (dict(joint_association="exact"), False),
    "cheap_zcovs": (dict(), True),
    "exact_zcovs_d3": (dict(joint_association="exact", dim=3,
                            gate_maha2=11.34), True),
}


@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_step_multi_matches_reference(name):
    """JPDA updates with three simultaneous measurements (two sources and
    clutter) into four slots, over 6 streams."""
    kw, with_covs = MULTI_CASES[name]
    jc, tc = _cfgs(**kw)
    seed = 20 + sorted(MULTI_CASES).index(name)
    n_meas = 3
    z, t, valid = _sequence(seed, N_STREAMS, N_STEPS, tc.dim, n_meas=n_meas)
    covs = _spd(np.random.default_rng(seed), (N_STEPS, N_STREAMS, n_meas),
                tc.dim, 0.02, 0.05) if with_covs else None

    def one(state, z_, t_, v_, *c):
        return jtr.step_multi(state, z_, t_, v_, jc,
                              z_covs=c[0] if c else None)

    jstep = jax.jit(jax.vmap(one))
    jst = jax.tree.map(lambda v: jnp.broadcast_to(v, (N_STREAMS,) + v.shape),
                       jtr.init_state(jc))
    tst = ttr.init_state(tc, "cpu", (N_STREAMS,))
    for i in range(N_STEPS):
        extra = [] if covs is None else [covs[i]]
        jst, jout = jstep(jst, *[jnp.asarray(a) for a in
                                 (z[i], t[i], valid[i], *extra)])
        tst, tout, terms = ttr._step_multi(
            tst, torch.from_numpy(z[i]), torch.from_numpy(t[i]),
            torch.from_numpy(valid[i]), tc,
            None if covs is None else torch.from_numpy(covs[i]))
        _check_margins(terms, tc, torch.from_numpy(valid[i]), f"{name} {i}")
        _compare(jout, tout, f"{name} step {i} outputs")
        _compare(jst, tst, f"{name} step {i} state")
    assert int(tst.dropped.sum()) > 0 and bool(tout["track_confirmed"].any())
    assert bool((tout["assigned"] >= 0).any())


@pytest.mark.parametrize("n,k", [(1, 1), (2, 3), (4, 4), (5, 2), (12, 3)])
def test_joint_event_tables_equal_reference(n, k):
    for got, want in zip(ttr._joint_event_tables(n, k),
                         jtr._joint_event_tables(n, k)):
        np.testing.assert_array_equal(got, want)


def test_joint_event_tables_guard():
    with pytest.raises(ValueError, match="cheap"):
        ttr._joint_event_tables(12, 12)


@pytest.mark.parametrize("dim", [2, 3])
def test_rts_smooth_matches_reference(dim):
    """A filtered history of one track (the port's own filter over 20
    events of a moving source) smoothed by both packages."""
    cfg = dict(dim=dim, gate_maha2=11.34 if dim == 3 else 9.21)
    jc, tc = _cfgs(**cfg)
    rng = np.random.default_rng(40 + dim)
    t = np.cumsum(rng.uniform(0.05, 0.3, 20)).astype(np.float32)
    v = rng.normal(0, 0.3, dim)
    z = (0.5 + v * t[:, None] + rng.normal(0, 0.01, (20, dim))).astype(
        np.float32)
    tr = ttr.Tracker(tc, "cpu")
    st = tr.init()
    xs, ps = [], []
    for zi, ti in zip(z, t):
        st, out = tr.step(st, zi, ti)
        assert int(out["assigned"]) in (-1, 0)
        xs.append(st.x[0].clone())
        ps.append(st.p[0].clone())
    x, p = torch.stack(xs), torch.stack(ps)
    got = tr.smooth(x, p, t)
    want = jtr.rts_smooth(jnp.asarray(x.numpy()), jnp.asarray(p.numpy()),
                          jnp.asarray(t), jc)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL)
    assert torch.equal(got[0][-1], x[-1])
    # batched over tracks: two histories in one call, each its own
    both = ttr.rts_smooth(torch.stack([x, x.flip(0)]),
                          torch.stack([p, p.flip(0)]),
                          torch.from_numpy(np.stack([t, t + 1.0])), tc)
    np.testing.assert_allclose(both[0][0].numpy(), got[0].numpy(),
                               rtol=RTOL, atol=ATOL)


def test_tracker_step_many_over_16_streams():
    """The JAX ``Tracker.step_many`` (vmap) and the port's on 16 stacked
    streams with per-stream covariances; the single-stream ``step`` is the
    batched step's row."""
    jc, tc = _cfgs()
    z, t, valid = _sequence(50, 16, 10, 2)
    covs = _spd(np.random.default_rng(50), (10, 16), 2, 0.02, 0.05)
    jt, tt = jtr.Tracker(jc), ttr.Tracker(tc, "cpu")
    jst, tst = jt.init_many(16), tt.init_many(16)
    one = tt.init()
    for i in range(10):
        jst, jout = jt.step_many(jst, z[i], t[i], valid[i], covs[i])
        tst, tout = tt.step_many(tst, z[i], t[i], valid[i], covs[i])
        _compare(jout, tout, f"step {i} outputs")
        _compare(jst, tst, f"step {i} state")
        one, oout = tt.step(one, z[i, 3], t[i, 3], valid[i, 3], covs[i, 3])
        for k in oout:
            assert torch.equal(oout[k], tout[k][3]), (i, k)
    assert one.x.shape == (4, 4) and one.next_id.ndim == 0


def test_tracker_refusals():
    tt = ttr.Tracker(ttr.TrackerConfig(), "cpu")
    with pytest.raises(ValueError, match="v_cov requires z_vel"):
        tt.step(tt.init(), [0.0, 0.0], 0.1, v_cov=np.eye(2))
    imm = ttr.Tracker(ttr.TrackerConfig(imm_q=(0.05, 8.0)), "cpu")
    with pytest.raises(ValueError, match="z_vel is not supported"):
        imm.step(imm.init(), [0.0, 0.0], 0.1, z_vel=[0.0, 0.0])
    with pytest.raises(ValueError, match="step_multi is not supported"):
        imm.step_multi(imm.init(), np.zeros((2, 2)), 0.1)
    with pytest.raises(ValueError, match="imm_q"):
        ttr.init_state_imm(ttr.TrackerConfig(), "cpu")
    # the default device is the card: no quiet fall-back to the CPU
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ttr.Tracker().init()


def test_converted_track_state_continues_equal():
    """A JAX bank state handed to the port mid-sequence continues equal."""
    jc, tc = _cfgs(association="soft")
    z, t, valid = _sequence(60, 4, 8, 2)
    fn = jax.jit(jax.vmap(functools.partial(jtr.step, cfg=jc)))
    jst = jax.tree.map(lambda v: jnp.broadcast_to(v, (4,) + v.shape),
                       jtr.init_state(jc))
    for i in range(4):
        jst, _ = fn(jst, z[i], t[i], valid[i])
    tst = convert.track_state_from_reference(_np_tree(jst), "cpu")
    for i in range(4, 8):
        jst, jout = fn(jst, z[i], t[i], valid[i])
        tst, tout = ttr.step(tst, torch.from_numpy(z[i]),
                             torch.from_numpy(t[i]),
                             torch.from_numpy(valid[i]), tc)
        _compare(jout, tout, f"converted step {i}")
    _compare(jst, tst, "converted state")
    # and back: the JAX package continues the port's state
    back = jtr.TrackState(**{k: jnp.asarray(v) for k, v in
                             convert.track_state_to_numpy(tst).items()})
    _, jout = fn(back, z[0], t[0] + 9.0, valid[0])
    _, tout = ttr.step(tst, torch.from_numpy(z[0]),
                       torch.from_numpy(t[0] + 9.0),
                       torch.from_numpy(valid[0]), tc)
    _compare(jout, tout, "handed back")
    with pytest.raises(ValueError, match="lacks"):
        convert.track_state_from_reference({"x": z[0]}, "cpu")


def test_tracker_defaults_to_the_card():
    """An entry point runs on the card unless the caller asks for the CPU:
    ``Tracker(cfg)`` takes device 'cuda', and nothing falls back to the CPU
    when no card is found (``test_tracker_refusals``)."""
    assert ttr.Tracker(ttr.TrackerConfig()).device == "cuda"
    assert ttr.Tracker(ttr.TrackerConfig(dim=3)).device == "cuda"
    assert ttr.Tracker(ttr.TrackerConfig(), "cpu").device == "cpu"
