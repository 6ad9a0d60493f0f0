"""PyTorch port, ``models/calibration`` against the JAX package's, on the
same seeded numpy inputs (8 mics on a 0.2 m circle, 16 events of 256
samples; the EM and tracked fits at 8 / 12 events).

Tolerances, from the measured gaps: both packages run the GCC chain in
float32, and the reference's predicted TDOAs are float64 here (the test
suite enables x64 and its ``jnp.zeros`` of the lifted mics follow it),
the port's float32.
- ``measured_tdoas`` within 1e-4 samples (measured 5.7e-6) without PHAT
  and 2e-2 with it (5.4e-3): the softmax's temperature beta * K = 92
  multiplies the correlograms' ~1.4e-4 of scale from float64.
- Losses within 1e-5 relative (measured 9e-7) without PHAT, 1e-4 with it
  (1.3e-5: fp32 under PHAT rounds to ~1.4e-4 of scale); the
  gradient with respect to ``mic_xy`` (and ``source_xy``, ``traj_coeffs``)
  within 2e-5 / 2e-4 of its largest entry (2.4e-6 / 2.2e-5).  Values and
  gradients are the same with the port's checkpoint on and off.
- ``log_gain`` is the reference's trap, pinned, not repaired:
  ``soft_tdoa`` max-normalises each correlogram, which cancels a per-mic
  gain exactly, so its gradient is rounding noise in both packages, under
  1e-5 of the largest ``mic_xy`` entry without PHAT and 1e-4 with it
  (measured 2.5e-9 and 1.3e-5 of it), and Adam turns that noise into steps
  of up to ``lr``.  Each package's ``log_gain`` after ``s`` steps is held
  only within ``lr * s`` of zero, so the two within ``2 * lr * s``.
- Ten ``train_step``s: the losses step by step at the loss tolerances,
  ``mic_xy`` within 1e-6 m / 1e-5 m.
- ``estimate_speed_of_sound``: ``c`` within 1e-4 m/s (measured 5.0e-7),
  ``n_used`` equal, the per-event estimates within 1e-3 m/s (2.9e-5).
- ``fit_em`` (2 rounds x 5 steps) and ``fit_tracked`` (20 steps) from the
  same guess: geometry within 2e-6 m (2.5e-7 / 1.0e-7), trajectory within
  2e-6 (1.8e-7), losses within 1e-4 relative (1.0e-5 / 1.2e-5); the
  localizations of their E-steps go through the port's ``Localizer``
  (the GCC and GN kernels' plain versions here).
- Every kernel launcher refuses an input that requires grad; the plain
  version of row 2 and ``measured_tdoas`` keep their autograd.
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import calibration as jcal
from audio_triangulation_tpu.utils import synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import calibration as tcal
from audio_triangulation_tpu_torch.ops.cuda import (
    detector_scan, dft_matmul, gcc_kernel, gcc_large, gn_kernel, srp_kernel)
from audio_triangulation_tpu_torch.utils import convert

MICS8 = jgeo.circular_array(8, 0.2)
N_EVENTS = 16
LR = 3e-3
# (loss rel, gradient rel, log_gain gradient share) without / with PHAT
TOL = {False: (1e-5, 2e-5, 1e-5), True: (1e-4, 2e-4, 1e-4)}


def _place(xy, h=1.2):
    p = np.concatenate([xy, np.full(xy.shape[:-1] + (1,), h)], -1)
    return p * (h / np.linalg.norm(p, axis=-1, keepdims=True))


def _kw(phat):
    return dict(frame_size_bits=8, phat=phat)


@functools.lru_cache(maxsize=None)
def _scene():
    """(frames [16, 8, 256] f32, planes [16, 2] f32, guess [8, 2] f32)."""
    rng = np.random.default_rng(3)
    planes = rng.uniform(-1, 1, (N_EVENTS, 2)).astype(np.float32)
    frames = jsynth.synth_scene(_place(planes.astype(np.float64)), MICS8,
                                n=256, noise_rms=0.01, seed=4)
    guess = (MICS8 + rng.normal(0, 0.01, MICS8.shape)).astype(np.float32)
    return frames.astype(np.float32), planes, guess


def _extra(kind):
    """The third parameter of the joint / tracked losses and the times."""
    frames, planes, _ = _scene()
    rng = np.random.default_rng(5)
    if kind == "joint":
        return (planes + rng.normal(0, 0.05, planes.shape)).astype(
            np.float32), None
    times = np.sort(rng.uniform(-1.0, 1.0, N_EVENTS)).astype(np.float32)
    coeffs = np.array([[0.1, -0.2], [0.4, 0.3]], np.float32)
    return coeffs, times


def _jax_loss(kind, phat, params_np):
    """JAX value_and_grad of the ``kind`` loss at numpy parameters."""
    frames, planes, guess = _scene()
    c = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(phat)))
    params = {k: jnp.asarray(v) for k, v in params_np.items()}
    fr = jnp.asarray(frames)
    if kind == "calib":
        fn = functools.partial(
            jcal.calib_loss, batch=jcal.CalibBatch(
                frames=fr, source_xy=jnp.asarray(planes)),
            pairs=c.pairs, window=c.window, cfg=c.pipeline)
        p = jcal.CalibParams(**params)
    elif kind == "joint":
        fn = functools.partial(
            jcal.joint_loss, frames=fr, pairs=c.pairs, window=c.window,
            cfg=c.pipeline, mic_anchor=jnp.asarray(guess))
        p = jcal.JointParams(**params)
    else:
        fn = functools.partial(
            jcal.tracked_loss, frames=fr,
            times=jnp.asarray(_extra("tracked")[1]), pairs=c.pairs,
            window=c.window, cfg=c.pipeline, mic_anchor=jnp.asarray(guess))
        p = jcal.TrackedParams(**params)
    loss, grads = jax.value_and_grad(fn)(p)
    return float(loss), {k: np.asarray(getattr(grads, k)) for k in params}


def _params_np(kind):
    _, _, guess = _scene()
    out = {"mic_xy": guess, "log_gain": np.zeros(8, np.float32)}
    if kind == "joint":
        out["source_xy"] = _extra("joint")[0]
    elif kind == "tracked":
        out["traj_coeffs"] = _extra("tracked")[0]
    return out


@functools.lru_cache(maxsize=None)
def _reference(kind, phat):
    return _jax_loss(kind, phat, _params_np(kind))


def _port_loss(kind, phat, params, checkpoint=True):
    frames, planes, guess = _scene()
    c = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(phat)),
                               device="cpu")
    fr = torch.from_numpy(frames)
    if kind == "calib":
        return tcal.calib_loss(
            params, tcal.CalibBatch(fr, torch.from_numpy(planes)), c.pairs,
            c.window, c.pipeline, checkpoint=checkpoint)
    anchor = torch.from_numpy(guess)
    if kind == "joint":
        return tcal.joint_loss(params, fr, c.pairs, c.window, c.pipeline,
                               anchor, checkpoint=checkpoint)
    times = torch.from_numpy(_extra("tracked")[1])
    return tcal.tracked_loss(params, fr, times, c.pairs, c.window,
                             c.pipeline, anchor, checkpoint=checkpoint)


def test_soft_tdoa_matches_reference_with_ties():
    """Values and the gradient of a random cotangent, on random
    correlograms and on rows whose largest |value| is tied (two equal
    maxima, and +m against -m): ``amax`` splits a tie's gradient evenly,
    as ``jnp.max`` does."""
    rng = np.random.default_rng(0)
    k = 5
    c = rng.normal(size=(4, 3, 2 * k + 1)).astype(np.float32)
    c[0, 0, 2] = c[0, 0, 7] = 4.0  # two equal maxima
    c[1, 1, 1], c[1, 1, 9] = 3.0, -3.0  # +m and -m
    ct = rng.normal(size=(4, 3)).astype(np.float32)
    ref, vjp = jax.vjp(lambda x: jcal.soft_tdoa(x, k), jnp.asarray(c))
    (gref,) = vjp(jnp.asarray(ct))
    x = torch.tensor(c, requires_grad=True)
    got = tcal.soft_tdoa(x, k)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("phat", [False, True], ids=["plain", "phat"])
def test_measured_tdoas_match_reference(phat):
    frames, _, guess = _scene()
    jc = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(phat)))
    ref = np.asarray(jcal.measured_tdoas(
        jcal.init_params(guess), jnp.asarray(frames), jc.pairs, jc.window,
        jc.pipeline))
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(phat)),
                                device="cpu")
    for ck in (True, False):
        got = tcal.measured_tdoas(tcal.init_params(guess, "cpu"),
                                  torch.from_numpy(frames), tc.pairs,
                                  tc.window, tc.pipeline, checkpoint=ck)
        assert got.shape == (N_EVENTS, 28)
        np.testing.assert_allclose(got.detach().numpy(), ref,
                                   atol=2e-2 if phat else 1e-4)


@pytest.mark.parametrize("checkpoint", [True, False], ids=["remat", "kept"])
@pytest.mark.parametrize("phat", [False, True], ids=["plain", "phat"])
@pytest.mark.parametrize("kind", ["calib", "joint", "tracked"])
def test_losses_and_gradients_match_reference(kind, phat, checkpoint):
    loss_tol, grad_tol, gain_share = TOL[phat]
    ref_loss, ref_grads = _reference(kind, phat)
    params = convert.calib_params_from_reference(_params_np(kind), "cpu")
    loss = _port_loss(kind, phat, params, checkpoint)
    loss.backward()
    assert abs(loss.item() - ref_loss) <= loss_tol * abs(ref_loss)
    mic_max = np.abs(ref_grads["mic_xy"]).max()
    for name, g in ref_grads.items():
        got = getattr(params, name).grad.numpy()
        if name == "log_gain":  # rounding noise in both (the trap)
            assert np.abs(g).max() < gain_share * mic_max
            assert np.abs(got).max() < gain_share * mic_max
            continue
        np.testing.assert_allclose(got, g, atol=grad_tol * np.abs(g).max())


@pytest.mark.parametrize("phat", [False, True], ids=["plain", "phat"])
def test_train_steps_match_reference_and_log_gain_trap(phat):
    """Ten Adam steps from the same guess; ``log_gain`` moves by noise."""
    loss_tol, _, _ = TOL[phat]
    frames, planes, guess = _scene()
    steps = 10
    jc = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(phat)))
    jp, js = jc.init(guess)
    jb = jcal.CalibBatch(frames=jnp.asarray(frames),
                         source_xy=jnp.asarray(planes))
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(phat)),
                                device="cpu")
    assert tc.learning_rate == jc.learning_rate == LR
    tp, opt = tc.init(guess)
    assert isinstance(opt, torch.optim.Adam)
    tb = tcal.CalibBatch(torch.from_numpy(frames), torch.from_numpy(planes))
    for _ in range(steps):
        jp, js, jl = jc.train_step(jp, js, jb)
        tp, opt, tl = tc.train_step(tp, opt, tb)
        assert abs(float(tl) - float(jl)) <= loss_tol * abs(float(jl))
    np.testing.assert_allclose(tp.mic_xy.detach().numpy(),
                               np.asarray(jp.mic_xy),
                               atol=1e-6 if not phat else 1e-5)
    jg, tg = np.asarray(jp.log_gain), tp.log_gain.detach().numpy()
    assert np.abs(jg).max() <= LR * steps * (1 + 1e-3)
    assert np.abs(tg).max() <= LR * steps * (1 + 1e-3)
    assert np.abs(tg - jg).max() <= 2 * LR * steps


def test_fit_collects_losses():
    frames, planes, guess = _scene()
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(False)),
                                device="cpu")
    batch = tcal.CalibBatch(torch.from_numpy(frames),
                            torch.from_numpy(planes))
    params, losses = tc.fit(guess, [batch, batch], steps_per_batch=2)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert params.mic_xy.shape == (8, 2)


def test_joint_step_and_init():
    """``init_joint`` / ``train_step_joint``: three steps against the
    reference's."""
    frames, _, guess = _scene()
    src0 = _extra("joint")[0]
    jc = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(False)))
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(False)),
                                device="cpu")
    jp, js = jc.init_joint(guess, src0)
    tp, opt = tc.init_joint(guess, src0)
    for _ in range(3):
        jp, js, jl = jc.train_step_joint(jp, js, jnp.asarray(frames),
                                         jnp.asarray(guess))
        tp, opt, tl = tc.train_step_joint(tp, opt, frames, guess)
        assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    np.testing.assert_allclose(tp.source_xy.detach().numpy(),
                               np.asarray(jp.source_xy), atol=1e-6)
    np.testing.assert_allclose(tp.mic_xy.detach().numpy(),
                               np.asarray(jp.mic_xy), atol=1e-6)


def _sos_scene(c_true=350.0):
    """tests/test_calibration_tracked.py's speed-of-sound scene."""
    mics = jgeo.square_array(0.3)
    rng = np.random.default_rng(31)
    planes = rng.uniform(-0.8, 0.8, (48, 2))
    frames = jsynth.synth_scene(_place(planes), mics,
                                speed_of_sound=c_true, noise_rms=0.005,
                                seed=32)
    return frames, planes, mics


def test_estimate_speed_of_sound_matches_reference():
    frames, planes, mics = _sos_scene()
    c_ref, d_ref = jcal.estimate_speed_of_sound(
        frames, planes, mics, jcfg.PipelineConfig())
    c, diag = tcal.estimate_speed_of_sound(
        frames, planes, mics, tcfg.PipelineConfig(), device="cpu")
    assert abs(c - 350.0) < 1.0
    assert abs(c - c_ref) <= 1e-4
    assert diag["n_used"] == d_ref["n_used"]
    assert diag["rms_samples"] == pytest.approx(d_ref["rms_samples"],
                                                abs=1e-4)
    np.testing.assert_allclose(diag["c_samples"], d_ref["c_samples"],
                               atol=1e-3)
    # a tensor's own device is used when none is named
    c_t, _ = tcal.estimate_speed_of_sound(
        torch.from_numpy(frames.astype(np.float32)), planes, mics)
    assert c_t == pytest.approx(c, abs=1e-9)


def test_estimate_speed_of_sound_rejects_degenerate():
    mics = jgeo.square_array(0.3)
    frames = jsynth.synth_scene(np.array([[0.0, 0.0, 1.2]]), mics,
                                noise_rms=0.005, seed=1)
    with pytest.raises(ValueError):
        jcal.estimate_speed_of_sound(frames, np.zeros((1, 2)), mics,
                                     jcfg.PipelineConfig())
    with pytest.raises(ValueError, match="speed-of-sound"):
        tcal.estimate_speed_of_sound(frames, np.zeros((1, 2)), mics,
                                     tcfg.PipelineConfig(), device="cpu")


def _em_scene(n_events, seed):
    rng = np.random.default_rng(seed)
    planes = rng.uniform(-1.0, 1.0, (n_events, 2))
    frames = jsynth.synth_scene(_place(planes), MICS8, n=256,
                                noise_rms=0.003, seed=seed + 1)
    guess = (MICS8 + rng.normal(0, 0.012, MICS8.shape)).astype(np.float32)
    return frames.astype(np.float32), guess


def test_fit_em_matches_reference():
    """``tests/test_sharding.py``'s EM scene cut to 8 events of 256
    samples, 2 rounds x 5 steps."""
    frames, guess = _em_scene(8, 33)
    jc = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(False)))
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(False)),
                                device="cpu")
    ref, ref_losses = jc.fit_em(guess, jnp.asarray(frames), em_rounds=2,
                                inner_steps=5)
    got, losses = tc.fit_em(guess, frames, em_rounds=2, inner_steps=5)
    np.testing.assert_allclose(got, ref, atol=2e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_fit_tracked_matches_reference():
    """``tests/test_calibration_tracked.py``'s moving source cut to 12
    events of 256 samples, 20 steps."""
    rng = np.random.default_rng(55)
    p0, v = np.array([-0.8, -0.3]), np.array([0.55, 0.3])
    times = np.sort(rng.uniform(0.0, 2.2, 12)).astype(np.float32)
    traj = p0[None] + times[:, None] * v[None]
    frames = jsynth.synth_scene(_place(traj), MICS8, n=256,
                                noise_rms=0.003, seed=56).astype(np.float32)
    guess = (MICS8 + rng.normal(0, 0.012, MICS8.shape)).astype(np.float32)
    jc = jcal.Calibrator.create(8, jcfg.PipelineConfig(**_kw(False)))
    tc = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(False)),
                                device="cpu")
    ref_mics, ref_coeffs, ref_losses = jc.fit_tracked(
        guess, jnp.asarray(frames), times, steps=20)
    mics, coeffs, losses = tc.fit_tracked(guess, frames, times, steps=20)
    assert len(losses) == 20 and losses[-1] < losses[0]
    np.testing.assert_allclose(mics, ref_mics, atol=2e-6)
    np.testing.assert_allclose(coeffs, ref_coeffs, atol=2e-6)
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-4)


def test_entry_points_default_to_the_card():
    """``Calibrator.create`` builds on 'cuda' unless the caller asks for
    the CPU; without a card it raises rather than carry on on the CPU."""
    import inspect

    sig = inspect.signature(tcal.Calibrator.create)
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(tcal.init_params).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tcal.Calibrator.create(3)


# ----------------------------------------------------------------------
# the kernels have no backward pass: their launchers refuse grad

def _gcc_operands(requires_grad):
    cfg = tcfg.PipelineConfig(frame_size_bits=8, phat=True)
    frames = torch.randn(2, 3, 256, requires_grad=requires_grad)
    window = torch.ones(256)
    pairs = torch.as_tensor(jgeo.mic_pairs(3))
    return frames, window, pairs, cfg


def _launchers():
    """(kernel name, call with one input that requires grad)."""
    frames, window, pairs, cfg = _gcc_operands(True)
    ops = gcc_kernel.operands(frames.detach(), window, cfg)
    kw = dict(phat=True, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom)
    sp = gcc_kernel.stats_params(
        tcfg.PipelineConfig(frame_size_bits=8, band_hz="auto"), True)
    g = dict(requires_grad=True)
    re = torch.randn(2, 3, 9, **g)
    lut = torch.zeros(3, 4, dtype=torch.int32)
    gn = gn_kernel.GnSolver(jgeo.square_array(0.3), c=343.0, h=1.2,
                            iters=4, damping=1e-3, sphere=True)
    x = torch.randn(4, 64, **g)
    w = torch.randn(64, 16)
    return {
        "gcc_kernel": lambda: gcc_kernel.launch(
            frames, *ops, pairs, with_peaks=False, **kw),
        "gcc_stats_kernel": lambda: gcc_kernel.launch_stats(
            frames, *ops, pairs, sp, with_peaks=True, **kw),
        "gcc_srp_kernel": lambda: gcc_kernel.launch_srp(
            frames, *ops, pairs, lut, **kw),
        "gcc_pipelined_kernel": lambda: gcc_kernel.launch_pipelined(
            frames, *ops, pairs, **kw),
        "gcc_large_kernel": lambda: gcc_large.launch(
            re, re.detach(), pairs, torch.zeros(9, 5), torch.zeros(9, 5),
            packed=torch.zeros(1), bf16=False, with_peaks=False,
            max_shift=2, taper_denom=36.0),
        "gn_kernel": lambda: gn.launch(torch.randn(5, 6, **g),
                                       torch.zeros(5, 2)),
        "srp_argmax_kernel": lambda: srp_kernel.launch(
            torch.randn(5, 8, **g), torch.ones(8, 3), 3),
        "dft_matmul_kernel": lambda: dft_matmul.launch(
            x, w, w, torch.zeros(())),
        "detector_scan_kernel": lambda: detector_scan.launch(
            torch.randn(3, 100, **g)),
    }


@pytest.mark.parametrize("kernel", list(_launchers()))
def test_kernel_launchers_refuse_grad(kernel):
    """A launcher given an input that requires grad raises ValueError
    naming its kernel (before it looks at the device, so on the CPU too):
    its output would carry no gradient."""
    with pytest.raises(ValueError, match=f"{kernel}: an input requires "
                       "grad"):
        _launchers()[kernel]()


def test_row2_plain_version_and_measured_tdoas_keep_autograd():
    """On CPU tensors row 2's entry point runs its plain version, which
    differentiates; ``measured_tdoas`` (plain ``xcorr_fft``, no kernel)
    gives ``log_gain`` and ``mic_xy`` gradients."""
    frames, window, pairs, cfg = _gcc_operands(True)
    corr = gcc_kernel.fused_gcc(frames, window, pairs, cfg,
                                with_peaks=False)
    corr.square().sum().backward()
    assert frames.grad is not None and torch.isfinite(frames.grad).all()
    assert float(frames.grad.abs().max()) > 0

    fr, planes, guess = _scene()
    params = tcal.init_params(guess, "cpu")
    c = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(False)),
                               device="cpu")
    loss = tcal.calib_loss(params, tcal.CalibBatch(
        torch.from_numpy(fr), torch.from_numpy(planes)), c.pairs, c.window,
        c.pipeline)
    loss.backward()
    assert params.log_gain.grad is not None
    assert torch.isfinite(params.log_gain.grad).all()
    assert float(params.mic_xy.grad.abs().max()) > 1.0


@pytest.mark.gpu
def test_card_matches_cpu_path():
    """On the card: the loss and gradients of a calibration step at
    4,096 events (past the 2,048 transforms where cuFFT's batched inverse
    reads the DC and Nyquist imaginary parts) within the loss tolerances
    of the CPU path, and the launchers of the dft_matmul helpers refuse
    grad too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    frames, planes, guess = _scene()
    reps = 4096 // N_EVENTS
    fr = torch.from_numpy(np.tile(frames, (reps, 1, 1)))
    pl = torch.from_numpy(np.tile(planes, (reps, 1)))
    out = {}
    for dev in ("cpu", "cuda"):
        c = tcal.Calibrator.create(8, tcfg.PipelineConfig(**_kw(True)),
                                   device=dev)
        params = tcal.init_params(guess, dev)
        loss = tcal.calib_loss(params, tcal.CalibBatch(fr.to(dev),
                                                       pl.to(dev)),
                               c.pairs, c.window, c.pipeline)
        loss.backward()
        out[dev] = float(loss), params.mic_xy.grad.cpu().numpy()
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-4 * out["cpu"][0]
    g = out["cpu"][1]
    np.testing.assert_allclose(out["cuda"][1], g, atol=2e-4 * np.abs(g).max())
    w = torch.randn(64, 16, device="cuda", requires_grad=True)
    for fn, name in ((dft_matmul.k_major, "k_major_kernel"),
                     (dft_matmul.split_k_major, "split_pack_kernel")):
        with pytest.raises(ValueError, match=name):
            fn(w, w)
