"""PyTorch port, ``models/neural`` against the JAX package's, on the same
seeded numpy inputs (``square_array(0.3)``, PHAT, 256-sample frames, 16
scenes a batch, a (32, 16) hidden MLP whose weights come from the JAX
package's ``init_mlp`` through ``utils.convert.mlp_params_from_reference``).

Tolerances, from the measured gaps: the port's features come from row 2's
plain version (``localizer.conditioned_correlograms``), the reference's
from its unfused matmul engine, both float32 under PHAT (~1.4e-4 of scale
from float64).
- ``apply_mlp`` within 1e-5 of the output scale (the same arithmetic).
- ``features`` within 1e-4 absolute of the max-normalized correlograms
  and, with ``include_tdoa``, of the soft-argmax lags / K (measured
  8.9e-6 / 1.9e-5; the soft-argmax multiplies the correlograms' rounding
  by its temperature beta * K).
- ``loss`` within 1e-5 relative (1.9e-7), its gradients within 1e-4 of
  each layer's largest entry (8.0e-6); five ``train_step``s and ``fit``
  over three batches: losses within 1e-5 relative step by step (1.8e-6),
  ``predict`` within 1e-4 m (9.0e-6).  Adam normalises each gradient
  entry, so an entry near zero may step by up to ``lr`` in one package
  and not in the other: the weights are held within ``2 * lr * steps``
  (1.2e-4).
- ``synthetic_batches``: anechoic and bank modes equal to the reference's
  arrays; room mode within 3e-5 of scale (``tests/test_torch_room.py``'s
  ``simulate_batch`` tolerance).
"""

import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import neural as jnn
from audio_triangulation_tpu.utils import room as jroom, synth as jsynth
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import neural as tnn
from audio_triangulation_tpu_torch.utils import convert, room as troom

MICS = jgeo.square_array(0.3)
KW = dict(frame_size_bits=8, phat=True)
HIDDEN = (32, 16)
LR = 1e-3


def _nets(include_tdoa=True):
    j = jnn.NeuralLocalizer.create(MICS, jcfg.PipelineConfig(**KW),
                                   hidden=HIDDEN, include_tdoa=include_tdoa)
    t = tnn.NeuralLocalizer.create(MICS, tcfg.PipelineConfig(**KW),
                                   device="cpu", hidden=HIDDEN,
                                   include_tdoa=include_tdoa)
    return j, t


@functools.lru_cache(maxsize=None)
def _dataset(n=16, seed=0, noise=0.02):
    """tests/test_neural.py's scenes at 256 samples."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-0.9, 0.9, (n, 2)).astype(np.float32)
    src = np.concatenate([xy, np.full((n, 1), 1.2)], axis=-1)
    frames = jsynth.synth_scene(src, MICS, n=256, noise_rms=noise, seed=seed)
    return frames.astype(np.float32), xy


def _same_weights(jparams, mlp, atol):
    for i, layer in enumerate(mlp.children()):
        ref = jparams[f"layer_{i}"]
        np.testing.assert_allclose(layer.weight.detach().numpy(),
                                   np.asarray(ref["w"]).T, atol=atol)
        np.testing.assert_allclose(layer.bias.detach().numpy(),
                                   np.asarray(ref["b"]), atol=atol)


def test_apply_mlp_matches_reference():
    sizes = (40, *HIDDEN, 2)
    jparams = jnn.init_mlp(3, sizes)
    mlp = convert.mlp_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    assert [n for n, _ in mlp.named_children()] == [
        "layer_0", "layer_1", "layer_2"]
    x = np.random.default_rng(1).normal(size=(9, 40)).astype(np.float32)
    ref = np.asarray(jnn.apply_mlp(jparams, jnp.asarray(x)))
    got = tnn.apply_mlp(mlp, torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError):
        convert.mlp_params_from_reference({"layer_1": {}}, "cpu")


def test_init_mlp_is_seeded_he():
    sizes = (600, 256, 2)
    a, b = tnn.init_mlp(0, sizes, "cpu"), tnn.init_mlp(0, sizes, "cpu")
    c = tnn.init_mlp(1, sizes, "cpu")
    assert torch.equal(a.layer_0.weight, b.layer_0.weight)
    assert not torch.equal(a.layer_0.weight, c.layer_0.weight)
    for layer, fan_in in ((a.layer_0, 600), (a.layer_1, 256)):
        assert float(layer.bias.detach().abs().max()) == 0.0
        std = float(layer.weight.detach().std())
        assert abs(std / np.sqrt(2.0 / fan_in) - 1.0) < 0.05
    assert a.layer_1.weight.shape == (2, 256)


@pytest.mark.parametrize("include_tdoa", [True, False],
                         ids=["with_tdoa", "correlograms"])
def test_features_match_reference(include_tdoa):
    j, t = _nets(include_tdoa)
    assert t.feature_dim == j.feature_dim and t.sizes == j.sizes
    frames, _ = _dataset()
    ref = np.asarray(j.features(jnp.asarray(frames)))
    got = t.features(torch.from_numpy(frames))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _reference_training():
    """The JAX package's loss and grads at init, five train_steps, a
    predict and a three-batch fit, from init_mlp(0)."""
    j, _ = _nets()
    frames, xy = _dataset()
    params, opt_state = j.init(seed=0)
    init = jax.tree_util.tree_map(np.asarray, params)
    loss, grads = jax.value_and_grad(j.loss)(params, jnp.asarray(frames),
                                             jnp.asarray(xy))
    losses = []
    for _ in range(5):
        params, opt_state, l5 = j.train_step(params, opt_state,
                                             jnp.asarray(frames),
                                             jnp.asarray(xy))
        losses.append(float(l5))
    val, _ = _dataset(8, seed=2)
    pred = np.asarray(j.predict(params, jnp.asarray(val)))
    data = list(jnn.synthetic_batches(
        MICS, n_batches=3, batch_size=16, pipeline=j.pipeline, seed=3))
    (_, _), fit_losses = j.fit(data, seed=0)
    return dict(init=init, loss=float(loss),
                grads=jax.tree_util.tree_map(np.asarray, grads),
                losses=losses, params=jax.tree_util.tree_map(np.asarray,
                                                             params),
                pred=pred, data=data, fit_losses=fit_losses)


def test_loss_and_gradients_match_reference():
    ref = _reference_training()
    _, t = _nets()
    frames, xy = _dataset()
    mlp = convert.mlp_params_from_reference(ref["init"], "cpu")
    loss = t.loss(mlp, torch.from_numpy(frames), torch.from_numpy(xy))
    loss.backward()
    assert abs(loss.item() - ref["loss"]) <= 1e-5 * ref["loss"]
    for i, layer in enumerate(mlp.children()):
        g = ref["grads"][f"layer_{i}"]
        np.testing.assert_allclose(layer.weight.grad.numpy(), g["w"].T,
                                   atol=1e-4 * np.abs(g["w"]).max())
        np.testing.assert_allclose(layer.bias.grad.numpy(), g["b"],
                                   atol=1e-4 * np.abs(g["b"]).max())


def test_train_steps_predict_and_fit_match_reference():
    ref = _reference_training()
    _, t = _nets()
    frames, xy = _dataset()
    mlp = convert.mlp_params_from_reference(ref["init"], "cpu")
    opt = t.optimizer(mlp)
    for step in range(5):
        mlp, opt, loss = t.train_step(mlp, opt, frames, xy)
        assert abs(float(loss) - ref["losses"][step]) <= (
            1e-5 * ref["losses"][step])
    _same_weights(ref["params"], mlp, atol=2 * LR * 5)
    val, _ = _dataset(8, seed=2)
    pred = t.predict(mlp, val)
    assert pred.shape == (8, 2) and not pred.requires_grad
    np.testing.assert_allclose(pred.numpy(), ref["pred"], atol=1e-4)

    # fit from the same initial weights over the reference's batches
    mlp0 = convert.mlp_params_from_reference(ref["init"], "cpu")
    (mlp_f, _), losses = t.fit(ref["data"], state=(mlp0, t.optimizer(mlp0)))
    assert len(losses) == 3 and np.isfinite(losses).all()
    np.testing.assert_allclose(losses, ref["fit_losses"], rtol=1e-5)


def test_fit_from_seed_runs():
    """``fit`` from the port's own ``init_mlp`` on the CPU: losses fall
    over 20 steps of one batch."""
    _, t = _nets()
    frames, xy = _dataset()
    (params, opt), losses = t.fit([(frames, xy)] * 20, seed=1)
    assert isinstance(opt, torch.optim.Adam)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("mode", ["anechoic", "bank"])
def test_synthetic_batches_match_reference(mode):
    kw = dict(n_batches=2, batch_size=4, pipeline=None, seed=4,
              bank=6 if mode == "bank" else 0)
    ref = list(jnn.synthetic_batches(
        MICS, **{**kw, "pipeline": jcfg.PipelineConfig(**KW)}))
    got = list(tnn.synthetic_batches(
        MICS, **{**kw, "pipeline": tcfg.PipelineConfig(**KW)},
        device="cpu"))
    assert len(got) == len(ref) == 2
    for (fr, xy), (rfr, rxy) in zip(got, ref):
        assert fr.dtype == np.float32 and fr.shape == (4, 4, 256)
        np.testing.assert_array_equal(fr, rfr)
        np.testing.assert_array_equal(xy, rxy)


def test_synthetic_batches_room_mode():
    room_kw = dict(size=(6.0, 6.0, 3.0), absorption=0.4, max_order=2)
    kw = dict(n_batches=1, batch_size=4, seed=4)
    (rfr, rxy), = jnn.synthetic_batches(
        MICS, pipeline=jcfg.PipelineConfig(**KW),
        room=jroom.ShoeboxRoom(**room_kw), **kw)
    (fr, xy), = tnn.synthetic_batches(
        MICS, pipeline=tcfg.PipelineConfig(**KW),
        room=troom.ShoeboxRoom(**room_kw), device="cpu", **kw)
    np.testing.assert_array_equal(xy, rxy)
    assert fr.shape == (4, 4, 256) and np.isfinite(fr).all()
    # the same noise draws on the simulated frames
    assert np.abs(fr - rfr).max() <= 3e-5 * np.abs(rfr).max()
    with pytest.raises(TypeError):
        next(tnn.synthetic_batches(MICS, n_batches=1, batch_size=1,
                                   room=object(), device="cpu"))


def test_create_defaults_to_the_card():
    """``NeuralLocalizer.create`` builds on 'cuda' unless the caller asks
    for the CPU; without a card it raises rather than carry on."""
    import inspect

    assert inspect.signature(tnn.NeuralLocalizer.create).parameters[
        "device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tnn.NeuralLocalizer.create(MICS)


@pytest.mark.gpu
def test_card_matches_cpu_path():
    """On the card the features come from row 2 (one launch a call),
    within 2e-4 of the CPU path's (the kernel is held to 1e-4 of scale of
    float64), and a train step's loss within 1e-4 relative of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    frames, xy = _dataset()
    ref = _reference_training()
    out = {}
    for dev in ("cpu", "cuda"):
        t = tnn.NeuralLocalizer.create(MICS, tcfg.PipelineConfig(**KW),
                                       device=dev, hidden=HIDDEN)
        before = gcc_kernel.launches
        feats = t.features(torch.from_numpy(frames).to(dev))
        if dev == "cuda":
            assert gcc_kernel.launches == before + 1
        mlp = convert.mlp_params_from_reference(ref["init"], dev)
        _, _, loss = t.train_step(mlp, t.optimizer(mlp), frames, xy)
        out[dev] = feats.cpu().numpy(), float(loss)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=2e-4)
    assert abs(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * out["cpu"][1]
