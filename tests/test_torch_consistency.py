"""PyTorch port, ``ops.consistency``: every function against the JAX
package's on the same numpy TDOAs, for 4 and 6 mics, batched, with a dead
channel.  Float tolerance: both sides solve M x M systems in float32 by LU,
so values agree to a few ulp of the TDOA scale (rtol 1e-4, atol 1e-4 of the
largest TDOA); the fault flags must be equal."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import geometry as jgeo
from audio_triangulation_tpu.ops import consistency as jcon
from audio_triangulation_tpu_torch.ops import consistency as tcon


def _tdoas(m, dead=None, batch=5, seed=0):
    """Consistent TDOAs (seconds) of random arrival times plus noise; the
    pairs of a ``dead`` mic replaced by garbage.  [batch, P] f32."""
    rng = np.random.default_rng(seed)
    pairs = jgeo.mic_pairs(m)
    t = rng.normal(size=(batch, m)) * 3e-4
    tau = t[:, pairs[:, 1]] - t[:, pairs[:, 0]]
    tau += rng.normal(size=tau.shape) * 2e-6
    if dead is not None:
        touch = (pairs == dead).any(axis=1)
        tau[:, touch] = rng.normal(size=(batch, int(touch.sum()))) * 5e-4
    return tau.astype(np.float32), pairs


def _close(got, ref, scale):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * scale)


CASES = [(4, None), (4, 2), (6, None), (6, 3)]
IDS = ["4mics", "4mics_dead2", "6mics", "6mics_dead3"]


@pytest.mark.parametrize("m,dead", CASES, ids=IDS)
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
def test_project_and_scores(m, dead, weighted):
    tau, pairs = _tdoas(m, dead)
    scale = np.abs(tau).max()
    w = None
    if weighted:
        w = np.random.default_rng(1).uniform(0.2, 1.0, tau.shape).astype(
            np.float32)
    ref = jcon.project_consistent(jnp.asarray(tau), jnp.asarray(pairs), m,
                                  None if w is None else jnp.asarray(w))
    got = tcon.project_consistent(torch.from_numpy(tau),
                                  torch.from_numpy(pairs), m,
                                  None if w is None else torch.from_numpy(w))
    for g, r in zip(got, ref):
        _close(g, r, scale)
    _close(tcon.mic_consistency_scores(got[2], torch.from_numpy(pairs), m),
           jcon.mic_consistency_scores(ref[2], jnp.asarray(pairs), m), scale)
    # one unbatched row gives the batched row
    one = tcon.project_consistent(torch.from_numpy(tau[0]),
                                  torch.from_numpy(pairs), m,
                                  None if w is None else torch.from_numpy(w[0]))
    _close(one[0], np.asarray(ref[0])[0], scale)


@pytest.mark.parametrize("m", [4, 6])
def test_mic_and_pair_weights(m):
    rng = np.random.default_rng(2)
    pairs = jgeo.mic_pairs(m)
    scores = rng.uniform(1e-6, 4e-6, (3, m)).astype(np.float32)
    scores[1, 0] = 3e-4  # one bad mic
    for kw in ({}, {"ratio": 2.0, "floor": 1e-5}):
        _close(tcon.mic_weights(torch.from_numpy(scores), **kw),
               jcon.mic_weights(jnp.asarray(scores), **kw), 1.0)
    w_mic = rng.uniform(0.1, 1.0, (3, m)).astype(np.float32)
    got = tcon.pair_weights(torch.from_numpy(w_mic), torch.from_numpy(pairs),
                            m)
    ref = jcon.pair_weights(jnp.asarray(w_mic), jnp.asarray(pairs), m)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("m,dead", CASES, ids=IDS)
def test_exclusion_and_fault_weights(m, dead):
    tau, pairs = _tdoas(m, dead, seed=3)
    kw = dict(ratio=3.0, floor=1e-5)
    ref = jcon.mic_exclusion_weights(jnp.asarray(tau), jnp.asarray(pairs), m,
                                     **kw)
    got = tcon.mic_exclusion_weights(torch.from_numpy(tau),
                                     torch.from_numpy(pairs), m, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-3,
                               atol=1e-5)
    if dead is not None and m >= 5:
        assert (got.argmin(dim=-1) == dead).all()
    rw, rtau, rmic = jcon.fault_weights(jnp.asarray(tau), jnp.asarray(pairs),
                                        m, **kw)
    gw, gtau, gmic = tcon.fault_weights(torch.from_numpy(tau),
                                        torch.from_numpy(pairs), m, **kw)
    # weights are Cauchy functions of residual ratios: relative 2e-3
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), rtol=2e-3,
                               atol=1e-5)
    np.testing.assert_allclose(gmic.numpy(), np.asarray(rmic), rtol=2e-3,
                               atol=1e-5)
    _close(gtau, rtau, np.abs(tau).max())


@pytest.mark.parametrize("m,dead", CASES, ids=IDS)
def test_diagnose_mics(m, dead):
    tau, pairs = _tdoas(m, dead, seed=4)
    ref = jcon.diagnose_mics(jnp.asarray(tau), jnp.asarray(pairs), m)
    got = tcon.diagnose_mics(torch.from_numpy(tau), torch.from_numpy(pairs),
                             m)
    scale = np.abs(tau).max()
    _close(got["scores"], ref["scores"], scale)
    _close(got["residual_rms"], ref["residual_rms"], scale)
    np.testing.assert_array_equal(got["faulty"].numpy(),
                                  np.asarray(ref["faulty"]))


def test_median_averages_the_middle_pair():
    """An even count: jnp.median averages the two middle values, which
    ``torch.median`` does not."""
    s = np.array([[1e-6, 2e-6, 4e-6, 9e-6]], np.float32)
    _close(tcon.mic_weights(torch.from_numpy(s)),
           jcon.mic_weights(jnp.asarray(s)), 1.0)
