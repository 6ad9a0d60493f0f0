"""PyTorch port: the SRP gather (``ops/cuda/srp_gather``), its plain version
on the CPU held to the JAX package's one-hot product
(``ops.srp.srp_scores_matmul``) and ``argmax`` at the benchmark cells' own
lag tables, with fewer frames: the 3-mic 101 x 101 grid in f32, the 4-mic
square's stride-3 grid in bf16, and the 8-mic circle's 360 azimuths.  Then
the tie rule, the non-finite rule, the one-hot flag an estimator keeps
and the route's refusals (the shared-memory fit, which the built library
reckons, is a ``gpu`` case of ``test_torch_srp_gather_gpu.py``)."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.models import doa as jdoa
from audio_triangulation_tpu.ops import srp as jsrp
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.models import doa as tdoa
from audio_triangulation_tpu_torch.models import localizer as tloc
from audio_triangulation_tpu_torch.ops.cuda import srp_gather
from audio_triangulation_tpu_torch.utils import profiling

# the benchmark cells' arrays, lag windows, grids and score types
CELLS = {
    "ref3": dict(mics=jgeo.reference_array(), max_shift=46,
                 grid=dict(half_cells_x=50, half_cells_y=50,
                           cells_per_m=24.0), dtype="float32"),
    "square4": dict(mics=jgeo.square_array(0.3), max_shift=46,
                    grid=dict(half_cells_x=16, half_cells_y=16,
                              cells_per_m=8.0), dtype="bfloat16"),
    "circ8": dict(mics=jgeo.circular_array(8, 0.15), max_shift=45,
                  azimuths=360, dtype="float32"),
}
SHAPES = {"ref3": (3, 93, 10201), "square4": (6, 93, 1089),
          "circ8": (28, 91, 360)}


def _cell(name):
    """(JAX lut [P, G] int32, JAX one-hot [P*L, G], L, dtype) of a cell."""
    c = CELLS[name]
    pipe = jcfg.PipelineConfig(max_shift_samples=c["max_shift"])
    pairs = jgeo.mic_pairs(c["mics"].shape[0])
    if "azimuths" in c:
        lut = jdoa.azimuth_lag_lut(c["mics"], pairs, pipe, c["azimuths"])
    else:
        lut = jgeo.lag_lut(jcfg.GridConfig(**c["grid"]), c["mics"], pairs,
                           pipe).reshape(pairs.shape[0], -1)
    onehot = jgeo.lag_onehot(lut[:, None, :], pipe.num_lags)
    assert (lut.shape[0], pipe.num_lags, lut.shape[1]) == SHAPES[name]
    return lut, onehot, pipe.num_lags, c["dtype"]


def _reference(corr, onehot, dtype):
    """The JAX package's product and first-max cell."""
    s = jsrp.srp_scores_matmul(jnp.asarray(corr), jnp.asarray(onehot), dtype)
    return np.asarray(s), np.asarray(jnp.argmax(s, axis=-1))


def _table(lut, onehot, num_lags):
    table = torch.from_numpy(lut.astype(np.int32))
    assert srp_gather.is_lag_onehot(table, torch.from_numpy(onehot),
                                    num_lags)
    return table


def _clear(scores, tol=1e-5):
    """Rows whose best score is more than ``tol`` of the row's scale above
    every lower score (as the benchmark's ``correct`` judges a grid cell).
    Cells of the same lags tie exactly in either sum; the first wins."""
    best = scores.max(axis=-1, keepdims=True)
    below = np.where(scores < best, scores, -np.inf).max(axis=-1)
    scale = np.abs(scores).max(axis=-1)
    return best[:, 0] - below > tol * scale


@pytest.mark.parametrize("name", sorted(CELLS))
def test_plain_version_matches_the_reference_product(name):
    """Scores within 1e-6 of their scale of the JAX package's product (the
    sums in another order at most), and the same first-max cell on every
    frame whose best cell is clear (noise with a peak planted at a drawn
    cell's lags, so that most are)."""
    lut, onehot, num_lags, dtype = _cell(name)
    table = _table(lut, onehot, num_lags)
    rng = np.random.default_rng(len(name))
    corr = rng.normal(size=(24, lut.shape[0], num_lags)).astype(np.float32)
    for f, g in enumerate(rng.integers(0, lut.shape[1], 24)):
        corr[f, np.arange(lut.shape[0]), lut[:, g]] += 4.0
    want_s, want_c = _reference(corr, onehot, dtype)
    got_s, got_c = srp_gather.scores_first_max_reference(
        torch.from_numpy(corr), table, dtype)
    assert got_s.dtype == torch.float32 and got_c.dtype == torch.int64
    scale = np.abs(want_s).max()
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0,
                               atol=1e-6 * scale)
    clear = _clear(want_s)
    assert clear.sum() >= 20
    np.testing.assert_array_equal(got_c.numpy()[clear], want_c[clear])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_integer_scores_tie_to_the_first_cell(name):
    """Integer correlograms sum exactly in any order, so the scores equal
    the product's bit for bit.  Every frame plants the same top value at
    the lags of a drawn cell and of the last cell, so at least two cells
    tie at the maximum: the first of them wins, as ``argmax`` gives it."""
    lut, onehot, num_lags, dtype = _cell(name)
    table = _table(lut, onehot, num_lags)
    rng = np.random.default_rng(7)
    corr = rng.integers(0, 3, size=(16, lut.shape[0], num_lags)).astype(
        np.float32)
    pair = np.arange(lut.shape[0])
    for f, g in enumerate(rng.integers(0, lut.shape[1] - 1, 16)):
        corr[f, pair, lut[:, g]] = 5.0
        corr[f, pair, lut[:, -1]] = 5.0
    want_s, want_c = _reference(corr, onehot, dtype)
    got_s, got_c = srp_gather.scores_first_max_reference(
        torch.from_numpy(corr), table, dtype)
    np.testing.assert_array_equal(got_s.numpy(), want_s)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    ties = (want_s == want_s.max(axis=-1, keepdims=True)).sum(axis=-1)
    assert (ties > 1).all()  # every frame's maximum is a tie
    first = np.argmax(want_s == want_s.max(axis=-1, keepdims=True), axis=-1)
    np.testing.assert_array_equal(got_c.numpy(), first)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_non_finite_frames_score_nan_everywhere(name):
    """A frame holding a NaN, or an inf at a lag no cell reads, scores NaN
    in every cell as the product does (0 * NaN, 0 * inf), and its first
    maximum is cell 0; the other frames are untouched."""
    lut, onehot, num_lags, dtype = _cell(name)
    table = _table(lut, onehot, num_lags)
    rng = np.random.default_rng(3)
    corr = rng.normal(size=(6, lut.shape[0], num_lags)).astype(np.float32)
    corr[1, 0, int(lut[0, 0])] = np.nan
    unread = sorted(set(range(num_lags)) - set(lut[-1].tolist()))
    at = unread[0] if unread else 0
    corr[3, -1, at] = np.inf
    corr[4, 0, 0] = -np.inf
    want_s, want_c = _reference(corr, onehot, dtype)
    got_s, got_c = srp_gather.scores_first_max_reference(
        torch.from_numpy(corr), table, dtype)
    got_s, got_c = got_s.numpy(), got_c.numpy()
    for f in (1, 3, 4):
        assert np.isnan(want_s[f]).all() and np.isnan(got_s[f]).all()
        assert want_c[f] == got_c[f] == 0
    ok = [0, 2, 5]
    assert np.isfinite(got_s[ok]).all()
    scale = np.abs(want_s[ok]).max()
    np.testing.assert_allclose(got_s[ok], want_s[ok], rtol=0,
                               atol=1e-6 * scale)


def test_bf16_rounding_is_the_products():
    """bf16 rounds each value before the sum, as the product's operand
    does: values a bf16 ulp apart score apart in f32 and together in
    bf16."""
    lut, onehot, num_lags, _ = _cell("square4")
    table = _table(lut, onehot, num_lags)
    corr = np.full((2, lut.shape[0], num_lags), 1.0, np.float32)
    corr[1] += 2.0 ** -10  # under half a bf16 ulp of 1: rounds to 1
    for dtype, same in (("float32", False), ("bfloat16", True)):
        want_s, _ = _reference(corr, onehot, dtype)
        got_s, _ = srp_gather.scores_first_max_reference(
        torch.from_numpy(corr), table, dtype)
        np.testing.assert_array_equal(got_s.numpy(), want_s)
        assert np.array_equal(got_s[0].numpy(), got_s[1].numpy()) == same


def _cell_estimator(name):
    """The port's estimator of a cell, built on the CPU as the cell builds
    it, with its lag table's shape (P, L, G)."""
    c = CELLS[name]
    pipe = tcfg.PipelineConfig(max_shift_samples=c["max_shift"],
                               srp_dtype=c["dtype"])
    if "azimuths" in c:
        est = tdoa.DoaEstimator.create(c["mics"], pipe, c["azimuths"],
                                       device="cpu")
    else:
        grid = tcfg.GridConfig(**c["grid"])
        est = tloc.Localizer.create(c["mics"], pipe, grid, device="cpu",
                                    srp_form="matmul")
    return est, (est.lut_flat.shape[0], pipe.num_lags, est.lut_flat.shape[1])


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_cells_estimators_pass_the_routes_host_checks(name):
    """Each cell's estimator keeps the one-hot flag beside an int32 table
    equal to the JAX package's, and its scoring inputs pass every check
    of the route that the host makes: on the CPU the refusal is the
    device's alone, and a score bias or a wrong table is refused first."""
    lut, _, num_lags, _ = _cell(name)
    est, shape = _cell_estimator(name)
    assert shape == SHAPES[name]
    assert est.lag_onehot and est.params.lag_onehot
    assert est.lut_flat.dtype == torch.int32
    np.testing.assert_array_equal(est.lut_flat.numpy(), lut)
    corr = torch.zeros((4, shape[0], num_lags))
    assert srp_gather.refusal(corr, est.lut_flat, True).startswith(
        "correlograms on cpu")
    assert srp_gather.refusal(corr, est.lut_flat, True, True) == \
        "a score bias"
    assert srp_gather.refusal(corr, est.lut_flat, False).startswith(
        "the steering matrix")
    assert not srp_gather.route(corr, est.lut_flat, True)


def _ref3_localizer(**kw):
    mics = jgeo.reference_array()
    return tloc.Localizer.create(mics, tcfg.PipelineConfig(), device="cpu",
                                 srp_form="matmul", **kw)


def test_estimators_keep_the_table_of_their_one_hot():
    """``Localizer.create`` and ``DoaEstimator.create`` keep the flag that
    their steering matrix is the one-hot of ``lut_flat``, which the kernel
    reads; the gather form, the volume and the 3-D lattice keep none; the
    flag rides with the localizer when it moves."""
    loc = _ref3_localizer()
    assert loc.lag_onehot and loc.params.lag_onehot
    assert "lag_onehot" not in dict(loc.named_buffers())
    bf16 = tloc.Localizer.create(
        jgeo.square_array(0.3), tcfg.PipelineConfig(srp_dtype="bfloat16"),
        device="cpu", srp_form="matmul", init_grid_stride=3)
    assert bf16.lag_onehot and bf16.lut_flat.shape == (6, 1089)
    assert not tloc.Localizer.create(jgeo.reference_array(), device="cpu",
                                     srp_form="gather").lag_onehot
    assert loc.to("cpu").lag_onehot
    est = tdoa.DoaEstimator.create(
        jgeo.circular_array(8, 0.15),
        tcfg.PipelineConfig(phat=True, max_shift_samples=45), device="cpu")
    assert est.lag_onehot and est.params.lag_onehot
    assert est.params.lut_flat is est.lut_flat


def test_a_matrix_that_is_not_the_one_hot_keeps_the_product():
    """A steering matrix from the reference's constants that differs from
    the one-hot of its table (one weight changed, or a lag outside [0, L)
    whose column is left empty) gives no flag, so every call keeps the
    product."""
    loc = _ref3_localizer()
    arrays = {k: getattr(loc, k).numpy() for k in
              ("mic_positions", "pairs", "window", "lut_flat", "onehot")}
    same = tloc.Localizer.from_reference_params(
        arrays, loc.pipeline, loc.grid, loc.solver, device="cpu",
        srp_form="matmul")
    assert same.lag_onehot
    arrays["onehot"] = arrays["onehot"].copy()
    arrays["onehot"][0, 5] += 0.5
    other = tloc.Localizer.from_reference_params(
        arrays, loc.pipeline, loc.grid, loc.solver, device="cpu",
        srp_form="matmul")
    assert not other.lag_onehot
    lut = torch.tensor([[0, 1, 2], [2, 1, 0]], dtype=torch.int32)
    onehot = torch.zeros((2 * 3, 3))
    onehot[[0, 1, 2, 5, 4, 3], [0, 1, 2, 0, 1, 2]] = 1.0
    assert srp_gather.is_lag_onehot(lut, onehot, 3)
    out_of_range = lut.clone()
    out_of_range[0, 2] = 3  # past L: the product reads no lag there
    onehot[2, 2] = 0.0
    assert not srp_gather.is_lag_onehot(out_of_range, onehot, 3)
    assert not srp_gather.is_lag_onehot(lut.float(), onehot, 3)
    assert not srp_gather.is_lag_onehot(lut, None, 3)


def test_a_bias_or_a_table_too_large_keeps_the_product():
    """The route refuses a score bias, more lags than a byte holds, a table
    of other pairs, a table that is not int32 and correlograms that are
    not float32, each before it looks at the device, and it asks the
    library about shared memory (which needs the card) only last."""
    lut = torch.zeros((3, 10201), dtype=torch.int32)
    corr = torch.zeros((4, 3, 93))
    assert srp_gather.refusal(corr, lut, True, has_bias=True) == \
        "a score bias"
    wide = torch.zeros((3, 10), dtype=torch.int32)
    onehot = torch.zeros((3 * 300, 10))
    onehot[0::300] = 1.0
    assert srp_gather.is_lag_onehot(wide, onehot, 300)
    for c, t, why in ((torch.zeros((4, 3, 300)), wide, "300 lags"),
                      (corr, lut[:2], "3 pairs of correlograms"),
                      (corr, lut.long(), "no int32 lag table"),
                      (corr, None, "no int32 lag table"),
                      (corr.double(), lut, "correlograms (4, 3, 93)")):
        assert why in srp_gather.refusal(c, t), why
        assert not srp_gather.route(c, t, True)
    assert srp_gather.refusal(corr, lut).startswith("correlograms on cpu")


def test_the_cpu_counts_the_product_route():
    """On the CPU every call keeps the product and counts
    ``srp.route.product``; the outputs are the product's."""
    loc = _ref3_localizer()
    frames = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 3, 1024)).astype(np.float32))
    profiling.reset()
    with profiling.tracing():
        out = loc(frames)
        counts = profiling.counters()
    profiling.reset()
    assert counts.get("srp.route.product") == 1
    assert "srp.route.kernel" not in counts
    assert not srp_gather.route(out["correlograms"], loc.lut_flat,
                                loc.lag_onehot)
    scores = torch.matmul(out["correlograms"].reshape(4, -1), loc.onehot)
    assert torch.equal(out["scores"], scores)
