"""PyTorch port: the SRP-argmax module (its plain version on the CPU)
against the JAX package's Pallas kernel in interpret mode, the large-array
scoring functions of ``ops.srp`` against the reference's, and the geometry
additions byte for byte; all on the same numpy inputs."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import srp as jsrp
from audio_triangulation_tpu.ops.pallas import srp_kernel as jsrpk
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.core import geometry as tgeo
from audio_triangulation_tpu_torch.ops import srp as tsrp
from audio_triangulation_tpu_torch.ops.cuda import srp_kernel as tsrpk

CFG = jcfg.PipelineConfig()
MICS = jgeo.reference_array()
PAIRS = jgeo.mic_pairs(3)
L = CFG.num_lags


def _onehot(half=12, cells_per_m=6.0):
    grid = jcfg.GridConfig(half_cells_x=half, half_cells_y=half,
                           cells_per_m=cells_per_m)
    lut = jgeo.lag_lut(grid, MICS, PAIRS, CFG)
    return jgeo.lag_onehot(lut, L), grid.num_cells


# (frames B, the reference's tile_b, its grid tile gt, bf16, a general matrix)
ARGMAX_CASES = {
    "f32": (16, 8, 128, False, False),
    "bf16": (16, 8, 128, True, False),
    "ragged_batch": (10, 8, 128, False, False),   # B % tile_b != 0
    "ragged_grid": (8, 8, 256, False, False),     # G = 625, G % gt != 0
    "ragged_both_bf16": (5, 4, 512, True, False),
    "general_matrix": (8, 8, 128, False, True),
    "general_matrix_bf16": (8, 8, 128, True, True),
}


@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_srp_argmax_matches_pallas_interpret(rng, case):
    """Best score within 1e-5 (relative) and the same cell as the
    reference's kernel, which tiles and pads where the port does not."""
    b, tile_b, gt, bf16, general = ARGMAX_CASES[case]
    oh, cells = _onehot()
    assert cells == 625
    if general:  # any [P*L, G] matrix, not only a 0/1 steering one
        oh = rng.normal(size=oh.shape).astype(np.float32)
    corr = rng.normal(size=(b, 3, L)).astype(np.float32)
    rv, rc = jsrpk.srp_argmax(jnp.asarray(corr), jnp.asarray(oh), cells,
                              tile_b=tile_b, gt=gt, bf16=bf16,
                              interpret=True)
    gv, gc = tsrpk.srp_argmax(torch.from_numpy(corr), torch.from_numpy(oh),
                              cells, tile_b=tile_b, gt=gt, bf16=bf16)
    assert gc.dtype == torch.int32 and gv.shape == gc.shape == (b,)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-5)
    if bf16:
        fv, _ = tsrpk.srp_argmax(torch.from_numpy(corr),
                                 torch.from_numpy(oh), cells)
        assert not torch.equal(fv, gv)  # the operands were rounded


def test_srp_argmax_ties_go_to_the_first_cell(rng):
    oh, cells = _onehot()
    zeros = np.zeros((2, 3, L), np.float32)
    rv, rc = jsrpk.srp_argmax(jnp.asarray(zeros), jnp.asarray(oh), cells,
                              tile_b=2, gt=128, interpret=True)
    gv, gc = tsrpk.srp_argmax(torch.from_numpy(zeros), torch.from_numpy(oh),
                              cells)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_array_equal(gc.numpy(), [0, 0])
    # a planted tie across two grid tiles of the reference: two equal
    # columns of a general matrix, far apart
    w = rng.normal(size=(3 * L, 400)).astype(np.float32) * 0.01
    w[:, 300] = w[:, 37] = np.abs(rng.normal(size=3 * L)) + 1.0
    corr = np.abs(rng.normal(size=(4, 3, L))).astype(np.float32)
    rv, rc = jsrpk.srp_argmax(jnp.asarray(corr), jnp.asarray(w), 400,
                              tile_b=4, gt=128, interpret=True)
    gv, gc = tsrpk.srp_argmax(torch.from_numpy(corr), torch.from_numpy(w),
                              400)
    np.testing.assert_array_equal(np.asarray(rc), [37] * 4)
    np.testing.assert_array_equal(gc.numpy(), [37] * 4)


def test_srp_argmax_masks_cells_past_num_cells(rng):
    """Padding columns never win, however large."""
    oh, cells = _onehot()
    padded = np.concatenate(
        [oh, np.full((oh.shape[0], 7), 9.0, np.float32)], axis=1)
    corr = np.abs(rng.normal(size=(6, 3, L))).astype(np.float32)
    rv, rc = jsrpk.srp_argmax(jnp.asarray(corr), jnp.asarray(padded), cells,
                              tile_b=2, gt=128, interpret=True)
    gv, gc = tsrpk.srp_argmax(torch.from_numpy(corr),
                              torch.from_numpy(padded), cells)
    ev, ec = tsrpk.srp_argmax(torch.from_numpy(corr), torch.from_numpy(oh),
                              cells)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert torch.equal(gc, ec) and torch.equal(gv, ev)
    assert int(gc.max()) < cells


def test_srp_argmax_equals_scores_then_argmax(rng):
    oh, cells = _onehot()
    corr = torch.from_numpy(rng.normal(size=(9, 3, L)).astype(np.float32))
    scores = tsrp.srp_scores_matmul(corr, torch.from_numpy(oh))
    val, cell = tsrpk.srp_argmax(corr, torch.from_numpy(oh), cells)
    assert torch.equal(cell.long(), scores.argmax(dim=-1))
    torch.testing.assert_close(val, scores.amax(dim=-1))


def test_srp_argmax_refuses_what_it_does_not_take():
    oh, cells = _onehot()
    before = tsrpk.launches
    tsrpk.srp_argmax(torch.zeros((2, 3, L)), torch.from_numpy(oh), cells)
    assert tsrpk.launches == before  # the CPU path launches nothing
    with pytest.raises(ValueError, match=r"\[B, P, L\]"):
        tsrpk.srp_argmax(torch.zeros((2, 3 * L)), torch.from_numpy(oh), cells)
    with pytest.raises(ValueError, match="CUDA"):  # no plain fallback
        tsrpk.srp_argmax(torch.zeros((2, 3, L), device="meta"),
                         torch.from_numpy(oh), cells)
    with pytest.raises(ValueError, match="CUDA"):
        tsrpk.launch(torch.zeros((2, 3 * L)), torch.from_numpy(oh), cells)


# ---------------------------------------------------------------------------
# ops.srp: the large-array scoring functions

def _large(rng, m=10, b=3, lead=()):
    mics = jgeo.circular_array(m, 0.25)
    pairs = jgeo.mic_pairs(m)  # 45 pairs
    grid = jcfg.GridConfig(half_cells_x=8, half_cells_y=8, cells_per_m=6.0)
    lut = jgeo.lag_lut(grid, mics, pairs, CFG).reshape(len(pairs), -1)
    corr = rng.normal(size=(*lead, b, len(pairs), L)).astype(np.float32)
    return corr, lut.astype(np.int32)


@pytest.mark.parametrize("chunk", [16, 45, 128], ids=lambda c: f"chunk{c}")
def test_srp_scores_gather_blocked_matches(rng, chunk):
    corr, lut = _large(rng, lead=(2,))
    ref = np.asarray(jsrp.srp_scores_gather_blocked(
        jnp.asarray(corr), jnp.asarray(lut), chunk))
    got = tsrp.srp_scores_gather_blocked(torch.from_numpy(corr),
                                         torch.from_numpy(lut), chunk)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    whole = tsrp.srp_scores_gather(torch.from_numpy(corr),
                                   torch.from_numpy(lut))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [16, 128], ids=lambda c: f"chunk{c}")
def test_srp_scores_matmul_blocked_matches(rng, chunk, dtype):
    corr, lut = _large(rng)
    ref = np.asarray(jsrp.srp_scores_matmul_blocked(
        jnp.asarray(corr), jnp.asarray(lut), L, chunk, dtype=dtype))
    got = tsrp.srp_scores_matmul_blocked(
        torch.from_numpy(corr), torch.from_numpy(lut), L, chunk, dtype=dtype)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    # f32 sums of the same exact products, in another order
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    if dtype == "float32":
        gather = tsrp.srp_scores_gather(torch.from_numpy(corr),
                                        torch.from_numpy(lut))
        np.testing.assert_allclose(got.numpy(), gather.numpy(), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_big_onehot_and_matmul_big_match(rng, dtype):
    corr, lut = _large(rng)
    p, g = lut.shape
    ref_w = jsrp.big_onehot_device(jnp.asarray(lut), L, dtype)
    got_w = tsrp.big_onehot_device(torch.from_numpy(lut), L, dtype)
    l8 = jsrp.sublane_pad_lags(L)
    assert tsrp.sublane_pad_lags(L) == l8 == 96
    assert [tsrp.sublane_pad_lags(n) for n in (1, 8, 9, 149)] == [
        jsrp.sublane_pad_lags(n) for n in (1, 8, 9, 149)]
    # the reference's matrix is the port's with zero rows padding each
    # pair's lag axis to 8
    ref_w3 = np.asarray(ref_w.astype(jnp.float32)).reshape(p, l8, g)
    assert got_w.shape == (p * L, g) and got_w.dtype == torch.float32
    np.testing.assert_array_equal(ref_w3[:, :L].reshape(p * L, g),
                                  got_w.numpy())
    assert ref_w3[:, L:].max() == 0.0
    ref = np.asarray(jsrp.srp_scores_matmul_big(jnp.asarray(corr), ref_w,
                                                dtype=dtype))
    got = tsrp.srp_scores_matmul_big(torch.from_numpy(corr), got_w,
                                     dtype=dtype)
    padded = tsrp.srp_scores_matmul_big(
        torch.from_numpy(corr),
        torch.from_numpy(ref_w3.reshape(p * l8, g).copy()), dtype=dtype)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(padded.numpy(), ref, rtol=1e-5, atol=1e-5)
    blocked = tsrp.srp_scores_matmul_blocked(
        torch.from_numpy(corr), torch.from_numpy(lut), L, 16, dtype=dtype)
    np.testing.assert_allclose(got.numpy(), blocked.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_grid_argmax_matches(rng):
    h, w = 17, 23
    scores = rng.normal(size=(2, 5, h * w)).astype(np.float32)
    scores[0, 0, 3 * w + 4] = scores[0, 0, 9 * w + 1] = 40.0  # first wins
    rr, rc = jsrp.grid_argmax(jnp.asarray(scores), (h, w))
    gr, gc = tsrp.grid_argmax(torch.from_numpy(scores), (h, w))
    assert gr.dtype == gc.dtype == torch.int32
    np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    assert (int(gr[0, 0]), int(gc[0, 0])) == (3, 4)


# ---------------------------------------------------------------------------
# core.geometry: the large-array additions, byte for byte

@pytest.mark.parametrize("shape", [(8, 8, 0.05), (3, 5, 0.11), (1, 4, 0.2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_grid_array_byte_equal(shape):
    ref, got = jgeo.grid_array(*shape), tgeo.grid_array(*shape)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert got.tobytes() == ref.tobytes()
    ref64 = jgeo.grid_array(*shape, dtype=np.float64)
    assert tgeo.grid_array(*shape, dtype=np.float64).tobytes() == (
        ref64.tobytes())


@pytest.mark.parametrize("array", ["grid64", "circular24", "reference"])
def test_pair_distances_and_max_lag_byte_equal(array):
    mics = {"grid64": lambda: jgeo.grid_array(8, 8, 0.05),
            "circular24": lambda: jgeo.circular_array(24, 0.5),
            "reference": jgeo.reference_array}[array]()
    pairs = jgeo.mic_pairs(mics.shape[0])
    ref = jgeo.pair_distances(mics, pairs)
    got = tgeo.pair_distances(mics, tgeo.mic_pairs(mics.shape[0]))
    assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes()
    for kw in ({}, {"sample_rate_hz": 16000}, {"speed_of_sound_mps": 331.0}):
        for margin in (1, 3):
            assert tgeo.max_lag_for_array(
                mics, tcfg.PipelineConfig(**kw), margin) == (
                    jgeo.max_lag_for_array(mics, jcfg.PipelineConfig(**kw),
                                           margin))
    if array == "grid64":  # the 64-mic bench window: 149 lags
        assert tgeo.max_lag_for_array(mics, tcfg.PipelineConfig()) == 74


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_srp_argmax_matches_plain_version(rng, cuda_device, bf16):
    oh, cells = _onehot()
    corr = torch.from_numpy(
        rng.normal(size=(300, 3, L)).astype(np.float32)).to(cuda_device)
    w = torch.from_numpy(oh).to(cuda_device)
    before = tsrpk.launches
    val, cell = tsrpk.srp_argmax(corr, w, cells, bf16=bf16)
    assert tsrpk.launches == before + 1
    rv, rc = tsrpk.srp_argmax_reference(
        corr.reshape(300, -1).double(), w.double(), cells, bf16=bf16)
    assert torch.equal(cell, rc)
    assert float((val.double() - rv).abs().max()) < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_srp_argmax_ties_and_ragged_sizes(rng, cuda_device, bf16):
    """The tensor-core kernel on sizes no tile divides (B = 301, K = 557,
    G = 1,531, 1,400 cells counted): equal columns far apart give bit-equal
    scores, so the first wins; a larger column past num_cells never does."""
    a = torch.from_numpy(np.abs(rng.standard_normal(
        (301, 1, 557))).astype(np.float32) + 1e-3).to(cuda_device)
    w = torch.from_numpy(
        rng.standard_normal((557, 1531)).astype(np.float32)).to(cuda_device)
    w[:, 5] = w[:, 1300] = 3.0
    w[:, 1500] = 9.0
    _, cell = tsrpk.srp_argmax(a, w, 1400, bf16=bf16)
    assert cell.tolist() == [5] * 301
    _, cell = tsrpk.srp_argmax(torch.zeros_like(a), w, 1400, bf16=bf16)
    assert cell.tolist() == [0] * 301
