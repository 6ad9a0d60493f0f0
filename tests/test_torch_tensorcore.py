"""PyTorch port: the arithmetic of the two tensor-core kernels, on the CPU.

``srp_argmax_split_reference`` repeats the SRP-argmax kernel's arithmetic in
plain PyTorch (f32 mode: operands split into TF32 parts, three products a
step of 8 values of K, small terms first; bf16 mode: bf16 operands, f32
sums); it is held against the JAX package's Pallas kernel in interpret
mode, against float64 at K = 558, and its split against the definition of
TF32.  ``k_major`` and ``split_k_major`` are the host-side preparation of
the DFT-product kernel's ``wgmma`` type sets; their plain versions are
held to the transposes and the TF32 split, and the f32 mode's arithmetic,
``dft_matmul_split_reference``, to the three products it keeps.  ``gpu`` cases hold the kernels themselves to these functions
on a CUDA device."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops.pallas import srp_kernel as jsrpk
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.core import geometry as tgeo
from audio_triangulation_tpu_torch.models.localizer import condition_frames
from audio_triangulation_tpu_torch.ops import mxu_fft as tmxu
from audio_triangulation_tpu_torch.ops import window as twindow
from audio_triangulation_tpu_torch.ops.cuda import _build, dft_matmul
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel as tgcc
from audio_triangulation_tpu_torch.ops.cuda import gcc_large as tlarge
from audio_triangulation_tpu_torch.ops.cuda import srp_kernel as tsrpk
from audio_triangulation_tpu_torch.tools import int8_microbench
from audio_triangulation_tpu_torch.utils import synth as tsynth

from test_torch_srp_kernel import ARGMAX_CASES, L, _onehot


# ---------------------------------------------------------------------------
# the TF32 split

def _f32(values):
    return torch.tensor(values, dtype=torch.float32)


def test_tf32_round_is_nearest_with_ties_away_from_zero():
    ulp = 2.0 ** -10  # of a TF32 value in [1, 2)
    x = _f32([1.0, 1.0 + 0.49 * ulp, 1.0 + 0.5 * ulp, 1.0 + 0.51 * ulp,
              -(1.0 + 0.5 * ulp), 1.0 + 1.5 * ulp, 3.0e-39, 0.0, -0.0])
    want = _f32([1.0, 1.0, 1.0 + ulp, 1.0 + ulp, -(1.0 + ulp),
                 1.0 + 2 * ulp, 3.0e-39, 0.0, -0.0])
    got = tsrpk.tf32_round(x)
    # the subnormal keeps its 10 leading stored bits
    want[6] = torch.tensor(
        (np.float32(3.0e-39).view(np.int32) + 0x1000) & ~0x1FFF,
        dtype=torch.int32).view(torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("scale", [1e-6, 1.0, 3e4], ids=["1e-6", "1", "3e4"])
def test_tf32_split_parts_are_tf32_and_sum_within_2_pow_minus_21(rng, scale):
    w = torch.from_numpy(
        (rng.standard_normal((558, 97)) * scale).astype(np.float32))
    hi, lo = tsrpk.tf32_split(w)
    for part in (hi, lo):  # 13 low mantissa bits clear
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert torch.equal(hi, tsrpk.tf32_round(w))
    # |w - hi| <= 2^-11 |w| and lo rounds that to 11 bits: 2^-22 of |w|,
    # held at 2^-21
    err = (hi.double() + lo.double() - w.double()).abs()
    assert bool((err <= 2.0 ** -21 * w.double().abs()).all())
    assert bool((lo.abs().double() <= 2.0 ** -11 * 1.001 * hi.abs().double()
                 ).all())


def test_tf32_split_of_bf16_values_has_no_low_part(rng):
    x = torch.from_numpy(rng.standard_normal(1000).astype(np.float32))
    x = x.to(torch.bfloat16).float()
    hi, lo = tsrpk.tf32_split(x)
    assert torch.equal(hi, x) and int(lo.count_nonzero()) == 0


# ---------------------------------------------------------------------------
# the SRP-argmax kernel's arithmetic

@pytest.mark.parametrize("case", sorted(ARGMAX_CASES))
def test_split_reference_matches_pallas_interpret(rng, case):
    """Same cells as the reference's kernel, best score within 1e-5
    relative, on the cases of the plain version's own test."""
    b, tile_b, gt, bf16, general = ARGMAX_CASES[case]
    oh, cells = _onehot()
    if general:
        oh = rng.normal(size=oh.shape).astype(np.float32)
    corr = rng.normal(size=(b, 3, L)).astype(np.float32)
    rv, rc = jsrpk.srp_argmax(jnp.asarray(corr), jnp.asarray(oh), cells,
                              tile_b=tile_b, gt=gt, bf16=bf16,
                              interpret=True)
    gv, gc = tsrpk.srp_argmax_split_reference(
        torch.from_numpy(corr).reshape(b, -1), torch.from_numpy(oh), cells,
        bf16=bf16)
    assert gc.dtype == torch.int32 and gv.shape == gc.shape == (b,)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(rc))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("matrix", ["onehot", "general"])
def test_split_reference_against_float64_at_k_558(rng, matrix, bf16):
    """K = 558 (6 pairs x 93 lags, the 4-mic array's), a general and a
    steering matrix: every score within 2e-6 of the score scale of the
    float64 product of the same (bf16-rounded, in bf16 mode) operands, as
    close as the plain f32 product is."""
    cfg = jcfg.PipelineConfig()
    mics = jgeo.square_array(0.3)
    grid = jcfg.GridConfig(half_cells_x=10, half_cells_y=10, cells_per_m=8.0)
    lut = jgeo.lag_lut(grid, mics, jgeo.mic_pairs(4), cfg)
    w = jgeo.lag_onehot(lut, cfg.num_lags)
    assert w.shape == (558, 441)
    if matrix == "general":
        w = rng.standard_normal(w.shape).astype(np.float32)
    a = rng.standard_normal((64, 558)).astype(np.float32)
    ta, tw = torch.from_numpy(a), torch.from_numpy(w)
    if bf16:
        a64 = ta.to(torch.bfloat16).double()
        w64 = tw.to(torch.bfloat16).double()
    else:
        a64, w64 = ta.double(), tw.double()
    scores = a64 @ w64
    scale = float(scores.abs().max())
    val, cell = tsrpk.srp_argmax_split_reference(ta, tw, 441, bf16=bf16)
    best = scores.max(dim=-1).values
    assert float((val.double() - best).abs().max()) <= 2e-6 * scale
    picked = scores.gather(-1, cell.long()[:, None])[:, 0]
    assert float((best - picked).abs().max()) <= 2e-6 * scale
    pv, _ = tsrpk.srp_argmax_reference(ta, tw, 441, bf16=bf16)
    assert float((pv.double() - best).abs().max()) <= 2e-6 * scale


def test_split_reference_drops_only_the_low_low_term(rng):
    """The f32 mode equals the float64 sum of the three products it keeps
    to f32 summation.  That sum misses the exact product by a_lo w_lo and
    by what the split itself leaves out, each 2^-22 of a product."""
    a = torch.from_numpy(rng.standard_normal((8, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((40, 24)).astype(np.float32))
    (ah, al), (wh, wl) = tsrpk.tf32_split(a), tsrpk.tf32_split(w)
    kept = (ah.double() @ wh.double() + ah.double() @ wl.double()
            + al.double() @ wh.double())
    val, _ = tsrpk.srp_argmax_split_reference(a, w, 24)
    assert float((val.double() - kept.max(dim=-1).values).abs().max()) < 1e-5
    product = float(a.abs().max() * w.abs().max())
    full = a.double() @ w.double()
    assert float((kept - full).abs().max()) <= 40 * 3 * 2.0 ** -22 * product
    dropped = al.double() @ wl.double()
    assert float(dropped.abs().max()) <= 40 * 2.0 ** -22 * product


def test_split_reference_ties_and_masking(rng):
    k = 3 * L
    w = rng.normal(size=(k, 400)).astype(np.float32) * 0.01
    w[:, 300] = w[:, 37] = np.abs(rng.normal(size=k)) + 1.0
    corr = np.abs(rng.normal(size=(4, k))).astype(np.float32)
    for bf16 in (False, True):
        _, cell = tsrpk.srp_argmax_split_reference(
            torch.from_numpy(corr), torch.from_numpy(w), 400, bf16=bf16)
        assert cell.tolist() == [37] * 4  # equal columns: the first wins
        _, cell = tsrpk.srp_argmax_split_reference(
            torch.from_numpy(corr), torch.from_numpy(w), 37, bf16=bf16)
        assert int(cell.max()) < 37  # cells past num_cells never win
    _, cell = tsrpk.srp_argmax_split_reference(
        torch.zeros((3, k)), torch.from_numpy(w), 400)
    assert cell.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# the split under PHAT: may a GCC kernel's forward DFT go to the tensor cores?

def _bench_frames(mics, n_frames, n, seed):
    """Chirp frames (800-6000 Hz, noise 0.01) of random sources on the
    1.2 m sphere: the scene the kernels are held to on the card."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-1.0, 1.0, (n_frames, 2))
    v = np.concatenate([xy, np.full((n_frames, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return torch.from_numpy(tsynth.synth_scene(
        src, mics, n=n, noise_rms=0.01,
        seed=int(rng.integers(1 << 30))).astype(np.float32))


def _split_rdft(x, cos, msin):
    """The forward DFT x [..., N] @ (cos, msin) [N, F] as a split-fp32
    product: both operands split by ``tf32_split``, and every 8 values of N
    add ``x_lo w_hi``, then ``x_hi w_lo``, then ``x_hi w_hi`` to one f32
    accumulator (the order of ``srp_argmax_split_reference``)."""
    xh, xl = tsrpk.tf32_split(x)
    out = []
    for w in (cos, msin):
        wh, wl = tsrpk.tf32_split(w)
        acc = torch.zeros((*x.shape[:-1], w.shape[1]))
        for k0 in range(0, x.shape[-1], 8):
            ks = slice(k0, k0 + 8)
            acc += xl[..., ks] @ wh[ks]
            acc += xh[..., ks] @ wl[ks]
            acc += xh[..., ks] @ wh[ks]
        out.append(acc)
    return out


SPLIT_PHAT_CASES = {
    # name: (mics, samples, frames, PipelineConfig fields)
    "4mic_1024_fullband": (tgeo.square_array(0.3), 1024, 16, {}),
    "4mic_1024_bandcrop": (tgeo.square_array(0.3), 1024, 16, dict(
        band_hz=(800.0, 6000.0), band_crop=True)),
    "8mic_4096_fullband": (tgeo.grid_array(2, 4, 0.05), 4096, 6, dict(
        frame_size_bits=12)),
    "8mic_4096_bandcrop": (tgeo.grid_array(2, 4, 0.05), 4096, 6, dict(
        frame_size_bits=12, band_hz=(800.0, 6000.0), band_crop=True)),
}


@pytest.mark.parametrize("case", sorted(SPLIT_PHAT_CASES))
def test_split_dft_under_phat_stays_inside_the_kernels_tolerance(case):
    """PHAT divides every bin by its magnitude, so an error of the DFT on a
    weak bin comes out at full size.  The forward DFT of ``gcc_reference``
    (4 mics x 1,024) and of ``gcc_large._prep_spectra`` (8 mics x 4,096) as
    a split-fp32 product, with PHAT, cross-power and lag synthesis in
    float64 behind it, against the all-float64 evaluation of the same f32
    operands: the correlogram error must stay under 1e-4 of scale, the
    tolerance the kernels are held to on the card.  One TF32 product
    without the split does not (about 1e-2), which is why the split is
    needed; the fp32 ``torch.matmul`` DFT's error is printed beside it."""
    mics, n, n_frames, kw = SPLIT_PHAT_CASES[case]
    cfg = tcfg.PipelineConfig(phat=True, fft_pad_mode="circular", **kw)
    frames = _bench_frames(mics, n_frames, n, seed=3)
    pairs = torch.as_tensor(tgeo.mic_pairs(mics.shape[0]))
    window = torch.as_tensor(twindow.window_for(cfg))
    if n == 1024:  # the fused kernel's conditioning and operands
        win_gain, mats = tgcc.operands(frames, window, cfg)
        x = (frames - frames.mean(dim=-1, keepdim=True)) * win_gain
        cos, msin, sync, syns = mats.cos, mats.msin, mats.sync, mats.syns
    else:  # the large-array path's
        x = condition_frames(frames, window, cfg).float()
        crop = tmxu.crop_bins(cfg)
        cos, msin = (tmxu.dft_matrices(n, cfg.fft_length) if crop is None
                     else tmxu.dft_matrices_band(n, cfg.fft_length, *crop))
        cos, msin = torch.from_numpy(cos), torch.from_numpy(msin)
        sync, syns = tlarge.synthesis(cfg, "cpu")
        # the operands are the path's own
        re, im = tlarge._prep_spectra(x, pairs, cfg)
        wre, wim = tmxu.whiten_reim(*tmxu.rdft(x, cos, msin), cfg.phat_eps,
                                    cfg.phat_beta)
        assert torch.equal(re, wre) and torch.equal(im, wim)

    def correlogram(re, im):
        rr, jj = tmxu.cross_power_reim(re.double(), im.double(), pairs,
                                       phat=True, phat_eps=cfg.phat_eps)
        return tmxu.lag_correlogram(rr, jj, sync.double(), syns.double())

    ref = correlogram(*tmxu.rdft(x.double(), cos.double(), msin.double()))
    scale = float(ref.abs().max())

    def err(re, im):
        return float((correlogram(re, im) - ref).abs().max()) / scale

    e_split = err(*_split_rdft(x, cos, msin))
    e_fp32 = err(*tmxu.rdft(x, cos, msin))
    xh = tsrpk.tf32_round(x)
    e_tf32 = err(xh @ tsrpk.tf32_round(cos), xh @ tsrpk.tf32_round(msin))
    print(f"{case}: correlogram error of scale under PHAT: split-fp32 DFT "
          f"{e_split:.2e}, fp32 torch.matmul DFT {e_fp32:.2e}, one TF32 "
          f"product {e_tf32:.2e}")
    assert e_split <= 1e-4
    assert e_split <= 4 * max(e_fp32, 2e-6)  # a small factor of fp32
    assert e_tf32 > 1e-3  # the split is what keeps the digits


# ---------------------------------------------------------------------------
# the DFT-product kernel's host-side preparation and refusals

@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_k_major_is_byte_equal_to_the_transposes(name):
    _, w1, _ = int8_microbench.make_inputs(name, 4, 192, 80, 1, "cpu")
    w2 = w1.flip(0).contiguous()
    km = dft_matmul.k_major(w1, w2)
    assert km.shape == (2, 80, 192) and km.dtype == w1.dtype
    assert km.is_contiguous()
    raw = torch.uint8 if name == "int8" else torch.int16
    assert torch.equal(km[0].view(raw), w1.t().contiguous().view(raw))
    assert torch.equal(km[1].view(raw), w2.t().contiguous().view(raw))
    assert torch.equal(km, dft_matmul.k_major_reference(w1, w2))


def test_k_major_refuses_what_it_does_not_take():
    w = torch.zeros((64, 16), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA"):  # no plain fallback
        dft_matmul.k_major(w.to("meta"), w.to("meta"))


def test_one_accumulator_order_stays_inside_the_tolerance(rng):
    """The wgmma kernel adds both products of a stage (64 bf16 values of
    K) into one f32 accumulator; in plain PyTorch that order stays within
    1e-5 of scale of float64, like the plain version's two sums."""
    x, w1, acc_dt = int8_microbench.make_inputs("bf16", 64, 1024, 48, 1,
                                                "cpu")
    w2 = w1.flip(0).contiguous()
    s = torch.full((1,), 2, dtype=acc_dt)
    xs = (x + s.to(x.dtype)).float()
    acc = torch.zeros((64, 48))
    for k0 in range(0, 1024, 64):
        acc += xs[:, k0:k0 + 64] @ w1[k0:k0 + 64].float()
        acc += xs[:, k0:k0 + 64] @ w2[k0:k0 + 64].float()
    r64 = xs.double() @ w1.double() + xs.double() @ w2.double()
    scale = float(r64.abs().max())
    assert float((acc.double() - r64).abs().max()) <= 1e-5 * scale
    ref = dft_matmul.dft_matmul_reference(x, w1, w2, s)
    assert float((ref.double() - r64).abs().max()) <= 1e-5 * scale


def test_dft_split_reference_drops_only_the_low_low_term(rng):
    """The f32 kernel's plain version equals the float64 sum of the three
    products it keeps, to f32 summation; that sum misses the exact product
    by x_lo w_lo and by what the split itself leaves out, each 2^-22 of a
    product."""
    x = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    s = torch.full((1,), 0.5)
    xs = x + s
    xh, xl = tsrpk.tf32_split(xs)
    kept = 0
    for w in (w1, w2):
        wh, wl = tsrpk.tf32_split(w)
        kept = kept + (xh.double() @ wh.double() + xh.double() @ wl.double()
                       + xl.double() @ wh.double())
    got = dft_matmul.dft_matmul_split_reference(x, w1, w2, s)
    assert float((got.double() - kept).abs().max()) < 1e-5
    product = float(xs.abs().max() * max(w1.abs().max(), w2.abs().max()))
    full = xs.double() @ w1.double() + xs.double() @ w2.double()
    assert float((kept - full).abs().max()) <= 2 * 64 * 3 * 2.0 ** -22 * product
    with pytest.raises(ValueError, match="f32"):
        dft_matmul.dft_matmul_split_reference(
            x.bfloat16(), w1.bfloat16(), w2.bfloat16(), s)


def test_split_k_major_holds_the_tf32_parts_k_major():
    """[4, F, N]: w1's hi and lo parts, then w2's, each transposed and
    contiguous; each part a TF32 value, and hi + lo within 2^-21 of w (two
    11-bit parts hold 22 of f32's 24 bits, so not exactly)."""
    _, w1, _ = int8_microbench.make_inputs("f32", 4, 192, 80, 1, "cpu")
    w2 = w1.flip(0).contiguous()
    pk = dft_matmul.split_k_major(w1, w2)
    assert pk.shape == (4, 80, 192) and pk.dtype == torch.float32
    assert pk.is_contiguous()
    for m, w in enumerate((w1, w2)):
        hi, lo = tsrpk.tf32_split(w)
        assert torch.equal(pk[2 * m], hi.t()) and torch.equal(pk[2 * m + 1],
                                                              lo.t())
        for part in (pk[2 * m], pk[2 * m + 1]):
            assert torch.equal(part, tsrpk.tf32_round(part))
        back = pk[2 * m].t().double() + pk[2 * m + 1].t().double()
        assert float(((back - w.double()).abs()
                      / w.double().abs()).max()) <= 2.0 ** -21
    with pytest.raises(ValueError, match="CUDA"):  # no plain fallback
        dft_matmul.split_k_major(w1.to("meta"), w2.to("meta"))


def test_flush_interval_is_the_sources():
    """The plain version flushes its sums where the f32 kernel does."""
    src = (_build.CSRC_DIR / "dft_matmul.cu").read_text()
    assert "constexpr int kSpK = 32;" in src
    stages = dft_matmul.FLUSH_STEPS * 8 // 32
    assert f"constexpr int kSpFlushStages = {stages};" in src


@pytest.mark.parametrize("name", ["bf16", "int8", "f32"])
def test_wgmma_type_sets_refuse_cpu_tensors_and_odd_shapes(name):
    x, w, acc_dt = int8_microbench.make_inputs(name, 4, 64, 16, 1, "cpu")
    s = torch.zeros((1,), dtype=acc_dt)
    before = dict(dft_matmul.launches)
    with pytest.raises(ValueError, match="CUDA"):
        dft_matmul.launch(x, w, w, s)
    with pytest.raises(ValueError, match="multiple"):
        dft_matmul.launch(x[:, :32], w[:32], w[:32], s)
    assert dft_matmul.launches == before


def test_tensor_map_error_code_is_the_sources():
    """The wrapper tells a refused tensor map from a failed launch by the
    code the C entry point returns for it, which no ``cudaError_t`` is."""
    src = (_build.CSRC_DIR / "dft_matmul.cu").read_text()
    shared = (_build.CSRC_DIR / "hopper.cuh").read_text()
    assert (f"constexpr int kErrTensorMap = {dft_matmul.TENSOR_MAP_ERROR};"
            in shared)
    assert "using hopper::kErrTensorMap;" in src
    assert src.count("return kErrTensorMap;") == 1
    assert dft_matmul.TENSOR_MAP_ERROR < 0


# ---------------------------------------------------------------------------
# on a CUDA device

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(300, 558, 10201, 10201),
                                   (129, 37, 1000, 777), (1, 1, 1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_cuda_srp_argmax_matches_its_arithmetic(rng, cuda_device, shape,
                                                bf16):
    b, k, g, cells = shape
    a = torch.from_numpy(rng.standard_normal((b, k)).astype(np.float32)).to(
        cuda_device)
    w = torch.from_numpy(rng.standard_normal((k, g)).astype(np.float32)).to(
        cuda_device)
    val, cell = tsrpk.launch(a, w, cells, bf16=bf16)
    rv, rc = tsrpk.srp_argmax_split_reference(a, w, cells, bf16=bf16)
    scale = float(rv.abs().max())
    assert float((val - rv).abs().max()) <= 2e-5 * scale
    ad, wd = ((a.bfloat16().double(), w.bfloat16().double()) if bf16
              else (a.double(), w.double()))
    scores = (ad @ wd)[:, :cells]
    picked = scores.gather(-1, cell.long()[:, None])[:, 0]
    assert float((scores.max(dim=-1).values - picked).abs().max()) <= (
        1e-4 * float(scores.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["bf16", "int8"])
def test_cuda_k_major_is_byte_equal_to_the_transposes(cuda_device, name):
    _, w1, _ = int8_microbench.make_inputs(name, 4, 1024, 512, 1,
                                           cuda_device)
    w2 = w1.flip(0).contiguous()
    assert torch.equal(dft_matmul.k_major(w1, w2),
                       dft_matmul.k_major_reference(w1, w2))
