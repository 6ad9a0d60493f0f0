"""PyTorch port, GCC kernel row 2 at many pairs: the pair phase.

Where the correlograms of a block's frames would crowd its tile (fewer
than ``128 // M`` frames a block), the base mode without peaks computes
the whitened spectra of full tiles into device memory and synthesises the
lags in a pair phase on split-fp32 ``wgmma``, in the same launch.  The CPU
cases hold its plain version (``gcc_reference(..., split=True,
pair_phase=True)``) to float64 and to the fused plain version; the
``gpu`` cases hold the kernel to both, check that a frame's outputs do not
depend on its neighbours and where the route engages, and that the fused
rows (1, 2 at full tiles, 4, 9) give the bits of the body they had before
the pair phase existed.  Imports no JAX."""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from audio_triangulation_tpu_torch.core import config as tcfg, geometry
from audio_triangulation_tpu_torch.ops import window as twin
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel as tgcc
from audio_triangulation_tpu_torch.utils import synth


def scene(mics: np.ndarray, b: int, seed: int = 3) -> np.ndarray:
    """Chirp frames [b, M, 1,024] f32 of b sources on the 1.2 m sphere
    around the array, noise 0.01."""
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.uniform(-1.0, 1.0, (b, 2)),
                        np.full((b, 1), 1.2)], axis=1)
    src = v * (1.2 / np.linalg.norm(v, axis=1, keepdims=True))
    return synth.synth_scene(src, mics, noise_rms=0.01,
                             seed=seed + 1).astype(np.float32)


# the fused rows' cases at full tiles: the 4-mic square's band crop with
# PHAT (32 frames a block) and the firmware's triangle at linear padding
# (42 frames a block), each on a batch no frames-a-block divides
FUSED_CASES = {
    "square4_band_crop": (geometry.square_array(0.3), dict(
        phat=True, fft_pad_mode="circular", band_hz=(800.0, 6000.0),
        band_crop=True)),
    "ref3_linear": (geometry.reference_array(), dict(fft_pad_mode="linear")),
}
FUSED_FRAMES = 203


def fused_outputs(case: str, device) -> dict:
    """Rows 1 (with peaks), 2 (without), 4 (SRP mode) and 9 (pipelined) of
    a FUSED_CASES case: {row: tuple of outputs}."""
    mics, kw = FUSED_CASES[case]
    cfg = tcfg.PipelineConfig(**kw)
    pairs = torch.from_numpy(geometry.mic_pairs(len(mics))).to(device)
    x = torch.from_numpy(scene(mics, FUSED_FRAMES)).to(device)
    win_gain, mats = tgcc.operands(
        x, torch.from_numpy(twin.dpss_window(1024)), cfg)
    lut = geometry.lag_lut(tcfg.GridConfig(half_cells_x=16, half_cells_y=16,
                                           cells_per_m=8.0), mics,
                           geometry.mic_pairs(len(mics)), cfg)
    lut_flat = torch.from_numpy(lut.reshape(len(pairs), -1)).to(device)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom)
    return {
        "row1": tgcc.launch(x, win_gain, mats, pairs, **kw, with_peaks=True),
        "row2": (tgcc.launch(x, win_gain, mats, pairs, **kw,
                             with_peaks=False),),
        "row4": tgcc.launch_srp(x, win_gain, mats, pairs, lut_flat, **kw),
        "row9": tgcc.launch_pipelined(x, win_gain, mats, pairs, **kw),
    }


def digest(outs) -> str:
    """sha256 of the outputs' bytes, in order."""
    h = hashlib.sha256()
    for t in outs:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


# the fused rows' outputs (FUSED_CASES, FUSED_FRAMES) as the body without
# the pair phase gave them on an NVIDIA H100 80GB HBM3 (rows 1 and 9 are
# bit-equal to each other)
FUSED_DIGESTS = {
    "square4_band_crop": {
        "row1": "de178a4404a2514c23d146c727669db8d7f07ef0688f623eb825c2e7367f0513",
        "row2": "2e4b7bf0c16bb150d11d9e9aead5b5a4b8664dff8c81781bcd91a54c59d6bd1f",
        "row4": "70437290b4c080b56612b1e981ca72e1ecd34ef024b34157a7dc80a6c50d7471",
        "row9": "de178a4404a2514c23d146c727669db8d7f07ef0688f623eb825c2e7367f0513",
    },
    "ref3_linear": {
        "row1": "281f7ea6abb7722f3bc402a3baea85635c8b0125e948871bd0bf6729ac6ee6ba",
        "row2": "97b05aa356e04e61a3bdf5d09e8fa0d118bbe74f76d6af1906c7f82017f7f38a",
        "row4": "76cfb10540c7125e0e48a09d0c167692d237d11969d87462d2f80bc9bc4b3041",
        "row9": "281f7ea6abb7722f3bc402a3baea85635c8b0125e948871bd0bf6729ac6ee6ba",
    },
}


def _widened(mics, cfg):
    """``cfg`` with its lag window over the array's aperture (as the DoA
    and volume estimators widen it)."""
    return dataclasses.replace(cfg, max_shift_samples=geometry.max_lag_for_array(
        mics, cfg))


# the estimators' row-2 shapes (mics, configuration): the DoA estimator's
# 8-mic circle (28 pairs, 91 lags, PHAT), localize_multi's (93 lags), the
# volume localizer's 1 m circle (295 lags, no PHAT), the spherical DoA's
# tetrahedron (6 pairs, 147 lags), and the fused rows' full tiles: a
# fusion array's 4-mic square (32 frames a block), the benchmark's square
# band crop and the firmware's triangle
SHAPES = {
    "doa_8mic": (geometry.circular_array(8, 0.15),
                 _widened(geometry.circular_array(8, 0.15),
                          tcfg.PipelineConfig(phat=True))),
    "multi_8mic": (geometry.circular_array(8, 0.15),
                   tcfg.PipelineConfig(phat=True)),
    "volume_8mic": (geometry.circular_array(8, 0.5),
                    _widened(geometry.circular_array(8, 0.5),
                             tcfg.PipelineConfig())),
    "doa3d_tetra": (geometry.tetrahedral_array(0.3),
                    _widened(geometry.tetrahedral_array(0.3),
                             tcfg.PipelineConfig(phat=True,
                                                 window_enabled=False))),
    "fusion_square": (geometry.square_array(0.25),
                      tcfg.PipelineConfig(phat=True)),
    "square4_band_crop": (FUSED_CASES["square4_band_crop"][0],
                          tcfg.PipelineConfig(**FUSED_CASES[
                              "square4_band_crop"][1])),
    "ref3_linear": (FUSED_CASES["ref3_linear"][0],
                    tcfg.PipelineConfig(**FUSED_CASES["ref3_linear"][1])),
}


def _operands(shape: str, b: int, device, phat=None):
    """(frames, win_gain, mats, pairs, keyword arguments) of a SHAPES
    shape on b scene frames; ``phat`` overrides the configuration's."""
    mics, cfg = SHAPES[shape]
    if phat is not None:
        cfg = dataclasses.replace(cfg, phat=phat)
    x = torch.from_numpy(scene(mics, b)).to(device)
    win_gain, mats = tgcc.operands(
        x, torch.from_numpy(twin.window_for(cfg)), cfg)
    pairs = torch.from_numpy(geometry.mic_pairs(len(mics))).to(device)
    kw = dict(phat=cfg.phat, phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
              taper_denom=cfg.taper_denom, with_peaks=False)
    return x, win_gain, mats, pairs, kw


# PHAT weighs every bin fully, and float32 rounds the phase of a bin near
# a spectral zero by about its rounding over its magnitude: rows whose mics
# have a bin under this share of the mic's rms bin are not judged (the
# benchmark's ``phase_floor``).  The DoA scene's frame 336 has its Nyquist
# bin at 2.6e-8 of it, where every float32 version, the fused body's too,
# lies 3.3e-3 of scale from float64.
PHASE_FLOOR = 1e-5


def _judged(x, win_gain, mats, pairs, phat: bool) -> torch.Tensor:
    """[B, P] bool: the (frame, pair) rows whose mics' bins all clear
    PHASE_FLOOR of their rms bin in float64 (every row without PHAT)."""
    if not phat:
        return torch.ones((x.shape[0], len(pairs)), dtype=torch.bool,
                          device=x.device)
    x64 = x.double()
    xc = (x64 - x64.mean(dim=-1, keepdim=True)) * win_gain.double()
    re, im = xc @ mats.cos.double(), xc @ mats.msin.double()
    mag = (re * re + im * im).sqrt()
    clear = (mag.amin(dim=-1)
             >= PHASE_FLOOR * mag.square().mean(dim=-1).sqrt())   # [B, M]
    return clear[:, pairs[:, 0].long()] & clear[:, pairs[:, 1].long()]


def _gaps(got, x, win_gain, mats, pairs, kw):
    """(gap to float64, gap to the plain pair-phase version in its own
    arithmetic, that plain version's own gap to float64, the share of rows
    judged), the gaps over the judged rows (_judged) as shares of float64's
    largest value."""
    ref64 = tgcc.gcc_reference(x.double(), win_gain.double(),
                               mats.to(torch.float64), pairs, **kw)
    plain = tgcc.gcc_reference(x, win_gain, mats, pairs, **kw, split=True,
                               pair_phase=True)
    judged = _judged(x, win_gain, mats, pairs, kw["phat"])
    if not bool(judged.any()):
        return float("nan"), float("nan"), float("nan"), 0.0
    scale = float(ref64.abs().max())

    def gap(a, b):
        return float((a.double() - b.double()).abs().amax(dim=-1)[judged].max()) / scale

    return (gap(got, ref64), gap(got, plain), gap(plain, ref64),
            float(judged.float().mean()))


@pytest.mark.parametrize("phat", [True, False], ids=["phat", "no_phat"])
def test_pair_phase_plain_version_against_float64(phat):
    """The pair phase's arithmetic (the DFT's split products, the synthesis
    as split-fp32 products summed PAIR_TC_STEPS steps in the tensor cores
    and flushed every PAIR_FLUSH_STEPS) at 8 mics, 28 pairs, F = 1,025 and
    L = 91, against float64 (the base mode's 1e-4 of scale) and beside the
    fused body's plain version (5e-5)."""
    x, win_gain, mats, pairs, kw = _operands("doa_8mic", 6, "cpu", phat)
    assert tuple(mats.sync.shape) == (1025, 91) and len(pairs) == 28
    got = tgcc.gcc_reference(x, win_gain, mats, pairs, **kw, split=True,
                             pair_phase=True)
    fused = tgcc.gcc_reference(x, win_gain, mats, pairs, **kw, split=True)
    ref64 = tgcc.gcc_reference(x.double(), win_gain.double(),
                               mats.to(torch.float64), pairs, **kw)
    scale = float(ref64.abs().max())
    assert float((got.double() - ref64).abs().max()) / scale < 1e-4
    assert float((got - fused).abs().max()) / scale < 5e-5
    # the plain version without the split arithmetic is the fused one's
    assert torch.equal(
        tgcc.gcc_reference(x, win_gain, mats, pairs, **kw, pair_phase=True),
        tgcc.gcc_reference(x, win_gain, mats, pairs, **kw))


@pytest.mark.parametrize("f,l", [(1025, 91), (1025, 295), (107, 93), (33, 5)])
def test_pack_synthesis_split_layout(f, l):
    """The pair phase's synthesis operand holds the split matrices, K
    ordered as split_lag_correlogram orders it, zero past F bins and L
    lags."""
    rng = np.random.default_rng(f + l)
    sync, syns = (torch.from_numpy(rng.standard_normal((f, l)).astype(
        np.float32)) for _ in range(2))
    packed = tgcc.pack_synthesis_split(sync, syns)
    fs, lp = tgcc.pair_bins(f), -(-l // tgcc.PAIR_LAG_COLS) * tgcc.PAIR_LAG_COLS
    assert packed.shape == (2, lp, 2 * fs) and fs % tgcc.PAIR_STAGE_BINS == 0
    (ch, sh), (cl, sl) = tgcc.unpack_synthesis_split(packed, f, l)
    for got, mat in ((ch, sync), (sh, syns)):
        assert torch.equal(got, tgcc.tf32_split(mat)[0])
    for got, mat in ((cl, sync), (sl, syns)):
        assert torch.equal(got, tgcc.tf32_split(mat)[1])
    full = torch.zeros((2, lp, 2 * fs), dtype=torch.bool)
    full[:, :l] = True
    k = torch.arange(2 * fs)
    full &= ((k // 8) * 4 + k % 4 < f)[None, None]
    assert not bool(packed[~full].any())
    # step s of K: slot t the cos row of bin 4 s + t, slot 4 + t its sin row
    s, t = 3, 2
    hi = packed[0]
    assert torch.equal(hi[:l, 8 * s + t], tgcc.tf32_split(sync[4 * s + t])[0])
    assert torch.equal(hi[:l, 8 * s + 4 + t],
                       tgcc.tf32_split(syns[4 * s + t])[0])


def test_cpu_path_is_unchanged_by_the_pair_route():
    """On CPU tensors fused_gcc runs the plain version as it did, whatever
    the shape, and counts no launch."""
    mics, cfg = SHAPES["doa_8mic"]
    x = torch.from_numpy(scene(mics, 3))
    win = torch.from_numpy(twin.window_for(cfg))
    pairs = torch.from_numpy(geometry.mic_pairs(8))
    before = (tgcc.launches, tgcc.pair_launches)
    got = tgcc.fused_gcc(x, win, pairs, cfg, with_peaks=False)
    win_gain, mats = tgcc.operands(x, win, cfg)
    ref = tgcc.gcc_reference(x, win_gain, mats, pairs, phat=cfg.phat,
                             phat_eps=cfg.phat_eps, max_shift=cfg.max_shift,
                             taper_denom=cfg.taper_denom, with_peaks=False)
    assert torch.equal(got, ref)
    assert (tgcc.launches, tgcc.pair_launches) == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 7, 17, 16385])
@pytest.mark.parametrize("phat", [True, False], ids=["phat", "no_phat"])
@pytest.mark.parametrize("shape", ["doa_8mic", "multi_8mic", "volume_8mic"])
def test_cuda_pair_phase_matches_float64_and_plain(cuda_device, shape, phat, b):
    """The pair phase against float64 (the base mode's 1e-4 of scale) and
    against its plain version in its own arithmetic (5e-5), each widened to
    twice the plain version's own distance from float64 where that is
    larger (as chip_smoke.py holds row 2: over 16,385 frames PHAT meets
    bins at 1e-4 of their rms, where float32's rounding moves both 6e-5 of
    scale), on the rows clear of a spectral zero (_judged: all but a few in
    a thousand with PHAT, all without); one launch counted on the new
    route."""
    x, win_gain, mats, pairs, kw = _operands(shape, b, cuda_device, phat)
    before = (tgcc.launches, tgcc.pair_launches)
    got = tgcc.launch(x, win_gain, mats, pairs, **kw)
    assert (tgcc.launches, tgcc.pair_launches) == (before[0] + 1,
                                                   before[1] + 1)
    e64, e_plain, plain64, share = _gaps(got, x, win_gain, mats, pairs, kw)
    print(f"{shape} phat={phat} b={b}: {e64:.2e} of scale from float64, "
          f"{e_plain:.2e} from the plain version ({plain64:.2e} from "
          f"float64), {share:.4f} of rows judged")
    assert share > 0.99
    assert e64 < max(1e-4, 2 * plain64)
    assert e_plain < max(5e-5, 2 * plain64)


@pytest.mark.gpu
def test_cuda_pair_phase_rows_do_not_depend_on_neighbours(cuda_device):
    """A frame's correlograms are the same bits whichever frames share its
    launch, its spectra tile and its pair tiles."""
    x, win_gain, mats, pairs, kw = _operands("doa_8mic", 40, cuda_device)
    whole = tgcc.launch(x, win_gain, mats, pairs, **kw)
    for lo, hi in ((5, 6), (3, 20), (17, 40), (0, 1)):
        part = tgcc.launch(x[lo:hi].contiguous(), win_gain, mats, pairs,
                           **kw)
        assert torch.equal(part, whole[lo:hi])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_cuda_pair_route_engages_where_tiles_crowd(cuda_device, shape):
    """The pair phase takes row 2 exactly where fewer than 128 // M frames
    a block fit the fused body (never at the benchmark's square band crop
    or firmware triangle), never with peaks, and the span system counts it
    as ``gcc.route.pairs``."""
    from audio_triangulation_tpu_torch.utils import profiling

    x, win_gain, mats, pairs, kw = _operands(shape, 3, cuda_device)
    m, p, l = x.shape[1], len(pairs), mats.sync.shape[1]
    tb = tgcc._lib().att_gcc_frames_per_block(m, p, l)
    crowded = tb < tgcc.BLOCK_ROWS // m
    assert tgcc.takes_pair_phase(m, p, l) == crowded
    assert crowded == (shape in ("doa_8mic", "multi_8mic", "volume_8mic",
                                 "doa3d_tetra"))
    with profiling.tracing():
        before = (tgcc.pair_launches,
                  profiling.counters().get("gcc.route.pairs", 0))
        tgcc.launch(x, win_gain, mats, pairs, **kw)
        tgcc.launch(x, win_gain, mats, pairs, **{**kw, "with_peaks": True})
        after = (tgcc.pair_launches,
                 profiling.counters().get("gcc.route.pairs", 0))
    assert after == (before[0] + crowded, before[1] + crowded)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_cuda_fused_rows_keep_their_bits(cuda_device, case):
    """Rows 1, 2 (at full tiles), 4 and 9 give the bits the fused body gave
    before the pair phase existed (FUSED_DIGESTS)."""
    if "H100" not in torch.cuda.get_device_name(cuda_device):
        pytest.skip("the digests were taken on an NVIDIA H100")
    outs = fused_outputs(case, cuda_device)
    assert {row: digest(v) for row, v in outs.items()} == FUSED_DIGESTS[case]
