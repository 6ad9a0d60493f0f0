"""PyTorch port, GCC kernel module: the port's fused GCC (its plain version
on the CPU) against the JAX package's Pallas GCC kernel in interpret mode,
on the same raw frames; plus the wrapper's no-fallback contract."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
from audio_triangulation_tpu.ops import window as jwin
from audio_triangulation_tpu.ops.pallas import gcc_kernel as jgcc
from audio_triangulation_tpu_torch.core import config as tcfg
from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel as tgcc

CASES = {
    "circular_phat": (3, {"fft_pad_mode": "circular", "phat": True}),
    "linear_nophat": (4, {}),
    "band_crop": (4, {"phat": True, "fft_pad_mode": "circular",
                      "band_hz": (800.0, 6000.0), "band_crop": True}),
    "static_band_no_crop": (4, {"phat": True,
                                "band_hz": (800.0, 6000.0)}),
    "2mic_per_pair_phat": (2, {"phat": True, "fft_pad_mode": "circular",
                               "phat_eps": 1e-9}),
    # without PHAT: mean removal leaves the unwindowed DC bin at rounding
    # noise, which whitening would blow up to unit magnitude
    "window_off": (3, {"window_enabled": False}),
    "normalize_none": (3, {"normalize_mode": "none",
                           "fft_pad_mode": "circular"}),
}


def _inputs(rng, m, b=8, n=1024):
    frames = (rng.normal(size=(b, m, n)) * 50 + 128).astype(np.float32)
    return frames, jwin.dpss_window(n), jgeo.mic_pairs(m)


def _port(frames, win, pairs, kw, with_peaks):
    return tgcc.fused_gcc(torch.from_numpy(frames), torch.from_numpy(win),
                          torch.from_numpy(pairs), tcfg.PipelineConfig(**kw),
                          with_peaks=with_peaks)


@pytest.mark.parametrize("with_peaks", [False, True],
                         ids=["no_peaks", "peaks"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_gcc_matches_pallas_interpret(rng, case, with_peaks):
    m, kw = CASES[case]
    frames, win, pairs = _inputs(rng, m)
    cfg = jcfg.PipelineConfig(**kw)
    call = jgcc.fused_gcc_peaks if with_peaks else jgcc.fused_gcc
    ref = call(jnp.asarray(frames), jnp.asarray(win), pairs, cfg,
               tile_b=8, interpret=True)
    got = _port(frames, win, pairs, kw, with_peaks)
    if not with_peaks:
        ref, got = (ref,), (got,)
    ref = [np.asarray(r) for r in ref]
    got = [g.numpy() for g in got]
    assert got[0].shape == ref[0].shape == (8, len(pairs), 93)
    scale = np.abs(ref[0]).max()
    np.testing.assert_allclose(got[0] / scale, ref[0] / scale, atol=1e-5)
    if with_peaks:
        shift, tdoa, peak, psr = got[1:]
        assert shift.dtype == np.int32
        np.testing.assert_array_equal(shift, ref[1])
        np.testing.assert_allclose(tdoa, ref[2], atol=1e-4)
        np.testing.assert_allclose(peak, ref[3], rtol=1e-5, atol=1e-5 * scale)
        np.testing.assert_allclose(psr, ref[4], rtol=1e-4)


def test_cpu_path_does_not_count_launches(rng):
    frames, win, pairs = _inputs(rng, 3, b=2)
    before = tgcc.launches
    _port(frames, win, pairs, {}, True)
    assert tgcc.launches == before


def test_window_gain_folds_shift8_and_window_off():
    w = torch.linspace(0.1, 1.0, 8)
    np.testing.assert_allclose(
        tgcc.window_gain(w, tcfg.PipelineConfig()).numpy(), w.numpy() * 256)
    np.testing.assert_array_equal(
        tgcc.window_gain(w, tcfg.PipelineConfig(window_enabled=False,
                                                normalize_mode="none")),
        torch.ones(8))


def test_non_cpu_tensor_never_falls_back():
    """A tensor off the CPU goes to the kernel launcher, which raises for
    anything that is not CUDA; there is no plain fallback."""
    frames = torch.empty((2, 3, 1024), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgcc.fused_gcc(frames, torch.ones(1024), torch.tensor([[0, 1]]),
                       tcfg.PipelineConfig(), with_peaks=True)
    with pytest.raises(ValueError, match="CUDA"):
        x = torch.zeros((2, 3, 1024))
        tgcc.launch(x, *tgcc.operands(x, torch.ones(1024),
                                      tcfg.PipelineConfig()),
                    torch.tensor([[0, 1]]), phat=False, phat_eps=1e-12,
                    max_shift=46, taper_denom=36.0, with_peaks=False)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_kernel_matches_plain_version(rng, cuda_device, case):
    m, kw = CASES[case]
    frames, win, pairs = _inputs(rng, m, b=64)
    cfg = tcfg.PipelineConfig(**kw)
    x = torch.from_numpy(frames).to(cuda_device)
    win_gain, mats = tgcc.operands(x, torch.from_numpy(win), cfg)
    p = torch.from_numpy(pairs).to(cuda_device)
    args = dict(phat=cfg.phat, phat_eps=cfg.phat_eps,
                max_shift=cfg.max_shift, taper_denom=cfg.taper_denom,
                with_peaks=True)
    # the plain version in float64: its fp32 evaluation carries cuBLAS's
    # own rounding, which exceeds the kernel's (see chip_smoke.py)
    ref = tgcc.gcc_reference(x.double(), win_gain.double(),
                             mats.to(torch.float64), p, **args)
    got = tgcc.launch(x, win_gain, mats, p, **args)
    scale = float(ref[0].abs().max())
    assert float((got[0].double() - ref[0]).abs().max()) / scale < 1e-4
    assert torch.equal(got[1], ref[1])
    assert float((got[2].double() - ref[2]).abs().max()) < 1e-3
