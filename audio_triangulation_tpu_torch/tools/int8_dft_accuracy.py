"""Accuracy bound of an int8-quantized DFT stage for configuration 4 (8-mic
circular, PHAT, parabolic sub-sample), on 8-bit ADC input.

Counterpart of the JAX package's ``tools/int8_dft_accuracy.py``, on its 64
scenes at 40 dB SNR and 800-6,000 Hz.  The int8 mode it bounds: the
conditioned samples (``x - mean``, within +-128 for 8-bit input) rounded to
int8, the windowed DFT matrices quantized to int8 a bin (symmetric, scale
``max|column| / 127``), the products accumulated in int32 (exact) and
dequantized before the PHAT cross-power, band mask, lag synthesis and
sub-sample peak, which stay in float32.  It prints the TDOA error of the
float32 and the int8 products against the scenes' true TDOAs: the
accuracy half of the int8 decision, whose speed half is
``tools/int8_microbench.py``.

The float32 products are numpy's, as the reference's.  The two int8
products run on the card through the DFT-product kernel's int8 mode
(``ops.cuda.dft_matmul.dft_matmul``: ``(x + s) @ w1 + (x + s) @ w2`` with
``s = 0`` and ``w2 = 0``), its F = 513 columns padded with zeros to 528 (the
kernel takes F a multiple of 16; N = 1,024 is a multiple of 64 already) and
dropped after; on the CPU through its plain version.  Both are held to
numpy's int32 product bit for bit: the tool exits non-zero if they differ.
The stages after the products run in torch on the same device.

    python -m audio_triangulation_tpu_torch.tools.int8_dft_accuracy
        [--device cuda]

It prints one JSON line, with the reference's keys, and writes no file.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..core import geometry
from ..core.config import PipelineConfig
from ..ops import _device, mxu_fft, solver, xcorr
from ..ops import window as window_ops
from ..ops.cuda import dft_matmul
from ..utils import synth
from .bench import require_device

N_SCENES = 64
SNR_DB = 40
BAND_HZ = (800.0, 6000.0)
HEIGHT_M = 1.2
F_ALIGN = 16  # the kernel's column multiple


def setup():
    """(mics [8, 2], pairs [28, 2], cfg, planes [64, 2], ADC frames
    [64, 8, 1,024] float64) of the reference's scenes."""
    mics = geometry.circular_array(8, 0.15)
    pairs = geometry.mic_pairs(8)
    cfg = PipelineConfig(phat=True, fft_pad_mode="circular", band_hz=BAND_HZ)
    rng = np.random.default_rng(7)
    planes = rng.uniform(-1.2, 1.2, (N_SCENES, 2))
    sources = np.stack([
        np.array([x, y, HEIGHT_M]) * (HEIGHT_M / np.linalg.norm(
            [x, y, HEIGHT_M])) for x, y in planes])
    noise = 0.8 / (10 ** (SNR_DB / 20.0)) / np.sqrt(2)
    scene = synth.synth_scene(sources, mics, noise_rms=noise, seed=30)
    adc = np.clip(np.round(np.asarray(scene) * 100 + 128), 0, 255)
    return mics, pairs, cfg, planes, adc


def quant_cols(m: np.ndarray):
    """(int8 matrix, float64 scale a column): symmetric, max|col| / 127."""
    s = np.abs(m).max(axis=0) / 127.0
    s = np.where(s == 0, 1.0, s)
    q = np.clip(np.round(m / s), -127, 127).astype(np.int8)
    return q, s


def int8_product(x8: np.ndarray, q: np.ndarray, device) -> np.ndarray:
    """x8 [R, N] @ q [N, F] as int32 through ``dft_matmul`` on ``device``:
    w1 = q with its columns padded with zeros to a multiple of 16, w2 = 0,
    s = 0; the padding dropped."""
    n, f = q.shape
    fp = -(-f // F_ALIGN) * F_ALIGN
    w1 = np.zeros((n, fp), np.int8)
    w1[:, :f] = q
    xt = torch.from_numpy(x8).to(device)
    w1t = torch.from_numpy(w1).to(device)
    out = dft_matmul.dft_matmul(xt, w1t, torch.zeros_like(w1t),
                                torch.zeros(1, dtype=torch.int32,
                                            device=device))
    return out[:, :f].cpu().numpy()


def tdoa_err(re, im, pairs, cfg, true_tau, device) -> np.ndarray:
    """|sub-sample TDOA - truth| [B, P] (samples) of spectra re, im
    [B, M, F] float32: PHAT cross-power, band mask, lag synthesis (the
    imaginary parts of DC and Nyquist read as zero, as numpy's irfft
    reads them), parabolic peak, in torch on ``device``."""
    spectra = torch.complex(torch.from_numpy(re).to(device),
                            torch.from_numpy(im).to(device))
    r = xcorr.cross_power(spectra, torch.as_tensor(pairs, device=device),
                          phat=True, phat_eps=cfg.phat_eps)
    mask = xcorr.band_mask(cfg)
    if mask is not None:
        r = r * torch.from_numpy(mask).to(device)
    k, f_len = cfg.max_shift, cfg.fft_length
    c = _device.irfft(r, f_len)
    corr = torch.cat([c[..., f_len - k:], c[..., :k + 1]], dim=-1)
    tdoa, _ = xcorr.subsample_peak(corr, k)
    return np.abs(tdoa.cpu().numpy() - true_tau)


def measure(device) -> tuple[dict, dict]:
    """(the reference's JSON line, the int8 products {"re", "im", "re_np",
    "im_np"} int32 from the kernel's path and from numpy)."""
    mics, pairs, cfg, planes, adc = setup()
    mic3 = np.zeros((8, 3), np.float32)
    mic3[:, :2] = mics
    true_tau = solver.predicted_tdoas(
        torch.as_tensor(planes, dtype=torch.float32), torch.from_numpy(mic3),
        torch.as_tensor(pairs), cfg.speed_of_sound_mps, HEIGHT_M,
        True).numpy() * cfg.sample_rate_hz

    win = np.asarray(window_ops.window_for(cfg), np.float64)
    n, f_len = cfg.frame_size, cfg.fft_length
    cos, msin = mxu_fft.dft_matrices(n, f_len, "float32")
    wcos = win[:, None] * cos.astype(np.float64)
    wsin = win[:, None] * msin.astype(np.float64)

    # float32 reference: the shipping path's products (PHAT makes overall
    # scale irrelevant, so the conditioning gain is left out)
    x = adc - adc.mean(axis=-1, keepdims=True)  # [B, M, N]
    e_f32 = tdoa_err((x @ wcos).astype(np.float32),
                     (x @ wsin).astype(np.float32), pairs, cfg, true_tau,
                     device)

    # int8: x clipped to +-127, per-bin int8 matrices, exact int32 sums
    x8 = np.clip(np.round(x), -127, 127).astype(np.int8)
    rows = x8.reshape(-1, n)
    qc, sc = quant_cols(wcos)
    qs, ss = quant_cols(wsin)
    prod = {"re": int8_product(rows, qc, device),
            "im": int8_product(rows, qs, device),
            "re_np": rows.astype(np.int32) @ qc.astype(np.int32),
            "im_np": rows.astype(np.int32) @ qs.astype(np.int32)}
    shape = (*x8.shape[:2], -1)
    re_i = prod["re"].reshape(shape) * sc
    im_i = prod["im"].reshape(shape) * ss
    e_i8 = tdoa_err(re_i.astype(np.float32), im_i.astype(np.float32), pairs,
                    cfg, true_tau, device)
    line = {
        "metric": "int8_dft_tdoa_error_config4",
        "scenes": int(e_f32.shape[0]),
        "snr_db": SNR_DB, "band_hz": [int(b) for b in BAND_HZ],
        "f32_median": round(float(np.median(e_f32)), 5),
        "f32_p90": round(float(np.percentile(e_f32, 90)), 5),
        "int8_median": round(float(np.median(e_i8)), 5),
        "int8_p90": round(float(np.percentile(e_i8, 90)), 5),
        "int8_minus_f32_median": round(
            float(np.median(e_i8) - np.median(e_f32)), 5),
        "unit": "samples",
    }
    return line, prod


def products_exact(prod: dict) -> bool:
    """Whether both int8 products equal numpy's int32 products bit for
    bit."""
    return all(prod[k].dtype == np.int32
               and np.array_equal(prod[k], prod[k + "_np"])
               for k in ("re", "im"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    line, prod = measure(require_device(args.device))
    if not products_exact(prod):
        raise SystemExit("the int8 products differ from numpy's int32 "
                         "products")
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
