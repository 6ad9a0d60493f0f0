"""Block WPE at ``examples/advanced.py``'s configuration in float32 and
float64: how far each package's float32 lands from the float64 recursion.

The example dereverberates 4 mics of a 0.25 m circle in a 6 x 5 x 3 m room
of RT60 0.45 s (``max_order=6``, 16,384 samples of a tiled chirp) with
frame 1,024, hop 256, 10 taps, delay 4 and 3 passes, and prints the cut
of the reverberant tail (samples 6,000-16,000) in dB.  This prints that
cut for the JAX package's float32, the port's float32 (CPU) and the
port's float64 path, and after 1, 2 and 3 passes the largest gap of each
float32 STFT output from float64, relative to float64's scale, and the
bins where the JAX package's gap is largest.  ``chip_smoke.py`` phase
``14 reverb`` (``wpe_block``) reads the JAX package's cut as its floor.
Last, the streaming dereverberator of the CLI (frame 1,024, hop 256, 10
taps, delay 4, alpha 0.998) on idle ADC input (integers -1..1, white):
the output's rms chunk by chunk in both packages, which grows as the RLS
filter adapts to noise (``dereverb_stream``'s idle streams trigger).

    JAX_PLATFORMS=cpu python tests/witness_wpe.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import torch
    from audio_triangulation_tpu.ops import dereverb as jdr
    from audio_triangulation_tpu_torch.ops import dereverb as tdr
    import chip_smoke

    wet = chip_smoke.wpe_example_scene()  # [4, 16,384] float64
    tail = slice(6000, 16000)
    kw = dict(frame=1024, hop=256, taps=10, delay=4)

    def cut_db(dry):
        return float(-10 * np.log10(np.mean(np.asarray(dry)[:, tail] ** 2)
                                    / np.mean(wet[:, tail] ** 2)))

    x32 = torch.from_numpy(wet.astype(np.float32))
    print(f"tail cut: JAX float32 "
          f"{cut_db(jdr.wpe(jnp.asarray(wet, jnp.float32), **kw)):.2f} dB, "
          f"port float32 {cut_db(tdr.wpe(x32, **kw).numpy()):.2f} dB, "
          f"port float64 "
          f"{cut_db(tdr.wpe(torch.from_numpy(wet), **kw).numpy()):.2f} dB")
    spec = tdr.stft(torch.from_numpy(wet), 1024, 256).movedim(-1, -3)
    spec32 = spec.to(torch.complex64)
    f_hz = np.fft.rfftfreq(1024, 1 / 50_000.0)
    for iters in (1, 2, 3):
        o64 = tdr.wpe_stft(spec, taps=10, delay=4, iters=iters).numpy()
        o32 = tdr.wpe_stft(spec32, taps=10, delay=4, iters=iters).numpy()
        oj = np.asarray(jdr.wpe_stft(jnp.asarray(spec32.numpy()), taps=10,
                                     delay=4, iters=iters))
        scale = np.abs(o64).max()
        gap_j = np.abs(oj - o64).max(axis=(-1, -2))
        worst = np.argsort(-gap_j)[:3]
        print(f"{iters} passes: float32 from float64, of scale: port "
              f"{np.abs(o32 - o64).max() / scale:.3e}, JAX "
              f"{gap_j.max() / scale:.3e}; JAX's worst bins (Hz) "
              f"{[round(float(f_hz[b]), 1) for b in worst]}")
    idle = np.random.default_rng(0).integers(127, 130, (3, 26 * 512)).astype(
        np.float32) - 128.0
    jsd = jdr.StreamingDereverb(3, frame=1024, hop=256)
    tsd = tdr.StreamingDereverb(3, frame=1024, hop=256, device="cpu")
    jst, tst, rows = jsd.init_state(), tsd.init_state(), []
    for i in range(26):
        c = idle[:, i * 512:(i + 1) * 512]
        jst, jy = jsd.step(jst, jnp.asarray(c))
        tst, ty = tsd.step(tst, torch.from_numpy(c))
        rows.append(f"{i}: {np.std(np.asarray(jy)):.3f} / "
                    f"{float(ty.std()):.3f}")
    print(f"idle input rms {idle.std():.3f}; dereverberated rms by chunk, "
          "JAX / port: " + ", ".join(rows))


if __name__ == "__main__":
    main()
