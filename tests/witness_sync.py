"""The JAX package's clock-synchronised fusion on more events of its own
test scene: how far its offsets and drifts land from the truth.

``tests/test_sync_fusion.py`` holds the offsets within 0.6 samples on its
six events and the drift within 3e-6 on eight; ``chip_smoke.py`` phase
``13 estimators`` checks the port's truth there and runs 256 events of
the same sources (``chip_smoke.sync_scene``) against the port's CPU path.
This prints the reference's own errors at 6, 8, 64 and 256 events, the
witness for what the truth check can ask of the larger scene.

    JAX_PLATFORMS=cpu python tests/witness_sync.py [events ...]
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(counts):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from audio_triangulation_tpu.core import config as jcfg
    from audio_triangulation_tpu.models import fusion as jfus

    fus = jfus.ArrayFusionLocalizer.create(
        chip_smoke.sync_arrays(),
        jcfg.PipelineConfig(phat=True, band_hz=(700.0, 7000.0)))
    off = np.asarray(chip_smoke.SYNC_OFFSETS[1:])
    drift = np.asarray(chip_smoke.SYNC_DRIFTS[1:])
    for n in counts:
        for with_drift in (False, True):
            seed = 7 if n == 6 else 11 if n == 8 else chip_smoke.SEED + 51
            frames, times, src = chip_smoke.sync_scene(n, seed, with_drift)
            out = fus.localize_sync(jnp.asarray(frames),
                                    event_times_s=times)
            err = np.linalg.norm(np.asarray(out["xy_sync"]) - src, axis=-1)
            line = (f"{n} events{' with drift' if with_drift else ''}: "
                    f"offsets - truth {(np.asarray(out['clock_offsets_s']) * 50_000.0 - off)} samples")
            if with_drift:
                line += (f", drift - truth "
                         f"{np.asarray(out['clock_drift']) - drift} s/s")
            print(f"{line}; xy_sync median {np.median(err):.4f} m, "
                  f"largest {err.max():.4f} m", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [6, 8, 64, 256])
