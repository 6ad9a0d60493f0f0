#!/usr/bin/env python3
"""Witness for chip_smoke.py's streaming check: the JAX package's own
``StreamingLocalizer.step_many`` and the port's CPU path on the planted
streams of the same scene (``chip_smoke.stream_scene``), in the three bench
pipelines.  Prints, per pipeline, how many planted events each accepted and
the median |xy - truth| at the event step: the source of chip_smoke's
``STREAM_MEDIAN_BOUND_M``.

    JAX_PLATFORMS=cpu python tests/witness_stream.py [n_streams]

Runs on the CPU (a minute or two at the default 2,048-stream scene, of
which the 512 planted streams are stepped).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def main():
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from audio_triangulation_tpu.core import config as jcfg, geometry as jgeo
    from audio_triangulation_tpu.models.streaming import StreamingLocalizer

    n_streams = int(sys.argv[1]) if len(sys.argv) > 1 else (
        chip_smoke.STREAM_CHECK_STREAMS)
    x, planted, truth, _ = chip_smoke.stream_scene(n_streams)
    x = x[planted]
    c = chip_smoke.STREAM_CHUNK
    port = dict(chip_smoke.stream_localizers("cpu"))
    for name, cfg in chip_smoke.stream_pipelines().items():
        kw = {f: getattr(cfg, f) for f in ("phat", "band_hz", "band_crop")}
        jsl = StreamingLocalizer.create(
            jgeo.reference_array(), jcfg.PipelineConfig(**kw),
            stream=jcfg.StreamConfig(chunk_size=c))
        tsl = port[name]
        jst, tst = jsl.init_states(len(planted)), tsl.init_states(len(planted))
        jxy = np.full((len(planted), 2), np.nan)
        txy = np.full((len(planted), 2), np.nan)
        for i in range(chip_smoke.STREAM_STEPS):
            chunk = x[:, :, i * c:(i + 1) * c]
            jst, jout = jsl.step_many(jst, jnp.asarray(chunk))
            tst, tout = tsl.step_many(tst, torch.from_numpy(chunk))
            je, te = np.asarray(jout["event"]), tout["event"].numpy()
            jxy[je] = np.asarray(jout["xy"])[je]
            txy[te] = tout["xy"].numpy()[te]
        for who, xy in (("JAX package", jxy), ("port, CPU path", txy)):
            ok = ~np.isnan(xy[:, 0])
            err = np.linalg.norm(xy[ok] - truth[ok], axis=-1)
            print(f"{name}: {who}: accepted {int(ok.sum())} of "
                  f"{len(planted)} planted events, median |xy - truth| "
                  f"{np.median(err) * 100:.4f} cm, largest "
                  f"{err.max() * 100:.4f} cm", flush=True)
        both = ~np.isnan(jxy[:, 0]) & ~np.isnan(txy[:, 0])
        print(f"{name}: largest |xy port - xy JAX| "
              f"{np.abs(jxy[both] - txy[both]).max():.2e} m", flush=True)


if __name__ == "__main__":
    main()
