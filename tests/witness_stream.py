#!/usr/bin/env python3
"""Witness for chip_smoke.py's streaming check: the JAX package's own
``StreamingLocalizer.step_many`` and the port's CPU path on the planted
streams of the same scene (``chip_smoke.stream_scene``), in the streaming
pipelines of ``chip_smoke.stream_setups``.  Prints, per pipeline, how many
planted events each accepted and the median |xy - truth| at the event step
(and, with the free 3-D solve, the median |xyz - source|): the source of
chip_smoke's ``STREAM_MEDIAN_BOUND_M`` and ``STREAM_XYZ_MEDIAN_BOUND_M``.

With ``tracked``, the JAX package's ``TrackedStreamingLocalizer`` and the
port's CPU path on the planted streams of chip_smoke's tracked scene
(``chip_smoke.tracked_scene``, the default tracker bank): per package the
streams that end with exactly one confirmed track and the median |track_xy
- truth| of those tracks, the source of ``TRACK_MEDIAN_BOUND_M``.

    JAX_PLATFORMS=cpu python tests/witness_stream.py [n_streams [names]]
    JAX_PLATFORMS=cpu python tests/witness_stream.py tracked [n_streams]

Runs on the CPU (a minute or two a pipeline at the default 2,048-stream
scene, of which the 512 planted streams are stepped).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def tracked(n_streams):
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from audio_triangulation_tpu.core import config as jcfg
    from audio_triangulation_tpu.core import geometry
    from audio_triangulation_tpu.models.tracked import (
        TrackedStreamingLocalizer)

    c = chip_smoke.STREAM_CHUNK
    x, planted, truth = chip_smoke.tracked_scene(n_streams)
    x = x[planted]
    jsl = TrackedStreamingLocalizer.create(
        geometry.reference_array(), jcfg.PipelineConfig(),
        stream=jcfg.StreamConfig(chunk_size=c))
    tsl = chip_smoke.tracked_banks("cpu")["nearest"]
    jst, tst = jsl.init_states(len(planted)), tsl.init_states(len(planted))
    for i in range(chip_smoke.STREAM_STEPS):
        chunk = x[:, :, i * c:(i + 1) * c]
        jst, jout = jsl.step_many(jst, jnp.asarray(chunk))
        tst, tout = tsl.step_many(tst, torch.from_numpy(chunk))
    jout = {k: torch.from_numpy(np.array(v)) for k, v in jout.items()}
    got = {}
    for label, out in (("JAX package", jout), ("port, CPU path", tout)):
        n_conf, xy = chip_smoke.confirmed_tracks(out)
        one = (n_conf == 1).numpy()
        err = np.linalg.norm(xy.numpy()[one] - truth[one], axis=-1)
        got[label] = xy.numpy()
        print(f"tracked: {label}: {int(one.sum())} of {len(planted)} planted "
              f"streams end with exactly one confirmed track, median "
              f"|track_xy - truth| {np.median(err) * 100:.4f} cm, largest "
              f"{err.max() * 100:.4f} cm", flush=True)
    print(f"tracked: largest |track_xy port - track_xy JAX| "
          f"{np.abs(got['JAX package'] - got['port, CPU path']).max():.2e} m",
          flush=True)


def main():
    if sys.argv[1:2] == ["tracked"]:
        return tracked(int(sys.argv[2]) if len(sys.argv) > 2 else 2048)
    import jax.numpy as jnp
    import torch

    import chip_smoke
    from audio_triangulation_tpu.core import config as jcfg
    from audio_triangulation_tpu.models.streaming import StreamingLocalizer

    n_streams = int(sys.argv[1]) if len(sys.argv) > 1 else (
        chip_smoke.STREAM_CHECK_STREAMS)
    c = chip_smoke.STREAM_CHUNK
    port = dict(chip_smoke.stream_localizers("cpu"))
    names = sys.argv[2:] or list(chip_smoke.stream_setups())
    for name, (mics, cfg, stream) in chip_smoke.stream_setups().items():
        if name not in names:
            continue
        x, planted, truth, src = chip_smoke.stream_scene(n_streams,
                                                         mics=mics)
        x = x[planted]
        kw = {f: getattr(cfg, f) for f in ("phat", "band_hz", "band_crop",
                                           "max_shift_samples")}
        jsl = StreamingLocalizer.create(
            mics, jcfg.PipelineConfig(**kw), stream=jcfg.StreamConfig(
                chunk_size=c, solve_xyz=stream.solve_xyz))
        tsl = port[name]
        jst, tst = jsl.init_states(len(planted)), tsl.init_states(len(planted))
        keys = ("xy", "xyz") if stream.solve_xyz else ("xy",)
        got = {(who, k): np.full((len(planted), 3 if k == "xyz" else 2),
                                 np.nan) for who in "jt" for k in keys}
        for i in range(chip_smoke.STREAM_STEPS):
            chunk = x[:, :, i * c:(i + 1) * c]
            jst, jout = jsl.step_many(jst, jnp.asarray(chunk))
            tst, tout = tsl.step_many(tst, torch.from_numpy(chunk))
            je, te = np.asarray(jout["event"]), tout["event"].numpy()
            for k in keys:
                got["j", k][je] = np.asarray(jout[k])[je]
                got["t", k][te] = tout[k].numpy()[te]
        for k in keys:
            want = truth if k == "xy" else src
            for who, label in (("j", "JAX package"), ("t", "port, CPU path")):
                v = got[who, k]
                ok = ~np.isnan(v[:, 0])
                err = np.linalg.norm(v[ok] - want[ok], axis=-1)
                print(f"{name}: {label}: accepted {int(ok.sum())} of "
                      f"{len(planted)} planted events, median |{k} - truth| "
                      f"{np.median(err) * 100:.4f} cm, largest "
                      f"{err.max() * 100:.4f} cm", flush=True)
            both = ~np.isnan(got["j", k][:, 0]) & ~np.isnan(got["t", k][:, 0])
            print(f"{name}: largest |{k} port - {k} JAX| "
                  f"{np.abs(got['j', k][both] - got['t', k][both]).max():.2e}"
                  " m", flush=True)


if __name__ == "__main__":
    main()
