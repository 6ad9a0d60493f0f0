"""HTTP serving tour: run the LocalizerServer in-process and query it the
way a production client would: batch localization and a stateful
streaming session.

Counterpart of the JAX package's ``examples/serving_http.py`` on the port
(also see ``python -m audio_triangulation_tpu_torch serve``).

    python -m audio_triangulation_tpu_torch.examples.serving_http
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import urllib.request

import numpy as np

from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
from audio_triangulation_tpu_torch.runtime.server import LocalizerServer
from audio_triangulation_tpu_torch.tools.bench import require_device
from audio_triangulation_tpu_torch.utils import synth


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    dev = require_device(ap.parse_args(argv).device)

    mics = geometry.reference_array()
    loc = Localizer.create(mics, PipelineConfig(), device=dev)
    srv = LocalizerServer(loc, port=0).start()
    base = f"http://127.0.0.1:{srv.port}"
    print(f"server up at {base}")

    def post(path, data, headers=None):
        req = urllib.request.Request(base + path, data=data)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        with urllib.request.urlopen(req, timeout=120) as r:
            return json.loads(r.read())

    try:
        # --- batch localization over HTTP ------------------------------
        plane = np.array([0.8, 0.5])
        src3 = np.array([0.8, 0.5, 1.2])
        src3 = src3 * 1.2 / np.linalg.norm(src3)
        frames = synth.synth_scene(src3, mics, noise_rms=0.01,
                                   seed=0).astype(np.float32)

        # raw float32 body (no JSON encode of megabytes of PCM)
        out = post("/localize", frames.tobytes(),
                   {"Content-Type": "application/octet-stream",
                    "X-Shape": ",".join(str(d) for d in frames.shape)})
        xy = np.asarray(out["xy"])[0]
        print(f"POST /localize -> xy=({xy[0]:+.3f}, {xy[1]:+.3f}), "
              f"err {100 * np.linalg.norm(xy - plane):.1f} cm")

        # --- stateful streaming session --------------------------------
        sid = post("/streams", b"{}",
                   {"Content-Type": "application/json"})["id"]
        rng = np.random.default_rng(1)
        streams = rng.integers(127, 130, size=(3, 8192)).astype(np.float64)
        streams[:, 3000:3000 + 1024] += 110.0 * frames[0]
        streams = np.clip(np.round(streams), 0, 255).astype(np.float32)

        chunk = 512
        for i in range(0, streams.shape[-1] - chunk + 1, chunk):
            c = np.ascontiguousarray(streams[:, i: i + chunk])
            out = post(f"/streams/{sid}", c.tobytes(),
                       {"Content-Type": "application/octet-stream",
                        "X-Shape": f"{c.shape[0]},{c.shape[1]}"})
            if out["event"]:
                exy = np.asarray(out["xy"])
                print(f"stream event @ chunk {i // chunk}: "
                      f"xy=({exy[0]:+.3f}, {exy[1]:+.3f})")
    finally:
        srv.stop()
    print("serving tour done")


if __name__ == "__main__":
    main()
