"""The knee of an open-loop stream cell: its traffic at several stream
counts, one window each, in one process.

    python3 -m benchmark.sweep --workload ref3_firmware.live
        --streams 4096,5120,6144 --seconds 20 --seed 7

``--workload`` names ``<config>.<traffic>``, in ``BENCHMARK.json`` or
not (``ref3_firmware.live`` is not: see ``README.md``).

A line a count: the p50 and p95 of chunk latency, the step's median, and
whether the backlog grew (the mean lateness of the window's last quarter
over its first quarter by more than a chunk period).  The knee is the
highest count whose p95 stays under one chunk period with no growing
backlog; the cell runs at four fifths of it.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import run as run_mod  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--streams", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    run_mod.cache_env()
    import torch

    from . import spec as spec_mod

    spec = spec_mod.load_spec(run_mod.ROOT)
    config, traffic = args.workload.split(".", 1)
    cell = {"name": args.workload, "config": config, "traffic": traffic,
            "chips": 1}
    for s in [int(v) for v in args.streams.split(",")]:
        run = run_mod.make_run(spec, args.workload, args.seed, args.seconds,
                               False, torch.device("cuda", 0),
                               time.perf_counter(),
                               {"streams": s, "check_streams": 32}, cell)
        out = run_mod.execute(run)
        host = out.readings.host
        late, lat = np.asarray(host["lateness_ms"]), np.asarray(
            host["latency_ms"])
        q = max(1, len(late) // 4)
        period_ms = 1e3 * run.config["stream"]["chunk_size"] / float(
            run.config["pipeline"]["sample_rate_hz"])
        growth = float(late[-q:].mean() - late[:q].mean())
        print(json.dumps({
            "streams": s, "chunks": int(lat.size),
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "step_p50_ms": float(np.median(host["step_ms"])),
            "lateness_growth_ms": growth,
            "backlog_grows": growth > period_ms,
            "correct": out.checks.correct and out.failed == 0}), flush=True)
        del out, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
