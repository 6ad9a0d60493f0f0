"""The readings that a cell's correctness limits are set from, in one
process: the program's numbers on many seeds (full runs of the cell,
untraced) and the control's (the reference at the precision below the
configuration's, in the program's place, on the same kind of inputs and
as many answers as a run compares).

    python3 -m benchmark.readings --workload <cell> --seeds 1,2,3
        [--control-seeds 4,5,6] [--seconds 20] [--out PATH]

One JSON line a seed and side; ``--out`` also writes them to a file.
The limits themselves live in
``limits/<cell>.json``, with the readings they were set from.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from . import run as run_mod  # noqa: E402


def control_numbers(run) -> dict:
    """The control's numbers on this run's seed: the checks of the
    reference at ``Precision.below()`` against the float64 reference."""
    from . import reference, scenes
    from .kinds import batch, stream

    kind = run.traffic["kind"]
    if kind == "batch":
        pool = scenes.frame_pool(run.config, run.traffic, run.seed,
                                 run.device)
        st = reference.settings(run.config)
        ctl = reference.Chain(st, run.device, reference.Precision.below())
        kept = {}
        for i in range(run.traffic["check_calls"]):
            out = ctl.localize(pool[i % len(pool)])
            kept[i] = tuple(out[k].double() for k in
                            ("tdoa_samples", "xy_grid", "xy"))
        frames = {i % len(pool): pool[i % len(pool)] for i in kept}
        checks, _ = batch.check(run, frames, kept)
    elif kind == "stream":
        pool = scenes.stream_pool(run.config, run.traffic, run.seed,
                                  run.device, run.traffic["streams"])
        _, chunks = stream.sampled(run, pool)
        steps = run.traffic.get("control_steps", 0) or int(
            run.seconds / stream_period(run.config)) + 40
        checks, _ = stream.check(run, chunks, [None] * steps,
                                 precision=reference.Precision.below())
    else:
        raise ValueError(kind)
    out = dict(checks.values)
    out.update(checks.extra)
    return out


def stream_period(config) -> float:
    return config["stream"]["chunk_size"] / float(
        config["pipeline"]["sample_rate_hz"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run_mod.cache_env()
    import torch

    from . import spec as spec_mod

    spec = spec_mod.load_spec(run_mod.ROOT)
    device = torch.device(args.device)
    lines = []

    def emit(rec):
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    for seed in [int(s) for s in args.seeds.split(",") if s]:
        run = run_mod.make_run(spec, args.workload, seed, args.seconds, False,
                               device, time.perf_counter())
        outcome = run_mod.execute(run)
        rec = {"side": "program", "seed": seed, **outcome.checks.values,
               **outcome.checks.extra,
               "failed": outcome.failed, "end_to_end": outcome.end_to_end}
        emit(rec)
        del outcome
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        run = run_mod.make_run(spec, args.workload, seed, args.seconds, False,
                               device, time.perf_counter())
        t0 = time.perf_counter()
        emit({"side": "control", "seed": seed, **control_numbers(run),
              "seconds": time.perf_counter() - t0})
    if args.out:
        with open(args.out, "w") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
