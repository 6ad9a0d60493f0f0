"""One run of one benchmark cell of ``audio_triangulation_tpu_torch``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

From the root of a checkout.  It builds the cell's inputs from the seed on
the card, warms up every shape the cell uses (set-up, ``setup_s``),
measures for ``--seconds``, then with ``--trace 1`` profiles a stretch of
the same loop, frees the program's state and checks what the timed path
produced against the float64 reference.  Standard error ends with each
number compared beside its limit; standard output ends with one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``.  It stops with a non-zero
code and no result without enough CUDA devices, or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_triangulation_tpu")


def cache_env() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def loaded_forbidden() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_run(spec, name, seed, seconds, trace, device, t_start,
             overrides=None, cell=None):
    """The Run of cell ``name`` (or of the entry ``cell``, for one not in
    ``BENCHMARK.json``), its traffic entries replaced by ``overrides``."""
    from . import spec as spec_mod
    from .harness import Run

    cell = cell or spec_mod.workload(spec, name)
    traffic = dict(spec_mod.traffic_of(cell))
    traffic.update(overrides or {})
    limits, margins = spec_mod.limits_of(cell)
    return Run(spec=spec, cell=cell, config=spec_mod.config_of(spec, cell),
               traffic=traffic, limits=limits, margins=margins, seed=seed,
               seconds=seconds,
               trace=trace, device=device, scratch=CACHE / "trace",
               t_start=t_start)


def execute(run):
    """The cell's traffic kind run on ``run``: its Outcome."""
    from . import spec as spec_mod

    return spec_mod.kind_module(run.traffic["kind"]).run(run)


def result_line(run, outcome, card=None) -> dict:
    """The run's result: end-to-end metrics, or per-layer ones when
    traced, the device, the card's name and power limit (``card``), and
    the checks last."""
    import torch

    from . import spec as spec_mod

    name = run.cell["name"]
    metrics = {}
    if run.trace:
        for m in spec_mod.per_layer_of(run.spec, name):
            value = spec_mod.reader(m["name"])(outcome.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec_mod.end_to_end_of(run.spec, name):
            metrics[m["name"]] = {"value": outcome.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    dev = torch.device(run.device)
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    line = {"correct": outcome.checks.correct and outcome.failed == 0,
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    tr = outcome.readings.trace
    if run.trace and tr is not None:
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_gaps()}
    line.update(outcome.extra)
    if card is not None:
        line["card"] = card
    line["checks"] = outcome.checks.table()
    return line


def main(argv=None) -> int:
    args = parse(argv)
    cache_env()
    import torch

    from . import spec as spec_mod
    from .roofline import power_limit_w

    spec = spec_mod.load_spec(ROOT)
    cell = spec_mod.workload(spec, args.workload)
    t_imports = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    run = make_run(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), torch.device("cuda", 0), T_START)
    run.marks.append(("imports", t_imports))
    torch.empty(1, device=run.device)
    run.mark("CUDA context")
    outcome = execute(run)
    found = loaded_forbidden()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    line = result_line(run, outcome, {
        "name": torch.cuda.get_device_name(0),
        "power_limit_w": power_limit_w(0)})
    print("setup_s parts: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in run.setup_parts().items()),
        file=sys.stderr)
    if outcome.checks.extra:
        print(f"checked: {json.dumps(outcome.checks.extra)}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    for text in outcome.checks.lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
