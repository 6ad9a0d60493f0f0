"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` over a
fixed number of iterations of the cell's own loop, read back from its
Chrome trace.

The trace gives every device operation (kernels, copies, sets) with its
start and length, and the host's operations and the harness's own spans
(``record_function`` names starting ``bench.``).  From them: the stretch's
length on the host (``window_s``, from the first recorded iteration's
start to the last one's end), the seconds in which the device ran an
operation (``busy_s``, the union of their intervals), the operations that
took most time, and the device's idle gaps by what the host was doing
meanwhile (the innermost host span or call that covers the gap).
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import defaultdict
from pathlib import Path

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")
ITER = "bench.iter"


@dataclasses.dataclass
class Trace:
    """Device operations of a traced stretch: (name, category, start us,
    length us) each, and the stretch's host interval in us."""

    ops: list
    host: list
    start_us: float
    end_us: float
    iterations: int
    _host_arrays: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def device_ops(self, cat: str = "kernel", match=None) -> list:
        return [o for o in self.ops if o[1] == cat
                and (match is None or match(o[0]))]

    def busy_s(self) -> float:
        total, cur_s, cur_e = 0.0, None, None
        for _, _, s, d in sorted(self.ops, key=lambda o: o[2]):
            s, e = max(s, self.start_us), min(s + d, self.end_us)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = defaultdict(float)
        for name, _, _, d in self.ops:
            by[name] += d / 1e6
        return sorted(([n, s] for n, s in by.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the stretch, summed by the host
        activity that covered each gap's middle, largest first."""
        by = defaultdict(float)
        t = self.start_us
        for _, _, s, d in sorted(self.ops, key=lambda o: o[2]) + [
                ("", "", self.end_us, 0.0)]:
            if s > t:
                by[self._host_at((t + s) / 2)] += (s - t) / 1e6
            t = max(t, s + d)
        return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:k]

    def _host_at(self, when: float) -> str:
        if self._host_arrays is None:
            self._host_arrays = (np.array([h[1] for h in self.host]),
                                 np.array([h[2] for h in self.host]))
        starts, lengths = self._host_arrays
        cover = (starts <= when) & (starts + lengths >= when)
        if not cover.any():
            return "host idle"
        idx = np.flatnonzero(cover)
        return self.host[int(idx[np.argmin(lengths[idx])])][0]


def parse(events: list, iterations: int) -> Trace:
    """A :class:`Trace` from a Chrome trace's ``traceEvents``."""
    ops, host, iters = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            ops.append((e["name"], cat, float(e["ts"]), float(e["dur"])))
        elif cat in HOST_CATS:
            host.append((e["name"], float(e["ts"]), float(e["dur"])))
            if e["name"] == ITER:
                iters.append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    if len(iters) != iterations:
        raise ValueError(f"the trace holds {len(iters)} {ITER!r} spans, "
                         f"not {iterations}")
    return Trace(ops, host, min(s for s, _ in iters),
                 max(e for _, e in iters), iterations)


def profile(step, iterations: int, out_dir: Path, warmup: int = 3) -> Trace:
    """Run ``step()`` under ``torch.profiler`` (CPU and CUDA activities):
    ``warmup`` iterations with the profiler warming up, then
    ``iterations`` recorded ones, each inside a ``bench.iter`` span, the
    last ending when the device is done.  The recorded iterations make the
    stretch.  The trace file is written to ``out_dir`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    from torch.profiler import schedule

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / "trace.json"
    with tprofile(activities=activities,
                  schedule=schedule(wait=0, warmup=warmup, active=iterations,
                                    repeat=1),
                  on_trace_ready=lambda p: p.export_chrome_trace(str(path))
                  ) as prof:
        for i in range(warmup + iterations):
            with torch.profiler.record_function(ITER):
                step()
                if cuda and i == warmup + iterations - 1:
                    torch.cuda.synchronize()
            prof.step()
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, iterations)
