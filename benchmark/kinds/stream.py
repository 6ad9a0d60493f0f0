"""Many 50 kHz arrays streamed through one card: every stream's next
512-sample chunk stepped by the program's graphed batched step
(``StreamingLocalizer.graph_step_many`` -> ``GraphedStep.__call__``, which
copies the chunk from pinned host memory to the card), then ``xy``,
``events`` and ``best_shift`` read back to the host.

``loop: closed``: the next step starts when the last one's outputs are on
the host; ``realtime_streams`` is streams x 10.24 ms x steps done in the
window, over the window.  ``loop: open``: chunk k of every stream falls due
at the window's start plus (k + 1) chunk periods, whatever the system
does; ``chunk_latency_p95_ms`` is the 95th percentile over the chunks due
in the window of the time from when a chunk was due to when its step's
outputs were on the host (a chunk that comes late counts its wait).

The check: a sample of the streams drawn from the seed, every step since
the graph was made (warm-up, window and traced stretch) against the
float64 streaming step on the same chunks: ``event_mismatch`` (steps whose
accepted-event flag differs), ``shift_mismatch`` (best shifts that differ
where the reference's smoothed peak is clear of its runner-up) and
``xy_gap_m`` (after a stream's first accepted event, where the smoothed
scores' best cell is clear of the runner-up by ``grid_clear``).  The
first two are exact comparisons.  A stream is judged as long as its
decisions are clear of float32 rounding (the cell's ``margins``): every
trigger decision (``trigger_clear``) and every accepted event's integer
peaks (``peak_clear``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import reference, scenes, trace as trace_mod
from ..harness import (Checks, Outcome, Readings, free_device, memory_peak,
                       mics_of, pinned, port_configs, quiet_gc)

# the open loop sleeps until this many seconds before a chunk is due, then
# spins: a sleep alone wakes late by about as much
SPIN_S = 0.0005


class EagerStep:
    """The graphed step's interface over the eager ``step_many``, for a
    device without CUDA graphs (the harness's own tests)."""

    def __init__(self, sl, states):
        self.sl, self.states = sl, states

    def __call__(self, chunks):
        self.states, out = self.sl.step_many(self.states,
                                             chunks.to(self.sl.params.window
                                                       .device))
        return out


def build(run):
    """The program's streaming localizer on the run's device."""
    from audio_triangulation_tpu_torch import StreamConfig, StreamingLocalizer

    pipeline, grid, solver = port_configs(run.config)
    sl = StreamingLocalizer.create(
        mics_of(run.config), pipeline, grid, solver,
        StreamConfig(chunk_size=run.config["stream"]["chunk_size"]),
        device=run.device)
    return sl


def sampled(run, pool):
    """The streams the check judges, drawn from the seed, and their chunks
    [C, S', M, chunk] as int16 on the host."""
    import torch

    n_streams = pool.shape[1]
    rng = np.random.default_rng([int(run.seed) % (1 << 63), 2])
    sample = np.sort(rng.choice(
        n_streams, size=min(run.traffic["check_streams"], n_streams),
        replace=False))
    chunks = pool[:, torch.as_tensor(sample, device=pool.device)].to(
        "cpu", torch.int16)
    return sample, chunks


class Recorder:
    """Steps the program and keeps the sampled streams' outputs."""

    def __init__(self, step, pool_host, sample, device, n_pairs):
        import torch

        self.step, self.pool, self.sample = step, pool_host, sample
        s = pool_host.shape[1]
        self.cuda = torch.device(device).type == "cuda"
        self.xy = pinned((s, 2), torch.float32, device)
        self.events = pinned((s, 1), torch.bool, device)
        self.best = pinned((s, n_pairs), torch.int32, device)
        self.rows = []
        self.stream = torch.cuda.current_stream() if self.cuda else None
        self.views = (self.events.numpy(), self.best.numpy(), self.xy.numpy())

    def __call__(self):
        import torch

        k = len(self.rows)
        with torch.profiler.record_function("bench.step"):
            out = self.step(self.pool[k % self.pool.shape[0]])
        with torch.profiler.record_function("bench.readback"):
            self.xy.copy_(out["xy"], non_blocking=self.cuda)
            self.events.copy_(out["events"], non_blocking=self.cuda)
            self.best.copy_(out["best_shift"], non_blocking=self.cuda)
            if self.cuda:
                self.stream.synchronize()
        ev, best, xy = self.views
        self.rows.append((ev[self.sample, 0], best[self.sample],
                          xy[self.sample]))


def run(run) -> Outcome:
    import torch

    tr = run.traffic
    n_streams = tr["streams"]
    sl = build(run)
    run.mark("program objects")
    pool_dev = scenes.stream_pool(run.config, tr, run.seed, run.device,
                                  n_streams)
    sample, ref_chunks = sampled(run, pool_dev)
    pool_host = pinned(pool_dev.shape, torch.float32, run.device)
    pool_host.copy_(pool_dev)
    del pool_dev
    free_device(run.device)
    run.mark("inputs (pinned chunk pool)")

    states = sl.init_states(n_streams)
    if torch.device(run.device).type == "cuda":
        step = sl.graph_step_many(states, pool_host[0].to(run.device))
    else:
        step = EagerStep(sl, states)
    rec = Recorder(step, pool_host, sample, run.device,
                   sl.params.pairs.shape[0])
    for _ in range(tr["warmup_steps"]):
        rec()
    run.mark("graph capture and warm-up")
    setup_s = run.setup_done()

    period = run.config["stream"]["chunk_size"] / float(
        run.config["pipeline"]["sample_rate_hz"])
    host = {}
    if tr["loop"] == "closed":
        with quiet_gc():
            t0 = time.perf_counter()
            deadline = t0 + run.seconds
            done = 0
            while time.perf_counter() < deadline:
                rec()
                if time.perf_counter() <= deadline:
                    done += 1
        e2e = {"realtime_streams": n_streams * period * done / run.seconds}
        attempted = len(rec.rows) - tr["warmup_steps"]
    elif tr["loop"] == "open":
        with quiet_gc():
            lat, late, step_ms = open_loop(rec, period, run.seconds)
        e2e = {"chunk_latency_p95_ms": float(np.percentile(lat, 95))}
        host = {"step_ms": step_ms, "lateness_ms": late, "latency_ms": lat}
        attempted = len(lat)
    else:
        raise ValueError(f"loop {tr['loop']!r}")
    e2e["setup_s"] = setup_s
    attempted *= n_streams

    traced = None
    if run.trace:
        if tr["loop"] == "open":
            traced = trace_mod.profile(open_stepper(rec, period),
                                       tr["trace_steps"], run.scratch)
        else:
            traced = trace_mod.profile(rec, tr["trace_steps"], run.scratch)
    peak = memory_peak(run.device)
    rows = rec.rows
    del rec, step, sl, pool_host
    free_device(run.device)

    checks, failed = check(run, ref_chunks, rows)
    st = reference.settings(run.config, full_grid=True)
    n = st.n
    shapes = dict(streams=n_streams, mics=st.mics.shape[0], n=n,
                  window=n - 1 + st.chunk, pairs=st.pairs.shape[0],
                  lags=st.num_lags, bins=len(reference.kept_bins(st)))
    readings = Readings(run.cell, run.config, tr, shapes, traced, host)
    return Outcome(e2e, attempted=attempted, failed=failed, checks=checks,
                   readings=readings, memory_peak_bytes=peak)


def open_loop(rec, period: float, seconds: float):
    """Chunks due every ``period`` from the window's start, each stepped
    once it is due: (latency, lateness, step time) lists in ms, over the
    chunks due in the window."""
    t0 = time.perf_counter()
    n_due = int(seconds / period)
    lat, late, step_ms = [], [], []
    for k in range(n_due):
        due = t0 + (k + 1) * period
        wait_until(due)
        start = time.perf_counter()
        rec()
        done = time.perf_counter()
        lat.append((done - due) * 1e3)
        late.append((start - due) * 1e3)
        step_ms.append((done - start) * 1e3)
    return lat, late, step_ms


def open_stepper(rec, period: float):
    """One step of the open loop a call, on its own schedule from the first
    call (the traced stretch)."""
    state = {"t0": None, "k": 0}

    def step():
        if state["t0"] is None:
            state["t0"] = time.perf_counter()
        state["k"] += 1
        wait_until(state["t0"] + state["k"] * period)
        rec()

    return step


def wait_until(t: float) -> None:
    import torch

    with torch.profiler.record_function("bench.wait_due"):
        while True:
            left = t - time.perf_counter()
            if left <= 0:
                return
            if left > SPIN_S:
                time.sleep(left - SPIN_S)


NUMBERS = ("event_mismatch", "shift_mismatch", "xy_gap_m")
MARGINS = ("trigger_clear", "peak_clear", "grid_clear")


class Replay:
    """The float64 streaming step of the sampled streams beside what is
    judged (the program's recorded outputs, or the control's step), each
    step's comparison accumulated on the device.  On a card one step and
    its comparison are one CUDA graph, replayed with the step's chunk and
    recorded outputs copied into its input buffers."""

    def __init__(self, run, ref_chunks, recorded=None, precision=None):
        import torch

        st = reference.settings(run.config, full_grid=True)
        dev = torch.device(run.device)
        self.dev = dev
        self.chunks = ref_chunks.to(dev, torch.int64)
        s = self.chunks.shape[1]
        self.ref = reference.StreamReference(
            st, s, dev, peak_clear=run.margins["peak_clear"],
            grid_clear=run.margins["grid_clear"])
        self.ctl = (None if precision is None
                    else reference.StreamReference(st, s, dev, precision))
        self.recorded = recorded
        self.chunk_in = torch.empty_like(self.chunks[0])
        self.prog_in = ([torch.empty_like(r[0]) for r in recorded]
                        if recorded is not None else None)
        self.k = st.k
        self.lim = run.limits.get("xy_gap_m")
        self.trigger_clear = run.margins["trigger_clear"]
        self.peak_clear = run.margins["peak_clear"]
        self.clear = torch.ones(s, dtype=torch.bool, device=dev)
        self.events = torch.zeros((), dtype=torch.long, device=dev)
        self.shifts = torch.zeros_like(self.events)
        self.over = torch.zeros_like(self.events)
        self.xy_gap = torch.zeros(s, dtype=torch.float64, device=dev)

    def _mutable(self) -> list:
        states = self.ref.state() + (self.ctl.state() if self.ctl else [])
        return states + [self.clear, self.events, self.shifts, self.over,
                         self.xy_gap]

    def body(self):
        import torch

        ev, best, xy, ema, accepted, margin, ev_clear, grid_clear = \
            self.ref.step(self.chunk_in)
        if self.ctl is None:
            p_ev, p_best, p_xy = self.prog_in
        else:
            p_ev, p_best, p_xy = self.ctl.step(self.chunk_in)[:3]
        self.clear.logical_and_((margin >= self.trigger_clear) & ev_clear)
        ev_bad = (p_ev.bool() != ev) & self.clear
        peak_clear = reference.peak_is_clear(ema, self.peak_clear)
        sh_bad = (p_best.long() != best) & peak_clear & self.clear[:, None]
        xg = torch.linalg.vector_norm(p_xy.double() - xy.double(), dim=-1)
        xg = torch.where(self.clear & (accepted > 0) & grid_clear, xg,
                         torch.zeros_like(xg))
        torch.maximum(self.xy_gap, xg, out=self.xy_gap)
        self.events.add_(ev_bad.sum())
        self.shifts.add_(sh_bad.sum())
        bad = ev_bad | sh_bad.any(dim=-1)
        if self.lim is not None:
            bad = bad | (xg > self.lim)
        self.over.add_(bad.sum())

    def _feed(self, g: int):
        self.chunk_in.copy_(self.chunks[g % self.chunks.shape[0]])
        if self.prog_in is not None:
            for buf, rec in zip(self.prog_in, self.recorded):
                buf.copy_(rec[g])

    def run(self, steps: int):
        import torch

        if steps == 0:
            return
        if self.dev.type != "cuda":
            for g in range(steps):
                self._feed(g)
                self.body()
            return
        self._feed(0)
        initial = [t.clone() for t in self._mutable()]
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.body()
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            self.body()
        for t, t0 in zip(self._mutable(), initial):
            t.copy_(t0)
        for g in range(steps):
            self._feed(g)
            graph.replay()
        torch.cuda.synchronize(self.dev)


def check(run, ref_chunks, rows: list, precision=None):
    """The sampled streams' recorded outputs against the float64 streaming
    step on their chunks ``ref_chunks`` [C, S', M, chunk]: (Checks, answers
    over a limit).  ``precision`` puts that precision's step in the
    program's place (the control), and ``rows`` then only counts the
    steps."""
    import torch

    recorded = None
    if precision is None and rows:
        recorded = [torch.as_tensor(np.stack([r[i] for r in rows]),
                                    device=run.device) for i in range(3)]
    rep = Replay(run, ref_chunks, recorded, precision)
    rep.run(len(rows))
    checks = Checks(run.limits)
    checks.add("event_mismatch", int(rep.events))
    checks.add("shift_mismatch", int(rep.shifts))
    checks.add("xy_gap_m", float(rep.xy_gap.max()))
    checks.extra = {"streams_clear": int(rep.clear.sum()),
                    "streams": rep.clear.numel(),
                    "streams_with_events": int((rep.ref.accepted > 0).sum()),
                    "steps": len(rows)}
    return checks, int(rep.over)
