"""The port's span system (``utils/profiling``): spans off cost nothing and
make nothing; on, records nest with parents, ids and self time; the
``StageTimer`` reads them; ``localize_frames``, the stream step and the
DoA estimator give bit-equal outputs with tracing on and off and open
their spans in order; the benchmark's readers of the spans and counts.
The ``gpu`` cases time a graphed step's stages on the card inside its CUDA
graph, and the DoA estimator's stages.  No JAX here: the
``gpu`` cases run on the card (``python -m pytest
tests/test_torch_tracing.py -m gpu -q``)."""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import time

import pytest
import torch

from audio_triangulation_tpu_torch import (Localizer, StreamConfig,
                                           StreamingLocalizer)
from audio_triangulation_tpu_torch.models.doa import DoaEstimator
from audio_triangulation_tpu_torch.utils import profiling
from benchmark import scenes, spans, spec as spec_mod, trace as trace_mod
from benchmark.harness import Readings, mics_of, port_configs
from benchmark.kinds import doa as doa_kind

SPEC = spec_mod.load_spec()
CELL = spec_mod.workload(SPEC, "ref3_firmware.stream4k")
CONFIG = spec_mod.config_of(SPEC, CELL)
STAGES = ("stream.detect", "stream.correlate", "stream.smooth",
          "stream.health", "stream.srp", "stream.solve")
DOA_CELL = spec_mod.workload(SPEC, "circ8_doa.batch16k")
DOA_CONFIG = spec_mod.config_of(SPEC, DOA_CELL)
DOA_STAGES = ("doa.gcc", "doa.srp", "doa.tail")
DOA_METRICS = ("doa.gcc_kernel_roofline", "doa.gcc_stage_ms",
               "doa.srp_stage_ms", "doa.tail_stage_ms", "idle_pct.doa")


@pytest.fixture(autouse=True)
def fresh():
    """Each test starts with tracing off and no records, and leaves them
    so."""
    before = profiling.enabled()
    profiling.enable(False)
    profiling.reset()
    yield
    profiling.enable(before)
    profiling.reset()


def _localizer(device="cpu"):
    pipeline, grid, solver = port_configs(CONFIG)
    return Localizer.create(mics_of(CONFIG), pipeline, grid, solver,
                            device=device,
                            init_grid_stride=CONFIG["init_grid_stride"])


def _streamer(device="cpu"):
    pipeline, grid, solver = port_configs(CONFIG)
    return StreamingLocalizer.create(
        mics_of(CONFIG), pipeline, grid, solver,
        StreamConfig(chunk_size=CONFIG["stream"]["chunk_size"]),
        device=device)


def _chunks(device, streams=8, chunks=6, seed=2101):
    traffic = dict(spec_mod.traffic_of(CELL), streams=streams,
                   pool_chunks=chunks, burst_every=2)
    return scenes.stream_pool(CONFIG, traffic, seed, device, streams)


def _frames(device, b=16, seed=2102):
    traffic = dict(spec_mod.traffic_of(
        spec_mod.workload(SPEC, "ref3_firmware.batch16k")),
        frames_per_call=b, pool_batches=1)
    return scenes.frame_pool(CONFIG, traffic, seed, device)[0]


# ----------------------------------------------------------------------
# the span system
# ----------------------------------------------------------------------

def test_tracing_off_makes_no_span_event_or_record(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: made.append(name))
    assert not profiling.enabled()
    with profiling.annotate("x", torch.device("cpu")) as r:
        assert r is None
    assert profiling.call_id() is None
    profiling.count("n", 3)
    assert profiling.replayed([object()]) == []
    assert made == []
    assert profiling.records() == [] and profiling.totals() == {}
    assert profiling.counters() == {}


def test_tracing_switch_restores_its_state():
    with profiling.tracing():
        assert profiling.enabled()
        with profiling.tracing(False):
            assert not profiling.enabled()
        assert profiling.enabled()
    assert not profiling.enabled()
    profiling.enable()
    assert profiling.enabled()


def test_records_nest_with_parents_ids_and_self_time():
    with profiling.tracing():
        with profiling.annotate("outer") as outer:
            with profiling.annotate("a"):
                time.sleep(0.002)
            with profiling.annotate("b"):
                with profiling.annotate("c"):
                    time.sleep(0.001)
            time.sleep(0.001)
        with profiling.annotate("next"):
            pass
        with profiling.annotate("given", call=outer.call):
            pass
    recs = profiling.records()
    assert [r.name for r in recs] == ["a", "c", "b", "outer", "next",
                                      "given"]
    by = {r.name: r for r in recs}
    assert [by[n].parent for n in ("a", "c", "b", "outer", "next")] == [
        "outer", "b", "outer", None, None]
    assert by["a"].call == by["b"].call == by["c"].call == by["outer"].call
    assert by["next"].call != by["outer"].call
    assert by["given"].call == by["outer"].call
    for name, kids in (("outer", ("a", "b")), ("b", ("c",)), ("a", ())):
        r = by[name]
        want = r.host_ms - sum(by[k].host_ms for k in kids)
        assert r.host_self_ms == pytest.approx(want, abs=1e-9)
    assert by["outer"].host_self_ms >= 1.0 and by["a"].host_ms >= 2.0
    assert all(r.device_ms is None for r in recs)  # no CUDA device given
    tot = profiling.totals()
    assert tot["outer"].count == 1 and tot["outer"].device_count == 0
    assert tot["b"].host_self_ms == pytest.approx(by["b"].host_self_ms)


def test_spans_follow_a_recording_profiler():
    """Not switched on, spans are made while a ``torch.profiler`` session
    records (as ``record_function`` ranges in its trace, and records), and
    not after it."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.enabled()
        with profiling.annotate("heard"):
            torch.ones(4).sum()
    assert not profiling.enabled()
    with profiling.annotate("after"):
        torch.ones(4).sum()
    assert "heard" in {e.key for e in prof.key_averages()}
    assert [r.name for r in profiling.records()] == ["heard"]


def test_records_and_pending_are_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "PENDING", 4)
    monkeypatch.setattr(profiling, "RING", 16)
    rec = profiling.Recorder()
    waited = []

    class Ev:  # a resolved event pair's stand-in
        def __init__(self, t):
            self.t = t

        def synchronize(self):
            waited.append(self.t)

        def elapsed_time(self, end):
            return end.t - self.t

    for i in range(100):
        r = profiling.Record("s", None, i, 0, 10, events=(Ev(0.0), Ev(2.0)))
        rec._close(r)
    assert len(rec._pending) <= 4 and len(waited) >= 96
    recs = rec.records()
    assert len(recs) == 16 and [r.call for r in recs] == list(range(84, 100))
    tot = rec.totals()["s"]
    assert (tot.count, tot.device_count, tot.device_ms) == (100, 100, 200.0)
    assert all(r.events is None for r in recs)  # events let go once read


def test_replayed_spans_are_children_of_the_open_span():
    """A graph's captured spans (here stand-ins with their events) give one
    record each a replay: children of the open span, with its id, device
    times read only when resolved, self time net of captured children."""

    class Ev:
        def __init__(self, t):
            self.t, self.waits = t, 0

        def synchronize(self):
            self.waits += 1

        def elapsed_time(self, end):
            return end.t - self.t

    outer = profiling.Record("stage", None, 0, 0, events=(Ev(1.0), Ev(5.0)))
    inner = profiling.Record("part", "stage", 0, 0, events=(Ev(2.0), Ev(3.5)),
                             up=outer)
    captured = [inner, outer]  # in the order they closed
    with profiling.tracing():
        with profiling.annotate("stream.replay") as replay:
            got = profiling.replayed(captured)
    assert [r.name for r in got] == ["part", "stage"]
    assert [r.parent for r in got] == ["stage", "stream.replay"]
    assert {r.call for r in got} == {replay.call}
    assert outer.events[1].waits == 0  # nothing read inside the span
    profiling.resolve(got)
    assert [r.device_ms for r in got] == [1.5, 4.0]
    assert got[1].device_self_ms == 2.5 and got[0].device_self_ms == 1.5
    assert outer.events is not None  # the graph keeps its events
    tot = profiling.totals()
    assert tot["stage"].device_ms == 4.0 and tot["stream.replay"].count == 1


def test_counts_and_counts_read_at_read_out():
    with profiling.tracing():
        profiling.count("frames", 8)
        profiling.count("frames", 8)
        box = [3]
        profiling.count_at_read("events", lambda: box[0])
        box[0] = 5
        assert profiling.counters() == {"frames": 16, "events": 5}
        gen = profiling.generation()
        profiling.reset()
        assert profiling.counters() == {} and profiling.generation() != gen


def test_stage_timer_reads_its_records():
    t = profiling.StageTimer()
    for _ in range(2):
        with t.stage("work") as h:
            with t.stage("inner"):
                time.sleep(0.001)
            h["result"] = torch.ones(2)
    assert not profiling.records()  # its own recorder, whatever the switch
    assert t.calls["work"] == 2 and t.calls["inner"] == 2
    assert t.calls["none"] == 0 and t.total_s["none"] == 0.0
    assert t.total_s["work"] >= t.total_s["inner"] >= 0.002
    lines = t.report().splitlines()
    assert lines[0] == "stage                 calls    total_ms     ms/call"
    ms = t.total_s["work"] * 1e3
    assert lines[1] == f"{'work':20s} {2:6d} {ms:11.2f} {ms / 2:11.3f}"
    t.reset()
    assert not t.calls and not t.total_s


def test_trace_turns_tracing_on_inside(tmp_path):
    with profiling.trace(str(tmp_path), host=True):
        assert profiling.enabled()
        with profiling.annotate("inside"):
            pass
    assert not profiling.enabled()
    assert [r.name for r in profiling.records()] == ["inside"]


# ----------------------------------------------------------------------
# the spans of the program
# ----------------------------------------------------------------------

def _estimator(device="cpu", smp=False):
    return DoaEstimator.create(mics_of(DOA_CONFIG),
                               doa_kind.pipeline_of(DOA_CONFIG),
                               DOA_CONFIG["n_azimuths"], smp=smp,
                               device=device)


def _doa_frames(device, b=8, seed=2103):
    traffic = dict(spec_mod.traffic_of(DOA_CELL), frames_per_call=b,
                   pool_batches=1)
    return doa_kind.plane_wave_pool(DOA_CONFIG, traffic, seed, device)[0]

def test_localize_frames_bit_equal_and_spans_in_order():
    loc = _localizer()
    frames = _frames("cpu")
    off = loc(frames)
    with profiling.tracing():
        on = loc(frames)
        direct = profiling.call_id()
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    recs = profiling.records()
    assert [(r.name, r.parent) for r in recs] == [
        ("loc.gcc", "loc.forward"), ("loc.srp", "loc.forward"),
        ("loc.forward", None)]
    assert len({r.call for r in recs}) == 1 and direct != recs[0].call
    assert recs[2].host_self_ms < recs[2].host_ms


@pytest.mark.parametrize("smp,route", [(False, "kernel"), (True, "unfused")])
def test_doa_estimator_bit_equal_spans_in_order_and_counts(smp, route):
    est = _estimator(smp=smp)
    frames = _doa_frames("cpu")
    off = est(frames)
    assert profiling.counters() == {}
    with profiling.tracing():
        on = est(frames)
        counts = profiling.counters()
    assert set(on) == set(off)
    for k in off:
        assert torch.equal(on[k], off[k]), k
    recs = profiling.records()
    assert [(r.name, r.parent) for r in recs] == [
        (name, "doa.forward") for name in DOA_STAGES] + [("doa.forward", None)]
    assert len({r.call for r in recs}) == 1
    assert all(r.device_ms is None for r in recs)  # no CUDA device here
    assert counts == {"doa.frames": frames.shape[0], f"doa.route.{route}": 1}


def test_step_many_bit_equal_and_stage_spans_in_order():
    sl = _streamer()
    pool = _chunks("cpu")
    st_off = st_on = sl.init_states(pool.shape[1])
    events = 0
    for k in range(pool.shape[0]):
        st_off, off = sl.step_many(st_off, pool[k])
        with profiling.tracing():
            st_on, on = sl.step_many(st_on, pool[k])
        for name in off:
            assert torch.equal(on[name], off[name]), (k, name)
        events += int(off["events"].sum())
    for a, b in zip(vars(st_off).values(), vars(st_on).values()):
        assert torch.equal(a, b)
    assert events > 0
    recs = profiling.records()
    assert [r.name for r in recs] == list(STAGES) * pool.shape[0]
    for k in range(pool.shape[0]):
        step = recs[6 * k: 6 * k + 6]
        assert len({r.call for r in step}) == 1
        assert all(r.parent is None for r in step)
    assert recs[0].call != recs[6].call


# ----------------------------------------------------------------------
# the benchmark's readers
# ----------------------------------------------------------------------

def _read(name, readings):
    return spec_mod.reader(name)(readings)


def _readings(trace):
    return Readings(CELL, CONFIG, {}, {}, trace, {})


def _synthetic_trace(with_spans=True):
    """Two steps: replay spans 0-100 and 1000-1100 us, ingest spans before
    them, the device busy 40-100 and 1050-1070 (+ 1060-1080) us, and
    forward spans of 300 and 500 us."""
    host = [("bench.iter", 0.0, 900.0), ("bench.iter", 900.0, 900.0)]
    if with_spans:
        host += [("stream.ingest", -50.0, 40.0), ("stream.replay", 0.0, 100.0),
                 ("stream.ingest", 950.0, 40.0),
                 ("stream.replay", 1000.0, 100.0),
                 ("loc.forward", 0.0, 300.0), ("loc.forward", 900.0, 500.0)]
    ops = [("k1", "kernel", 40.0, 60.0), ("k2", "kernel", 1050.0, 20.0),
           ("k3", "kernel", 1060.0, 20.0), ("m", "gpu_memcpy", 2000.0, 5.0)]
    return trace_mod.Trace(ops, host, 0.0, 1800.0, 2)


def test_host_span_readers_on_a_synthetic_trace():
    r = _readings(_synthetic_trace())
    assert _read("entry.forward_host_ms", r) == pytest.approx(0.4)
    assert _read("stream.ingest_host_ms", r) == pytest.approx(0.04)
    assert _read("stream.replay_host_ms", r) == pytest.approx(0.1)
    # idle inside the replays: 40 us of the first, 70 of the second
    assert _read("stream.launch_idle_ms", r) == pytest.approx(0.055)
    bare = _readings(_synthetic_trace(with_spans=False))
    for name in ("entry.forward_host_ms", "stream.ingest_host_ms",
                 "stream.replay_host_ms", "stream.launch_idle_ms"):
        assert _read(name, bare) is None, name
        assert _read(name, _readings(None)) is None, name


def test_host_span_reader_on_a_cpu_traced_run(tmp_path):
    loc = _localizer()
    frames = _frames("cpu", b=4)
    with profiling.tracing():
        tr = trace_mod.profile(lambda: loc(frames), 2, tmp_path, warmup=1)
    ms = _read("entry.forward_host_ms", _readings(tr))
    assert ms is not None and ms > 0
    # no device here: the device readers say nothing, never a CPU number
    assert _read("gcc.stage_ms", _readings(tr)) is None
    assert _read("srp.stage_ms", _readings(tr)) is None


def _replay_records(steps=3):
    recs = []
    for call in range(steps):
        recs.append(profiling.Record("stream.replay", None, call, 0, 1))
        for i, name in enumerate(STAGES):
            recs.append(profiling.Record(name, "stream.replay", call, 0, 0,
                                         device_ms=0.1 * (i + 1) + call))
        recs.append(profiling.Record("loc.gcc", "loc.forward", 99, 0, 0,
                                     device_ms=1.0 + call))
        recs.append(profiling.Record("loc.srp", "loc.forward", 99, 0, 0,
                                     device_ms=0.5 + call))
    # an eager step's stages (a warm-up) are not a replay's
    recs.insert(0, profiling.Record("stream.detect", None, 50, 0, 0,
                                    device_ms=100.0))
    return recs


def test_program_readers_on_synthetic_records(monkeypatch):
    monkeypatch.setattr(profiling, "records", lambda: _replay_records())
    monkeypatch.setattr(profiling, "counters", lambda: {
        "stream.frames_correlated": 4000, "stream.events_accepted": 12})
    r = _readings(_synthetic_trace())  # 2 iterations: the last 2 of 3 steps
    assert _read("gcc.stage_ms", r) == pytest.approx(2.5)
    assert _read("srp.stage_ms", r) == pytest.approx(2.0)
    for i, name in enumerate(STAGES):
        got = _read(name + "_ms", r)
        assert got == pytest.approx(0.1 * (i + 1) + 1.5), name
    assert _read("stream.correlate_yield_pct", r) == pytest.approx(0.3)


def test_program_readers_read_none_without_records(monkeypatch):
    r = _readings(_synthetic_trace())
    names = ["gcc.stage_ms", "srp.stage_ms",
             "stream.correlate_yield_pct"] + [s + "_ms" for s in STAGES]
    for name in names:  # tracing on nothing
        assert _read(name, r) is None, name
    # a program without the span system (an older one)
    monkeypatch.delattr(profiling, "records")
    assert spans.program_profiling() is None
    monkeypatch.setattr(profiling, "counters", lambda: {
        "stream.frames_correlated": 10})
    for name in names:
        assert _read(name, r) is None, name


def test_span_metrics_have_entries_and_readers():
    """The readers a traced run reads have entries; the stage readers wait
    for a traced run that switches tracing on before the graph's capture
    (``PERF.md``, section 7)."""
    names = ["entry.forward_host_ms", "gcc.stage_ms", "srp.stage_ms",
             "stream.ingest_host_ms", "stream.replay_host_ms",
             "stream.launch_idle_ms", "stream.correlate_yield_pct"]
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in names:
        assert entries[name]["source"] in ("host_clock", "device_trace")
        assert callable(spec_mod.reader(name)), name
    for name in (s + "_ms" for s in STAGES):
        assert name not in entries and callable(spec_mod.reader(name))


def _doa_readings(trace, frames=16384):
    st = doa_kind.shapes_of(DOA_CONFIG, frames)
    return Readings(DOA_CELL, DOA_CONFIG, {}, st, trace, {})


def test_doa_metrics_have_entries_and_readers():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in DOA_METRICS:
        m = entries[name]
        assert m["workloads"] == [DOA_CELL["name"]], name
        assert m["moves"] == "frames_per_s" and m["source"] == "device_trace"
        assert callable(spec_mod.reader(name)), name
    cell_metrics = {m["name"] for m in spec_mod.per_layer_of(
        SPEC, DOA_CELL["name"])}
    assert cell_metrics == set(DOA_METRICS)


def test_doa_readers_on_synthetic_records_and_trace(monkeypatch):
    from benchmark.roofline import gcc_bound

    recs = [profiling.Record("doa.forward", None, 99, 0, 1)]
    for call in range(3):
        for i, name in enumerate(DOA_STAGES):
            recs.append(profiling.Record(name, "doa.forward", call, 0, 0,
                                         device_ms=10.0 * (i + 1) + call))
    monkeypatch.setattr(profiling, "records", lambda: recs)
    tr = trace_mod.Trace(
        [("void gcc_kernel<false>(CUtensorMap_st)", "kernel", 0.0, 30000.0),
         ("void gcc_kernel<false>(CUtensorMap_st)", "kernel", 40000.0,
          34000.0),
         ("sgemm", "kernel", 30000.0, 1000.0)], [], 0.0, 80000.0, 2)
    r = _doa_readings(tr)
    # the last 2 calls' spans (the traced stretch's), their median
    for i, name in enumerate(DOA_STAGES):
        got = spec_mod.reader(name + "_stage_ms")(r)
        assert got == pytest.approx(10.0 * (i + 1) + 1.5), name
    bound = gcc_bound(16384, 8, 1024, 1025, 28, 91, with_peaks=False)
    assert spec_mod.reader("doa.gcc_kernel_roofline")(r) == pytest.approx(
        100.0 * bound["bound_ms"] / 32.0)
    assert spec_mod.reader("idle_pct.doa")(r) == pytest.approx(
        100.0 * (1 - 65000.0 / 80000.0))
    # row 2's bound at the estimator shape in the kernel table (PERF.md)
    assert bound["bound_ms"] == pytest.approx(4.4146, abs=1e-4)


def test_doa_readers_read_none_without_records_or_trace(monkeypatch):
    for name in DOA_METRICS:
        assert spec_mod.reader(name)(_doa_readings(None)) is None, name
    r = _doa_readings(trace_mod.Trace([], [], 0.0, 1.0, 2))
    for name in DOA_METRICS:  # tracing on nothing
        assert spec_mod.reader(name)(r) is None, name
    # a program without the span system (an older one)
    monkeypatch.delattr(profiling, "records")
    for name in DOA_METRICS[1:4]:
        assert spec_mod.reader(name)(r) is None, name


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events and graphs)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_graphed_step_stage_times_on_the_card(cuda_device):
    """A graph captured with tracing on: six positive stage times a
    replay, read from the events captured in it, summing to no more than
    the call's span on the card; the counts of frames and events."""
    sl = _streamer(cuda_device)
    pool = _chunks(cuda_device, streams=512, chunks=8)
    with profiling.tracing():
        g = sl.graph_step_many(sl.init_states(512), pool[0])
        assert len(g._spans) == 6
        profiling.reset()
        outer = []
        for k in range(pool.shape[0]):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            g(pool[k])
            b.record()
            outer.append((a, b))
        recs = profiling.records()
        counts = profiling.counters()
    torch.cuda.synchronize()
    replays = [r for r in recs if r.name == "stream.replay"]
    assert len(replays) == pool.shape[0]
    for rep, (a, b) in zip(replays, outer):
        stages = [r for r in recs if r.call == rep.call
                  and r.parent == "stream.replay"]
        assert [r.name for r in stages] == list(STAGES)
        assert all(r.device_ms > 0 for r in stages)
        assert sum(r.device_ms for r in stages) <= a.elapsed_time(b)
    assert counts["stream.frames_correlated"] == 512 * pool.shape[0]
    assert counts["stream.events_accepted"] == int(
        g.states.event_count.sum())
    assert counts["stream.events_accepted"] > 0


@pytest.mark.gpu
def test_graph_outputs_bit_equal_with_tracing_on_and_off(cuda_device):
    """Captured with tracing off (no event node, no stage record) and with
    it on, the two graphs give bit-equal outputs and states."""
    sl = _streamer(cuda_device)
    pool = _chunks(cuda_device, streams=512, chunks=8)
    off = sl.graph_step_many(sl.init_states(512), pool[0])
    assert off._spans == []
    with profiling.tracing():
        on = sl.graph_step_many(sl.init_states(512), pool[0])
        profiling.reset()
        for k in range(pool.shape[0]):
            a = {n: t.clone() for n, t in off(pool[k]).items()}
            b = on(pool[k])
            for n in a:
                assert torch.equal(a[n], b[n]), (k, n)
    names = {r.name for r in profiling.records()}
    assert names == {"stream.ingest", "stream.replay"} | set(STAGES)
    for x, y in zip(vars(off.states).values(), vars(on.states).values()):
        assert torch.equal(x, y)
    profiling.reset()
    with profiling.tracing():
        off(pool[0])  # its graph has no events: host spans only
    assert {r.name for r in profiling.records()} == {"stream.ingest",
                                                     "stream.replay"}


@pytest.mark.gpu
def test_eager_localizer_spans_time_on_the_card(cuda_device, monkeypatch):
    """``loc.gcc`` and ``loc.srp`` timed on the card with no wait inside a
    span: the events are read only when the records are."""
    loc = _localizer(cuda_device)
    frames = _frames(cuda_device, b=4096)
    loc(frames)
    torch.cuda.synchronize()
    waits = []
    real = torch.cuda.Event.synchronize
    monkeypatch.setattr(torch.cuda.Event, "synchronize",
                        lambda self: (waits.append(1), real(self))[1])
    with profiling.tracing():
        for _ in range(3):
            loc(frames)
    assert waits == []
    recs = profiling.records()
    assert waits
    for name in ("loc.gcc", "loc.srp"):
        ms = [r.device_ms for r in recs if r.name == name]
        assert len(ms) == 3 and all(m > 0 for m in ms), name
    assert all(r.device_ms is None for r in recs if r.name == "loc.forward")
    # read, their events are reused: another call makes none
    free = profiling._PROCESS._free[torch.cuda.current_device()]
    pairs = len(free)
    assert pairs >= 6
    with profiling.tracing():
        loc(frames)
    assert len(free) == pairs - 2
    profiling.records()
    assert len(free) == pairs


@pytest.mark.gpu
def test_doa_spans_time_on_the_card(cuda_device):
    """``doa.gcc``, ``doa.srp`` and ``doa.tail`` timed on the card by their
    events, inside the host span ``doa.forward``; bit-equal outputs with
    tracing on and off; one GCC kernel launch a call, on the pair route at
    8 mics and 28 pairs (``gcc.route.pairs``)."""
    est = _estimator(cuda_device)
    frames = _doa_frames(cuda_device, b=4096)
    off = {k: v.clone() for k, v in est(frames).items()}
    torch.cuda.synchronize()
    with profiling.tracing():
        for _ in range(3):
            on = est(frames)
        counts = profiling.counters()
    for k in off:
        assert torch.equal(on[k], off[k]), k
    recs = profiling.records()
    for name in DOA_STAGES:
        ms = [r.device_ms for r in recs if r.name == name]
        assert len(ms) == 3 and all(m > 0 for m in ms), name
    assert all(r.device_ms is None for r in recs if r.name == "doa.forward")
    assert counts == {"doa.frames": 3 * 4096, "doa.route.kernel": 3,
                      "gcc.route.pairs": 3}
    from audio_triangulation_tpu_torch.ops.cuda import gcc_kernel

    before = gcc_kernel.launches
    est(frames)
    assert gcc_kernel.launches == before + 1
