"""PyTorch port, the host runtime: WAV I/O, the cooperative scheduler, the
native ingest runtime (the port's own ``libatrt.so``) and its live
transports, each against the JAX package's on the same numpy inputs (the
same pushes into both packages' runtimes give equal events, stamps and
counters: integers and int16 frames, held exactly); and the root exports
of the two packages."""

import os
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest
import torch

import audio_triangulation_tpu as jpkg
import audio_triangulation_tpu_torch as tpkg
from audio_triangulation_tpu.runtime import native_rt as jnative
from audio_triangulation_tpu.runtime import scheduler as jsched
from audio_triangulation_tpu.utils import io as jio
from audio_triangulation_tpu_torch import Localizer, geometry
from audio_triangulation_tpu_torch.runtime import native_rt, transport
from audio_triangulation_tpu_torch.runtime import scheduler as tsched
from audio_triangulation_tpu_torch.utils import golden, synth
from audio_triangulation_tpu_torch.utils import io as tio

MICS = geometry.reference_array()
# the JAX package's root names that wait for a later slice of the port
WAITING_EXPORTS = {"ShardingConfig": "the parallel slice"}


@pytest.fixture
def native():
    """Skip (decided at run time, never at import) where the port's
    libatrt.so does not build: the host has no g++."""
    if not native_rt.native_available():
        pytest.skip("g++ build of libatrt.so failed")


# ----------------------------------------------------------------------
# root exports
# ----------------------------------------------------------------------

def test_root_exports_match_reference():
    """The two packages export the same root names, but for those listed as
    waiting; each exported name resolves."""
    missing = set(jpkg.__all__) - set(tpkg.__all__)
    assert missing == set(WAITING_EXPORTS)
    assert set(tpkg.__all__) >= set(jpkg.__all__) - set(WAITING_EXPORTS)
    for name in tpkg.__all__:
        assert getattr(tpkg, name) is not None
    assert tpkg.localize_frames.__module__.endswith("models.localizer")
    assert tpkg.LocalizerParams.__name__ == "LocalizerParams"


# ----------------------------------------------------------------------
# scheduler and WAV I/O (copies: equal behaviour, equal files)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mod", [jsched, tsched], ids=["jax", "port"])
def test_producer_consumer_rendezvous(mod):
    """The pipeline<->render handoff through two counting semaphores
    (sample_compute.h:142-145) alternates strictly in both packages."""
    data_ready = mod.Semaphore()
    buffer_free = mod.Semaphore(1)
    log = []

    def pipeline():
        for i in range(3):
            yield buffer_free.wait()
            log.append(f"produce{i}")
            data_ready.signal()
            yield

    def render():
        for i in range(3):
            yield data_ready.wait()
            log.append(f"render{i}")
            buffer_free.signal()
            yield

    s = mod.Scheduler()
    s.add("pipeline", pipeline())
    s.add("render", render())
    s.run(max_rounds=50)
    assert log == ["produce0", "render0", "produce1", "render1",
                   "produce2", "render2"]
    assert "pipeline" in s.stats_report()
    assert [t.stats.runs for t in s.tasks] == [7, 7]


def test_priority_mode_orders_tasks():
    for mod in (jsched, tsched):
        order = []

        def t(name):
            order.append(name)
            yield

        s = mod.Scheduler(priority_mode=True)
        s.add("low", t("low"), priority=5)
        s.add("high", t("high"), priority=0)
        s.round()
        assert order == ["high", "low"]


@pytest.mark.parametrize("dtype", ["int16", "uint8", "float"])
def test_wav_roundtrip_across_packages(tmp_path, rng, dtype):
    """A file either package writes reads back equal in the other: int16
    and 8-bit exactly, floats written as int16 within 1e-4."""
    if dtype == "int16":
        x = rng.integers(-30000, 30000, size=(3, 500)).astype(np.int16)
    elif dtype == "uint8":
        x = rng.integers(0, 255, size=(3, 400)).astype(np.uint8)
    else:
        x = rng.uniform(-1, 1, size=(2, 300))
    for write, read in ((tio.write_wav, jio.read_wav),
                        (jio.write_wav, tio.read_wav)):
        p = str(tmp_path / f"{dtype}_{write.__module__}.wav")
        write(p, x, 48_000)
        y, rate = read(p)
        assert rate == 48_000
        if dtype == "float":
            np.testing.assert_allclose(y / 32767.0, x, atol=1e-4)
        else:
            assert y.dtype == x.dtype
            np.testing.assert_array_equal(x, y)
    assert open(tmp_path / f"{dtype}_{tio.write_wav.__module__}.wav",
                "rb").read() == open(
        tmp_path / f"{dtype}_{jio.write_wav.__module__}.wav", "rb").read()


def test_wav_24bit_and_32bit_paths(tmp_path, rng):
    """Hand-written 24/32-bit WAVs narrow to int16 as the reference does."""
    import struct
    import wave

    x = rng.integers(-2**23, 2**23 - 1, size=(1, 64)).astype(np.int32)
    p = str(tmp_path / "t24.wav")
    with wave.open(p, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(3)
        w.setframerate(48000)
        w.writeframes(b"".join(struct.pack("<i", int(v))[:3] for v in x[0]))
    p32 = str(tmp_path / "t32.wav")
    with wave.open(p32, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(4)
        w.setframerate(48000)
        w.writeframes((x[0] << 8).astype(np.int32).tobytes())
    for path, want in ((p, (x[0] >> 8).astype(np.int16)),
                       (p32, ((x[0] << 8) >> 16).astype(np.int16))):
        got, _ = tio.read_wav(path)
        np.testing.assert_array_equal(got[0], want)
        np.testing.assert_array_equal(got, jio.read_wav(path)[0])


# ----------------------------------------------------------------------
# native ingest runtime
# ----------------------------------------------------------------------

def _stream_with_burst(rng, t_len=4000, burst_at=1800, amp=90):
    streams = rng.integers(127, 130, size=(3, t_len))
    n = 400
    burst = amp * np.sin(np.linspace(0, 50, n)) * np.hanning(n)
    for m in range(3):
        streams[m, burst_at: burst_at + n] = np.clip(
            streams[m, burst_at: burst_at + n] + burst, 0, 255)
    return streams.astype(np.int16)


def _poll_all(rt):
    events = []
    while (ev := rt.poll()) is not None:
        events.append(ev)
    return events


def _same_events(a, b):
    assert len(a) == len(b)
    for (fa, sa), (fb, sb) in zip(a, b):
        assert sa == sb
        np.testing.assert_array_equal(fa, fb)


def _counters(rt):
    return (rt.sample_count, rt.events_detected, rt.events_dropped)


@pytest.mark.usefixtures("native")
def test_native_builds_into_the_port():
    """The port builds its own library into its ``_build/``, never the JAX
    package's ``runtime/native/libatrt.so``."""
    path = native_rt.library_path()
    assert path.exists()
    assert path.parent == native_rt.BUILD_DIR
    assert "audio_triangulation_tpu_torch" in str(path)
    assert native_rt.SOURCE.read_bytes() != b""
    rt = native_rt.create_ingest_runtime(3)
    assert isinstance(rt, native_rt.NativeIngestRuntime)
    rt.close()


@pytest.mark.parametrize("impl", ["native", "python"])
def test_trigger_matches_golden_and_reference(request, impl, rng):
    """One burst: the trigger stamp and frame of the golden model
    (``utils.golden``), and the JAX package's runtime's exactly."""
    if impl == "native":
        request.getfixturevalue("native")
    streams = _stream_with_burst(rng)
    gp = golden.GoldenPipeline()
    ref_idx = gp.detect_index(streams.astype(np.uint8))
    assert ref_idx is not None
    ref_frame = np.stack([
        np.concatenate([r.buffer[r.head:], r.buffer[: r.head]])
        for r in gp.rings])
    rt = (native_rt.NativeIngestRuntime(3) if impl == "native"
          else native_rt.PyIngestRuntime(3))
    jrt = jnative.PyIngestRuntime(3)
    assert rt.push(streams.T) == jrt.push(streams.T) == 1
    frames, stamp = rt.poll()
    assert stamp == ref_idx
    np.testing.assert_array_equal(frames, ref_frame)
    _same_events([(frames, stamp)], [jrt.poll()])
    assert rt.poll() is None
    assert _counters(rt) == _counters(jrt)
    rt.close()


@pytest.mark.usefixtures("native")
def test_native_matches_python_and_reference_on_multiple_events(rng):
    streams = np.concatenate([_stream_with_burst(rng, burst_at=1500),
                              _stream_with_burst(rng, burst_at=2000)], axis=1)
    rts = [native_rt.NativeIngestRuntime(3), native_rt.PyIngestRuntime(3),
           jnative.NativeIngestRuntime(3)]
    for rt in rts:
        rt.push(streams.T)
    assert rts[0].events_detected >= 2
    assert len({_counters(rt) for rt in rts}) == 1
    events = [_poll_all(rt) for rt in rts]
    _same_events(events[0], events[1])
    _same_events(events[0], events[2])
    for rt in rts:
        rt.close()


@pytest.mark.usefixtures("native")
def test_chunked_push_equals_bulk(rng):
    streams = _stream_with_burst(rng)
    rt_a = native_rt.NativeIngestRuntime(3)
    rt_b = native_rt.NativeIngestRuntime(3)
    rt_a.push(streams.T)
    for i in range(0, streams.shape[1], 128):
        rt_b.push(streams.T[i: i + 128])
    ea, eb = _poll_all(rt_a), _poll_all(rt_b)
    assert len(ea) == 1
    _same_events(ea, eb)


@pytest.mark.usefixtures("native")
def test_powers_observability(rng):
    """int64-exact incoming / outgoing powers: the golden ring's and the
    JAX package's runtime's."""
    streams = rng.integers(127, 130, size=(2000, 3)).astype(np.int16)
    rt = native_rt.NativeIngestRuntime(3)
    jrt = jnative.NativeIngestRuntime(3)
    rt.push(streams)
    jrt.push(streams)
    inc, out = rt.powers()
    assert inc.shape == (3,)
    gr = golden.RollingBuffer()
    for t in range(streams.shape[0]):
        gr.push(int(streams[t, 0]))
    assert inc[0] == gr.get_incoming_power()
    assert out[0] == gr.get_outgoing_power()
    jinc, jout = jrt.powers()
    np.testing.assert_array_equal(inc, jinc)
    np.testing.assert_array_equal(out, jout)
    rt.close()
    jrt.close()


@pytest.mark.usefixtures("native")
def test_factory():
    rt = native_rt.create_ingest_runtime(4, frame_size=512)
    assert rt.frame_size == 512
    assert rt.threshold == jnative.PyIngestRuntime(4, 512).threshold
    rt.close()
    py = native_rt.create_ingest_runtime(4, prefer_native=False)
    assert isinstance(py, native_rt.PyIngestRuntime)


@pytest.mark.usefixtures("native")
def test_threaded_producer_consumer(rng):
    """The SPSC event queue under a producer thread pushing while the main
    thread polls: every event arrives, stamps in order, equal to the JAX
    package's runtime fed in one push."""
    streams = np.concatenate(
        [_stream_with_burst(rng, t_len=4000, burst_at=1500 + 300 * i)
         for i in range(4)], axis=-1)
    rt = native_rt.NativeIngestRuntime(3, queue_capacity=8)

    def producer():
        for i in range(0, streams.shape[1], 64):
            rt.push(streams.T[i: i + 64])

    th = threading.Thread(target=producer)
    th.start()
    events = []
    deadline = time.time() + 30
    while time.time() < deadline:
        ev = rt.poll()
        if ev is not None:
            events.append(ev)
        elif not th.is_alive():
            break
    th.join(timeout=30)
    assert not th.is_alive()
    events += _poll_all(rt)
    assert len(events) == rt.events_detected - rt.events_dropped >= 3
    stamps = [e[1] for e in events]
    assert stamps == sorted(stamps)
    if rt.events_dropped == 0:
        jrt = jnative.NativeIngestRuntime(3, queue_capacity=8)
        jrt.push(streams.T)
        _same_events(events, _poll_all(jrt))
    rt.close()


@pytest.mark.usefixtures("native")
def test_fuzz_native_vs_python_vs_reference(rng):
    """Randomized streams and chunkings: the port's C++ and NumPy runtimes
    and the JAX package's C++ runtime agree exactly on every event."""
    for trial in range(3):
        t_len = int(rng.integers(3000, 9000))
        streams = rng.integers(120, 140, size=(3, t_len)).astype(np.int16)
        for _ in range(int(rng.integers(0, 3))):
            at = int(rng.integers(0, t_len - 500))
            ln = int(rng.integers(200, 500))
            streams[:, at: at + ln] = np.clip(
                streams[:, at: at + ln]
                + rng.integers(-120, 120, size=(3, ln)), 0, 255)
        rts = [native_rt.NativeIngestRuntime(3), native_rt.PyIngestRuntime(3),
               jnative.NativeIngestRuntime(3)]
        i = 0
        while i < t_len:
            step = int(rng.integers(1, 700))
            for rt in rts:
                rt.push(streams.T[i: i + step])
            i += step
        assert len({_counters(rt) for rt in rts}) == 1, trial
        events = [_poll_all(rt) for rt in rts]
        _same_events(events[0], events[1])
        _same_events(events[0], events[2])
        for rt in rts:
            rt.close()


# ----------------------------------------------------------------------
# live transports (every wait bounded)
# ----------------------------------------------------------------------

def _scene_pcm(t_len=30_000, event_at=9_000, seed=0):
    """[T, 3] int16 interleaved stream with one known event burst."""
    src = np.array([0.5, 0.4, 1.2])
    src = src * 1.2 / np.linalg.norm(src)
    r = np.random.default_rng(seed)
    streams = r.integers(127, 130, size=(3, t_len)).astype(np.float64)
    frame = synth.synth_scene(src, MICS, noise_rms=0.0, seed=seed)[0]
    streams[:, event_at: event_at + 1024] += 110.0 * frame
    return (np.clip(np.round(streams), 0, 255).astype(np.int16).T.copy(),
            src[:2])


def _reference_events(pcm):
    """The JAX package's runtime fed the same PCM in one push."""
    rt = jnative.PyIngestRuntime(3, 1024)
    rt.push(pcm)
    return _poll_all(rt)


def _drain(rt, source, timeout_s=15.0, max_events=None):
    """Events until the source ends or ``timeout_s`` passes."""
    events = []
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        ev = rt.poll()
        if ev is not None:
            events.append(ev)
            if max_events is not None and len(events) >= max_events:
                break
            continue
        if not source.running:
            events += _poll_all(rt)
            break
        time.sleep(0.01)
    return events


def _wait_tuples(src, n, timeout_s=12.0):
    t0 = time.time()
    while src.tuples_pushed < n and time.time() - t0 < timeout_s:
        time.sleep(0.01)
    assert src.tuples_pushed == n, (src.tuples_pushed, n)


def _joined(thread, timeout_s=15.0):
    thread.join(timeout=timeout_s)
    assert not thread.is_alive(), "producer thread did not finish"


@pytest.mark.usefixtures("native")
def test_fifo_source_native(tmp_path):
    pcm, _ = _scene_pcm()
    path = str(tmp_path / "audio.fifo")
    os.mkfifo(path)
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"fifo://{path}")
    assert isinstance(src, native_rt.NativeSource)  # the C++ reader thread
    writer = transport.stream_pcm_to_fifo(path, pcm)
    events = _drain(rt, src)
    _joined(writer)
    _same_events(events, _reference_events(pcm))
    assert len(events) == 1 and 9_000 <= events[0][1] <= 11_000
    assert src.tuples_pushed == len(pcm)
    assert src.bytes_read == pcm.nbytes
    src.stop()
    rt.close()


@pytest.mark.usefixtures("native")
def test_socket_listen_source_native():
    """listen:// -> native detector -> the port's Localizer (CPU): the
    plane position of the transported event, and the JAX package's events
    on the same PCM."""
    pcm, plane = _scene_pcm(seed=2)
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, "listen://:0")
    port = src.wait_port()
    assert port > 0
    writer = transport.stream_pcm_to_socket("127.0.0.1", port, pcm)
    events = _drain(rt, src)
    _joined(writer)
    _same_events(events, _reference_events(pcm))
    loc = Localizer.create(MICS, device="cpu")
    out = loc(torch.from_numpy(events[0][0].astype(np.float32))[None])
    assert np.linalg.norm(out["xy"][0].numpy() - plane) < 0.1
    src.stop()
    rt.close()


@pytest.mark.usefixtures("native")
def test_socket_connect_source_native():
    """socket:// (connect) against a Python server, bytes dribbled in odd
    chunk sizes so tuple reassembly (carry) is exercised."""
    import socket as socket_mod

    pcm, _ = _scene_pcm(seed=3)
    data = pcm.tobytes()
    srv = socket_mod.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(15)
    port = srv.getsockname()[1]

    def serve():
        conn, _ = srv.accept()
        for i in range(0, len(data), 997):  # not a multiple of 6 bytes
            conn.sendall(data[i: i + 997])
        conn.close()
        srv.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"socket://127.0.0.1:{port}")
    events = _drain(rt, src)
    _joined(th)
    _same_events(events, _reference_events(pcm))
    assert src.tuples_pushed == len(pcm)
    src.stop()
    rt.close()


def test_fifo_source_python_fallback(tmp_path):
    """The Python reader and PyIngestRuntime give the same events."""
    pcm, _ = _scene_pcm(seed=4)
    path = str(tmp_path / "audio.fifo")
    os.mkfifo(path)
    rt = native_rt.PyIngestRuntime(3, 1024)
    writer = transport.stream_pcm_to_fifo(path, pcm)
    src = transport.open_source(rt, f"fifo://{path}", prefer_native=False)
    assert isinstance(src, transport.PySource)
    events = _drain(rt, src)
    _joined(writer)
    _same_events(events, _reference_events(pcm))
    assert src.tuples_pushed == len(pcm)
    src.stop()


def test_alsa_source_gated():
    """alsa:// either starts (arecord present) or raises a clear error."""
    rt = native_rt.PyIngestRuntime(3, 1024)
    if shutil.which("arecord") is None:
        with pytest.raises(RuntimeError, match="arecord"):
            transport.open_source(rt, "alsa://default")
    else:  # pragma: no cover - depends on host audio
        src = transport.open_source(rt, "alsa://null")
        src.stop()


@pytest.mark.usefixtures("native")
def test_fifo_writer_churn_reconnect_native(tmp_path):
    """Three writer sessions (close + gap between each) into one
    reconnecting FIFO source: every event survives, the source stays up."""
    path = str(tmp_path / "churn.fifo")
    os.mkfifo(path)
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"fifo://{path}", reconnect=True)
    total = 0
    for seed in range(3):
        pcm, _ = _scene_pcm(seed=seed)
        _joined(transport.stream_pcm_to_fifo(path, pcm))
        total += len(pcm)
        _wait_tuples(src, total)
        time.sleep(0.15)  # deliberate producer gap
    assert len(_poll_all(rt)) == 3
    assert src.reconnects >= 2, src.reconnects
    assert src.running
    src.stop()
    rt.close()


@pytest.mark.usefixtures("native")
def test_listen_reaccept_reconnect_native():
    """A listen source re-accepts a second peer on the SAME port; the
    stream continues mid-event across the disconnect."""
    pcm, _ = _scene_pcm(seed=4)
    half = 10_000  # splits the 9_000..10_024 burst across the two peers
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, "listen://:0", reconnect=True)
    port = src.wait_port()
    _joined(transport.stream_pcm_to_socket("127.0.0.1", port, pcm[:half]))
    _wait_tuples(src, half)
    _joined(transport.stream_pcm_to_socket("127.0.0.1", port, pcm[half:]))
    _wait_tuples(src, len(pcm))
    _same_events(_poll_all(rt), _reference_events(pcm))
    assert src.reconnects == 1, src.reconnects
    src.stop()
    rt.close()


@pytest.mark.usefixtures("native")
def test_tcp_redial_reconnect_native():
    """A tcp:// (connect) source re-dials after the server drops it."""
    import socket as socket_mod

    pcm, _ = _scene_pcm(seed=5)
    half = len(pcm) // 2
    srv = socket_mod.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    srv.settimeout(15)
    port = srv.getsockname()[1]

    def serve(chunk):
        def run():
            conn, _ = srv.accept()
            conn.sendall(np.ascontiguousarray(chunk, "<i2").tobytes())
            conn.close()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        return t

    first = serve(pcm[:half])
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"tcp://127.0.0.1:{port}",
                                reconnect=True)
    _wait_tuples(src, half)
    _joined(first)
    _joined(serve(pcm[half:]))
    _wait_tuples(src, len(pcm))
    _same_events(_poll_all(rt), _reference_events(pcm))
    assert src.reconnects >= 1, src.reconnects
    src.stop()
    rt.close()
    srv.close()


def test_fifo_writer_churn_python_fallback(tmp_path):
    path = str(tmp_path / "churn_py.fifo")
    os.mkfifo(path)
    rt = native_rt.PyIngestRuntime(3, 1024)
    src = transport.open_source(rt, f"fifo://{path}", prefer_native=False,
                                reconnect=True)
    total = 0
    for seed in range(2):
        pcm, _ = _scene_pcm(seed=seed)
        _joined(transport.stream_pcm_to_fifo(path, pcm))
        total += len(pcm)
        _wait_tuples(src, total)
        time.sleep(0.1)
    assert len(_poll_all(rt)) == 2
    assert src.reconnects >= 1, src.reconnects
    assert src.running
    src.stop()


def test_listen_reaccept_python_fallback():
    pcm, _ = _scene_pcm(seed=6)
    half = 10_000
    rt = native_rt.PyIngestRuntime(3, 1024)
    src = transport.open_source(rt, "listen://:0", prefer_native=False,
                                reconnect=True)
    port = src.wait_port()
    _joined(transport.stream_pcm_to_socket("127.0.0.1", port, pcm[:half]))
    _wait_tuples(src, half)
    _joined(transport.stream_pcm_to_socket("127.0.0.1", port, pcm[half:]))
    _wait_tuples(src, len(pcm))
    _same_events(_poll_all(rt), _reference_events(pcm))
    assert src.reconnects == 1, src.reconnects
    src.stop()


# ----------------------------------------------------------------------
# native ALSA capture through a shim libasound (no audio hardware here):
# the same five snd_pcm_* entry points the JAX package's tests compile
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def fake_alsa(tmp_path_factory):
    """Compile the JAX package's tests' shim libasound; returns its path."""
    from test_transport import _FAKE_ALSA_C

    d = tmp_path_factory.mktemp("fakealsa")
    src = d / "fake_asound.c"
    lib = d / "libfakeasound.so"
    src.write_text(_FAKE_ALSA_C)
    subprocess.run(
        ["g++", "-x", "c", "-shared", "-fPIC", "-O1", "-o", str(lib),
         str(src)], check=True, capture_output=True, timeout=120)
    return str(lib)


@pytest.mark.usefixtures("native")
def test_alsa_available_probe(fake_alsa):
    rt = native_rt.NativeIngestRuntime(3, 1024)
    assert rt.alsa_available(fake_alsa)
    assert not rt.alsa_available("/nonexistent/libasound.so.2")


@pytest.mark.usefixtures("native")
def test_alsa_native_capture_end_to_end(fake_alsa, tmp_path, monkeypatch):
    """dlopen -> snd_pcm_readi loop -> detector -> event, with parameter
    negotiation logged by the shim and one recovered overrun."""
    log = tmp_path / "alsa.log"
    monkeypatch.setenv("FAKE_ALSA_LOG", str(log))
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = rt.start_alsa_source("hw:0", sample_rate=50_000,
                               libpath=fake_alsa)
    events = _drain(rt, src, timeout_s=10.0, max_events=1)
    assert events, "no event from the native ALSA path"
    frame, _ = events[0]
    assert frame.shape == (3, 1024)
    assert np.abs(frame.astype(np.int64) - 128).max() >= 2999
    assert src.error == 0
    t0 = time.time()
    while src.tuples_pushed <= 7000 and time.time() - t0 < 3.0:
        time.sleep(0.01)
    assert src.tuples_pushed > 7000
    src.stop()
    text = log.read_text()
    assert "open hw:0 stream=1 mode=1" in text   # capture, NONBLOCK
    assert "params fmt=2 acc=3 ch=3 rate=50000" in text
    assert "recover -32" in text                 # overrun recovered


@pytest.mark.usefixtures("native")
def test_alsa_open_failure_reported(fake_alsa):
    rt = native_rt.NativeIngestRuntime(3, 1024)
    src = rt.start_alsa_source("nodev", libpath=fake_alsa)
    t0 = time.time()
    while src.running and time.time() - t0 < 5.0:
        time.sleep(0.01)
    assert not src.running
    assert src.error == 2  # kErrDeviceOpen
    src.stop()


@pytest.mark.usefixtures("native")
def test_alsa_transport_dispatch_native(fake_alsa, monkeypatch):
    """open_source('alsa://...') takes the native path when an ALSA library
    is loadable (the shim substituted for the system probe)."""
    rt = native_rt.NativeIngestRuntime(3, 1024)
    monkeypatch.setattr(
        native_rt.NativeIngestRuntime, "alsa_available",
        lambda self, libpath="": True)
    real = native_rt.NativeIngestRuntime.start_alsa_source

    def patched(self, device="default", **kw):
        kw["libpath"] = fake_alsa
        return real(self, device, **kw)

    monkeypatch.setattr(
        native_rt.NativeIngestRuntime, "start_alsa_source", patched)
    src = transport.open_source(rt, "alsa://plughw:1")
    assert isinstance(src, native_rt.NativeSource)
    t0 = time.time()
    while src.tuples_pushed == 0 and time.time() - t0 < 5.0:
        time.sleep(0.01)
    assert src.tuples_pushed > 0
    src.stop()
