"""PyTorch port, live serving: the feeder and event pump, the HTTP server,
export and graph capture, checkpoints and profiling, against the JAX
package's on the same numpy inputs.

Tolerances, from the measured gaps:
- The two servers get the same requests and give equal ``/healthz`` and
  ``/config`` bodies, status codes and integer fields (``best_shift``,
  ``event``, ``event_count``); floats at the Localizer tests' tolerances
  (``xy`` 2e-4 m, ``tdoa_samples`` 1e-3 samples, ``rms_m`` 1e-5 m; the
  port's CPU path sits 1.4e-6 m, 2.9e-6 samples and 1.3e-8 m from the JAX
  package's unfused path on these scenes).  Stream sessions: ``xy_grid``
  and an event's ``xy`` within 1e-4 m (measured 3.0e-7 and 1.5e-6),
  ``consistency_rms`` within 1e-7 s (2.9e-11).
- ``EventPump`` batches, stamps and masks equal the JAX package's exactly.
- The exported artifact runs the same plain-torch operations as the port's
  CPU path: equal there; against the JAX package's exported artifact at
  the Localizer tolerances (measured 4.2e-7 m, 6.7e-6 samples).
- Checkpoints: key paths equal to the JAX package's for the stream, tracked
  and calibration states; archives restore exactly in both directions; an
  Adam state restored from the JAX package continues within 1e-6 m of it
  over three more steps (the ten-step test's tolerance).
"""

import torch_threads  # noqa: F401  (first: before torch loads OpenMP)

import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from audio_triangulation_tpu import Localizer as JLocalizer
from audio_triangulation_tpu.core import config as jcfg
from audio_triangulation_tpu.models import calibration as jcal
from audio_triangulation_tpu.models.streaming import (
    StreamingLocalizer as JStreamingLocalizer)
from audio_triangulation_tpu.models.tracked import (
    TrackedStreamingLocalizer as JTracked)
from audio_triangulation_tpu.runtime import feeder as jfeeder
from audio_triangulation_tpu.runtime import native_rt as jnative
from audio_triangulation_tpu.runtime.server import (
    LocalizerServer as JServer)
from audio_triangulation_tpu.utils import checkpoint as jckpt
from audio_triangulation_tpu.utils import serving as jserving
from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
from audio_triangulation_tpu_torch.models import calibration as tcal
from audio_triangulation_tpu_torch.models.streaming import StreamingLocalizer
from audio_triangulation_tpu_torch.models.tracked import (
    TrackedStreamingLocalizer)
from audio_triangulation_tpu_torch.ops import _device
from audio_triangulation_tpu_torch.ops.cuda import _build
from audio_triangulation_tpu_torch.runtime import native_rt
from audio_triangulation_tpu_torch.runtime.feeder import (
    DoubleBufferedFeeder, EventPump)
from audio_triangulation_tpu_torch.runtime.server import LocalizerServer
from audio_triangulation_tpu_torch.utils import (checkpoint, convert,
                                                 profiling, serving, synth)

MICS = geometry.reference_array()
SQUARE = geometry.square_array(0.3)
XY_TOL, TDOA_TOL, RMS_TOL = 2e-4, 1e-3, 1e-5


# ----------------------------------------------------------------------
# feeder and event pump
# ----------------------------------------------------------------------

def test_double_buffered_feeder_order(rng):
    batches = [rng.normal(size=(4, 8)).astype(np.float32) for _ in range(5)]
    out = list(DoubleBufferedFeeder(iter(batches), device="cpu"))
    ref = list(jfeeder.DoubleBufferedFeeder(iter(batches)))
    assert len(out) == len(ref) == 5
    for a, r, b in zip(out, ref, batches):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


def test_feeder_propagates_producer_errors():
    def bad_gen():
        yield np.zeros((2, 2), np.float32)
        raise RuntimeError("producer died")

    it = iter(DoubleBufferedFeeder(bad_gen(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="producer died"):
        for _ in it:
            pass


def test_feeder_and_pump_default_to_the_card():
    """Without a CUDA device, device=None raises; nothing moves to the CPU
    unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DoubleBufferedFeeder(iter([]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EventPump(native_rt.PyIngestRuntime(3))


def _burst_pushes(rng, rt_list, n_events=2):
    for i in range(n_events):
        streams = rng.integers(127, 130, size=(3, 4000))
        n = 400
        burst = 90 * np.sin(np.linspace(0, 50, n)) * np.hanning(n)
        at = 1500 + 300 * i
        streams[:, at: at + n] += burst.astype(np.int64)
        pcm = np.clip(streams, 0, 255).astype(np.int16).T
        for rt in rt_list:
            rt.push(pcm)


@pytest.mark.parametrize("batch_size", [4, 1])
def test_event_pump_batches_match_reference(rng, batch_size):
    """The same events through both pumps: equal batches (the tail padded
    by repeating the last event), stamps and validity masks."""
    rt = native_rt.create_ingest_runtime(3, frame_size=1024)
    jrt = jnative.PyIngestRuntime(3, 1024)
    _burst_pushes(rng, [rt, jrt])
    got, ref = [], []
    pump = EventPump(rt, batch_size=batch_size, device="cpu",
                     on_batch=lambda a, s, v: got.append((a, s, v)))
    jpump = jfeeder.EventPump(jrt, batch_size=batch_size,
                              on_batch=lambda a, s, v: ref.append((a, s, v)))
    assert pump.pump(flush=True) == jpump.pump(flush=True) == len(ref) >= 1
    assert sum(int(v.sum()) for _, _, v in got) == rt.events_detected == 2
    for (a, s, v), (ja, js, jv) in zip(got, ref):
        assert a.dtype == torch.float32 and a.shape == (batch_size, 3, 1024)
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(v, jv)
    rt.close()



# ----------------------------------------------------------------------
# HTTP server: both packages' servers on the CPU, the same requests
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def servers():
    port_loc = Localizer.create(MICS, PipelineConfig(), device="cpu")
    jax_loc = JLocalizer.create(MICS, jcfg.PipelineConfig())
    srv = LocalizerServer(port_loc, port=0).start()
    jsrv = JServer(jax_loc, port=0).start()
    yield srv, jsrv
    srv.stop()
    jsrv.stop()


def _req(srv, path, data=None, method=None, headers=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    req = urllib.request.Request(
        url, data=data, method=method or ("POST" if data else "GET"))
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(servers, *args, **kwargs):
    return [_req(s, *args, **kwargs) for s in servers]


def _scene(seed=0, noise=0.01, b=1):
    src = np.array([0.8, 0.5, 1.2])
    src = src * (1.2 / np.linalg.norm(src))
    frames = synth.synth_scene(np.broadcast_to(src, (b, 3)), MICS,
                               noise_rms=noise, seed=seed)
    return np.array([0.8, 0.5]), frames.astype(np.float32)


def _same_localize(got, ref):
    assert sorted(got) == sorted(ref)
    assert got["best_shift"] == ref["best_shift"]
    np.testing.assert_allclose(got["xy"], ref["xy"], atol=XY_TOL)
    np.testing.assert_allclose(got["tdoa_samples"], ref["tdoa_samples"],
                               atol=TDOA_TOL)
    np.testing.assert_allclose(got["rms_m"], ref["rms_m"], atol=RMS_TOL)


def test_healthz_and_config_match_reference(servers):
    (c1, h1), (c2, h2) = _both(servers, "/healthz")
    assert c1 == c2 == 200 and h1 == h2
    assert h1 == {"ok": True, "backend": "cpu", "mics": 3}
    (c1, b1), (c2, b2) = _both(servers, "/config")
    assert c1 == c2 == 200 and b1 == b2
    assert b1["pipeline"]["sample_rate_hz"] == 50_000.0
    assert _req(servers[0], "/nope") == _req(servers[1], "/nope")


@pytest.mark.parametrize("body", ["json", "octet"])
def test_localize_matches_reference_and_library(servers, body):
    plane, frames = _scene(b=3)
    if body == "json":
        kw = dict(data=json.dumps({"frames": frames.tolist()}).encode(),
                  headers={"Content-Type": "application/json"})
    else:
        kw = dict(data=frames.tobytes(), headers={
            "Content-Type": "application/octet-stream",
            "X-Shape": ",".join(str(d) for d in frames.shape)})
    (c1, got), (c2, ref) = _both(servers, "/localize", **kw)
    assert c1 == c2 == 200
    _same_localize(got, ref)
    assert np.linalg.norm(np.asarray(got["xy"]) - plane, axis=-1).max() < 0.05
    # and exactly the library call's values, through JSON
    direct = servers[0].loc(torch.from_numpy(frames))
    assert torch.equal(torch.tensor(got["xy"], dtype=torch.float32),
                       direct["xy"])
    assert torch.equal(torch.tensor(got["tdoa_samples"],
                                    dtype=torch.float32),
                       direct["tdoa_samples"])


def test_bad_bodies_get_the_reference_codes(servers):
    """Unparseable JSON, a wrong frame length and a batch over max_batch
    are 400, an oversize Content-Length is 413 before the body is read,
    an unknown session 404; every server stays alive."""
    cases = [
        dict(data=b"not json", headers={"Content-Type": "application/json"}),
        dict(data=np.zeros((1, 3, 777), np.float32).tobytes(), headers={
            "Content-Type": "application/octet-stream", "X-Shape": "1,3,777"}),
        dict(data=np.zeros((1, 3, 1024), np.float32).tobytes(), headers={
            "Content-Type": "application/octet-stream",
            "X-Shape": "1,3,1024"}, path="/streams/nosuchsession"),
    ]
    for case in cases:
        path = case.pop("path", "/localize")
        codes = [c for c, _ in _both(servers, path, **case)]
        assert codes[0] == codes[1] and codes[0] in (400, 404), case
    for srv in servers:
        big = srv.max_body_bytes + 1
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/localize", data=b"", method="POST")
        req.add_header("Content-Type", "application/octet-stream")
        req.add_header("Content-Length", str(big))
        req.add_header("X-Shape", "1,3,1024")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 413
        assert _req(srv, "/healthz")[0] == 200


def test_batch_over_max_batch_is_400():
    loc = Localizer.create(MICS, device="cpu")
    srv = LocalizerServer(loc, port=0, max_batch=2).start()
    jsrv = JServer(JLocalizer.create(MICS), port=0, max_batch=2).start()
    try:
        frames = np.zeros((3, 3, 1024), np.float32)
        codes = [c for c, _ in _both(
            (srv, jsrv), "/localize", frames.tobytes(),
            headers={"Content-Type": "application/octet-stream",
                     "X-Shape": "3,3,1024"})]
        assert codes == [400, 400]
    finally:
        srv.stop()
        jsrv.stop()


def _session_stream(seed=1):
    _, frames = _scene(seed=seed, noise=0.0)
    r = np.random.default_rng(seed)
    streams = r.integers(127, 130, size=(3, 8192)).astype(np.float64)
    streams[:, 3000:3000 + 1024] += 110.0 * frames[0]
    return np.clip(np.round(streams), 0, 255).astype(np.float32)


def test_streaming_session_matches_reference(servers):
    """A session on each server fed the same chunks: equal events and
    counts, positions at the stream tolerance; DELETE frees the id."""
    streams = _session_stream()
    ids = [b["id"] for _, b in _both(servers, "/streams", b"{}", headers={
        "Content-Type": "application/json"})]
    got_events = 0
    for i in range(0, streams.shape[-1] - 511, 512):
        c = np.ascontiguousarray(streams[:, i: i + 512])
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": f"{c.shape[0]},{c.shape[1]}"}
        outs = [_req(s, f"/streams/{sid}", c.tobytes(), headers=hdr)
                for s, sid in zip(servers, ids)]
        (c1, o1), (c2, o2) = outs
        assert c1 == c2 == 200
        assert sorted(o1) == sorted(o2)
        assert o1["event"] == o2["event"]
        assert o1["event_count"] == o2["event_count"]
        np.testing.assert_allclose(o1["xy_grid"], o2["xy_grid"], atol=1e-4)
        np.testing.assert_allclose(o1["consistency_rms"],
                                   o2["consistency_rms"], atol=1e-7)
        if o1["event"]:
            got_events += 1
            np.testing.assert_allclose(o1["xy"], o2["xy"], atol=1e-4)
            assert np.linalg.norm(np.asarray(o1["xy"]) - [0.8, 0.5]) < 0.15
    assert got_events >= 1
    for srv, sid in zip(servers, ids):
        assert _req(srv, f"/streams/{sid}", method="DELETE")[0] == 200
        assert _req(srv, f"/streams/{sid}", b"{}", headers={
            "Content-Type": "application/json"})[0] in (400, 404)


def test_session_limit_and_concurrent_clients():
    """max_sessions sessions are created and the next is refused (400, as
    the reference's); 8 client threads at once get what one client gets."""
    loc = Localizer.create(MICS, device="cpu")
    srv = LocalizerServer(loc, port=0, max_sessions=3).start()
    try:
        codes = [_req(srv, "/streams", b"{}", headers={
            "Content-Type": "application/json"})[0] for _ in range(4)]
        assert codes == [200, 200, 200, 400]
        _, frames = _scene(b=2)
        body = frames.tobytes()
        hdr = {"Content-Type": "application/octet-stream",
               "X-Shape": "2,3,1024"}
        want = _req(srv, "/localize", body, headers=hdr)
        results = [None] * 8

        def client(k):
            results[k] = _req(srv, "/localize", body, headers=hdr)

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(not t.is_alive() for t in threads)
        assert all(r == want for r in results)
    finally:
        srv.stop()


def test_device_constant_cache_is_thread_safe():
    """Sixteen threads (more than the cores) filling and evicting the
    device-constant cache at once, the interpreter switching threads every
    microsecond (on the meta device, which takes the caching path): no
    thread raises (an unlocked eviction pops a key another thread already
    popped) and the cache keeps at most MAX_ENTRIES entries."""
    arrays = [np.full(4, i, np.float32)
              for i in range(4 * _device.MAX_ENTRIES)]
    errors = []

    def worker(k):
        try:
            for i in range(300):
                a = arrays[(k * 7 + i) % len(arrays)]
                t = _device.device_constant(a, "meta")
                if t.shape != (4,) or t.dtype != torch.float32:
                    errors.append(("wrong entry", k, i))
        except Exception as e:  # collected, raised below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(not t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors
    assert len(_device._cache) <= _device.MAX_ENTRIES


# ----------------------------------------------------------------------
# export, graph capture, kernel cache
# ----------------------------------------------------------------------

def _square_frames(b, seed=0):
    src = np.array([0.5, 0.4, 1.2]) * (1.2 / np.linalg.norm([0.5, 0.4, 1.2]))
    f = synth.synth_scene(src, SQUARE, noise_rms=0.01, seed=seed)
    return np.broadcast_to(f, (b, 4, 1024)).astype(np.float32).copy()


@pytest.fixture(scope="module")
def exported():
    """(port Localizer on the CPU, its artifact, the JAX package's)."""
    loc = Localizer.create(SQUARE, PipelineConfig(phat=True), device="cpu")
    jloc = JLocalizer.create(SQUARE, jcfg.PipelineConfig(phat=True))
    return loc, serving.export_localizer(loc), jserving.export_localizer(jloc)


def test_export_roundtrip_matches_direct_and_reference(tmp_path, exported):
    loc, blob, jblob = exported
    path = str(tmp_path / "loc.pt2")
    assert serving.export_localizer(loc, path) and os.path.getsize(path) > 1000
    fn = serving.load_exported(path, device="cpu")
    frames = _square_frames(4)
    got = fn(frames)
    want = loc(torch.from_numpy(frames))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ref = jserving.load_exported(jblob)(jnp.asarray(frames))
    np.testing.assert_allclose(got["xy"].numpy(), np.asarray(ref["xy"]),
                               atol=XY_TOL)
    np.testing.assert_allclose(got["tdoa_samples"].numpy(),
                               np.asarray(ref["tdoa_samples"]),
                               atol=TDOA_TOL)


def test_export_symbolic_batch_any_size(exported):
    """One artifact takes any batch; the eager localizer is unchanged after
    the trace (its constant tables hold no fake tensors)."""
    loc, blob, _ = exported
    fn = serving.load_exported(blob, device="cpu")
    for b in (1, 3, 8):
        frames = _square_frames(b, seed=b)
        out = fn(frames)
        assert out["xy"].shape == (b, 2)
        assert torch.equal(out["xy"], loc(torch.from_numpy(frames))["xy"])


def test_aot_compile_and_load_need_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    loc = Localizer.create(SQUARE, device="cpu")
    with pytest.raises(ValueError, match="CUDA graph"):
        serving.aot_compile(loc, batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_exported(b"", device="cuda")


def test_compilation_cache_points_the_kernel_library(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    serving.enable_compilation_cache(str(tmp_path / "kernels"))
    assert _build.BUILD_DIR == tmp_path / "kernels"
    assert _build.library_path(_build.BUILD_DIR).parent == tmp_path / "kernels"




# ----------------------------------------------------------------------
# checkpoints: the port's states, and archives across the packages
# ----------------------------------------------------------------------

def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(k) for k in p), tuple(np.shape(v)),
             np.asarray(v).dtype) for p, v in flat]


def _port_paths(tree):
    return [(p, tuple(v.shape), v.detach().cpu().numpy().dtype)
            for p, v in checkpoint.flatten_with_paths(tree)]


def _calib_pair():
    jc = jcal.Calibrator.create(3)
    tc = tcal.Calibrator.create(3, device="cpu")
    jtree = jc.init(MICS)
    params, opt = tc.init(MICS)
    return jtree, (params, convert.adam_state_to_reference(opt, params))


@pytest.mark.parametrize("kind", ["stream", "tracked", "calib"])
def test_key_paths_equal_reference(kind):
    if kind == "stream":
        jtree = JStreamingLocalizer.create(MICS).init_state()
        ttree = StreamingLocalizer.create(MICS, device="cpu").init_state()
    elif kind == "tracked":
        jtree = JTracked.create(MICS).init_state()
        ttree = TrackedStreamingLocalizer.create(MICS,
                                                 device="cpu").init_state()
    else:
        jtree, ttree = _calib_pair()
    assert _port_paths(ttree) == _jax_paths(jtree)


def _stream_states(steps=6):
    """The same chunks through both packages' single-stream steps: (JAX
    state, port state, port localizer, remaining chunks)."""
    streams = _session_stream(seed=3)
    jsl = JStreamingLocalizer.create(MICS)
    tsl = StreamingLocalizer.create(MICS, device="cpu")
    js, ts = jsl.init_state(), tsl.init_state()
    chunks = [np.ascontiguousarray(streams[:, i: i + 512])
              for i in range(0, 8192, 512)]
    for c in chunks[:steps]:
        js, _ = jsl(js, jnp.asarray(c))
        ts, _ = tsl(ts, torch.from_numpy(c))
    return jsl, js, tsl, ts, chunks[steps:]


def test_stream_state_roundtrip_and_continue(tmp_path):
    tsl = StreamingLocalizer.create(MICS, device="cpu")
    state = tsl.init_state()
    state = type(state)(**{**state.__dict__,
                           "ema_corr": state.ema_corr + 3.25,
                           "event_count": state.event_count + 7})
    p = checkpoint.save(str(tmp_path / "stream"), state)
    restored = checkpoint.restore(p, tsl.init_state())
    for (pa, a), (pb, b) in zip(checkpoint.flatten_with_paths(state),
                                checkpoint.flatten_with_paths(restored)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    chunk = torch.from_numpy(np.random.default_rng(0).integers(
        127, 130, size=(3, 256)).astype(np.float32))
    new_state, _ = tsl(restored, chunk)
    assert int(new_state.event_count) == 7


def test_reference_archive_restores_into_port(tmp_path):
    """A stream state the JAX package saved mid-stream restores into the
    port's template leaf for leaf, and the port continues it: events and
    counts equal to the JAX package's own continuation."""
    jsl, js, tsl, _, rest = _stream_states()
    p = jckpt.save(str(tmp_path / "jax_state"), js, use_orbax=False)
    ts = checkpoint.restore(p, tsl.init_state())
    for (path, a), (_, b) in zip(checkpoint.flatten_with_paths(ts),
                                 jax.tree_util.tree_flatten_with_path(js)[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
    events = 0
    for c in rest:
        js, jo = jsl(js, jnp.asarray(c))
        ts, to = tsl(ts, torch.from_numpy(c))
        assert bool(to["event"]) == bool(jo["event"])
        assert int(to["event_count"]) == int(jo["event_count"])
        events += bool(to["event"])
    assert events >= 1


def test_port_archive_restores_into_reference(tmp_path):
    _, _, tsl, ts, _ = _stream_states()
    p = checkpoint.save(str(tmp_path / "port_state"), ts)
    js = jckpt.restore(p, JStreamingLocalizer.create(MICS).init_state())
    for (path, a), (_, b) in zip(checkpoint.flatten_with_paths(ts),
                                 jax.tree_util.tree_flatten_with_path(js)[0]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=path)
        assert a.numpy().dtype == np.asarray(b).dtype


def _calib_batch():
    src = np.array([[0.5, 0.4], [-0.6, 0.3], [0.2, -0.7], [0.9, 0.8]])
    v = np.concatenate([src, np.full((4, 1), 1.2)], axis=1)
    frames = synth.synth_scene(v * (1.2 / np.linalg.norm(v, axis=1,
                                                         keepdims=True)),
                               MICS, noise_rms=0.01, seed=5)
    return frames.astype(np.float32), src.astype(np.float32)


def test_calibration_adam_state_crosses_both_ways(tmp_path):
    """optax's (mu, nu, count) saved by the JAX package restore into the
    port's Adam exactly, and three more steps from there stay within 1e-6 m
    of the JAX package's; the port's state saved restores into the JAX
    package's template exactly."""
    frames, src = _calib_batch()
    jc = jcal.Calibrator.create(3)
    tc = tcal.Calibrator.create(3, device="cpu")
    jb = jcal.CalibBatch(frames=jnp.asarray(frames),
                         source_xy=jnp.asarray(src))
    tb = tcal.CalibBatch(torch.from_numpy(frames), torch.from_numpy(src))
    jp, js = jc.init(MICS)
    for _ in range(3):
        jp, js, _ = jc.train_step(jp, js, jb)
    p = jckpt.save(str(tmp_path / "jax_calib"), (jp, js), use_orbax=False)
    params, opt = tc.init(MICS)
    template = (params, convert.adam_state_to_reference(opt, params))
    tparams, tstate = checkpoint.restore(p, template)
    assert tparams.mic_xy.requires_grad
    opt = tc.optimizer(tparams)
    convert.adam_state_from_reference(tstate, opt)
    back = convert.adam_state_to_reference(opt, tparams)[0]
    assert int(back.count) == int(js[0].count) == 3
    for f in ("mic_xy", "log_gain"):
        np.testing.assert_array_equal(getattr(back.mu, f).numpy(),
                                      np.asarray(getattr(js[0].mu, f)))
        np.testing.assert_array_equal(getattr(back.nu, f).numpy(),
                                      np.asarray(getattr(js[0].nu, f)))
    for _ in range(3):
        jp, js, _ = jc.train_step(jp, js, jb)
        tparams, opt, _ = tc.train_step(tparams, opt, tb)
    np.testing.assert_allclose(tparams.mic_xy.detach().numpy(),
                               np.asarray(jp.mic_xy), atol=1e-6)
    p2 = checkpoint.save(str(tmp_path / "port_calib"),
                         (tparams, convert.adam_state_to_reference(opt,
                                                                   tparams)))
    jrest = jckpt.restore(p2, jc.init(MICS))
    port_flat = checkpoint.flatten_with_paths(
        (tparams, convert.adam_state_to_reference(opt, tparams)))
    for (path, a), (_, b) in zip(
            port_flat, jax.tree_util.tree_flatten_with_path(jrest)[0]):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b),
                                      err_msg=path)


def test_calibration_roundtrip(tmp_path):
    params, state = _calib_pair()[1]
    p = checkpoint.save(str(tmp_path / "calib"), (params, state))
    got = checkpoint.restore(p, _calib_pair()[1])
    for (pa, a), (pb, b) in zip(checkpoint.flatten_with_paths((params, state)),
                                checkpoint.flatten_with_paths(got)):
        assert pa == pb and torch.equal(a.detach(), b.detach())


def test_orbax_form_is_refused(tmp_path):
    """The JAX package's orbax directory form is a JAX library's."""
    (tmp_path / "orbax_ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.restore(str(tmp_path / "orbax_ckpt"), {"a": torch.zeros(1)})
    with pytest.raises(ValueError, match="orbax"):
        checkpoint.save(str(tmp_path / "x"), {"a": torch.zeros(1)},
                        use_orbax=True)


def test_restore_structure_mismatch_raises(tmp_path):
    sl = StreamingLocalizer.create(MICS, device="cpu")
    p = checkpoint.save(str(tmp_path / "plain"), sl.init_state())
    tsl = TrackedStreamingLocalizer.create(MICS, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(p, tsl.init_state())


def test_restore_partial_keeps_template_for_missing(tmp_path):
    old = {"a": torch.tensor([1.0, 2.0]), "b": torch.tensor(7)}
    p = checkpoint.save(str(tmp_path / "old"), old)
    template = {"a": torch.zeros(2), "b": torch.tensor(0),
                "c": torch.tensor(42.0)}
    got = checkpoint.restore(p, template, partial=True)
    assert torch.equal(got["a"], torch.tensor([1.0, 2.0]))
    assert int(got["b"]) == 7 and got["b"].dtype == torch.int64
    assert float(got["c"]) == 42.0
    # and a JAX-written dict archive restores by the same paths
    jp = jckpt.save(str(tmp_path / "jold"), {k: jnp.asarray(v.numpy())
                                             for k, v in old.items()},
                    use_orbax=False)
    got = checkpoint.restore(jp, template, partial=True)
    assert torch.equal(got["a"], torch.tensor([1.0, 2.0]))


# ----------------------------------------------------------------------
# profiling
# ----------------------------------------------------------------------

def test_stage_timer_report_format():
    from audio_triangulation_tpu.utils import profiling as jprof

    t = profiling.StageTimer()  # the host clock: no card here
    jax_timer = jprof.StageTimer()
    for timer in (t, jax_timer):
        with timer.stage("work") as h:
            h["result"] = torch.ones(8, 8) * 2 if timer is t else (
                jnp.ones((8, 8)) * 2)
    assert t.calls["work"] == jax_timer.calls["work"] == 1
    ref = jax_timer.report().splitlines()
    got = t.report().splitlines()
    assert got[0] == ref[0] and got[1].split()[:2] == ref[1].split()[:2]
    t.reset()
    assert not t.calls


def test_throughput_meter_and_memory_stats():
    m = profiling.ThroughputMeter()
    m.add(frames=100, events=2)
    assert (m.frames, m.events) == (100, 2)
    assert m.frames_per_sec > 0
    assert profiling.device_memory_stats("cpu") is None
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), host=True) as d:
        with profiling.annotate("stage_x"):
            torch.ones(16, 16).sum()
    files = list((tmp_path).glob("trace_*.json"))
    assert d == str(tmp_path) and len(files) == 1
    assert "stage_x" in files[0].read_text()
