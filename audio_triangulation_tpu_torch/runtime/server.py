"""HTTP/JSON serving endpoint for the localization pipeline.

Counterpart of the JAX package's ``runtime/server``, with its protocol:
the same routes, JSON keys, status codes (200, 400, 404, 413), body cap
checked before the body is read, batch and session limits, and the same
per-session lock.  Query-response serving (stdlib only): clients POST PCM
frames and receive events/positions as JSON.

Protocol (all bodies JSON unless noted):

- ``GET  /healthz``            -> {"ok": true, "backend": ..., "mics": M};
  ``backend`` is "gpu" for a Localizer on a CUDA device, else "cpu"
- ``GET  /config``             -> the pipeline/grid/solver configuration
- ``POST /localize``           -> batch localization.  Body either
  {"frames": [[[...]]]} (nested lists, [B, M, N] or [M, N]) or raw
  float32 little-endian bytes with ``Content-Type:
  application/octet-stream`` and ``X-Shape: B,M,N``.  Returns
  {"xy": [[x, y]...], "tdoa_samples": ..., "best_shift": ...,
  "rms_m": ...}.
- ``POST /streams``            -> create a streaming session -> {"id": ...}
- ``POST /streams/<id>``       -> feed one chunk (same body formats,
  shape [M, C]); returns {"event": bool, "xy": ..., "event_count": N}.
- ``DELETE /streams/<id>``     -> drop the session.

``/localize`` calls the Localizer, so on a card each request runs its
kernels (the GCC kernel and the GN kernel for a small planar array) once.
Each streaming session steps one chunk at a time through
``StreamingLocalizer.__call__`` on the Localizer's device (the detector's
prefix-sum kernel once a step on a card); independent sessions step
concurrently on the server's threads.  The HTTP layer is a thin host-side
shim: device work is identical to library use.
"""

from __future__ import annotations

import json
import threading
import uuid
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch


class BodyTooLarge(Exception):
    """Request body exceeds the server's max_body_bytes cap."""


def _read_body(handler, length: int) -> bytearray:
    """Exactly ``length`` bytes of the request body, into a writable
    buffer (numpy and torch then share it without a copy)."""
    body = bytearray(length)
    view = memoryview(body)
    got = 0
    while got < length:
        n = handler.rfile.readinto(view[got:])
        if not n:
            raise ValueError(f"body ended after {got} of {length} bytes")
        got += n
    return body


def _decode_frames(handler, expected_tail_dims, max_body_bytes):
    """Read a request body as float32 array: JSON nested lists or raw
    float32 bytes + X-Shape header.

    The body is capped at ``max_body_bytes`` BEFORE it is read: the server
    runs unauthenticated, so an oversize Content-Length must not be able
    to exhaust the host's memory or enqueue arbitrary-size device work."""
    length = int(handler.headers.get("Content-Length", 0))
    if length > max_body_bytes:
        raise BodyTooLarge(
            f"body {length} B exceeds cap {max_body_bytes} B")
    body = _read_body(handler, length)
    ctype = handler.headers.get("Content-Type", "application/json")
    if ctype.startswith("application/octet-stream"):
        shape = tuple(
            int(v) for v in handler.headers.get("X-Shape", "").split(","))
        arr = np.frombuffer(body, dtype="<f4").reshape(shape)
    else:
        payload = json.loads(body)
        arr = np.asarray(payload["frames"], dtype=np.float32)
    if arr.ndim == expected_tail_dims:
        arr = arr[None]
    return arr


def _lists(out: dict, keys) -> dict:
    """The named outputs as nested lists (float32 values exactly: a JSON
    number round-trips the double that holds them)."""
    return {k: out[k].cpu().numpy().tolist() for k in keys if k in out}


class LocalizerServer:
    """Serve a Localizer (and streaming sessions) over HTTP.

    >>> srv = LocalizerServer(loc, port=0); srv.start()
    >>> ... requests against srv.port ...
    >>> srv.stop()
    """

    def __init__(self, loc, host: str = "127.0.0.1", port: int = 8080,
                 stream_factory=None, max_sessions: int = 256,
                 max_body_bytes: int = 64 << 20, max_batch: int = 4096):
        self.loc = loc
        self.device = loc.window.device
        self.max_body_bytes = int(max_body_bytes)
        self.max_batch = int(max_batch)
        self.backend = "gpu" if self.device.type == "cuda" else "cpu"
        # sid -> [lock, state]; the per-session lock serializes steps on
        # THAT session, while independent sessions step concurrently.
        # self._lock guards only the dict and the lazy streamer init.
        self._sessions: dict = {}
        self._lock = threading.Lock()
        self._stream_factory = stream_factory
        self._streamer = None
        self.max_sessions = max_sessions
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _json(self, code, obj):
                data = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    m = int(server.loc.mic_positions.shape[0])
                    self._json(200, {"ok": True,
                                     "backend": server.backend,
                                     "mics": m})
                elif self.path == "/config":
                    self._json(200, {
                        "pipeline": asdict(server.loc.pipeline),
                        "grid": asdict(server.loc.grid),
                        "solver": asdict(server.loc.solver),
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                try:
                    if self.path == "/localize":
                        self._json(200, server._localize(self))
                    elif self.path == "/streams":
                        # the body is not used, but a reply that leaves it
                        # unread in the socket resets the connection
                        server._drain(self)
                        self._json(200, {"id": server._create_session()})
                    elif self.path.startswith("/streams/"):
                        sid = self.path.rsplit("/", 1)[1]
                        self._json(200, server._step_session(sid, self))
                    else:
                        self._json(404, {"error": "not found"})
                except KeyError as e:
                    self._json(404, {"error": f"unknown session {e}"})
                except BodyTooLarge as e:
                    self._json(413, {"error": str(e)})
                except Exception as e:  # report, don't crash the server
                    self._json(400, {"error": f"{type(e).__name__}: {e}"})

            def do_DELETE(self):
                if self.path.startswith("/streams/"):
                    sid = self.path.rsplit("/", 1)[1]
                    with server._lock:
                        server._sessions.pop(sid, None)
                    self._json(200, {"ok": True})
                else:
                    self._json(404, {"error": "not found"})

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = None

    # ------------------------------------------------------------------
    def _localize(self, handler):
        frames = _decode_frames(handler, expected_tail_dims=2,
                                max_body_bytes=self.max_body_bytes)
        m = int(self.loc.mic_positions.shape[0])
        n = int(self.loc.pipeline.frame_size)
        if frames.shape[0] > self.max_batch or frames.shape[1:] != (m, n):
            raise ValueError(
                f"frames shape {frames.shape} exceeds server bounds "
                f"(expected [<= {self.max_batch}, {m}, {n}])")
        out = self.loc(torch.from_numpy(frames).to(self.device))
        return _lists(out, ("xy", "tdoa_samples", "best_shift", "rms_m",
                            "psr"))

    def _drain(self, handler) -> None:
        """Read and drop a request body, capped as every body is."""
        length = int(handler.headers.get("Content-Length", 0))
        if length > self.max_body_bytes:
            raise BodyTooLarge(
                f"body {length} B exceeds cap {self.max_body_bytes} B")
        _read_body(handler, length)

    def _get_streamer(self):
        with self._lock:
            if self._streamer is None:
                if self._stream_factory is not None:
                    self._streamer = self._stream_factory()
                else:
                    from ..models.streaming import StreamingLocalizer

                    self._streamer = StreamingLocalizer.create(
                        self.loc.mic_positions.cpu().numpy(),
                        self.loc.pipeline, self.loc.grid, self.loc.solver,
                        device=self.device)
            return self._streamer

    def _create_session(self) -> str:
        sl = self._get_streamer()
        sid = uuid.uuid4().hex[:12]
        with self._lock:
            if len(self._sessions) >= self.max_sessions:
                raise RuntimeError(
                    f"session limit {self.max_sessions} reached "
                    f"(DELETE /streams/<id> to free slots)")
            self._sessions[sid] = [threading.Lock(), sl.init_state()]
        return sid

    def _step_session(self, sid: str, handler):
        sl = self._get_streamer()
        chunk = _decode_frames(handler, expected_tail_dims=2,
                               max_body_bytes=self.max_body_bytes)[0]  # [M,C]
        # chunk length is free but must be bounded, and the channel count
        # must match the array
        m = int(sl.params.mic_positions.shape[0])
        if chunk.shape[0] != m or chunk.shape[1] > (1 << 20):
            raise ValueError(
                f"chunk shape {chunk.shape} invalid (need [{m}, <=2^20])")
        with self._lock:
            entry = self._sessions[sid]  # KeyError -> 404
        with entry[0]:
            # hold THIS session's lock across the step: two steps of one
            # session must not both start from the same state.  Other
            # sessions proceed.
            new_state, out = sl(entry[1], torch.from_numpy(chunk).to(
                sl.params.window.device))
            entry[1] = new_state
        resp = {
            "event": bool(out["event"]),
            "event_count": int(out["event_count"]),
            "xy_grid": out["xy_grid"].cpu().numpy().tolist(),
            # continuous array health (TDOA cycle-consistency, seconds)
            "consistency_rms": float(out["consistency_rms"]),
        }
        resp.update(_lists(out, ("xy", "xy_cov", "xyz")))
        if "xyz" in out:
            # free-3-D solve (StreamConfig.solve_xyz via stream_factory)
            resp["xyz_rms_m"] = float(out["xyz_rms_m"])
        return resp

    # ------------------------------------------------------------------
    def start(self):
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
