"""ctypes bindings for the native host runtime (``libatrt.so``).

Counterpart of the JAX package's ``runtime/native_rt``, with the same API
(``NativeIngestRuntime``, ``NativeSource``, ``PyIngestRuntime``,
``create_ingest_runtime``) and the same C++ source, copied to
``runtime/native/atrt.cpp``.  The library is built with ``g++`` at first use
(never at import) into the package's ``_build/`` directory, under a name
that carries a hash of the source, the flags and the host CPU (the flags
hold ``-march=native``), so a library built on another machine is never
loaded.  Without a toolchain, :class:`PyIngestRuntime` gives the same API
and semantics in NumPy.  Both reproduce the firmware's exact trigger
semantics (``utils.golden``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent / "native"
SOURCE = NATIVE_DIR / "atrt.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# as runtime/native/Makefile has them
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra",
             "-march=native", "-pthread")
_build_lock = threading.Lock()
_lib = None


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (what ``-march=native``
    compiles for)."""
    keys = (b"model name", b"flags")
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.split(b":")[0].strip() in keys]
    except OSError:
        lines = []
    return platform.machine().encode() + b"".join(sorted(set(lines)))


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_host_cpu())
    return Path(build_dir) / f"libatrt_{h.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile ``native/atrt.cpp`` into ``build_dir`` unless a library of
    the same source, flags and host CPU is there; returns its path.  Raises
    RuntimeError when there is no ``g++`` or the compile fails."""
    out = library_path(build_dir)
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native runtime cannot be "
                           "built (PyIngestRuntime needs no toolchain)")
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp_dir:
        tmp = str(Path(tmp_dir) / out.name)
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-shared", "-o", tmp, str(SOURCE), "-ldl"],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building libatrt.so failed "
                               f"({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a loader never sees half a file
    return out


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.atrt_create.restype = ctypes.c_void_p
        lib.atrt_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong]
        lib.atrt_destroy.argtypes = [ctypes.c_void_p]
        lib.atrt_push.restype = ctypes.c_int
        lib.atrt_push.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16), ctypes.c_int]
        lib.atrt_poll.restype = ctypes.c_int
        lib.atrt_poll.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int16),
            ctypes.POINTER(ctypes.c_longlong)]
        for name in ("atrt_sample_count", "atrt_events_detected",
                     "atrt_events_dropped"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_void_p]
        lib.atrt_powers.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.atrt_source_start.restype = ctypes.c_void_p
        lib.atrt_source_start.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.atrt_source_start2.restype = ctypes.c_void_p
        lib.atrt_source_start2.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.atrt_source_stop.argtypes = [ctypes.c_void_p]
        for name in ("atrt_source_port", "atrt_source_running"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p]
        for name in ("atrt_source_bytes", "atrt_source_tuples",
                     "atrt_source_reconnects"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_longlong
            fn.argtypes = [ctypes.c_void_p]
        lib.atrt_alsa_available.restype = ctypes.c_int
        lib.atrt_alsa_available.argtypes = [ctypes.c_char_p]
        lib.atrt_source_start_alsa.restype = ctypes.c_void_p
        lib.atrt_source_start_alsa.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p]
        lib.atrt_source_error.restype = ctypes.c_int
        lib.atrt_source_error.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native runtime builds and loads on this host."""
    try:
        _load_library()
        return True
    except (RuntimeError, OSError):
        return False


class NativeIngestRuntime:
    """Native streaming ingest + event detection (libatrt.so)."""

    def __init__(self, channels: int, frame_size: int = 1024,
                 threshold: Optional[int] = None, queue_capacity: int = 64,
                 trigger_ratio: float = 1.0):
        """``trigger_ratio`` > 1 enables CFAR-style relative triggering:
        out > threshold + ratio * inc — the incoming half-window IS the
        local noise-floor estimate, so the detector adapts to it.  1.0 is
        the reference's exact rule (sample_compute.h:89)."""
        if threshold is None:
            bits = int(np.log2(frame_size))
            threshold = 2 << (2 * (bits - 1))
        self._lib = _load_library()
        self.channels = channels
        self.frame_size = frame_size
        self.threshold = threshold
        self.trigger_ratio = float(trigger_ratio)
        self._h = self._lib.atrt_create(
            channels, frame_size, threshold, queue_capacity,
            int(round(trigger_ratio * 1000)))
        if not self._h:
            raise MemoryError("atrt_create failed")
        self._frame_buf = np.empty(channels * frame_size, np.int16)

    def push(self, samples: np.ndarray) -> int:
        """samples: [T, channels] (interleaved tuples) int16.
        Returns events enqueued by this push."""
        arr = np.ascontiguousarray(samples, dtype=np.int16)
        assert arr.ndim == 2 and arr.shape[1] == self.channels
        return self._lib.atrt_push(
            self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            arr.shape[0])

    def poll(self):
        """Pop one event -> (frames [channels, frame_size] int16, stamp) or
        None."""
        stamp = ctypes.c_longlong()
        ok = self._lib.atrt_poll(
            self._h,
            self._frame_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            ctypes.byref(stamp))
        if not ok:
            return None
        return (self._frame_buf.reshape(
            self.channels, self.frame_size).copy(), int(stamp.value))

    def powers(self):
        inc = (ctypes.c_longlong * self.channels)()
        out = (ctypes.c_longlong * self.channels)()
        self._lib.atrt_powers(self._h, inc, out)
        return np.array(inc[:]), np.array(out[:])

    @property
    def sample_count(self) -> int:
        return self._lib.atrt_sample_count(self._h)

    @property
    def events_detected(self) -> int:
        return self._lib.atrt_events_detected(self._h)

    @property
    def events_dropped(self) -> int:
        return self._lib.atrt_events_dropped(self._h)

    # --- live transport sources (native reader thread -> atrt_push) ------
    SOURCE_KINDS = {"fifo": 0, "pipe": 0, "file": 0,
                    "tcp": 1, "socket": 1, "listen": 2, "socket-listen": 2}

    def start_source(self, url: str, *,
                     reconnect: bool = False) -> "NativeSource":
        """Start a native reader thread feeding this runtime from a byte
        stream of interleaved little-endian int16 tuples.

        ``url``: fifo:///path | tcp://host:port (connect) |
        listen://:port (accept one peer; port 0 picks a free one; aliases:
        socket:// = tcp://, pipe/file = fifo).

        ``reconnect=True`` makes the source survive producer churn: FIFO
        writers may close and re-open, a dead TCP peer is re-dialed with
        backoff, a listen source re-accepts the next peer on the same
        port.  ``.reconnects`` counts the re-attachments."""
        scheme, _, rest = url.partition("://")
        if scheme not in self.SOURCE_KINDS:
            raise ValueError(f"unsupported source scheme {scheme!r}")
        kind = self.SOURCE_KINDS[scheme]
        h = self._lib.atrt_source_start2(
            self._h, kind, rest.encode(), int(reconnect))
        if not h:
            raise RuntimeError(f"atrt_source_start failed for {url}")
        return NativeSource(self._lib, h)

    def alsa_available(self, libpath: str = "") -> bool:
        """True when a dlopen-able ALSA implementation exists (the system
        libasound, or ``libpath`` for tests)."""
        return bool(self._lib.atrt_alsa_available(
            libpath.encode() if libpath else None))

    def start_alsa_source(self, device: str = "default", *,
                          sample_rate: int = 50_000,
                          latency_us: int = 50_000,
                          reconnect: bool = False,
                          libpath: str = "") -> "NativeSource":
        """Native live-mic capture: a C++ reader thread pulls S16_LE
        interleaved tuples from the ALSA device straight into the detector
        (``snd_pcm_readi`` loop; overruns recovered in place).  The ALSA
        library is dlopen'd — no link-time dependency; ``libpath``
        substitutes a shim library in tests."""
        h = self._lib.atrt_source_start_alsa(
            self._h, device.encode(), int(sample_rate), int(latency_us),
            int(reconnect), libpath.encode() if libpath else None)
        if not h:
            raise RuntimeError(f"atrt_source_start_alsa failed for {device}")
        return NativeSource(self._lib, h)

    def close(self):
        if self._h:
            self._lib.atrt_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeSource:
    """Handle to a native transport reader thread (see start_source)."""

    def __init__(self, lib, handle):
        self._lib = lib
        self._h = handle
        # final counter values, captured when the handle is freed so the
        # properties stay valid after stop()
        self._final = {"port": 0, "running": False, "bytes": 0, "tuples": 0,
                       "reconnects": 0, "error": 0}

    @property
    def port(self) -> int:
        """Bound port of a listen:// source (0 until bound)."""
        if not self._h:
            return self._final["port"]
        return self._lib.atrt_source_port(self._h)

    def wait_port(self, timeout_s: float = 5.0) -> int:
        import time

        t0 = time.time()
        while time.time() - t0 < timeout_s:
            p = self.port
            if p:
                return p
            time.sleep(0.005)
        raise TimeoutError("listen source never bound")

    @property
    def running(self) -> bool:
        if not self._h:
            return False
        return bool(self._lib.atrt_source_running(self._h))

    @property
    def bytes_read(self) -> int:
        if not self._h:
            return self._final["bytes"]
        return self._lib.atrt_source_bytes(self._h)

    @property
    def tuples_pushed(self) -> int:
        if not self._h:
            return self._final["tuples"]
        return self._lib.atrt_source_tuples(self._h)

    @property
    def reconnects(self) -> int:
        """Producer re-attachments survived (reconnect mode)."""
        if not self._h:
            return self._final["reconnects"]
        return self._lib.atrt_source_reconnects(self._h)

    @property
    def error(self) -> int:
        """Last source error (0 ok, 1 dlopen, 2 device-open, 3 params,
        4 unrecoverable I/O); see atrt.cpp SourceError."""
        if not self._h:
            return self._final["error"]
        return self._lib.atrt_source_error(self._h)

    def stop(self):
        if self._h:
            self._final = {
                "port": self._lib.atrt_source_port(self._h),
                "running": False,
                "bytes": self._lib.atrt_source_bytes(self._h),
                "tuples": self._lib.atrt_source_tuples(self._h),
                "reconnects": self._lib.atrt_source_reconnects(self._h),
                "error": self._lib.atrt_source_error(self._h),
            }
            self._lib.atrt_source_stop(self._h)
            self._h = None

    def __del__(self):
        try:
            self.stop()
        except Exception:
            pass


class PyIngestRuntime:
    """Pure-NumPy fallback with the same API and semantics."""

    def __init__(self, channels: int, frame_size: int = 1024,
                 threshold: Optional[int] = None, queue_capacity: int = 64,
                 trigger_ratio: float = 1.0):
        bits = int(np.log2(frame_size))
        self.channels = channels
        self.frame_size = frame_size
        self.threshold = (threshold if threshold is not None
                          else 2 << (2 * (bits - 1)))
        self.trigger_ratio = float(trigger_ratio)
        self._ratio_milli = int(round(trigger_ratio * 1000))
        self._half_bits = bits - 1
        self._events: list = []
        self._queue_capacity = queue_capacity
        self.sample_count = 0
        self.events_detected = 0
        self.events_dropped = 0
        self._suppress_until = frame_size - 1
        self._reset_rings()

    def _reset_rings(self):
        n, c = self.frame_size, self.channels
        self._buf = np.zeros((c, n), np.int16)
        self._head = 0
        self._full = False
        self._inc_t = np.zeros(c, np.int64)
        self._inc_p = np.zeros(c, np.int64)
        self._out_t = np.zeros(c, np.int64)
        self._out_p = np.zeros(c, np.int64)

    def push(self, samples: np.ndarray) -> int:
        arr = np.asarray(samples, np.int16)
        events = 0
        n = self.frame_size
        for tup in arr:
            mid = (self._head - n // 2) % n
            m = self._buf[:, mid].astype(np.int64)
            o = self._buf[:, self._head].astype(np.int64)
            s = tup.astype(np.int64)
            self._out_t += m - o
            self._out_p += m * m - o * o
            self._inc_t += s - m
            self._inc_p += s * s - m * m
            self._buf[:, self._head] = tup
            self._head += 1
            if self._head >= n:
                self._head = 0
                self._full = True
            t = self.sample_count
            self.sample_count += 1
            if not self._full or t < self._suppress_until:
                continue
            inc = int(((self._inc_p << self._half_bits)
                       - self._inc_t ** 2).sum())
            out = int(((self._out_p << self._half_bits)
                       - self._out_t ** 2).sum())
            floor = (inc if self._ratio_milli == 1000
                     else (self._ratio_milli * inc) // 1000)
            if out > self.threshold + floor:
                frame = np.concatenate(
                    [self._buf[:, self._head:], self._buf[:, : self._head]],
                    axis=1)
                self.events_detected += 1
                if len(self._events) < self._queue_capacity:
                    self._events.append((frame.copy(), t))
                    events += 1
                else:
                    self.events_dropped += 1
                self._reset_rings()
                self._suppress_until = self.sample_count + n - 1
        return events

    def poll(self):
        if not self._events:
            return None
        return self._events.pop(0)

    def powers(self):
        inc = (self._inc_p << self._half_bits) - self._inc_t ** 2
        out = (self._out_p << self._half_bits) - self._out_t ** 2
        return inc, out

    def close(self):
        pass


def create_ingest_runtime(channels: int, frame_size: int = 1024,
                          threshold: Optional[int] = None,
                          queue_capacity: int = 64,
                          prefer_native: bool = True,
                          trigger_ratio: float = 1.0):
    """Factory: native runtime when buildable, NumPy fallback otherwise."""
    if prefer_native and native_available():
        return NativeIngestRuntime(
            channels, frame_size, threshold, queue_capacity, trigger_ratio)
    return PyIngestRuntime(
        channels, frame_size, threshold, queue_capacity, trigger_ratio)
