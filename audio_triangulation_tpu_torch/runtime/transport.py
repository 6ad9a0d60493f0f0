"""Live audio transports: byte streams -> the ingest runtime.

Counterpart of the JAX package's ``runtime/transport`` (numpy and the
ctypes runtime only, so the same code).  The reference acquires audio
autonomously in hardware (chained-DMA ADC,
``src/components/dma_sampler.c:8-56``).  The host analogue is a reader
thread feeding ``atrt_push`` from a real transport; with the native runtime
(``native_rt.NativeIngestRuntime``) the whole path — read, frame assembly,
detection — runs in C++ with no Python in the loop, and only event frames
surface via ``poll``.

Supported source URLs (interleaved little-endian int16 tuples):

- ``fifo:///path``           named pipe / file (container-friendly default)
- ``tcp://host:port``        TCP connect (``socket://`` is an alias)
- ``listen://:port``         TCP listen on loopback, accept one peer
                             (port 0 picks a free one)
- ``alsa://device``          live mic capture: native dlopen(libasound)
                             reader thread (snd_pcm_readi straight into the
                             C++ detector); ``arecord`` subprocess fallback
                             when no ALSA library is loadable

``open_source`` dispatches to the native reader when available and falls
back to a Python thread with identical semantics otherwise.
"""

from __future__ import annotations

import shutil
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import native_rt


# ----------------------------------------------------------------------
# Python fallback reader (same semantics as the native Source thread)
# ----------------------------------------------------------------------

@dataclass
class PySource:
    """Python reader thread feeding ``rt.push`` from a file object.

    ``fifo_persist``: FIFO reconnect semantics — an empty read means "no
    writer right now", not EOF; the fd stays open across writer churn (the
    native reader's behavior).  ``reopen``: called after EOF to obtain the
    next session's file object (TCP re-dial / listen re-accept); must
    return None to retry later, and raise StopIteration to end."""

    rt: object
    fileobj: object
    channels: int
    proc: Optional[subprocess.Popen] = None
    fifo_persist: bool = False
    reopen: Optional[object] = None  # Callable[[], Optional[fileobj]]
    closer: Optional[object] = None  # extra resource closed on stop()
    _stop: threading.Event = field(default_factory=threading.Event)
    bytes_read: int = 0
    tuples_pushed: int = 0
    reconnects: int = 0
    running: bool = True
    port: int = 0

    def __post_init__(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _read_session(self, fileobj):
        """Read one producer session; returns on EOF / close / stop."""
        import time

        tuple_bytes = 2 * self.channels
        carry = b""
        writer_gone = False
        while not self._stop.is_set():
            try:
                data = fileobj.read(tuple_bytes * 4096)
            except (OSError, ValueError):
                return
            if data is None:  # non-blocking fd, nothing available
                time.sleep(0.01)
                continue
            if not data:
                if self.fifo_persist:
                    writer_gone = True
                    time.sleep(0.02)
                    continue
                return
            if writer_gone:  # a new FIFO writer attached
                self.reconnects += 1
                writer_gone = False
            self.bytes_read += len(data)
            data = carry + data
            n_tuples = len(data) // tuple_bytes
            if n_tuples:
                used = n_tuples * tuple_bytes
                arr = np.frombuffer(
                    data[:used], dtype="<i2").reshape(-1, self.channels)
                self.rt.push(arr)
                self.tuples_pushed += n_tuples
                carry = data[used:]
            else:
                carry = data

    def _run(self):
        import time

        fileobj = self.fileobj  # may be None: reopen() provides session 1
        had_session = False
        try:
            while not self._stop.is_set():
                if fileobj is not None:
                    had_session = True
                    self._read_session(fileobj)
                    try:
                        fileobj.close()
                    except Exception:
                        pass
                    fileobj = None
                if self.reopen is None or self._stop.is_set():
                    break
                try:
                    fileobj = self.reopen()
                except StopIteration:
                    break
                except Exception:
                    fileobj = None
                if fileobj is None:
                    time.sleep(0.05)
                    continue
                self.fileobj = fileobj
                if had_session:
                    self.reconnects += 1
        finally:
            self.running = False

    def wait_port(self, timeout_s: float = 5.0) -> int:
        return self.port

    def stop(self):
        self._stop.set()
        try:
            self.fileobj.close()
        except Exception:
            pass
        if self.closer is not None:
            try:
                self.closer.close()
            except Exception:
                pass
        if self.proc is not None:
            self.proc.terminate()
            self.proc.wait(timeout=5)
        self._thread.join(timeout=5)


def _open_alsa(rt, url: str, sample_rate: int, *, prefer_native: bool = True,
               reconnect: bool = False):
    """alsa://device -> native dlopen(libasound) capture thread when both
    the native runtime and an ALSA library are present; `arecord`
    subprocess fallback otherwise."""
    device = url.partition("://")[2] or "default"
    if (prefer_native
            and isinstance(rt, native_rt.NativeIngestRuntime)
            and rt.alsa_available()):
        return rt.start_alsa_source(device, sample_rate=sample_rate,
                                    reconnect=reconnect)
    if shutil.which("arecord") is None:
        raise RuntimeError(
            "alsa:// sources need libasound (native capture) or the "
            "`arecord` binary (alsa-utils); neither is present in this "
            "environment")
    if reconnect:
        import warnings

        warnings.warn(
            "alsa:// reconnect=True is only honored by the native "
            "libasound capture; the arecord subprocess fallback in use "
            "here does not reconnect", RuntimeWarning, stacklevel=3)
    proc = subprocess.Popen(
        ["arecord", "-D", device, "-t", "raw", "-f", "S16_LE",
         "-r", str(sample_rate), "-c", str(rt.channels), "-q"],
        stdout=subprocess.PIPE)
    return PySource(rt=rt, fileobj=proc.stdout, channels=rt.channels,
                    proc=proc)


def open_source(rt, url: str, *, sample_rate: int = 50_000,
                prefer_native: bool = True, reconnect: bool = False):
    """Attach a live source to an ingest runtime; returns a source handle
    with .running/.bytes_read/.tuples_pushed/.reconnects/.stop() (and
    .wait_port() for listen sources).

    ``reconnect=True`` survives producer churn: FIFO writers may close and
    re-open, a dead TCP peer is re-dialed with backoff, a listen source
    re-accepts the next peer on the same port.  For alsa:// the NATIVE
    dlopen(libasound) capture honors it (the device is re-opened after
    unrecoverable I/O errors); the `arecord` subprocess fallback does not
    reconnect (a warning is emitted when reconnect=True falls back)."""
    scheme = url.partition("://")[0]
    if scheme == "alsa":
        return _open_alsa(rt, url, sample_rate, prefer_native=prefer_native,
                          reconnect=reconnect)
    if (prefer_native
            and isinstance(rt, native_rt.NativeIngestRuntime)
            and scheme in native_rt.NativeIngestRuntime.SOURCE_KINDS):
        return rt.start_source(url, reconnect=reconnect)
    # Python fallback (PyIngestRuntime, or exotic runtimes)
    rest = url.partition("://")[2]
    if scheme in ("fifo", "pipe", "file"):
        if reconnect:
            import os

            # non-blocking fd: empty reads mean "no writer", the fd
            # survives writer churn (native reader semantics)
            fd = os.open(rest, os.O_RDONLY | os.O_NONBLOCK)
            return PySource(rt=rt, fileobj=open(fd, "rb", buffering=0),
                            channels=rt.channels, fifo_persist=True)
        return PySource(rt=rt, fileobj=open(rest, "rb"),
                        channels=rt.channels)
    if scheme in ("tcp", "socket"):
        import socket as socket_mod

        host, _, port = rest.rpartition(":")
        addr = (host or "127.0.0.1", int(port))

        def dial():
            try:
                return socket_mod.create_connection(addr,
                                                    timeout=1.0).makefile("rb")
            except OSError:
                return None  # retry later

        first = socket_mod.create_connection(addr).makefile("rb")
        return PySource(rt=rt, fileobj=first, channels=rt.channels,
                        reopen=dial if reconnect else None)
    if scheme in ("listen", "socket-listen"):
        import socket as socket_mod

        port = int(rest.rpartition(":")[2] or 0)
        srv = socket_mod.socket()
        srv.setsockopt(socket_mod.SOL_SOCKET, socket_mod.SO_REUSEADDR, 1)
        srv.bind(("127.0.0.1", port))
        srv.listen(1)
        bound = srv.getsockname()[1]
        if reconnect:
            # even the FIRST accept runs on the reader thread (the native
            # reader's behavior): open_source returns immediately with the
            # bound port, peers come and go on the same port
            srv.settimeout(0.2)

            def reaccept():
                try:
                    c, _ = srv.accept()
                    return c.makefile("rb")
                except TimeoutError:
                    return None
                except OSError:
                    raise StopIteration

            src = PySource(rt=rt, fileobj=None, channels=rt.channels,
                           reopen=reaccept, closer=srv)
        else:
            conn, _ = srv.accept()
            srv.close()
            src = PySource(rt=rt, fileobj=conn.makefile("rb"),
                           channels=rt.channels)
        src.port = bound
        return src
    raise ValueError(f"unsupported source url {url!r}")


# ----------------------------------------------------------------------
# Producer-side helpers (tests / demos): stream PCM over a transport
# ----------------------------------------------------------------------

def stream_pcm_to_fifo(path: str, samples: np.ndarray,
                       chunk_tuples: int = 2048) -> threading.Thread:
    """Write [T, C] int16 samples into a FIFO from a daemon thread
    (open blocks until the consumer side opens)."""
    data = np.ascontiguousarray(samples, dtype="<i2").tobytes()

    def run():
        with open(path, "wb") as f:
            step = chunk_tuples * samples.shape[1] * 2
            for i in range(0, len(data), step):
                f.write(data[i: i + step])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def stream_pcm_to_socket(host: str, port: int, samples: np.ndarray,
                         chunk_tuples: int = 2048) -> threading.Thread:
    """Connect to host:port and send [T, C] int16 samples."""
    import socket as socket_mod

    data = np.ascontiguousarray(samples, dtype="<i2").tobytes()

    def run():
        with socket_mod.create_connection((host, port)) as s:
            step = chunk_tuples * samples.shape[1] * 2
            for i in range(0, len(data), step):
                s.sendall(data[i: i + step])

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t
