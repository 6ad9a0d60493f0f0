"""Asynchronous host->device feeding: the chained-DMA analogue.

Counterpart of the JAX package's ``runtime/feeder``.  The reference arms
two chained DMA channels once and the ADC then streams into memory with
zero CPU (``src/components/dma_sampler.c:28-55``).  On a card the same
overlap needs three things that JAX's ``device_put`` did out of sight:
page-locked host memory (a copy from pageable memory cannot overlap
compute), a copy stream beside the compute stream, and an event that orders
the two.  :class:`DoubleBufferedFeeder` keeps a ring of ``depth`` pinned
host buffers, reused (pinning a batch afresh costs milliseconds), and
copies each batch on a side stream while the consumer computes on the
previous one.  :class:`EventPump` connects the native ingest runtime's
event queue to batched device inference.

Both default to the card; with no CUDA device they raise unless given
``device="cpu"``.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch


def _device(device) -> torch.device:
    """``device``, or the card when None; a CUDA device must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to feed the "
                           "host's memory")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _host_tensor(batch) -> torch.Tensor:
    """A host batch (numpy array or CPU tensor) as a CPU tensor, no copy."""
    if isinstance(batch, torch.Tensor):
        if batch.device.type != "cpu":
            raise ValueError(f"host batches must be on the CPU; got "
                             f"{batch.device}")
        return batch
    return torch.from_numpy(np.ascontiguousarray(batch))


class DoubleBufferedFeeder:
    """Iterate device-resident batches with transfer/compute overlap.

    >>> for dev_batch in DoubleBufferedFeeder(host_batches):
    ...     out = step(dev_batch)   # the copy of the next batch overlaps this

    On a card a producer thread stages each host batch in one of ``depth``
    pinned buffers (a slot is refilled only after its last copy's event has
    completed), copies it with ``non_blocking=True`` on a side stream into a
    fresh device tensor and records an event there.  The consumer's stream
    waits on that event before the batch is handed out, and the batch is
    marked used on the consumer's stream (``record_stream``), so the caching
    allocator does not hand its memory to the side stream while the
    consumer's kernels still read it.  A producer error is raised in the
    consumer."""

    def __init__(self, batches: Iterable, device=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be at least 1; got {depth}")
        self._it = iter(batches)
        self._device = _device(device)
        self._depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._error = None
        if self._device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self._device)
            self._pinned: list = [None] * depth  # flat uint8 buffers
            self._copied: list = [None] * depth  # each slot's last event
        self._thread = threading.Thread(target=self._pump, daemon=True)
        self._thread.start()

    def _stage(self, slot: int, host: torch.Tensor) -> torch.Tensor:
        """``host`` copied into pinned slot ``slot`` (grown as needed), as a
        view of the batch's dtype and shape."""
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()
        nbytes = host.numel() * host.element_size()
        buf = self._pinned[slot]
        if buf is None or buf.numel() < nbytes:
            buf = self._pinned[slot] = torch.empty(
                nbytes, dtype=torch.uint8, pin_memory=True)
        view = buf[:nbytes].view(host.dtype).view(host.shape)
        view.copy_(host)
        return view

    def _pump(self):
        try:
            if self._device.type != "cuda":
                for b in self._it:
                    self._q.put((_host_tensor(b).to(self._device), None))
                return
            with torch.cuda.device(self._device):
                for k, b in enumerate(self._it):
                    slot = k % self._depth
                    staged = self._stage(slot, _host_tensor(b))
                    with torch.cuda.stream(self._copy_stream):
                        dev = torch.empty(staged.shape, dtype=staged.dtype,
                                          device=self._device)
                        dev.copy_(staged, non_blocking=True)
                        ev = torch.cuda.Event()
                        ev.record(self._copy_stream)
                    self._copied[slot] = ev
                    self._q.put((dev, ev))
        except BaseException as e:  # surfaced to the consumer, not swallowed
            self._error = e
        finally:
            self._q.put(self._done)

    def __iter__(self) -> Iterator[torch.Tensor]:
        while True:
            item = self._q.get()
            if item is self._done:
                if self._error is not None:
                    raise self._error
                return
            dev, ev = item
            if ev is not None:
                consumer = torch.cuda.current_stream(self._device)
                consumer.wait_event(ev)
                dev.record_stream(consumer)
            yield dev


class EventPump:
    """Drain an ingest runtime's event queue into fixed-size device batches.

    The cooperative pipeline<->render handoff of the reference (two counting
    semaphores, ``sample_compute.h:142-145``) becomes: the ingest thread
    pushes events; this pump assembles float32 [batch, M, N] tensors on the
    device (padding the tail batch by repeating the last event, with a
    validity mask) and hands them, with the stamps, to a callback running
    device inference.  On a card each batch is staged in one reused pinned
    buffer and copied on the current stream."""

    def __init__(self, runtime, batch_size: int = 64,
                 on_batch: Optional[Callable] = None, device=None):
        self.runtime = runtime
        self.batch_size = batch_size
        self.on_batch = on_batch
        self._device = _device(device)
        self._pending: list[np.ndarray] = []
        self._stamps: list[int] = []
        self._staging = None  # pinned float32 [batch, M, N]
        self._copied = None  # the event of the staging buffer's last copy

    def _to_device(self, batch: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(batch)
        if self._device.type != "cuda":
            return host.to(self._device)
        if self._copied is not None:
            self._copied.synchronize()
        if self._staging is None or self._staging.shape != host.shape:
            self._staging = torch.empty(host.shape, dtype=torch.float32,
                                        pin_memory=True)
        self._staging.copy_(host)
        with torch.cuda.device(self._device):
            out = self._staging.to(self._device, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()
        return out

    def pump(self, flush: bool = False) -> int:
        """Poll all queued events; emit full batches (all batches when
        ``flush``).  Returns number of batches emitted."""
        while True:
            ev = self.runtime.poll()
            if ev is None:
                break
            frames, stamp = ev
            self._pending.append(frames)
            self._stamps.append(stamp)

        emitted = 0
        while len(self._pending) >= self.batch_size or (
            flush and self._pending
        ):
            take = min(self.batch_size, len(self._pending))
            batch = self._pending[:take]
            stamps = self._stamps[:take]
            del self._pending[:take], self._stamps[:take]
            valid = np.zeros(self.batch_size, bool)
            valid[:take] = True
            while len(batch) < self.batch_size:
                batch.append(batch[-1])
                stamps.append(stamps[-1])
            arr = self._to_device(np.stack(batch).astype(np.float32))
            if self.on_batch is not None:
                self.on_batch(arr, np.asarray(stamps), valid)
            emitted += 1
        return emitted
