"""Production serving helpers: a portable exported pipeline, a localizer
captured as one CUDA graph, and a persistent kernel build.

Counterpart of the JAX package's ``utils/serving``:

- :func:`export_localizer` / :func:`load_exported`: one ``torch.export``
  artifact of the whole pipeline with its constants (window, steering
  matrices, geometry) baked in and a symbolic batch dimension, so any batch
  size runs from it, on the card or the CPU, without the package's source.
  The artifact is the PLAIN-TORCH route, the role of the reference's
  portable ``fused="off"`` artifact: ``torch.export`` traces torch
  operations, and the kernels are launched through ctypes, which it cannot
  capture.  On the card it therefore runs without the hand kernels.
- :func:`aot_compile`: build the kernels now, warm the localizer up at one
  batch size and capture its forward as one CUDA graph (the stream step's
  ``GraphedStep``): each call is one graph replay with the kernels inside,
  bit-equal to an eager call.  XLA's ``cost_analysis`` has no counterpart.
- :func:`enable_compilation_cache`: put the hash-named kernel library
  (``ops/cuda/_build``) in a directory of the caller's, so a restarted
  process loads it instead of running ``nvcc``.
"""

from __future__ import annotations

import dataclasses
import io
import sys
from pathlib import Path

import torch

from ..models import localizer as localizer_mod
from ..models.streaming import GraphedStep
from ..ops.cuda import _build


def _cpu_copy(loc, with_heatmap: bool):
    """``loc`` rebuilt on the CPU from its own buffers, where every wrapper
    takes its plain version."""
    params = localizer_mod.LocalizerParams(**{
        name: None if getattr(loc, name) is None else getattr(loc, name).cpu()
        for name in localizer_mod.PARAM_NAMES})
    return localizer_mod.Localizer(
        loc.pipeline, loc.grid, loc.solver, params, srp_form=loc.srp_form,
        with_solver=loc.with_solver, with_heatmap=with_heatmap)


def _clear_constant_caches() -> None:
    """Empty the package's ``functools.lru_cache`` constant tables.  Tracing
    runs the pipeline on fake tensors, and a table first built during the
    trace (the GCC kernel's matrices, say) would be kept as one and handed
    to every later eager call."""
    for name, mod in list(sys.modules.items()):
        if name.split(".")[0] != __package__.split(".")[0]:
            continue
        for fn in list(vars(mod).values()):
            if callable(getattr(fn, "cache_clear", None)) and hasattr(
                    fn, "cache_info"):
                fn.cache_clear()


def export_localizer(loc, path: str | None = None, *,
                     with_heatmap: bool | None = None) -> bytes:
    """Serialize ``loc``'s full pipeline (frames [b, M, N] -> output dict)
    as a ``torch.export`` artifact with a symbolic batch dimension, traced
    on the plain-torch route (see the module docstring).  Returns the
    serialized bytes; also writes them to ``path`` if given.
    ``with_heatmap`` overrides the heatmap output flag."""
    heat = loc.with_heatmap if with_heatmap is None else with_heatmap
    cpu = _cpu_copy(loc, heat)
    m = cpu.mic_positions.shape[0]
    example = torch.zeros((2, m, cpu.pipeline.frame_size))
    batch = torch.export.Dim("batch")
    try:
        exported = torch.export.export(cpu, (example,),
                                       dynamic_shapes={"frames": {0: batch}})
    finally:
        _clear_constant_caches()
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def load_exported(path_or_bytes, *, device="cuda"):
    """Load an :func:`export_localizer` artifact onto ``device`` (the card
    unless the caller asks for the CPU) -> ``fn(frames)`` returning the
    pipeline's output dict; frames [b, M, N] of any b.  Works in a process
    that never imports the package's model code."""
    from torch.export.passes import move_to_device_pass

    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu'")
        # the plain route needs full fp32, as the Localizer's does
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    exported = torch.export.load(io.BytesIO(blob))
    if device.type != "cpu":
        exported = move_to_device_pass(exported, device)
    module = exported.module()

    def fn(frames):
        return module(torch.as_tensor(frames, dtype=torch.float32,
                                      device=device))

    fn.exported = exported
    return fn


@dataclasses.dataclass
class _NoState:
    """The carried state of a stateless step (no tensors)."""


def aot_compile(loc, batch: int) -> GraphedStep:
    """Build the kernels, warm ``loc`` up on a side stream and capture its
    forward at ``batch`` frames as one CUDA graph.  Returns the
    ``GraphedStep``: ``g(frames)`` copies frames [batch, M, N] in, replays
    the graph and returns the outputs, which are the graph's own buffers
    (each call overwrites them: read or clone what is needed first).  The
    replay runs the same kernels on the same inputs as ``loc(frames)``, so
    its outputs are bit-equal to an eager call.  CUDA only."""
    dev = loc.window.device
    if dev.type != "cuda":
        raise ValueError(f"aot_compile captures a CUDA graph; the localizer "
                         f"lives on {dev}")
    _build.load_library()
    m = loc.mic_positions.shape[0]
    frames = torch.zeros((batch, m, loc.pipeline.frame_size), device=dev)
    return GraphedStep(lambda state, x: (state, loc(x)), _NoState(), frames)


def enable_compilation_cache(cache_dir: str) -> None:
    """Build and load the kernel library in ``cache_dir`` from now on: the
    library is named by a hash of the sources and flags, so a process
    started later with the same directory finds it and skips ``nvcc``."""
    _build.BUILD_DIR = Path(cache_dir)
