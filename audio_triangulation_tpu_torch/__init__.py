"""PyTorch / CUDA port of audio_triangulation_tpu: the frame-batch localizer
with its kernels written for Hopper, and the streaming localizers.

The JAX package stays the reference; this package imports torch and never
jax.  Quick start::

    from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
    loc = Localizer.create(geometry.reference_array(),
                           PipelineConfig(phat=True), device="cuda")
    out = loc(frames)   # frames: torch f32 [B, M, 1024] on the same device

    sl = StreamingLocalizer.create(geometry.reference_array(),
                                   stream=StreamConfig(chunk_size=512),
                                   device="cuda")
    states = sl.init_states(2048)
    states, out = sl.step_many(states, chunks)   # chunks [2048, M, 512]
"""

from .core import geometry
from .core.config import (GridConfig, PipelineConfig, SolverConfig,
                          StreamConfig)
from .models.localizer import Localizer
from .models.streaming import StreamingLocalizer, TwoRateStreamingLocalizer

__all__ = ["Localizer", "StreamingLocalizer", "TwoRateStreamingLocalizer",
           "PipelineConfig", "GridConfig", "SolverConfig", "StreamConfig",
           "geometry"]
