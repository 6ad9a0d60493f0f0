"""PyTorch / CUDA port of audio_triangulation_tpu, slice A: the frame-batch
localizer, with its GCC and Gauss-Newton kernels written for Hopper.

The JAX package stays the reference; this package imports torch and never
jax.  Quick start::

    from audio_triangulation_tpu_torch import Localizer, PipelineConfig, geometry
    loc = Localizer.create(geometry.reference_array(),
                           PipelineConfig(phat=True), device="cuda")
    out = loc(frames)   # frames: torch f32 [B, M, 1024] on the same device
"""

from .core import geometry
from .core.config import GridConfig, PipelineConfig, SolverConfig
from .models.localizer import Localizer

__all__ = ["Localizer", "PipelineConfig", "GridConfig", "SolverConfig",
           "geometry"]
