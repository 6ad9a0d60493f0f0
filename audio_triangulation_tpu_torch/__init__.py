"""PyTorch / CUDA port of audio_triangulation_tpu: the frame-batch localizer
with its kernels written for Hopper (simultaneous sources through
``Localizer.localize_multi``, moving ones through ``localize_moving``), the
streaming localizers and tracked streaming (a Kalman tracker bank on the
streaming step), and the estimators beside them: direction of arrival
(``models.doa``), volumetric 3-D (``VolumeLocalizer``), multi-array fusion
(``models.fusion``) and the frequency-domain and subspace spectra
(``ops.srp_freq``); and for reverberant rooms the image-source simulator
(``utils.room``), WPE dereverberation (``ops.dereverb``), beamformed source
extraction (``ops.beamform``, ``Localizer.extract``, the streaming
``models.extraction.StreamingExtractor``) and reflector mapping
(``ops.echo``, ``models.mapping.ReflectorMapper``); and the training side:
array self-calibration (``models.calibration.Calibrator``), the learned
localizer (``models.neural.NeuralLocalizer``) and array design
(``core.design``), through ``torch.autograd`` and ``torch.optim.Adam``;
and live serving: the native ingest runtime and its transports
(``runtime.native_rt``, ``runtime.transport``), the feeder and event pump
(``runtime.feeder``), the HTTP server (``runtime.server``), export and
graph capture (``utils.serving``), checkpoints (``utils.checkpoint``) and
profiling (``utils.profiling``).

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

    tsl = TrackedStreamingLocalizer.create(geometry.reference_array(),
                                           stream=StreamConfig(chunk_size=512),
                                           device="cuda")
    g = tsl.graph_step_many(tsl.init_states(2048), chunks)
    out = g(chunks)          # out["track_xy"] [2048, 4, 2]; one graph replay

    vl = VolumeLocalizer.create(geometry.tetrahedral_array(0.3),
                                device="cuda")
    out = vl(frames)         # out["xyz"] [B, 3]

    calib = Calibrator.create(8, device="cuda")
    params, opt = calib.init(mic_xy_guess)
    params, opt, loss = calib.train_step(params, opt, batch)  # CalibBatch

    from audio_triangulation_tpu_torch.runtime.server import LocalizerServer
    srv = LocalizerServer(loc, port=8080).start()   # POST /localize, /streams
"""

from .core import geometry
from .core.config import (GridConfig, PipelineConfig, SolverConfig,
                          StreamConfig, VolumeConfig)
from .models.calibration import Calibrator
from .models.localizer import Localizer, LocalizerParams, localize_frames
from .models.neural import NeuralLocalizer
from .models.streaming import StreamingLocalizer, TwoRateStreamingLocalizer
from .models.tracked import TrackedStreamingLocalizer
from .models.tracking import Tracker, TrackerConfig
from .models.volume import VolumeLocalizer

__all__ = ["Localizer", "LocalizerParams", "localize_frames", "Calibrator",
           "NeuralLocalizer", "StreamingLocalizer",
           "TwoRateStreamingLocalizer", "TrackedStreamingLocalizer",
           "Tracker", "TrackerConfig", "VolumeLocalizer", "PipelineConfig",
           "GridConfig", "SolverConfig", "StreamConfig", "VolumeConfig",
           "geometry"]
