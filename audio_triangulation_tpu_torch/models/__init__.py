"""Model families of the port: frame-batch, streaming, tracking, DoA,
volumetric, multi-array fusion, streaming source extraction, reflector
mapping, and the training side: array self-calibration and the learned
(neural) localizer."""

from .localizer import (  # noqa: F401
    Localizer, LocalizerParams, localize_frames)
from .streaming import (  # noqa: F401
    StreamingLocalizer, StreamState, TwoRateStreamingLocalizer)
from .tracked import (  # noqa: F401
    TrackedStreamingLocalizer, TrackedStreamState)
from .tracking import (Tracker, TrackerConfig, TrackState,  # noqa: F401
                       rts_smooth)
from .doa import DoaEstimator  # noqa: F401
from .calibration import CalibBatch, CalibParams, Calibrator  # noqa: F401
from .neural import NeuralLocalizer  # noqa: F401
from .fusion import ArrayFusionLocalizer  # noqa: F401
from .volume import VolumeLocalizer, localize_frames_volume  # noqa: F401
from .extraction import StreamingExtractor, ExtractorState  # noqa: F401
from .mapping import ReflectorMapper, WallEstimate  # noqa: F401
