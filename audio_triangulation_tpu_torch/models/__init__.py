"""Model families of the port: frame-batch, streaming, tracking."""

from .localizer import (  # noqa: F401
    Localizer, LocalizerParams, localize_frames)
from .streaming import (  # noqa: F401
    StreamingLocalizer, StreamState, TwoRateStreamingLocalizer)
from .tracked import (  # noqa: F401
    TrackedStreamingLocalizer, TrackedStreamState)
from .tracking import (Tracker, TrackerConfig, TrackState,  # noqa: F401
                       rts_smooth)
