"""Bring the JAX package's localizer constants into the port.

``params_from_reference`` takes the reference's ``LocalizerParams`` as a
dict of numpy arrays (for example ``{k: np.asarray(v) for k, v in
vars(params).items()}``) and returns the port's buffers on ``device``.
``onehot_big`` (the large-array steering matrix, bf16 or f32 there) comes
across as float32; ``onehot_pad`` is dropped: it is ``onehot`` with zero
rows padding the lag axis.

``stream_state_from_reference`` and ``stream_state_to_numpy`` carry a
streaming state across the same way, so one stream can be continued by
either package mid-way; ``track_state_*`` a tracker bank's state
(``TrackState`` or ``ImmTrackState``) and ``tracked_state_*`` a tracked
stream's (``TrackedStreamState``: both together), so a stream continues its
tracks in either package.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "mic_positions": torch.float32,
    "pairs": torch.int32,
    "window": torch.float32,
    "lut_flat": torch.int32,
    "onehot": torch.float32,
    "score_bias": torch.float32,
    "onehot_big": torch.float32,
}


def params_from_reference(arrays: dict, device) -> dict:
    """{name: tensor or None} for the port's ``LocalizerParams`` fields.
    The pair indices are checked here, once: the GCC kernel reads mics by
    them unchecked (``Localizer.create`` builds them itself)."""
    mics, pairs = arrays.get("mic_positions"), arrays.get("pairs")
    if mics is None or pairs is None:
        raise ValueError("mic_positions and pairs are required")
    pairs, m = np.asarray(pairs), np.shape(mics)[0]
    if (pairs.ndim != 2 or pairs.shape[1] != 2 or len(pairs) < 1
            or pairs.min() < 0 or pairs.max() >= m):
        raise ValueError(f"pairs must be [P, 2] indices of the {m} mics")
    out = {}
    for name, dtype in _DTYPES.items():
        a = arrays.get(name)
        if a is not None and name == "onehot_big":
            a = np.asarray(a).astype(np.float32)  # numpy's bf16 is not torch's
        out[name] = (None if a is None else torch.as_tensor(
            np.array(a, copy=True), device=device).to(dtype))
    return out


_STATE_DTYPES = {
    "context": torch.float32,
    "ema_corr": torch.float32,
    "best_shift": torch.int32,
    "time_s": torch.float32,
    "last_event_s": torch.float32,
    "suppress": torch.int32,
    "abs_sample": torch.int32,
    "event_count": torch.int32,
}


def stream_state_from_reference(arrays: dict, device):
    """The port's ``StreamState`` on ``device`` from the leaves of the JAX
    package's ``StreamState`` given as numpy arrays (for example
    ``{f.name: np.asarray(getattr(state, f.name)) for f in
    dataclasses.fields(state)}``), one stream or stacked streams alike."""
    from ..models.streaming import StreamState

    missing = sorted(set(_STATE_DTYPES) - set(arrays))
    if missing:
        raise ValueError(f"stream state lacks {missing}")
    return StreamState(**{
        name: torch.as_tensor(np.array(arrays[name], copy=True),
                              device=device).to(dtype)
        for name, dtype in _STATE_DTYPES.items()})


def stream_state_to_numpy(state) -> dict:
    """{leaf name: numpy array} of a port ``StreamState``, the form
    :func:`stream_state_from_reference` takes and from which the JAX
    package's ``StreamState(**arrays)`` can be rebuilt."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in _STATE_DTYPES}


_TRACK_DTYPES = {
    "x": torch.float32, "p": torch.float32,
    "active": torch.bool, "hits": torch.int32, "last_t": torch.float32,
    "state_t": torch.float32, "born_t": torch.float32,
    "track_id": torch.int32, "next_id": torch.int32,
    "dropped": torch.int32, "unassigned": torch.int32,
}
# the IMM bank: per-mode filters and mode beliefs in place of x and p
_IMM_FILTERS = {"xm": torch.float32, "pm": torch.float32,
                "mu": torch.float32}


def _track_dtypes(imm: bool) -> dict:
    if not imm:
        return _TRACK_DTYPES
    return {**_IMM_FILTERS, **{k: v for k, v in _TRACK_DTYPES.items()
                               if k not in ("x", "p")}}


def track_state_from_reference(arrays: dict, device):
    """The port's ``TrackState`` (or ``ImmTrackState``, when ``arrays``
    holds ``xm``) on ``device`` from the leaves of the JAX package's bank
    state given as numpy arrays, one bank or stacked banks alike."""
    from ..models.tracking import ImmTrackState, TrackState

    imm = "xm" in arrays
    dtypes = _track_dtypes(imm)
    missing = sorted(set(dtypes) - set(arrays))
    if missing:
        raise ValueError(f"track state lacks {missing}")
    return (ImmTrackState if imm else TrackState)(**{
        name: torch.as_tensor(np.array(arrays[name], copy=True),
                              device=device).to(dtype)
        for name, dtype in dtypes.items()})


def track_state_to_numpy(state) -> dict:
    """{leaf name: numpy array} of a port ``TrackState`` or
    ``ImmTrackState``, from which the JAX package's state class can be
    rebuilt with ``(**arrays)``."""
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in _track_dtypes(hasattr(state, "xm"))}


def tracked_state_from_reference(arrays: dict, device):
    """The port's ``TrackedStreamState`` from ``{"stream": {...}, "track":
    {...}}``, the leaves of the JAX package's ``TrackedStreamState``."""
    from ..models.tracked import TrackedStreamState

    return TrackedStreamState(
        stream=stream_state_from_reference(arrays["stream"], device),
        track=track_state_from_reference(arrays["track"], device))


def tracked_state_to_numpy(state) -> dict:
    """``{"stream": {...}, "track": {...}}`` of a port
    ``TrackedStreamState``, the form :func:`tracked_state_from_reference`
    takes."""
    return {"stream": stream_state_to_numpy(state.stream),
            "track": track_state_to_numpy(state.track)}
