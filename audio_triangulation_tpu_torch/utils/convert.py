"""Bring the JAX package's localizer constants into the port.

``params_from_reference`` takes the reference's ``LocalizerParams`` as a
dict of numpy arrays (for example ``{k: np.asarray(v) for k, v in
vars(params).items()}``) and returns the port's buffers on ``device``.
``onehot_big`` (the large-array steering matrix, bf16 or f32 there) comes
across as float32; ``onehot_pad`` is dropped: it is ``onehot`` with zero
rows padding the lag axis.  A ``VolumeLocalizer``'s constants are its
``LocalizerParams`` and take the same function.

``doa_from_reference`` (a ``DoaEstimator``'s ``params`` with its
``onehot_az``, ``merge`` and ``disp``), ``doa3d_from_reference`` (a
``Doa3dEstimator``'s ``params`` with ``dirs`` and ``onehot_sph``) and
``fusion_params_from_reference`` (``FusionParams``) carry the other
estimators' constants across the same way.

``stream_state_from_reference`` and ``stream_state_to_numpy`` carry a
streaming state across the same way, so one stream can be continued by
either package mid-way; ``track_state_*`` a tracker bank's state
(``TrackState`` or ``ImmTrackState``) and ``tracked_state_*`` a tracked
stream's (``TrackedStreamState``: both together), so a stream continues its
tracks in either package; ``dereverb_state_*`` a ``StreamingDereverb``'s
state (``DereverbState`` with its ``WpeState``) and ``extractor_state_*`` a
``StreamingExtractor``'s (``ExtractorState``).

``calib_params_from_reference`` takes a calibration's trainable
parameters (``CalibParams``, ``JointParams``, ``TrackedParams``) and
``mlp_params_from_reference`` a neural localizer's MLP weights;
``adam_state_to_reference`` / ``adam_state_from_reference`` carry a
calibration's Adam state (optax's ``mu``, ``nu``, ``count`` against
``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq``, ``step``), so that
``utils.checkpoint`` archives of ``(params, opt_state)`` cross both ways.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

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


def doa_from_reference(arrays: dict, device):
    """({buffer name: tensor or None}, disp numpy or None) of the port's
    ``DoaEstimator`` from a JAX ``DoaEstimator``'s ``params`` fields plus
    ``onehot_az``, ``merge`` and ``disp`` (the last two None unless
    ``smp``), as numpy arrays."""
    out = params_from_reference(arrays, device)
    missing = [k for k in ("onehot_az", "lut_flat") if arrays.get(k) is None]
    if missing:
        raise ValueError(f"DoA constants lack {missing}")
    out["onehot_az"] = _f32(arrays["onehot_az"], device)
    merge, disp = arrays.get("merge"), arrays.get("disp")
    if (merge is None) != (disp is None):
        raise ValueError("merge and disp come together (smp) or not at all")
    out["merge"] = None if merge is None else _f32(merge, device)
    return out, None if disp is None else np.array(disp, np.float32)


def doa3d_from_reference(arrays: dict, device) -> dict:
    """{buffer name: tensor} of the port's ``Doa3dEstimator`` from a JAX
    ``Doa3dEstimator``'s ``params`` fields (mics [M, 3]) plus ``dirs`` and
    ``onehot_sph``, as numpy arrays."""
    out = params_from_reference(arrays, device)
    missing = [k for k in ("dirs", "onehot_sph", "lut_flat")
               if arrays.get(k) is None]
    if missing:
        raise ValueError(f"spherical DoA constants lack {missing}")
    out["dirs"] = _f32(arrays["dirs"], device)
    out["onehot_sph"] = _f32(arrays["onehot_sph"], device)
    return out


_FUSION_DTYPES = {
    "mic_world": torch.float32,
    "pairs": torch.int32,
    "window": torch.float32,
    "onehot": torch.float32,
    "cat_mics": torch.float32,
    "cat_pairs": torch.int32,
    "cross_pairs": torch.int32,
    "mic_array_id": torch.int32,
}


def fusion_params_from_reference(arrays: dict, device) -> dict:
    """{name: tensor} for the port's ``FusionParams`` from the JAX
    package's ``FusionParams`` fields as numpy arrays.  Every pair index is
    checked here (the GCC kernel reads mics by them unchecked)."""
    missing = sorted(set(_FUSION_DTYPES) - set(arrays))
    if missing:
        raise ValueError(f"fusion constants lack {missing}")
    k, m = np.shape(arrays["mic_world"])[:2]
    for name, n in (("pairs", m), ("cat_pairs", k * m),
                    ("cross_pairs", k * m)):
        pr = np.asarray(arrays[name])
        if (pr.ndim != 2 or pr.shape[1] != 2 or len(pr) < 1
                or pr.min() < 0 or pr.max() >= n):
            raise ValueError(f"{name} must be [P, 2] indices of {n} mics")
    return {name: torch.as_tensor(np.array(arrays[name], copy=True),
                                  device=device).to(dtype)
            for name, dtype in _FUSION_DTYPES.items()}


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, np.float32), device=device)


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


def _tensors(arrays: dict, dtypes: dict, what: str, device) -> dict:
    missing = sorted(set(dtypes) - set(arrays))
    if missing:
        raise ValueError(f"{what} lacks {missing}")
    return {name: torch.as_tensor(np.array(arrays[name], copy=True),
                                  device=device).to(dtype)
            for name, dtype in dtypes.items()}


def _numpy(state, dtypes: dict) -> dict:
    return {name: getattr(state, name).detach().cpu().numpy()
            for name in dtypes}


_WPE_DTYPES = {"kinv": torch.complex64, "g": torch.complex64,
               "hist": torch.complex64}
_TAIL_DTYPES = {"in_tail": torch.float32, "out_tail": torch.float32}


def dereverb_state_from_reference(arrays: dict, device):
    """The port's ``DereverbState`` on ``device`` from ``{"wpe": {"kinv",
    "g", "hist"}, "in_tail", "out_tail"}``, the leaves of the JAX
    package's ``DereverbState`` as numpy arrays (one stream or stacked
    streams alike)."""
    from ..ops.dereverb import DereverbState, WpeState

    if "wpe" not in arrays:
        raise ValueError("dereverb state lacks ['wpe']")
    return DereverbState(
        wpe=WpeState(**_tensors(arrays["wpe"], _WPE_DTYPES, "WPE state",
                                device)),
        **_tensors(arrays, _TAIL_DTYPES, "dereverb state", device))


def dereverb_state_to_numpy(state) -> dict:
    """``{"wpe": {...}, "in_tail", "out_tail"}`` of a port
    ``DereverbState``, the form :func:`dereverb_state_from_reference`
    takes."""
    return {"wpe": _numpy(state.wpe, _WPE_DTYPES),
            **_numpy(state, _TAIL_DTYPES)}


_EXTRACTOR_DTYPES = {"in_tail": torch.float32, "out_tail": torch.float32,
                     "delays": torch.float32}


def extractor_state_from_reference(arrays: dict, device):
    """The port's ``ExtractorState`` on ``device`` from the leaves of the
    JAX package's ``ExtractorState`` as numpy arrays."""
    from ..models.extraction import ExtractorState

    return ExtractorState(**_tensors(arrays, _EXTRACTOR_DTYPES,
                                     "extractor state", device))


def extractor_state_to_numpy(state) -> dict:
    """{leaf name: numpy array} of a port ``ExtractorState``."""
    return _numpy(state, _EXTRACTOR_DTYPES)


def calib_params_from_reference(arrays: dict, device):
    """The port's ``CalibParams``, ``JointParams`` or ``TrackedParams`` (by
    the fields given: ``mic_xy`` and ``log_gain``, plus ``source_xy`` or
    ``traj_coeffs``) on ``device`` from the JAX package's as numpy arrays;
    float32 leaf tensors that require grad."""
    from ..models import calibration

    extra = {"source_xy": calibration.JointParams,
             "traj_coeffs": calibration.TrackedParams}
    given = [k for k in extra if arrays.get(k) is not None]
    if len(given) > 1:
        raise ValueError(f"calibration parameters hold {given}: at most one "
                         "of source_xy (joint) and traj_coeffs (tracked)")
    cls = extra[given[0]] if given else calibration.CalibParams
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [k for k in names if arrays.get(k) is None]
    if missing:
        raise ValueError(f"{cls.__name__} lacks {missing}")
    return cls(**{k: torch.tensor(np.asarray(arrays[k], np.float32),
                                  device=device, requires_grad=True)
                  for k in names})


def mlp_params_from_reference(params: dict, device):
    """The port's ``models.neural.MLP`` on ``device`` from the JAX package's
    ``{layer_i: {w [in, out], b [out]}}`` as numpy arrays: each
    ``nn.Linear`` weight is ``w`` transposed to [out, in]."""
    from ..models.neural import MLP

    n = len(params)
    if sorted(params) != sorted(f"layer_{i}" for i in range(n)):
        raise ValueError(f"MLP parameters must be layer_0..layer_{n - 1}; "
                         f"got {sorted(params)}")
    ws = [np.asarray(params[f"layer_{i}"]["w"], np.float32) for i in range(n)]
    sizes = (ws[0].shape[0], *(w.shape[1] for w in ws))
    if any(a.shape[1] != b.shape[0] for a, b in zip(ws[:-1], ws[1:])):
        raise ValueError(f"layer widths do not chain: "
                         f"{[w.shape for w in ws]}")
    mlp = MLP(sizes)
    with torch.no_grad():
        for i, layer in enumerate(mlp.children()):
            layer.weight.copy_(torch.from_numpy(ws[i].T.copy()))
            layer.bias.copy_(torch.from_numpy(
                np.array(params[f"layer_{i}"]["b"], np.float32)))
    return mlp.to(device)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` fields, for a port Adam's state as the
    JAX package holds it: ``count`` int32, ``mu`` and ``nu`` each a
    parameter dataclass of the moments."""

    count: torch.Tensor
    mu: Any
    nu: Any


def adam_state_to_reference(opt: torch.optim.Adam, params) -> tuple:
    """``opt``'s state as ``optax.adam``'s, ``(AdamState(count, mu, nu),
    ())``, the last the key-path-free ``EmptyState``: so ``(params,
    adam_state_to_reference(opt, params))`` has the key paths of the JAX
    package's ``(params, opt_state)`` for a ``Calibrator`` and crosses
    through ``utils.checkpoint``.  ``exp_avg`` -> ``mu``, ``exp_avg_sq`` ->
    ``nu``, ``step`` -> ``count``; a fresh optimizer gives zeros.  ``opt``
    must be over the fields of ``params`` in order (``Calibrator.optimizer``
    makes it so)."""
    fields = dataclasses.fields(params)
    group = opt.param_groups[0]["params"]
    if len(opt.param_groups) != 1 or len(group) != len(fields) or any(
            t is not getattr(params, f.name) for t, f in zip(group, fields)):
        raise ValueError("the optimizer is not over the fields of params, "
                         "in order")
    moments = {}
    step = 0
    for key in ("exp_avg", "exp_avg_sq"):
        vals = {}
        for t, f in zip(group, fields):
            st = opt.state.get(t, {})
            vals[f.name] = (st[key].detach().clone() if key in st
                            else torch.zeros_like(t.detach()))
            step = int(st["step"]) if "step" in st else step
        moments[key] = type(params)(**vals)
    return (AdamState(count=torch.tensor(step, dtype=torch.int32),
                      mu=moments["exp_avg"], nu=moments["exp_avg_sq"]), ())


def adam_state_from_reference(state, opt: torch.optim.Adam) -> None:
    """Load an ``optax.adam`` state into ``opt`` (its ``state_dict``):
    ``state`` is ``(ScaleByAdamState, EmptyState)`` or the
    ``ScaleByAdamState`` alone, from the JAX package (as numpy arrays, or
    restored by ``utils.checkpoint`` into :func:`adam_state_to_reference`'s
    structure), with ``mu`` and ``nu`` holding the fields of the parameter
    dataclass that ``opt`` is over, in order."""
    adam = state[0] if not hasattr(state, "mu") else state
    names = [f.name for f in dataclasses.fields(adam.mu)]
    group = opt.param_groups[0]["params"]
    if len(group) != len(names):
        raise ValueError(f"the Adam state holds {names}; the optimizer has "
                         f"{len(group)} parameters")
    sd = opt.state_dict()
    step = float(np.asarray(adam.count))
    for i, (t, name) in enumerate(zip(group, names)):
        def moment(tree):
            return torch.as_tensor(np.asarray(getattr(tree, name)),
                                   dtype=t.dtype).to(t.device)

        sd["state"][i] = {"step": torch.tensor(step, dtype=torch.float32),
                          "exp_avg": moment(adam.mu),
                          "exp_avg_sq": moment(adam.nu)}
    opt.load_state_dict(sd)
