"""Learned localization model family: a neural regressor on GCC features.

Counterpart of ``audio_triangulation_tpu.models.neural``: a small MLP maps
max-normalized correlograms [P, L] (and, with ``include_tdoa``, each pair's
soft-argmax lag) to source coordinates.

The features depend on the frames alone, not on the weights, so they carry
no gradient: they come from ``localizer.conditioned_correlograms``, which
on the card is the GCC kernel without peaks (row 2 of the kernel table,
once a ``train_step`` and once a ``predict``) and on the CPU its plain
version.  The network is an ``nn.Module`` of ``nn.Linear`` layers named
``layer_{i}`` with ReLU between them; training is ``torch.autograd`` and
``torch.optim.Adam`` with optax's defaults, eagerly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core import geometry
from ..core.config import PipelineConfig
from ..ops import window as window_ops
from . import calibration
from . import localizer as localizer_mod


class MLP(nn.Module):
    """ReLU MLP of ``layer_0 .. layer_{n-1}`` (``nn.Linear``); linear last
    layer."""

    def __init__(self, sizes: tuple[int, ...]):
        super().__init__()
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            self.add_module(f"layer_{i}", nn.Linear(fan_in, fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        layers = list(self.children())
        for i, layer in enumerate(layers):
            x = layer(x)
            if i < len(layers) - 1:
                x = torch.relu(x)
        return x


def init_mlp(seed: int, sizes: tuple[int, ...], device="cuda") -> MLP:
    """He-initialized MLP for the given layer widths (features, hidden...,
    out): weights N(0, 2 / fan_in) from a generator seeded with ``seed``,
    zero biases.  The numbers are not the reference's (another PRNG);
    ``utils.convert.mlp_params_from_reference`` carries those across."""
    g = torch.Generator().manual_seed(seed)
    mlp = MLP(sizes)
    with torch.no_grad():
        for layer in mlp.children():
            fan_out, fan_in = layer.weight.shape
            layer.weight.copy_(torch.randn(fan_out, fan_in, generator=g)
                               * np.sqrt(2.0 / fan_in))
            layer.bias.zero_()
    return mlp.to(device)


def apply_mlp(params: MLP, x: torch.Tensor) -> torch.Tensor:
    """ReLU MLP; linear last layer."""
    return params(x)


@dataclasses.dataclass(frozen=True)
class NeuralLocalizer:
    """GCC-feature MLP regressor with an Adam trainer, on the device of
    ``window``.

    >>> net = NeuralLocalizer.create(mic_positions, device="cuda")
    >>> params, opt = net.init(seed=0)
    >>> params, opt, loss = net.train_step(params, opt, frames, xy)
    >>> net.predict(params, frames)       # [B, 2]
    """

    pipeline: PipelineConfig
    pairs: torch.Tensor            # [P, 2]
    window: torch.Tensor           # [N]
    hidden: tuple[int, ...] = (256, 128)
    out_dim: int = 2
    learning_rate: float = 1e-3
    # append per-pair soft-argmax lags (calibration.soft_tdoa) to the
    # correlogram features: the TDOA -> position mapping is smooth and
    # low-dimensional, so convergence is much faster with the peak
    # locations made explicit
    include_tdoa: bool = True

    @classmethod
    def create(cls, mic_positions: np.ndarray,
               pipeline: PipelineConfig = PipelineConfig(), *,
               device="cuda", **kwargs) -> "NeuralLocalizer":
        """Constants on ``device``: the card unless the caller says
        otherwise."""
        mic_positions = np.asarray(mic_positions, np.float32)
        pairs = torch.as_tensor(geometry.mic_pairs(mic_positions.shape[0]),
                                device=device)
        win = torch.as_tensor(window_ops.window_for(pipeline), device=device)
        return cls(pipeline=pipeline, pairs=pairs, window=win, **kwargs)

    @property
    def device(self) -> torch.device:
        return self.window.device

    @property
    def feature_dim(self) -> int:
        p = int(self.pairs.shape[0])
        return p * self.pipeline.num_lags + (p if self.include_tdoa else 0)

    @property
    def sizes(self) -> tuple[int, ...]:
        return (self.feature_dim, *self.hidden, self.out_dim)

    def features(self, frames: torch.Tensor) -> torch.Tensor:
        """Frames [B, M, N] -> max-normalized correlograms [B, P*L] (+ the
        soft-argmax lags / K [B, P] with ``include_tdoa``)."""
        cfg = self.pipeline
        flat = localizer_mod._flat_frames(frames, cfg)
        corr = localizer_mod.conditioned_correlograms(
            flat, _feature_params(self.pairs, self.window), cfg)  # [B, P, L]
        corr = corr / (corr.abs().amax(dim=-1, keepdim=True) + 1e-20)
        feats = corr.reshape(corr.shape[0], -1)
        if self.include_tdoa:
            tdoa = calibration.soft_tdoa(corr, cfg.max_shift)  # [B, P]
            feats = torch.cat([feats, tdoa / cfg.max_shift], dim=-1)
        return feats

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    # ------------------------------------------------------------------
    def optimizer(self, params: MLP) -> torch.optim.Adam:
        """Adam over the MLP's parameters (optax.adam's update)."""
        return torch.optim.Adam(params.parameters(), lr=self.learning_rate,
                                betas=calibration.ADAM_BETAS,
                                eps=calibration.ADAM_EPS)

    def init(self, seed: int = 0):
        params = init_mlp(seed, self.sizes, self.device)
        return params, self.optimizer(params)

    def loss(self, params: MLP, frames: torch.Tensor,
             target_xy: torch.Tensor) -> torch.Tensor:
        pred = apply_mlp(params, self.features(frames))
        return ((pred - target_xy) ** 2).sum(dim=-1).mean()

    def train_step(self, params: MLP, opt, frames, target_xy):
        """(params, opt, frames, xy) -> (params, opt, loss); the weights
        are updated in place."""
        frames, target_xy = self._f32(frames), self._f32(target_xy)
        opt.zero_grad(set_to_none=True)
        loss = self.loss(params, frames, target_xy)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    def predict(self, params: MLP, frames) -> torch.Tensor:
        """Frames [B, M, N] -> predicted source coordinates [B, out_dim]."""
        with torch.no_grad():
            return apply_mlp(params, self.features(self._f32(frames)))

    def fit(self, data, *, seed: int = 0, state=None, log_every: int = 0):
        """Train over an iterable of (frames, xy) batches; returns
        ((params, opt), losses)."""
        params, opt = self.init(seed) if state is None else state
        losses = []
        for i, (frames, xy) in enumerate(data):
            params, opt, loss = self.train_step(params, opt, frames, xy)
            losses.append(loss)
            if log_every and i % log_every == 0:
                print(f"step {i}: loss {float(loss):.5f}")
        return (params, opt), [float(v) for v in losses]


def _feature_params(pairs: torch.Tensor,
                    window: torch.Tensor) -> localizer_mod.LocalizerParams:
    """Minimal LocalizerParams for conditioned_correlograms (no grid)."""
    return localizer_mod.LocalizerParams(
        mic_positions=torch.zeros((0, 2), device=window.device),
        pairs=pairs, window=window,
        lut_flat=torch.zeros((pairs.shape[0], 1), dtype=torch.int32,
                             device=window.device),
        onehot=None, score_bias=None)


def synthetic_batches(
    mic_positions: np.ndarray,
    *,
    n_batches: int,
    batch_size: int,
    pipeline: PipelineConfig = PipelineConfig(),
    extent_m: float = 1.0,
    height_m: float = 1.2,
    noise_rms: tuple[float, float] = (0.005, 0.05),
    room=None,
    bank: int = 0,
    seed: int = 0,
    device="cuda",
):
    """Generator of (frames [B, M, N], xy [B, 2]) float32 numpy batches:
    the reference's draws for a seed.

    Sources are uniform on the plane z = height_m within +-extent_m;
    anechoic by default (numpy, the reference's arrays), or simulated in a
    ``utils.room.ShoeboxRoom`` by ``room.simulate_batch`` on ``device`` (the
    card unless the caller says otherwise; the array is placed at the
    room's floor center).  ``bank > 0`` synthesizes ``bank`` scenes once
    up front, then every batch samples the bank with replacement and adds
    fresh measurement noise."""
    from ..utils import synth

    rng = np.random.default_rng(seed)
    mics = np.asarray(mic_positions, np.float64)
    n = pipeline.frame_size
    fs = pipeline.sample_rate_hz

    if room is not None:
        from ..utils import room as room_mod

        if not isinstance(room, room_mod.ShoeboxRoom):
            raise TypeError(f"room must be a utils.room.ShoeboxRoom; got "
                            f"{type(room).__name__}")
        shift = np.array([room.size[0] / 2, room.size[1] / 2, 0.0])
        mic3 = np.zeros((mics.shape[0], 3))
        mic3[:, : mics.shape[1]] = mics

    def scenes(count: int, b: int):
        """count noiseless scenes with a freshly drawn chirp."""
        xy = rng.uniform(-extent_m, extent_m, (count, 2))
        src = np.concatenate(
            [xy, np.full((count, 1), height_m)], axis=-1)
        sigs = synth.chirp_burst(
            n, fs, f0=rng.uniform(500, 1200), f1=rng.uniform(4000, 8000))
        if room is None:
            frames = synth.synth_scene(
                src, mics, n=n, fs=fs, signal=sigs, noise_rms=0.0,
                seed=seed + 31 * b)
        else:
            frames = room_mod.simulate_batch(
                src + shift, mic3 + shift, room, device=device, n=n, fs=fs,
                signal=sigs).cpu().numpy()
        return frames, xy

    if bank:
        chunks = [scenes(min(batch_size, bank - i), 1000 + j)
                  for j, i in enumerate(range(0, bank, batch_size))]
        bank_fr = np.concatenate([c[0] for c in chunks])
        bank_xy = np.concatenate([c[1] for c in chunks])
        for _ in range(n_batches):
            idx = rng.integers(0, bank, batch_size)
            nr = rng.uniform(*noise_rms)
            frames = bank_fr[idx] + rng.normal(
                0.0, nr, (batch_size,) + bank_fr.shape[1:])
            yield frames.astype(np.float32), bank_xy[idx].astype(np.float32)
        return

    for b in range(n_batches):
        frames, xy = scenes(batch_size, b)
        nr = rng.uniform(*noise_rms)
        frames = frames + rng.normal(0.0, nr, frames.shape)
        yield frames.astype(np.float32), xy.astype(np.float32)
