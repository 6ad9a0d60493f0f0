"""Device mesh construction and the slice of each axis a rank holds.

Counterpart of ``audio_triangulation_tpu.parallel.mesh``.  The reference
builds a ``jax.sharding.Mesh`` with named axes and lets jit place global
arrays by ``PartitionSpec``; here the mesh is a ``torch.distributed``
``DeviceMesh`` over the world's ranks, and every rank passes and gets back
its own shard (SPMD as torch writes it):

- ``data``  — frames / batch / stream axis
- ``model`` — SRP grid / pair / array axis

The reference's shardings become plain functions that say which slice a
rank holds (:func:`frames_shard`, :func:`grid_range`, :func:`pair_range`),
and :func:`gather_batch` assembles a batch-sharded result across the data
axis for callers that want the global array.  The backend follows the
device: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def device_type(device) -> str:
    """'cuda' or 'cpu' for a device given as a string or ``torch.device``."""
    return torch.device(device).type


def backend_for(device) -> str:
    """The collective backend for ``device``: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if device_type(device) == "cuda" else "gloo"


def ensure_process_group(device="cuda") -> None:
    """Join the world the environment describes, or make a world of one.

    An initialized process group is kept as it is.  With torchrun's
    variables (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) or the
    reference's (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``,
    ``PROCESS_ID``) ``distributed.initialize`` joins that world; with
    neither a single process gets a world of one on an in-memory store."""
    if dist.is_initialized():
        return
    from . import distributed

    distributed.initialize(device=device)
    if dist.is_initialized():
        return
    if device_type(device) == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh on the card needs a CUDA device; "
                               "pass device='cpu' for a gloo world")
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(backend_for(device), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(
    mesh_shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    device="cuda",
):
    """A ``DeviceMesh`` over the world's ranks, on ``device``'s type.

    Default: every rank on the data axis (pure data parallel), the other
    axes of size 1.  ``mesh_shape`` must multiply to the world size; ranks
    fill it in row-major order (with a (data, model) shape the model groups
    are runs of consecutive ranks)."""
    from torch.distributed.device_mesh import init_device_mesh

    ensure_process_group(device)
    n = dist.get_world_size()
    if mesh_shape is None:
        mesh_shape = (n,) + (1,) * (len(axis_names) - 1)
    mesh_shape = tuple(int(v) for v in mesh_shape)
    if int(np.prod(mesh_shape)) != n or len(mesh_shape) != len(axis_names):
        raise ValueError(f"mesh shape {mesh_shape} != {n} ranks over axes "
                         f"{tuple(axis_names)}")
    return init_device_mesh(device_type(device), mesh_shape,
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, axis: str) -> int:
    return int(mesh.mesh.shape[list(mesh.mesh_dim_names).index(axis)])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shard_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of shard ``index`` of an axis of ``n`` padded up to a
    multiple of ``parts`` (the reference's ``pad_grid_axis``): each shard
    holds ``ceil(n / parts)`` places, and places from ``n`` on are
    padding."""
    size = -(-n // parts)
    return index * size, (index + 1) * size


def frames_shard(mesh, frames, axis: str = DATA_AXIS):
    """The rank's contiguous slice of a batch-leading array or tensor, in
    data-axis order (the reference's ``frames_sharding``).  The batch must
    divide by the data-axis size."""
    n = axis_size(mesh, axis)
    b = frames.shape[0]
    if b % n:
        raise ValueError(f"batch {b} not divisible by the {axis} axis "
                         f"({n})")
    i = axis_index(mesh, axis)
    return frames[i * (b // n):(i + 1) * (b // n)]


def grid_range(mesh, g: int) -> tuple[int, int]:
    """The rank's [start, stop) of ``g`` grid cells on the model axis, in
    the padded grid (cells from ``g`` on are padding)."""
    return shard_range(g, axis_size(mesh, MODEL_AXIS),
                       axis_index(mesh, MODEL_AXIS))


def pair_range(mesh, p: int) -> tuple[int, int]:
    """The rank's [start, stop) of ``p`` pairs on the model axis, in the
    padded pair list (pairs from ``p`` on are padding)."""
    return shard_range(p, axis_size(mesh, MODEL_AXIS),
                       axis_index(mesh, MODEL_AXIS))


def all_gather(x: torch.Tensor, group, n: int) -> list:
    """``x`` from each of the ``n`` ranks of ``group``, in rank order."""
    if n == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def gather_batch(mesh, x, axis: str = DATA_AXIS):
    """A batch-sharded result assembled across ``axis``: tensors
    concatenated on dim 0 in axis order; dicts, lists, tuples and
    dataclasses of them gathered leaf by leaf.  Every rank gets the global
    value (a collective: every rank of the axis must call it)."""
    group, n = mesh.get_group(axis), axis_size(mesh, axis)
    if isinstance(x, torch.Tensor):
        return torch.cat(all_gather(x, group, n), dim=0)
    if isinstance(x, dict):
        return {k: gather_batch(mesh, v, axis) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(gather_batch(mesh, v, axis) for v in x)
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: gather_batch(mesh, getattr(x, f.name),
                                               axis)
                          for f in dataclasses.fields(x)})
    return x

