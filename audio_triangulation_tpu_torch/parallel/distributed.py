"""Multi-host initialization and host-aware mesh construction.

Counterpart of ``audio_triangulation_tpu.parallel.distributed``.
:func:`initialize` joins the process group that a launcher describes:
torchrun's variables (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``) or the reference's (``COORDINATOR_ADDRESS``,
``NUM_PROCESSES``, ``PROCESS_ID``).  :func:`make_hybrid_mesh` lays the mesh
out so that the ``model`` axis stays inside one host (its collectives ride
the host's NVLink) and only the ``data`` axis, which needs no collective in
the forward pass, crosses hosts.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from . import mesh as mesh_lib


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
) -> None:
    """Join the process group from the arguments or the launcher's
    variables; a no-op when a group exists or nothing is configured (a
    single process).  On the card each process takes the card
    ``LOCAL_RANK`` names (0 without it)."""
    if dist.is_initialized():
        return
    backend = mesh_lib.backend_for(device)
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is not None:
        world = int(num_processes if num_processes is not None
                    else os.environ.get("NUM_PROCESSES", 1))
        rank = int(process_id if process_id is not None
                   else os.environ.get("PROCESS_ID", 0))
        _use_local_card(device)
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)
    elif all(k in os.environ for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK")):
        _use_local_card(device)
        dist.init_process_group(backend, init_method="env://")


def _use_local_card(device) -> None:
    if mesh_lib.device_type(device) == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))


def per_host_ranks(device="cuda") -> int:
    """Ranks on one host: ``LOCAL_WORLD_SIZE``, else the card count on the
    card, else the world (one host)."""
    if "LOCAL_WORLD_SIZE" in os.environ:
        return int(os.environ["LOCAL_WORLD_SIZE"])
    if mesh_lib.device_type(device) == "cuda":
        return min(torch.cuda.device_count(), dist.get_world_size())
    return dist.get_world_size()


def make_hybrid_mesh(model_parallel: int = 1, device="cuda"):
    """Mesh (world // model_parallel, model_parallel) with each model group
    on one host: ranks are host-major, so consecutive runs of
    ``model_parallel`` ranks share a host as long as ``model_parallel``
    divides the per-host rank count; otherwise ``ValueError``."""
    mesh_lib.ensure_process_group(device)
    per_host = max(1, per_host_ranks(device))
    if model_parallel > per_host or per_host % model_parallel != 0:
        raise ValueError(
            f"model_parallel={model_parallel} must divide per-host rank "
            f"count {per_host} so model collectives stay inside a host")
    n = dist.get_world_size()
    return mesh_lib.make_mesh((n // model_parallel, model_parallel),
                              device=device)
