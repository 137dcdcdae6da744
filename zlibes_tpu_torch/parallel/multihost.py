"""Multi-process set-up of the block-parallel codec (the port of
``zlibes_tpu/parallel/multihost.py``).

One process a device, on one host or many, joined in one
``torch.distributed`` process group; then the same block-parallel codec
runs over the group's mesh.  The code path does not change with the number
of hosts, only ``initialize()``'s arguments do.

    from zlibes_tpu_torch.parallel import multihost, parallel_deflate
    multihost.initialize()          # env:// (MASTER_ADDR, RANK, ...)
    mesh = multihost.global_mesh()
    comp = parallel_deflate(data, mesh)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..codec.api import _device
from .block_parallel import Mesh, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: torch.device | str = "cuda") -> None:
    """Join this process to the default process group (idempotent: a group
    that exists is kept).

    ``coordinator_address`` ("host:port") with ``num_processes`` and
    ``process_id``: ``tcp://`` with these; without them ``env://`` (the
    launcher's MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  The backend
    follows ``device``: NCCL for ``cuda`` (which raises without a card),
    gloo for ``cpu``."""
    if dist.is_initialized():
        return
    backend = "nccl" if _device(device).type == "cuda" else "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)


def global_mesh(*, device: torch.device | str = "cuda") -> Mesh:
    """The mesh over every rank of the default process group (a world of
    one without a group)."""
    return make_mesh(device=device)


def host_shard(total_rows: int) -> tuple[int, int]:
    """This rank's contiguous [start, end) of ``total_rows`` block rows split
    equally over the default group's ranks (one rank a device, in rank
    order): the rows ``parallel_deflate`` asks this rank's
    ``block_provider`` for, so per-rank input stays at 1/world of the
    whole.  ``total_rows`` must be a multiple of the world size (the codec
    pads its blocks to world * ceil(blocks / world) rows)."""
    on = dist.is_available() and dist.is_initialized()
    D = dist.get_world_size() if on else 1
    rank = dist.get_rank() if on else 0
    if total_rows % D:
        raise ValueError(f"total_rows {total_rows} not divisible by {D}")
    per = total_rows // D
    return rank * per, (rank + 1) * per
