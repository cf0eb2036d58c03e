"""Process groups that span hosts or cards, and source meshes over them.

One process per card (NCCL), started by ``torchrun`` or with an explicit
address, world size and rank:

    from nlos_surface_optimization_torch.parallel import multihost
    multihost.initialize()                       # torchrun's env://
    dmesh = multihost.global_source_mesh()       # this rank's card
    t, g = sharded_inverse_render(..., dmesh=dmesh)

Every rank passes the FULL (lighting, data, weight) arrays and gets the
full transient and the reduced gradient back; counter-based sampling keys
keep the result equal to the single-process render.  The CPU tests run
the same path over gloo (``backend="gloo"``, CPU devices given).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .shard import AXIS, SourceMesh, make_source_mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: str = "nccl") -> None:
    """``dist.init_process_group`` at tcp://``coordinator_address``
    ("host:port"), else from the environment torchrun sets (env://).  For
    NCCL the process's card is LOCAL_RANK's (else process_id's, modulo
    the visible cards), set before the group starts."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: NCCL needs a CUDA device; CPU "
                               "processes pass backend='gloo'")
        local = os.environ.get("LOCAL_RANK")
        local = int(local) if local is not None else (process_id or 0)
        torch.cuda.set_device(local % torch.cuda.device_count())
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id)


def global_source_mesh(devices: Optional[Sequence] = None) -> SourceMesh:
    """A source mesh over the whole default group, with ``devices`` (default:
    this rank's card) as this rank's shards."""
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    return make_source_mesh(devices, dist.group.WORLD)


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def scaling_summary(dmesh: Optional[SourceMesh] = None) -> dict:
    """The group's shape: processes, this process's index, and the shards
    (devices) in all and on this process; with no mesh, one card a
    process."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    local = 1 if dmesh is None else len(dmesh.devices)
    return {
        "processes": world,
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "global_devices": world * local,
        "local_devices": local,
        "axis": AXIS,
    }
