"""Multi-process initialization (torch.distributed).

The counterpart of iyokan_tpu/parallel/distributed.py: call initialize()
once in each process of the job, one process per card, then build the
global mesh; the gate batches are then sharded over every process's shards
(parallel/mesh.py) and gathered back with all-gathers between the
processes: NCCL where the process's device is a card, gloo on the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """torch.distributed.init_process_group over tcp:// with the JAX
    package's environment fallbacks: IYOKAN_COORDINATOR ("host:port" of
    process 0), IYOKAN_NUM_PROCESSES and IYOKAN_PROCESS_ID.  The backend
    follows the process's device (crypto/ops.py: default_device): NCCL on
    a card, each process taking card process_id mod the host's cards; gloo
    on the CPU."""
    from ..crypto.ops import default_device

    addr = coordinator_address or os.environ.get("IYOKAN_COORDINATOR")
    npn = num_processes or os.environ.get("IYOKAN_NUM_PROCESSES")
    pid = process_id if process_id is not None else os.environ.get(
        "IYOKAN_PROCESS_ID")
    if not addr or npn is None or pid is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of "
            "processes and this process's id (arguments, or "
            "IYOKAN_COORDINATOR / IYOKAN_NUM_PROCESSES / IYOKAN_PROCESS_ID)")
    npn, pid = int(npn), int(pid)
    if "://" not in addr:
        addr = f"tcp://{addr}"
    if default_device().type == "cuda":
        torch.cuda.set_device(pid % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=addr, world_size=npn,
                            rank=pid)


def global_mesh(axis: str = "gates", local_shards: int = 1) -> Mesh:
    """The mesh over every process of the job: each process's
    local_shards (one per card by default; a process may ask for more of
    its own device), gathered in rank order.  A world of one process gets
    no process group."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return Mesh(counts=(int(local_shards),), axis=axis)
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, int(local_shards))
    return Mesh(counts=tuple(counts), rank=dist.get_rank(),
                group=dist.group.WORLD, axis=axis)
