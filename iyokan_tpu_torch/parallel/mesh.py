"""Multi-device sharding of the batched executors (torch).

The counterpart of iyokan_tpu/parallel/mesh.py.  The parallel axis is the
gate batch: every expensive stage is a batch of independent rows (the
bootstrap rows of a level, the RAM write's refresh rows), so running on
several devices is data parallelism over that axis with the evaluation
keys replicated.  The JAX package states the placement as a sharding
constraint and lets XLA insert the all-gather; in eager torch the same
placement is explicit work:

  * a Mesh is the ordered list of shards over the whole job: each
    process's shards in rank order, one process per card (torch's own
    idiom, as under torchrun), and the process group between them (None
    for a world of one process);
  * shard_batch(x, fn) splits x's rows into the mesh's equal shards, runs
    fn on this process's shards one after another, and brings the results
    back whole in shard order: torch.cat within the process, an all-gather
    across processes;
  * every process keeps the whole wire state and the whole keys, so
    replicated() is the identity; shards of one process share its device's
    keys (crypto/ops.py: DeviceKeys.from_evalkey caches them per device).

make_mesh(n) gives n shards of the process's one device: on the CPU the
counterpart of the JAX tests' 8 virtual devices, on a card n shards on that
card.  Spanning several cards takes one process per card
(parallel/distributed.py: initialize, then global_mesh).  With no mesh set
every function here is a no-op, so one code path serves every placement.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Optional

import torch

_active_mesh: Optional["Mesh"] = None
_inside_shard = False     # a shard's fn is running: nested batches stay whole


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the job: counts[r] shards in process r, this process
    being `rank`; `group` the process group joining them (None: a world of
    one process, where nothing is ever communicated)."""

    counts: tuple
    rank: int = 0
    group: object = None
    axis: str = "gates"

    @property
    def size(self) -> int:
        """The number of shards over the whole job."""
        return sum(self.counts)

    @property
    def local(self) -> range:
        """The indices of this process's shards."""
        first = sum(self.counts[:self.rank])
        return range(first, first + self.counts[self.rank])


@dataclass(frozen=True)
class NamedSharding:
    """The placement shard_batch gives a shape: spec names the mesh axis at
    the sharded dimension (None elsewhere), or is () where the array is
    replicated, as jax.sharding.PartitionSpec's entries read."""

    mesh: Mesh
    spec: tuple


def _min_rows_per_device() -> int:
    """A batch is sharded only when every shard gets at least this many
    rows (IYOKAN_SHARD_MIN_ROWS, default 8, read at each call as the JAX
    package reads it); smaller batches run whole."""
    return int(os.environ.get("IYOKAN_SHARD_MIN_ROWS", "8"))


def make_mesh(n_devices: Optional[int] = None, axis: str = "gates") -> Mesh:
    """n_devices shards (default 1) of this process's device, in a world of
    one process."""
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, not {n}")
    return Mesh(counts=(n,), axis=axis)


def set_mesh(mesh: Optional[Mesh]) -> None:
    global _active_mesh
    _active_mesh = mesh


def get_mesh() -> Optional[Mesh]:
    return _active_mesh


def batch_sharding(shape, axis: int = 0) -> Optional[NamedSharding]:
    """The placement shard_batch gives an array of `shape` (None where no
    mesh is set): sharded along `axis` where every shard gets at least
    IYOKAN_SHARD_MIN_ROWS rows and the rows divide evenly, else
    replicated."""
    mesh = _active_mesh
    if mesh is None:
        return None
    n = mesh.size
    if shape[axis] < n * _min_rows_per_device() or shape[axis] % n:
        return NamedSharding(mesh, ())
    spec = [None] * len(shape)
    spec[axis] = mesh.axis
    return NamedSharding(mesh, tuple(spec))


def shard_batch(x: torch.Tensor, fn: Callable[[torch.Tensor], torch.Tensor],
                axis: int = 0) -> torch.Tensor:
    """fn(x) computed as the mesh places x's rows along `axis`; fn maps
    rows to rows (its row i depends on x's row i alone) and keeps `axis`.

    With no mesh, inside another shard's fn, or where batch_sharding
    replicates x, fn runs on the whole of x.  Otherwise this process runs
    fn on each of its shards' rows and the results come back whole in
    shard order (torch.cat here, an all-gather across processes)."""
    global _inside_shard
    sh = batch_sharding(x.shape, axis)
    if sh is None or not sh.spec or _inside_shard:
        return fn(x)
    mesh = sh.mesh
    step = x.shape[axis] // mesh.size
    _inside_shard = True
    try:
        outs = [fn(x.narrow(axis, i * step, step)) for i in mesh.local]
    finally:
        _inside_shard = False
    out = outs[0] if len(outs) == 1 else torch.cat(outs, axis)
    return _all_gather(mesh, out, axis)


def _all_gather(mesh: Mesh, local: torch.Tensor, axis: int) -> torch.Tensor:
    """Every process's shard results, whole, in shard order (the identity
    in a world of one process).  Processes may hold different numbers of
    shards: each pads its block to the largest before the gather."""
    if mesh.group is None:
        return local
    import torch.distributed as dist

    step = local.shape[axis] // mesh.counts[mesh.rank]
    most = max(mesh.counts) * step
    local = local.movedim(axis, 0)
    if local.shape[0] < most:
        local = torch.cat([local, local.new_zeros(
            (most - local.shape[0],) + tuple(local.shape[1:]))])
    # the list form: gloo and NCCL both take it on every torch this port
    # runs on (the single-tensor forms differ between versions)
    parts = [torch.empty_like(local) for _ in mesh.counts]
    dist.all_gather(parts, local.contiguous(), group=mesh.group)
    out = torch.cat([part[:c * step] for part, c in zip(parts, mesh.counts)])
    return out.movedim(0, axis)


def replicated(x: torch.Tensor) -> torch.Tensor:
    """x placed whole on every shard: every process already holds the whole
    wire state and keys, so this is the identity."""
    return x
