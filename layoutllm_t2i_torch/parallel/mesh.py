"""The process group and its batch helpers (layoutllm_t2i_tpu/parallel/
mesh.py).

The JAX package runs one controller over a device mesh and leaves every
collective to GSPMD. The port runs one process a rank, each the same
program, on ``torch.distributed``: a ``Mesh`` is this process's view of
the group (rank, world size, its device) and every collective is an
explicit call (``parallel/collectives.py``).

``make_mesh`` reads ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``). Without it the world is
one process and no group is made, as ``jax.devices()`` on one chip is one
device. The backend is NCCL for a CUDA device and gloo for the CPU. Ranks
that share one card must ask for gloo: NCCL refuses two ranks on one
device, and ``make_mesh`` says so before NCCL would.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

BACKENDS = ("nccl", "gloo")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's rank in a group of ``size`` processes, one device
    each. ``group`` is None for a world of one made without a group."""

    rank: int
    size: int
    device: torch.device
    backend: Optional[str] = None
    group: Any = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def make_mesh(num_devices: Optional[int] = None, backend: Optional[str] = None,
              device: DeviceLike = None,
              timeout: Optional[datetime.timedelta] = None) -> Mesh:
    """The group ``torchrun``'s environment describes, or a world of one.

    device: None is ``cuda:LOCAL_RANK``; "cpu" (or another device) is
    taken as given. backend: None is the running group's, else NCCL for
    CUDA and gloo for the CPU.
    num_devices, where given, must be the world size (each process holds
    one device). ``timeout`` bounds every collective of the group."""
    world = _env_int("WORLD_SIZE", 1)
    rank = _env_int("RANK", 0)
    local = _env_int("LOCAL_RANK", rank)
    if num_devices is not None and num_devices != world:
        raise ValueError(f"num_devices={num_devices}: this group has "
                         f"{world} processes, one device each")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local)
    if backend is None and dist.is_initialized():
        backend = dist.get_backend()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: want one of {BACKENDS}")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("NCCL needs a CUDA device; the CPU takes gloo")
        cards = torch.cuda.device_count()
        if dev.index != local or local >= cards or (
                _env_int("LOCAL_WORLD_SIZE", 1) > cards):
            raise ValueError(
                f"NCCL needs a card of its own for each rank (rank {rank} on "
                f"{dev}, local rank {local}, {cards} cards): NCCL refuses two "
                "ranks on one device. Ranks that share a card take "
                "backend='gloo'")
        torch.cuda.set_device(dev)
    if "WORLD_SIZE" not in os.environ and not dist.is_initialized():
        return Mesh(0, 1, dev)
    if not dist.is_initialized():
        kw = {} if timeout is None else {"timeout": timeout}
        dist.init_process_group(backend, rank=rank, world_size=world, **kw)
    elif dist.get_backend() != backend:
        raise ValueError(f"the default group runs {dist.get_backend()}, "
                         f"not {backend}")
    return Mesh(dist.get_rank(), dist.get_world_size(), dev, backend,
                dist.group.WORLD)


def is_primary() -> bool:
    """Rank 0 of the default group, or the one process of a world of one."""
    return not dist.is_initialized() or dist.get_rank() == 0


def sync_global_devices(name: str = "sync") -> None:
    """A barrier over the default group (the reference's synchronize())."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def row_block(n: int, mesh: Mesh) -> slice:
    """This rank's rows of ``n``, which must divide over the world."""
    if n % mesh.size:
        raise ValueError(f"batch {n} must divide over {mesh.size} devices")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def batch_rows(n: int, mesh: Mesh, accum_steps: int = 1) -> np.ndarray:
    """The rows of a global batch of ``n`` that this rank takes, in order:
    its block of each of the ``accum_steps`` microbatches the global batch
    splits into (the JAX step's reshape to (k, n / k, ...)), so that its
    local microbatch i is its block of global microbatch i. ``n`` must
    divide over world x accum_steps."""
    if n % (mesh.size * accum_steps):
        raise ValueError(f"batch {n} must divide over {mesh.size} devices x "
                         f"{accum_steps} microbatches")
    micro, per = n // accum_steps, n // accum_steps // mesh.size
    return np.concatenate([np.arange(i * micro + mesh.rank * per,
                                     i * micro + (mesh.rank + 1) * per)
                           for i in range(accum_steps)])


def take_rows(batch: dict, rows) -> dict:
    """Rows ``rows`` of every leaf of a host batch (arrays and lists)."""
    return {k: (v[rows] if isinstance(v, (np.ndarray, torch.Tensor))
                else [v[i] for i in rows]) for k, v in batch.items()}


def share(mesh: Mesh, obj=None):
    """Rank 0's ``obj`` (any picklable host object) on every rank (the
    others pass None)."""
    if mesh.size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(
        box, src=0, group=mesh.group,
        device=mesh.device if mesh.backend == "nccl" else None)
    return box[0]


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of every tensor or array leaf of ``batch``, on the
    mesh's device (the leading axis divides over the world)."""
    def take(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        return x[row_block(x.shape[0], mesh)].to(mesh.device)
    return _map(batch, take)


def replicate(mesh: Mesh, tree):
    """Rank 0's value of every tensor leaf of ``tree`` on every rank, on the
    mesh's device: a broadcast from rank 0. Every rank passes leaves of the
    same shapes and types (as when each builds the same batch)."""
    from .collectives import broadcast

    def bcast(x):
        if not isinstance(x, torch.Tensor):
            return x
        return broadcast(mesh, x.to(mesh.device))
    return _map(tree, bcast)


def zero1_dim(shape, n: int) -> Optional[int]:
    """ZeRO-1's rule for one leaf over ``n`` devices: its largest dimension
    that ``n`` divides (at least ``n`` long; the first of equals), or None
    where none does and the leaf stays whole (parallel/mesh.py
    zero1_sharding in the JAX package)."""
    best = None
    for i, d in enumerate(shape):
        if d >= n and d % n == 0 and (best is None or d > shape[best]):
            best = i
    return best


def zero1_sharding(mesh: Mesh, tree):
    """``zero1_dim`` of every tensor leaf: the dimension each leaf's
    optimizer state is split along, or None."""
    return _map(tree, lambda x: zero1_dim(tuple(getattr(x, "shape", ())),
                                          mesh.size))
