"""Process groups for data-parallel runs (counterpart of
``nerf_tpu/parallel/distributed.py``, over ``torch.distributed``).

One process per GPU, every process runs the same program, and the
collectives go over NCCL between GPUs (gloo for CPU tensors).  Unlike
JAX's ``initialize``, which does nothing for one process, ``initialize``
always builds a group, a group of one when no launcher set the
environment: the data-parallel step calls its collective whatever the
number of ranks.

    torchrun --nproc_per_node=N -m nerf_tpu_torch.cli.train_tiny_nerf --data-parallel

``initialize`` reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) for what it is not
given.  The group's device is ``cuda:<LOCAL_RANK>`` unless one is passed;
a missing GPU raises, it is never remapped.  The backend follows the
device, ``"nccl"`` for CUDA and ``"gloo"`` for the CPU, unless the caller
names one (gloo also runs ``all_reduce`` and ``broadcast`` on CUDA
tensors, which is how two ranks can share one card).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# A rendezvous or collective that waits longer than this fails instead of
# hanging the run (the watchdog's supervisor restarts it).
DEFAULT_TIMEOUT_S = 300.0

# The device of the default group's collectives and its timeout, set by
# ``initialize`` (the mesh's axis groups take the same timeout).
_group_device: Optional[torch.device] = None
_group_timeout: Optional[datetime.timedelta] = None


def initialize(
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device=None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Create the default process group and return this rank's device.

    Arguments not given come from torchrun's environment; without it, a
    group of one (rank 0, an in-process store).  ``init_method`` is a
    ``tcp://host:port`` or ``file://path`` address, or ``env://``
    (the default when ``MASTER_ADDR`` and ``MASTER_PORT`` are set)."""
    global _group_device, _group_timeout
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; call shutdown() first")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a group of {world_size}")
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', 0))}"
    device = torch.device(device)
    if device.type == "cuda":
        index = 0 if device.index is None else device.index
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if index >= count:
            raise RuntimeError(f"rank {rank} wants {device}, but {count} GPU(s) are visible")
        device = torch.device("cuda", index)
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    if init_method is None and not ("MASTER_ADDR" in env and "MASTER_PORT" in env):
        if world_size != 1:
            raise ValueError(
                f"a group of {world_size} needs an init_method or MASTER_ADDR and MASTER_PORT"
            )
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size, timeout=timeout)
    _group_device, _group_timeout = device, timeout
    logger.info("initialized rank %d/%d on %s over %s", rank, world_size, device, backend)
    return device


def group_device() -> torch.device:
    """The device of the default group's collectives."""
    if not dist.is_initialized() or _group_device is None:
        raise RuntimeError("no process group: call distributed.initialize() first")
    return _group_device


def group_timeout() -> datetime.timedelta:
    """The default group's timeout, which every group made beside it takes."""
    group_device()  # raises without a group
    return _group_timeout


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_coordinator() -> bool:
    """True on rank 0, the only rank that writes logs and checkpoints."""
    return rank() == 0


def host_local_slice(n: int, batch_size: int) -> slice:
    """The contiguous rows of a global batch that this rank owns: rank
    ``p`` of ``P`` takes the ``p``-th of ``P`` equal parts, so the global
    batch stays the single-process one."""
    p, count = rank(), world_size()
    if batch_size % count:
        raise ValueError(f"global batch {batch_size} not divisible by {count} ranks")
    del n
    per = batch_size // count
    return slice(p * per, (p + 1) * per)


def collective_barrier(tag: int = 0) -> None:
    """A barrier through an ``all_reduce`` of ones on the group's device,
    checked against the group's size: a dead rank makes it fail at the
    group's timeout instead of letting training diverge silently."""
    del tag
    ones = torch.ones(1, device=group_device())
    dist.all_reduce(ones)
    total = int(ones.item())
    if total != world_size():
        raise RuntimeError(f"collective barrier mismatch: {total} != {world_size()}")


def shutdown() -> None:
    """Destroy the default group (a no-op without one)."""
    global _group_device, _group_timeout
    if dist.is_initialized():
        dist.destroy_process_group()  # every group, the mesh's axis groups too
    _group_device = _group_timeout = None
