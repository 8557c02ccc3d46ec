"""The data-parallel mesh over a process group (counterpart of
``nerf_tpu/parallel/mesh.py``'s 1-D ``batch`` mesh).

JAX's mesh lays devices along a ``batch`` axis: the parameters are
replicated and the ray batch is split along it.  Here each rank of a
``torch.distributed`` group holds one device, so the mesh is the group:
its ranks in order along ``BATCH_AXIS``.  ``shard_batch`` keeps this
rank's contiguous rows of a global batch, and ``replicate`` broadcasts the
train state from rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from nerf_tpu_torch.parallel import distributed

BATCH_AXIS = "batch"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen as a 1-D mesh: ``size`` ranks along
    ``axis_name``, this process ``rank`` on ``device``."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device
    axis_name: str = BATCH_AXIS


def make_mesh(num_devices: int = 0, axis_name: str = BATCH_AXIS) -> Mesh:
    """The mesh over every rank of the default group
    (``distributed.initialize`` first).  The mesh spans the whole group, so
    ``num_devices``, when given, must be the group's size."""
    size = distributed.world_size()
    if num_devices and num_devices != size:
        raise ValueError(f"requested {num_devices} ranks, the group has {size}")
    return Mesh(group=None, rank=distributed.rank(), size=size,
                device=distributed.group_device(), axis_name=axis_name)


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of ``n`` rows; raises when ``n`` does
    not divide over the mesh."""
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (every entry's leading axis)."""
    sizes = {v.shape[0] for v in batch.values()}
    if len(sizes) != 1:
        raise ValueError(f"batch entries disagree on the number of rows: {sorted(sizes)}")
    rows = local_rows(sizes.pop(), mesh)
    return {k: v[rows] for k, v in batch.items()}


def _in_memory_order(t: torch.Tensor):
    """``(view, dims)``: ``t`` permuted to its memory order, contiguous for
    a dense tensor of any strides (a transposed gradient), and the
    permutation; ``None`` where no permutation makes it contiguous."""
    dims = sorted(range(t.dim()), key=lambda d: (-t.stride(d), d))
    view = t.permute(dims)
    return (view, dims) if view.is_contiguous() else (None, None)


def flat_collective(tensors: List[torch.Tensor], mesh: Mesh, op: str) -> List[torch.Tensor]:
    """One collective over ``tensors`` packed into a single flat buffer:
    ``"sum"`` or ``"mean"`` (``all_reduce`` of the sum, the mean divided by
    the mesh's size) or ``"broadcast"`` (from rank 0).  Returns views of
    the buffer with the inputs' shapes and strides, so a reduction over a
    result sums in the same order as over its input.  Each input is packed
    in its memory order: the packing is one copy (the concatenation) and
    the unpacking none, whatever the inputs' strides."""
    ordered = [_in_memory_order(t.detach()) for t in tensors]
    flat = torch.cat([t.detach().reshape(-1) if view is None else view.view(-1)
                      for t, (view, _) in zip(tensors, ordered)])
    if op in ("sum", "mean"):
        dist.all_reduce(flat, group=mesh.group)
        if op == "mean":
            flat /= mesh.size
    elif op == "broadcast":
        dist.broadcast(flat, src=0, group=mesh.group)
    else:
        raise ValueError(f"unknown collective {op!r}")
    out = []
    for part, t, (view, dims) in zip(flat.split([t.numel() for t in tensors]), tensors, ordered):
        if view is None:
            out.append(part.view(t.shape))
        else:
            inverse = sorted(range(len(dims)), key=dims.__getitem__)
            out.append(part.view(view.shape).permute(inverse))
    return out


def replicate(state, mesh: Mesh):
    """Make ``state`` (a ``TrainState``) rank 0's on every rank, in place:
    its step and seed, the model's parameters and Adam's moments and
    count, each group in one broadcast.  Returns ``state``."""
    from nerf_tpu_torch.train import checkpoint  # train/loop.py imports this package

    meta = torch.tensor([int(state.step), int(state.seed)], dtype=torch.int64,
                        device=mesh.device)
    dist.broadcast(meta, src=0, group=mesh.group)
    state.step, state.seed = int(meta[0]), int(meta[1])
    params = list(state.model.parameters())
    with torch.no_grad():
        for p, new in zip(params, flat_collective(params, mesh, "broadcast")):
            p.copy_(new)
    count, mu, nu = checkpoint.adam_state(state)
    names = list(mu)
    moments = [mu[k] for k in names] + [nu[k] for k in names]
    count_t = torch.tensor([float(count)], device=mesh.device)
    *moments, count_t = flat_collective(moments + [count_t], mesh, "broadcast")
    checkpoint.load_adam_state(state, int(count_t.item()),
                               dict(zip(names, moments[:len(names)])),
                               dict(zip(names, moments[len(names):])))
    return state
