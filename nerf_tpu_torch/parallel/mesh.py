"""Meshes over a process group (counterpart of ``nerf_tpu/parallel/mesh.py``).

JAX's mesh lays devices along named axes.  Here each rank of a
``torch.distributed`` group holds one device, so a mesh is the group seen
as a grid of ranks:

* ``make_mesh``: the 1-D data-parallel mesh, every rank in order along
  ``BATCH_AXIS``; the parameters are replicated and the ray batch is split
  along it.
* ``make_mesh_2d``: a ``(batch, sample|model)`` grid, ranks laid out
  row-major (``rank = b * second + s``, as JAX reshapes its device list).
  The second axis carries the samples of every ray
  (``parallel/sample_parallel.py``) or the MLP's hidden width
  (``parallel/tensor_parallel.py``).  Each axis has its own process group:
  the ranks that differ only along it.

``shard_batch`` keeps this rank's contiguous rows of a global batch (split
over the batch axis, the same rows on every rank of the second axis),
``flat_collective`` runs one collective over a list of tensors along an
axis or the whole mesh, and ``replicate`` broadcasts the train state from
rank 0.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from nerf_tpu_torch.parallel import distributed

BATCH_AXIS = "batch"
SAMPLE_AXIS = "sample"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Axis:
    """One axis of a mesh as this rank sees it: ``size`` ranks along it,
    this rank at ``index``, ``group`` the ranks that differ from this one
    only along it (``None``: the default group) and ``root`` the global
    rank of the group's member at index 0."""

    name: str
    size: int
    index: int
    group: Optional[dist.ProcessGroup]
    root: int = 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen as a mesh: ``size`` ranks, this process
    ``rank`` on ``device``.  A 1-D mesh lays them along ``axis_name``; a
    2-D mesh (``make_mesh_2d``) holds its two axes in ``grid``."""

    group: Optional[dist.ProcessGroup]  # None: the default group
    rank: int
    size: int
    device: torch.device
    axis_name: str = BATCH_AXIS
    grid: Tuple[Axis, ...] = ()

    @property
    def axes(self) -> Tuple[Axis, ...]:
        """The mesh's axes in order, the rows' (batch) axis first."""
        return self.grid or (Axis(self.axis_name, self.size, self.rank, self.group),)

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(a.name for a in self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        """Each axis's size by name, as JAX's ``Mesh.shape``."""
        return {a.name: a.size for a in self.axes}

    def axis(self, name: Optional[str] = None) -> Axis:
        """The axis ``name``; ``None``: the whole mesh as one axis."""
        if name is None:
            return Axis(",".join(self.axis_names), self.size, self.rank, self.group)
        for a in self.axes:
            if a.name == name:
                return a
        raise ValueError(f"mesh has no {name!r} axis: its axes are {self.axis_names}")


def make_mesh(num_devices: int = 0, axis_name: str = BATCH_AXIS) -> Mesh:
    """The mesh over every rank of the default group
    (``distributed.initialize`` first).  The mesh spans the whole group, so
    ``num_devices``, when given, must be the group's size."""
    size = distributed.world_size()
    if num_devices and num_devices != size:
        raise ValueError(f"requested {num_devices} ranks, the group has {size}")
    return Mesh(group=None, rank=distributed.rank(), size=size,
                device=distributed.group_device(), axis_name=axis_name)


def make_mesh_2d(batch_devices: int, second_devices: int,
                 second_axis: str = SAMPLE_AXIS) -> Mesh:
    """A ``(batch, second_axis)`` mesh over every rank of the default group:
    rank ``b * second_devices + s`` at ``(b, s)``.  ``batch_devices *
    second_devices`` must be the group's size.  Every rank makes every
    axis group, in the same order (``dist.new_group`` is collective), with
    the default group's backend and timeout; ``distributed.shutdown``
    destroys them with it."""
    size = distributed.world_size()
    if batch_devices < 1 or second_devices < 1 or batch_devices * second_devices != size:
        raise ValueError(
            f"requested {batch_devices} x {second_devices} ranks, the group has {size}")
    if second_axis == BATCH_AXIS:
        raise ValueError(f"the second axis cannot be named {BATCH_AXIS!r}")
    rank = distributed.rank()
    b, s = divmod(rank, second_devices)
    device = distributed.group_device()
    options = dict(backend=dist.get_backend(), timeout=distributed.group_timeout())
    columns = [dist.new_group([i * second_devices + j for i in range(batch_devices)], **options)
               for j in range(second_devices)]
    rows = [dist.new_group([i * second_devices + j for j in range(second_devices)], **options)
            for i in range(batch_devices)]
    return Mesh(group=None, rank=rank, size=size, device=device, axis_name=BATCH_AXIS,
                grid=(Axis(BATCH_AXIS, batch_devices, b, columns[s], root=s),
                      Axis(second_axis, second_devices, s, rows[b], root=b * second_devices)))


def local_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous share of ``n`` rows along the mesh's first
    (batch) axis; raises when ``n`` does not divide over it."""
    rows = mesh.axes[0]
    if n % rows.size:
        raise ValueError(f"{n} rows do not divide over {rows.size} ranks")
    per = n // rows.size
    return slice(rows.index * per, (rows.index + 1) * per)


def shard_batch(batch: Dict[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (every entry's leading axis),
    split over the batch axis: the ranks along a second axis keep the same
    rows."""
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


def flat_collective(tensors: List[torch.Tensor], mesh: Mesh, op: str,
                    axis: Optional[str] = None) -> List[torch.Tensor]:
    """One collective over ``tensors`` packed into a single flat buffer,
    among the ranks along ``axis`` (``None``: the whole mesh):
    ``"sum"`` or ``"mean"`` (``all_reduce`` of the sum, the mean divided by
    the number of those ranks) or ``"broadcast"`` (from the one at index
    0).  Returns views of the buffer with the inputs' shapes and strides,
    so a reduction over a result sums in the same order as over its input.
    Each input is packed in its memory order: the packing is one copy (the
    concatenation) and the unpacking none, whatever the inputs' strides."""
    if op not in ("sum", "mean", "broadcast"):
        raise ValueError(f"unknown collective {op!r}")
    along = mesh.axis(axis)
    ordered = [_in_memory_order(t.detach()) for t in tensors]
    flat = torch.cat([t.detach().reshape(-1) if view is None else view.view(-1)
                      for t, (view, _) in zip(tensors, ordered)])
    if op == "broadcast":
        dist.broadcast(flat, src=along.root, group=along.group)
    else:
        dist.all_reduce(flat, group=along.group)
        if op == "mean":
            flat /= along.size
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
