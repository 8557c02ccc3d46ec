"""Collectives that autograd differentiates, for the sample- and
tensor-parallel paths (JAX has no counterpart: ``shard_map`` transposes its
collectives itself).

Each is a ``torch.autograd.Function`` whose backward is its exact adjoint,
taking every rank's copy of a replicated result as an input of the whole
mesh's objective:

* ``all_reduce``: ``y = sum_r x_r`` on every rank; its adjoint is again
  the ``all_reduce(SUM)`` of the cotangents.
* ``all_gather``: this rank's block written into a zero-filled buffer,
  then ``all_reduce(SUM)``; its adjoint is the ``all_reduce(SUM)`` of the
  cotangent, of which this rank keeps its block.

So a rank's gradient is the gradient of the sum of every rank's loss.  A
loss held by ``k`` ranks (a pixel completed on every rank of an axis)
counts ``k`` times: each rank seeds its backward with its loss divided by
the number of ranks that hold it.  The backward of a collective is not
chosen per consumer (Megatron's identity-or-reduce pair): a replicated
value that only some ranks consume, as only the first sample shard
composites the coarse block, still sends every rank its share.

Every rank issues the same collectives in the same order, forward and
backward: the graph is the same on every rank, and what differs by rank is
data (an index, a mask), never a branch.  Only ``all_reduce`` runs, which
NCCL and gloo both take on CUDA tensors.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist


def _summed(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    out = x.contiguous().clone()  # contiguous() may return x itself
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, index, size, group):
        ctx.dim, ctx.block, ctx.group = dim, (index * x.shape[dim], x.shape[dim]), group
        shape = list(x.shape)
        shape[dim] *= size
        out = x.new_zeros(shape)
        out.narrow(dim, *ctx.block).copy_(x)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group).narrow(ctx.dim, *ctx.block), None, None, None, None


def all_reduce(x: torch.Tensor, axis) -> torch.Tensor:
    """The sum of ``x`` over the ranks along ``axis`` (a ``mesh.Axis``), on
    every one of them."""
    return _AllReduce.apply(x, axis.group)


def all_gather(x: torch.Tensor, axis, dim: int) -> torch.Tensor:
    """The blocks of ``x`` of every rank along ``axis`` (a ``mesh.Axis``),
    concatenated along ``dim`` in the ranks' order (JAX's ``all_gather``
    with ``tiled=True``), on every one of them."""
    return _AllGather.apply(x, dim, axis.index, axis.size, axis.group)
