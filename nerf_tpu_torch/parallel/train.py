"""Data-parallel training and rendering over a process group (counterpart
of ``nerf_tpu/parallel/train.py``).

The ray batch is split over the mesh's ranks, the train state is the same
on every rank, and the gradients are averaged: each rank evaluates only
its own rows (through autograd over ``render_rays``, or through the fused
kernels of ``make_fused_loss_and_grads``), then one ``all_reduce`` of a
single flat buffer holding every gradient, divided by the number of
ranks, gives the global batch's mean gradient (the loss is a mean over
equal shards).  The aux values are averaged the same way, in one more
buffer, and ``grad_norm`` is taken after the average.  Adam then runs on
every rank on identical gradients, so the states stay equal without a
second collective.

Draws: every rank makes the *global* batch's indices and draws from
``step_generator(state)``, as the single-process step does, and keeps its
own rows.  The sharded step therefore equals the single-process step up to
the order of summation (bitwise at one rank).  JAX folds the key per shard
instead (``jax.random.fold_in(key, axis_index)``), which gives noise that is
only identically distributed; threefry and Philox never agree anyway, so
the two packages' stochastic steps are not compared draw for draw.

Rendering: each rank renders its contiguous rows of the (padded) ray
grid through ``render_rays`` in one call (no ``fused_eval``, as in JAX, so
the classic frame's fine stage runs K1-fwd rather than K4), writes them
into a zero buffer of the whole grid, and one ``all_reduce(SUM)`` gathers
the frame on every rank.  Only ``all_reduce`` and ``broadcast`` are used:
NCCL and gloo both run them on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.data.rays import RayBank
from nerf_tpu_torch.ops import cameras, sampling
from nerf_tpu_torch.parallel.mesh import Mesh, flat_collective, local_rows, replicate
# The module, not its names: train/loop.py imports this package (the
# watchdog) while it is itself being imported.
from nerf_tpu_torch.train import loop
from nerf_tpu_torch.train.state import TrainState, step_generator

Batch = Dict[str, torch.Tensor]
Aux = Dict[str, torch.Tensor]


def shard_draws(draws: sampling.StepDraws, mesh: Mesh) -> sampling.StepDraws:
    """This rank's rows of a global batch's draws."""
    rows = local_rows(draws.t_coarse.shape[0], mesh)
    return sampling.StepDraws(*(None if d is None else d[rows] for d in draws))


def make_parallel_loss_and_grads(model, render: RenderConfig, mesh: Mesh,
                                 segmentation_loss_weight: float = 0.0,
                                 fused: bool = False) -> Callable:
    """``fn(local_batch, local_draws) -> (loss, grads, aux)``: this rank's
    rows through autograd over ``render_rays`` (or, ``fused``, through
    ``make_fused_loss_and_grads``), then the gradients and the aux values
    averaged over the mesh, each set in one flat ``all_reduce``.  ``loss``
    and ``aux`` are the global batch's."""
    if fused:
        local = loop.make_fused_loss_and_grads(model, render, segmentation_loss_weight)
    else:
        loss_fn = loop.make_loss_fn(model, render, segmentation_loss_weight)

        def local(batch: Batch, draws: sampling.StepDraws):
            names, params = zip(*model.named_parameters())
            with torch.enable_grad():
                loss, aux = loss_fn(batch, draws)
            return loss, dict(zip(names, torch.autograd.grad(loss, params))), aux

    def fn(batch: Batch, draws: sampling.StepDraws):
        _, grads, aux = local(batch, draws)
        names, keys = list(grads), list(aux)
        grads = dict(zip(names, flat_collective([grads[k] for k in names], mesh, "mean")))
        aux = dict(zip(keys, flat_collective([aux[k] for k in keys], mesh, "mean")))
        return aux["loss"], grads, aux

    return fn


def _global_draws(state: TrainState, model, render: RenderConfig, local_n: int,
                  mesh: Mesh, device) -> sampling.StepDraws:
    """This rank's rows of the draws of a global batch of ``local_n``
    rows a rank, from ``step_generator(state)``."""
    draws = loop.draws_for_model(step_generator(state, device), model, render,
                            local_n * mesh.size, device)
    return shard_draws(draws, mesh)


def make_parallel_train_step(model, render: RenderConfig, mesh: Mesh,
                             segmentation_loss_weight: float = 0.0,
                             fused: bool = False) -> Callable:
    """One data-parallel step on this rank's rows of a global batch
    (``shard_batch``): ``step(state, local_batch, local_draws=None) ->
    aux``, updating ``state`` in place.  Without draws, the global batch's
    draws are made from ``step_generator(state)`` and this rank keeps its
    rows.  With ``randomly_sample=False`` and no density noise the step is
    the single-process step on the global batch up to summation order."""
    loss_and_grads = make_parallel_loss_and_grads(model, render, mesh,
                                                  segmentation_loss_weight, fused)

    def step(state: TrainState, batch: Batch,
             draws: Optional[sampling.StepDraws] = None) -> Aux:
        if draws is None:
            draws = _global_draws(state, model, render, batch["rays_o"].shape[0], mesh,
                                  batch["rays_o"].device)
        _, grads, aux = loss_and_grads(batch, draws)
        return loop._apply(state, grads, aux)

    return step


def make_parallel_sampling_train_step(model, render: RenderConfig, bank: RayBank,
                                      batch_size: int, mesh: Mesh,
                                      segmentation_loss_weight: float = 0.0,
                                      fused: bool = False) -> Callable:
    """The data-parallel step with the batch gather from the bank:
    ``step(state) -> aux``.  Every rank draws the global batch of
    ``batch_size`` rays and its draws from ``step_generator(state)`` (the
    single-process step's) and keeps its own rows."""
    rows = local_rows(batch_size, mesh)
    inner = make_parallel_train_step(model, render, mesh, segmentation_loss_weight, fused)

    def step(state: TrainState) -> Aux:
        batch, draws = loop._sample(state, bank, batch_size, render)
        return inner(state, {k: v[rows] for k, v in batch.items()}, shard_draws(draws, mesh))

    return step


def make_parallel_multi_step_train_fn(model, render: RenderConfig, bank: RayBank,
                                      batch_size: int, mesh: Mesh, num_steps: int,
                                      segmentation_loss_weight: float = 0.0,
                                      fused: bool = False) -> Callable:
    """``num_steps`` data-parallel steps: ``run(state) -> (state, aux)``,
    each aux entry stacked to ``[num_steps]``.  ``fused=True`` computes
    each rank's gradients through the fused kernels
    (``make_fused_loss_and_grads``: K1-fwd, K3 and K1-bwd for the reuse
    step, K2 for coarse-only, K6 for the mip family)."""
    return loop._multi_step(
        make_parallel_sampling_train_step(model, render, bank, batch_size, mesh,
                                          segmentation_loss_weight, fused),
        num_steps,
    )


def prepare_parallel_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Rank 0's train state on every rank (``mesh.replicate``)."""
    return replicate(state, mesh)


def make_parallel_render(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """``render_fn(rays_o, rays_d, states_x=None, states_d=None) -> out``:
    the global ray batch (its rows divisible over the mesh) rendered with
    this rank's rows in one ``render_rays`` call each, and the finest
    stage's rgb (the mip family: rgb ++ class log-probabilities) of every
    row gathered on every rank by one ``all_reduce`` of a zero-filled
    buffer."""

    @torch.no_grad()
    def render_fn(rays_o, rays_d, states_x=None, states_d=None):
        rows = local_rows(rays_o.shape[0], mesh)
        out = model.render_rays(
            rays_o[rows], rays_d[rows], render,
            states_x=None if states_x is None else states_x[rows],
            states_d=None if states_d is None else states_d[rows],
        )
        local = out.rgb[..., -1, :]
        if out.segmentation is not None:
            local = torch.cat([local, out.segmentation[..., -1, :]], dim=-1)
        full = torch.zeros((rays_o.shape[0], local.shape[-1]), dtype=local.dtype,
                           device=local.device)
        full[rows] = local
        (full,) = flat_collective([full], mesh, "sum")
        return full

    return render_fn


def render_image_sharded(model, mesh: Mesh, camera_o, camera_r, image_h: int, image_w: int,
                         focal_length: float, render: RenderConfig, states_x=None,
                         states_d=None) -> torch.Tensor:
    """A full-image render ``[B, H, W, C]`` with the pixels split over the
    mesh: the ray grid padded with zero rays to a multiple of the mesh's
    size, rendered by ``make_parallel_render`` and cut back; every rank
    returns the whole image."""
    rays_o, rays_d = cameras.pose_to_rays(camera_o, camera_r, image_h, image_w, focal_length)
    b = rays_o.shape[0]
    n = b * image_h * image_w
    rays_o, rays_d = rays_o.reshape(n, 3), rays_d.reshape(n, 3)

    def expand_states(states):
        if states is None:
            return None
        states = states[:, None, :].expand(b, image_h * image_w, states.shape[-1])
        return states.reshape(n, states.shape[-1])

    sx, sd = expand_states(states_x), expand_states(states_d)
    pad = (-n) % mesh.size

    def padded(x):
        return x if x is None or not pad else torch.nn.functional.pad(x, (0, 0, 0, pad))

    out = make_parallel_render(model, render, mesh)(padded(rays_o), padded(rays_d), padded(sx),
                                                    padded(sd))
    return out[:n].reshape(b, image_h, image_w, -1)
