"""Sample parallelism: the samples of every ray split over a mesh axis
(counterpart of ``nerf_tpu/parallel/sample_parallel.py``).

On a ``(batch, sample)`` mesh (``make_mesh_2d(b, s)``) the rays are split
over ``batch`` and each rank evaluates the encoding and the MLP for only
its contiguous slice of every ray's samples.  The volume-rendering
integral is completed with collectives that move O(rays) values while the
O(rays x samples) MLP work stays split:

1. **Transmittance hand-off.**  Each shard forms its own exclusive
   cumulative product of ``alpha + 1e-10``, the shards gather one total a
   ray, and each scales by the product of the totals of the shards before
   it.
2. **Pixel sums.**  Each shard's partial ``sum w * sigmoid(c)``, depth and
   opacity are summed over the sample axis by one ``all_reduce``.

The hierarchical fine stage is sample-parallel in both formulations:

* re-evaluate (``reuse_coarse_in_fine=False``): the coarse stage gathers
  its weights, every shard resamples the whole ray from them (the same
  draws on every shard), and each evaluates its slice of the merged set;
* reuse (``reuse_coarse_in_fine=True``): the coarse stage gathers its raw
  noised density and color logits, the MLP runs on each shard's slice of
  the new fine samples, and the order-free union composite completes with
  the fine block's log-alpha totals handed off as above and the
  fine-before-coarse cross terms summed by one ``all_reduce``.  Only the
  first shard adds the (replicated) coarse block's terms: a mask, not a
  branch, so every rank runs the same collectives.

On the kernel path (``use_pallas``) each slice's ``model.forward`` runs
K1-fwd, and K1-bwd under autograd, on the weights packed once a call.

Gradients: the collectives are differentiable (``parallel/collectives.py``).
A loss is held by the ``s`` ranks of its sample axis; each rank seeds its
backward with its loss divided by the mesh's size (``s`` copies, and the
mean over the ``b`` batch shards), and one ``all_reduce`` of a flat buffer
over the whole mesh sums the parameters' gradients, so every rank holds
the global batch's mean gradient and Adam keeps the states equal.

Draws: every rank makes the global batch's draws from
``step_generator(state)`` (``parallel/train.py::_global_draws``), keeps its
rows along the batch axis, and each stage takes its columns of the density
noise; the fenceposts and the pdf uniforms are used whole.  At one batch
shard the sample-parallel step is therefore the single-process step on the
same draws, up to the regrouped sums.  JAX instead folds the noise key per
sample shard (``jax.random.fold_in(key, axis_index)``), noise only
identically distributed to the single-device step's.

``ClassicNeRF`` only, as in JAX: the mip family renders 63 intervals, too
few to split; it takes the data-parallel path (``parallel/train.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from nerf_tpu_torch.config import RenderConfig
from nerf_tpu_torch.models.nerf import ClassicNeRF, RenderOutput
from nerf_tpu_torch.ops import compositing, sampling
from nerf_tpu_torch.ops.kernels import classic_mlp
from nerf_tpu_torch.parallel.collectives import all_gather, all_reduce
from nerf_tpu_torch.parallel.mesh import BATCH_AXIS, SAMPLE_AXIS, Axis, Mesh, flat_collective, local_rows
from nerf_tpu_torch.parallel.train import _global_draws, shard_draws
from nerf_tpu_torch.train import loop
from nerf_tpu_torch.train.state import TrainState

Batch = Dict[str, torch.Tensor]


def _local_cols(size: int, sample: Axis) -> slice:
    """This shard's contiguous slice of ``size`` samples."""
    if size % sample.size:
        raise ValueError(f"sample count {size} not divisible by {sample.size} sample shards")
    per = size // sample.size
    return slice(sample.index * per, (sample.index + 1) * per)


def _carry_in(shard_total: torch.Tensor, sample: Axis, combine) -> torch.Tensor:
    """Every shard's per-ray total gathered, and those of the shards before
    this one combined (``torch.prod`` or ``torch.sum``) with the masked
    ones at the identity."""
    totals = all_gather(shard_total[None], sample, dim=0)  # [P, rays, ...]
    before = torch.arange(sample.size, device=totals.device) < sample.index
    before = before.reshape((-1,) + (1,) * shard_total.ndim)
    identity = 1.0 if combine is torch.prod else 0.0
    return combine(torch.where(before, totals, identity), dim=0)


def _pixel_sums(rgb, depth, acc, sample: Axis):
    """``(rgb, depth, acc)`` summed over the sample shards in one
    ``all_reduce``."""
    packed = all_reduce(torch.cat([rgb, depth[..., None], acc[..., None]], dim=-1), sample)
    return packed[..., :-2], packed[..., -2], packed[..., -1]


def _stage(model, weights, rays_o, rays_d, t_full, noise, states_x, states_d, sample: Axis,
           gather: Optional[str] = None):
    """One compositing stage on this shard's slice of ``t_full`` (the whole
    fencepost vector, the same on every shard).  Returns ``(rgb, depth,
    acc, gathered)``: the complete pixel sums, and with ``gather="weights"``
    the gathered weights ``[rays, S, 1]`` (the re-evaluate resampler's
    input), with ``gather="raw"`` the gathered noised density and color
    logits (the reuse union's coarse block)."""
    cols = _local_cols(t_full.shape[-1], sample)
    t_loc = t_full[..., cols]
    _, density, color = model.forward(rays_o, rays_d, t_loc, states_x, states_d, weights)
    density = density + noise[..., cols, None]
    # Interval lengths from the whole vector: the shard boundaries' are
    # exact, and the 1e10 far pad lands on the last shard.
    dists = compositing.distances_from_tvals(t_full, rays_d)[..., cols, :]
    alpha = torch.exp(-torch.relu(density) * dists)
    incl = torch.cumprod(alpha + 1e-10, dim=-2)
    excl = torch.cat([torch.ones_like(incl[..., :1, :]), incl[..., :-1, :]], dim=-2)
    carry = _carry_in(incl[..., -1, :], sample, torch.prod)  # [rays, 1]
    w = (1.0 - alpha) * (carry[..., None, :] * excl)
    rgb, depth, acc = _pixel_sums(torch.sum(w * torch.sigmoid(color), dim=-2),
                                  torch.sum(w[..., 0] * t_loc, dim=-1),
                                  torch.sum(w[..., 0], dim=-1), sample)
    gathered = None
    if gather == "weights":
        gathered = all_gather(w, sample, dim=-2)
    elif gather == "raw":
        gathered = all_gather(torch.cat([density, color], dim=-1), sample, dim=-2)
    return rgb, depth, acc, gathered


def _excl_cumsum(x: torch.Tensor) -> torch.Tensor:
    c = torch.cumsum(x, dim=-1)
    return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], dim=-1)


def _reuse_fine_stage(model, weights, rays_o, rays_d, t_coarse, dens_c, col_c, t_fine, noise_f,
                      states_x, states_d, sample: Axis):
    """The reuse formulation's fine stage with the new fine samples split:
    the coarse block's raw outputs arrive gathered (the same on every
    shard), the MLP runs on this shard's fine slice, and the order-free
    union composite (``compositing.weights_from_union_norm``'s sums)
    completes across the shards.  Returns the complete ``(rgb, depth,
    acc)``."""
    dist_c, dist_f = compositing.union_dists_sorted(t_coarse, t_fine, rays_d)
    alpha_c = torch.exp(-torch.relu(dens_c[..., 0]) * dist_c[..., 0])  # [rays, Sc]
    log_ac = torch.log(alpha_c + 1e-10)

    cols = _local_cols(t_fine.shape[-1], sample)
    t_f = t_fine[..., cols]
    _, dens_f, col_f = model.forward(rays_o, rays_d, t_f, states_x, states_d, weights)
    dens_f = dens_f + noise_f[..., cols, None]
    alpha_f = torch.exp(-torch.relu(dens_f[..., 0]) * dist_f[..., cols, 0])  # [rays, Sf/P]
    log_af = torch.log(alpha_f + 1e-10)
    incl = torch.cumsum(log_af, dim=-1)
    pref_f = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], dim=-1)
    pref_f = pref_f + _carry_in(incl[..., -1], sample, torch.sum)[..., None]

    # Coarse log-alphas at or before each local fine sample (coarse ties
    # sort first), and fine log-alphas strictly before each coarse sample:
    # a partial of this shard's fine slice, summed over the shards.
    cross_c = torch.sum(torch.where(t_coarse[..., None, :] <= t_f[..., :, None],
                                    log_ac[..., None, :], 0.0), dim=-1)  # [rays, Sf/P]
    cross_f = all_reduce(torch.sum(torch.where(t_f[..., None, :] < t_coarse[..., :, None],
                                               log_af[..., None, :], 0.0), dim=-1),
                         sample)  # [rays, Sc]
    w_f = (1.0 - alpha_f) * torch.exp(pref_f + cross_c)
    w_c = (1.0 - alpha_c) * torch.exp(_excl_cumsum(log_ac) + cross_f)

    first = float(sample.index == 0)  # the replicated coarse block counts once
    rgb = (torch.sum(w_f[..., None] * torch.sigmoid(col_f), dim=-2)
           + first * torch.sum(w_c[..., None] * torch.sigmoid(col_c), dim=-2))
    depth = torch.sum(w_f * t_f, dim=-1) + first * torch.sum(w_c * t_coarse, dim=-1)
    acc = torch.sum(w_f, dim=-1) + first * torch.sum(w_c, dim=-1)
    return _pixel_sums(rgb, depth, acc, sample)


def _check(model, render: RenderConfig, mesh: Mesh) -> Axis:
    """The mesh's sample axis, after refusing what the path cannot run: a
    model other than ``ClassicNeRF``, and sample counts that do not divide
    over the sample shards."""
    if not isinstance(model, ClassicNeRF):
        raise TypeError(
            f"sample parallelism runs ClassicNeRF only, not {type(model).__name__}; the mip "
            "family takes the data-parallel path (parallel.make_parallel_train_step)")
    sample = mesh.axis(SAMPLE_AXIS)
    sc, sf = render.num_coarse_samples, render.num_fine_samples
    counts = [sc] + ([] if sf == 0 else [sf if render.reuse_coarse_in_fine else sc + sf])
    for n in counts:
        _local_cols(n, sample)
    return sample


def _render_rays_sample_parallel(model, render: RenderConfig, mesh: Mesh, rays_o, rays_d,
                                 draws: sampling.StepDraws, states_x=None,
                                 states_d=None) -> RenderOutput:
    """This rank's rays rendered with their samples split over the mesh's
    sample axis: ``RenderOutput(rgb [rays, stages, 3], depth, acc)``,
    complete on every rank of the axis, the counterpart of
    ``ClassicNeRF.render_rays`` on the same ``draws`` (this rank's rows of
    ``sampling.draw_step``'s, whole columns)."""
    sample = _check(model, render, mesh)
    weights = None
    if model._uses_kernels():
        weights = classic_mlp.prepare_weights(model.mlp, dtype=model._compute_dtype())
    hierarchical = render.num_fine_samples > 0
    reuse = hierarchical and render.reuse_coarse_in_fine
    background = 1.0 if render.white_background else 0.0
    t_coarse = draws.t_coarse
    rgb, depth, acc, gathered = _stage(
        model, weights, rays_o, rays_d, t_coarse, draws.noise_c, states_x, states_d, sample,
        gather=None if not hierarchical else "raw" if reuse else "weights")
    stages = [rgb + (1.0 - acc[..., None]) * background]
    if hierarchical:
        if reuse:
            dens_c, col_c = gathered[..., :1], gathered[..., 1:]
            w_full = compositing.weights_from_density(
                dens_c, compositing.distances_from_tvals(t_coarse, rays_d))
        else:
            w_full = gathered
        t_mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
        t_fine = sampling.sample_pdf(None, t_mids, w_full[..., 1:-1, 0].detach(),
                                     render.num_fine_samples,
                                     randomly_sample=render.randomly_sample, u=draws.u)
        if reuse:
            rgb, depth, acc = _reuse_fine_stage(
                model, weights, rays_o, rays_d, t_coarse, dens_c, col_c, t_fine, draws.noise_f,
                states_x, states_d, sample)
        else:
            rgb, depth, acc, _ = _stage(
                model, weights, rays_o, rays_d, sampling.merge_samples(t_coarse, t_fine),
                draws.noise_f, states_x, states_d, sample)
        stages.append(rgb + (1.0 - acc[..., None]) * background)
    return RenderOutput(rgb=torch.stack(stages, dim=-2), depth=depth, acc=acc)


def make_sample_parallel_render(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """``render_fn(rays_o, rays_d) -> rgb [rays, 3]``: the global ray batch
    (its rows divisible over the batch axis) with this rank's rows rendered
    sample-parallel, and the finest stage's rgb of every row gathered on
    every rank by one ``all_reduce`` of a zero-filled buffer over the batch
    axis.  As JAX's renders without a key: no density noise, and the
    samples deterministic (``randomly_sample=False``)."""
    _check(model, render, mesh)
    noiseless = dataclasses.replace(render, density_noise_std=0.0)

    @torch.no_grad()
    def render_fn(rays_o, rays_d):
        n = rays_o.shape[0]
        draws = sampling.draw_step(None, noiseless, n, rays_o.device)
        rows = local_rows(n, mesh)
        out = _render_rays_sample_parallel(model, render, mesh, rays_o[rows], rays_d[rows],
                                           shard_draws(draws, mesh))
        full = torch.zeros((n, out.rgb.shape[-1]), dtype=out.rgb.dtype, device=out.rgb.device)
        full[rows] = out.rgb[..., -1, :]
        (full,) = flat_collective([full], mesh, "sum", axis=BATCH_AXIS)
        return full

    return render_fn


def make_sample_parallel_loss_and_grads(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """``fn(local_batch, local_draws) -> (loss, grads, aux)``: this rank's
    rows (``shard_batch``, ``shard_draws``) rendered sample-parallel under
    autograd, the stage-mean MSE (``train.loop.make_loss_fn``'s), and the
    gradients summed over the mesh in one flat ``all_reduce`` (the seed
    divided by the mesh's size: see the module's docstring).  ``loss`` and
    ``aux`` are the global batch's; ``grads`` is keyed by
    ``model.named_parameters()``."""
    _check(model, render, mesh)

    def fn(batch: Batch, draws: sampling.StepDraws):
        names, params = zip(*model.named_parameters())
        with torch.enable_grad():
            out = _render_rays_sample_parallel(model, render, mesh, batch["rays_o"],
                                               batch["rays_d"], draws, batch.get("states_x"),
                                               batch.get("states_d"))
            sq = (out.rgb - batch["pixels"][..., None, :]) ** 2
            loss = torch.mean(sq)
            grads = torch.autograd.grad(loss / mesh.size, params)
        grads = dict(zip(names, flat_collective(list(grads), mesh, "sum")))
        aux = {"loss": loss.detach(), "rgb_loss": loss.detach(),
               "fine_mse": torch.mean(sq[..., -1, :]).detach()}
        aux = dict(zip(aux, flat_collective(list(aux.values()), mesh, "mean", axis=BATCH_AXIS)))
        return aux["loss"], grads, aux

    return fn


def make_sample_parallel_train_step(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """One sample-parallel step on this rank's rows of a global batch
    (``shard_batch``): ``step(state, local_batch, local_draws=None) ->
    aux``, updating ``state`` (replicated: ``prepare_parallel_state``) in
    place.  Without draws, the global batch's draws are made from
    ``step_generator(state)`` and this rank keeps its rows."""
    loss_and_grads = make_sample_parallel_loss_and_grads(model, render, mesh)

    def step(state: TrainState, batch: Batch,
             draws: Optional[sampling.StepDraws] = None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = _global_draws(state, model, render, batch["rays_o"].shape[0], mesh,
                                  batch["rays_o"].device)
        _, grads, aux = loss_and_grads(batch, draws)
        return loop._apply(state, grads, aux)

    return step
