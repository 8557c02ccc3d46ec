"""Tensor parallelism: the MLP's hidden width split over a mesh axis
(counterpart of ``nerf_tpu/parallel/tensor_parallel.py``).

The partition specs are JAX's, over the leaves of JAX's parameter tree
(``w`` as ``[in, out]``): every trunk Linear is column-sharded (its output
features over ``MODEL_AXIS``, with the LayerNorm scale and bias that follow
them), and the heads are row-sharded (their contraction over the split
hidden width) with their biases replicated.  Torch keeps a Linear's weight
as ``[out, in]``, so a trunk weight is split along its dim 0 and a head
weight along its dim 1.

JAX leaves the collectives to XLA's partitioner.  Here ``shard_params``
replaces the model's MLP by a ``TensorParallelMLP`` that holds this rank's
slices and places them by hand (``parallel/collectives.py``, so autograd
differentiates them):

* each trunk layer takes the whole width (the hidden activations gathered
  over the model axis, with the skip's or the view branch's encodings
  concatenated as ``models/mlp.py`` does), applies this rank's output
  columns, and takes the LayerNorm's statistics over the whole hidden
  width with two ``all_reduce``s (the mean, then the centred sum of
  squares);
* each head contracts this rank's slice of the width, and one
  ``all_reduce`` completes it before the replicated bias is added once.

``render_rays`` and the losses then run unchanged on the sharded model,
on the plain path only: the fused kernels take whole weight matrices, and
a ``use_pallas`` model is refused, as JAX refuses them
(``_require_xla_path``).  The ``(batch, model)`` mesh composes data
parallelism: the ranks along the model axis share their rows and draws.

Gradients: a rank's loss is held by the ``m`` ranks of its model axis.
Each rank seeds its backward with its loss divided by the mesh's size
(``m`` copies, and the mean over the batch shards); a split leaf's
gradient is then complete on its rank after a sum over the batch axis,
and a replicated leaf's is summed over the whole mesh.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from nerf_tpu_torch.config import ClassicNeRFConfig, MipNeRFConfig, RenderConfig
from nerf_tpu_torch.models.mlp import LAYER_NORM_EPS
from nerf_tpu_torch.ops import sampling
from nerf_tpu_torch.parallel.collectives import all_gather, all_reduce
from nerf_tpu_torch.parallel.mesh import BATCH_AXIS, MODEL_AXIS, Mesh, flat_collective, local_rows, replicate
from nerf_tpu_torch.parallel.train import _global_draws
from nerf_tpu_torch.train import checkpoint, loop
from nerf_tpu_torch.train.state import TrainState

Params = Dict[str, object]


def P(*axes) -> tuple:
    """A partition spec: one mesh axis name (or ``None``) per dimension of
    a leaf in JAX's layout; equal to JAX's ``PartitionSpec`` of the same
    axes."""
    return tuple(axes)


def _layer_specs(axis: str) -> Params:
    """One trunk layer: the Linear's output features, and the LayerNorm's
    parameters with them, over ``axis``."""
    return {
        "linear": {"w": P(None, axis), "b": P(axis)},
        "ln": {"scale": P(axis), "bias": P(axis)},
    }


def classic_param_specs(cfg: ClassicNeRFConfig, axis: str = MODEL_AXIS) -> Params:
    """The specs of JAX's ``init_classic_mlp`` tree: trunk Linears
    column-sharded, the density and color heads row-sharded."""
    specs: Params = {
        "block_0": [_layer_specs(axis) for _ in range(cfg.trunk_blocks[0])],
        "block_1": [_layer_specs(axis) for _ in range(cfg.trunk_blocks[1])],
        "density": {"w": P(axis, None), "b": P()},
        "color": {"w": P(axis, None), "b": P()},
    }
    if cfg.use_viewdirs:
        specs["block_2"] = [_layer_specs(axis) for _ in range(cfg.view_branch_depth)]
    return specs


def mip_param_specs(cfg: MipNeRFConfig, axis: str = MODEL_AXIS) -> Params:
    """The specs of JAX's ``init_mip_mlp`` tree."""
    return {
        "layers": [_layer_specs(axis) for _ in range(cfg.num_hidden_layers)],
        "out": {"w": P(axis, None), "b": P()},
    }


def param_specs_for(model) -> Params:
    cfg = model.cfg
    if isinstance(cfg, ClassicNeRFConfig):
        return classic_param_specs(cfg)
    if isinstance(cfg, MipNeRFConfig):
        return mip_param_specs(cfg)
    raise TypeError(f"no tensor-parallel specs for {type(cfg).__name__}")


def _require_xla_path(model) -> None:
    if getattr(model.cfg, "use_pallas", False):
        raise ValueError(
            "tensor parallelism splits the hidden width by hand and needs the plain MLP "
            "path; construct the model with use_pallas=False"
        )


Layout = Dict[str, Tuple[Tuple[int, ...], np.ndarray, bool]]


def _layout(tree: Params, specs: Params, mesh: Mesh) -> Layout:
    """By JAX leaf path: the leaf's global shape, this rank's block of it
    (``[dims, 2]`` bounds in JAX's layout) and whether this rank writes the
    block to a sharded checkpoint: the one at index 0 along every axis the
    leaf is not split over (JAX's ``replica_id == 0``)."""
    out = {}
    for (path, leaf), (spec_path, spec) in zip(checkpoint._flatten(tree),
                                                checkpoint._flatten(specs)):
        if path != spec_path:
            raise ValueError(f"the specs do not mirror the parameter tree: {path} vs {spec_path}")
        shape = tuple(np.shape(leaf))
        bounds = np.zeros((len(shape), 2), dtype=np.int64)
        for d, n in enumerate(shape):
            name = spec[d] if d < len(spec) else None
            if name is None:
                bounds[d] = (0, n)
                continue
            axis = mesh.axis(name)
            if n % axis.size:
                raise ValueError(f"{path}: {n} does not divide over {axis.size} {name!r} shards")
            per = n // axis.size
            bounds[d] = (axis.index * per, (axis.index + 1) * per)
        writes = all(a.index == 0 for a in mesh.axes if a.name not in spec)
        out[path] = (shape, bounds, writes)
    return out


def _local(model, named: Dict[str, torch.Tensor], layout: Layout) -> Dict[str, torch.Tensor]:
    """This rank's slices of tensors keyed like the full MLP's
    ``state_dict`` (through JAX's tree, where the specs are stated), on
    the tensors' device."""
    device = next(iter(named.values())).device
    tree = checkpoint._to_jax_tree(model, named)
    leaves = (leaf[tuple(slice(a, b) for a, b in layout[path][1])]
              for path, leaf in checkpoint._flatten(tree))
    local = checkpoint._from_jax_tree(model, checkpoint._refill(tree, leaves))
    return {k: v.to(device) for k, v in local.items()}


class _Affine(nn.Module):
    """A Linear's or a LayerNorm's parameters: this rank's slice."""

    def __init__(self, weight: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)


class TensorParallelMLP(nn.Module):
    """This rank's slices of a classic or mip MLP, with the full MLP's
    ``forward`` signature and ``state_dict`` keys (the tensors sliced).
    ``jax_layout`` holds each leaf's block (``_layout``) for the sharded
    checkpoint; ``replicated`` names the parameters every rank holds
    whole (the heads' biases)."""

    def __init__(self, model, mesh: Mesh):
        super().__init__()
        cfg = self.cfg = model.cfg
        self.axis = mesh.axis(MODEL_AXIS)
        if cfg.hidden_size % self.axis.size:
            raise ValueError(f"hidden size {cfg.hidden_size} does not divide over "
                             f"{self.axis.size} model shards")
        full = {k: v.detach() for k, v in model.mlp.state_dict().items()}
        self.jax_layout = _layout(checkpoint._to_jax_tree(model, full), param_specs_for(model),
                                  mesh)
        sd = _local(model, full, self.jax_layout)

        def affine(key: str) -> _Affine:
            return _Affine(sd[f"{key}.weight"], sd[f"{key}.bias"])

        def trunk(name: str, depth: int) -> nn.Sequential:
            # The full MLP's Sequential indices: Linear at 3i, then ReLU and
            # LayerNorm (classic) or LayerNorm and ReLU (mip).
            layers = []
            for i in range(depth):
                linear = affine(f"{name}.{3 * i}")
                if isinstance(cfg, MipNeRFConfig):
                    layers += [linear, affine(f"{name}.{3 * i + 1}"), nn.ReLU()]
                else:
                    layers += [linear, nn.ReLU(), affine(f"{name}.{3 * i + 2}")]
            return nn.Sequential(*layers)

        if isinstance(cfg, MipNeRFConfig):
            n = cfg.num_hidden_layers
            self.prediction_heads = nn.Sequential(*trunk("prediction_heads", n),
                                                  affine(f"prediction_heads.{3 * n}"))
            self.replicated = (f"prediction_heads.{3 * n}.bias",)
        else:
            self.block_0 = trunk("block_0", cfg.trunk_blocks[0])
            self.block_1 = trunk("block_1", cfg.trunk_blocks[1])
            self.density = affine("density")
            if cfg.use_viewdirs:
                self.block_2 = trunk("block_2", cfg.view_branch_depth)
            self.color = affine("color")
            self.replicated = ("density.bias", "color.bias")

    def _gather(self, h: torch.Tensor) -> torch.Tensor:
        return all_gather(h, self.axis, dim=-1)

    def _layer_norm(self, x: torch.Tensor, norm: _Affine) -> torch.Tensor:
        """LayerNorm over the whole hidden width of this rank's columns:
        two passes, so the variance is the centred one."""
        n = self.cfg.hidden_size
        mean = all_reduce(torch.sum(x, dim=-1, keepdim=True), self.axis) / n
        centred = x - mean
        var = all_reduce(torch.sum(centred * centred, dim=-1, keepdim=True), self.axis) / n
        return centred * torch.rsqrt(var + LAYER_NORM_EPS) * norm.weight + norm.bias

    def _trunk(self, block: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """The classic order, Linear -> ReLU -> LayerNorm, on the whole
        width ``x``; returns this rank's columns."""
        layers = list(block)
        for i in range(0, len(layers), 3):
            if i:
                x = self._gather(x)
            x = F.linear(x, layers[i].weight, layers[i].bias)
            x = self._layer_norm(torch.relu(x), layers[i + 2])
        return x

    def _head(self, head: _Affine, h: torch.Tensor) -> torch.Tensor:
        return all_reduce(F.linear(h, head.weight), self.axis) + head.bias

    def forward(self, x: torch.Tensor, d_enc: torch.Tensor = None):
        cfg = self.cfg
        if isinstance(cfg, MipNeRFConfig):
            layers = list(self.prediction_heads)
            for i in range(0, len(layers) - 1, 3):
                if i:
                    x = self._gather(x)
                x = F.linear(x, layers[i].weight, layers[i].bias)
                x = torch.relu(self._layer_norm(x, layers[i + 1]))
            out = self._head(layers[-1], x)
            c = cfg.color_outputs
            return out[..., :1], out[..., 1:1 + c], out[..., 1 + c:]
        h = self._trunk(self.block_0, x)
        h = self._trunk(self.block_1, torch.cat([self._gather(h), x], dim=-1))
        density = self._head(self.density, h)
        if cfg.use_viewdirs:
            if d_enc is None:
                raise ValueError("use_viewdirs=True requires encoded directions")
            h = self._trunk(self.block_2, torch.cat([self._gather(h), d_enc], dim=-1))
        return density, self._head(self.color, h)


def shard_params(model, mesh: Mesh):
    """A copy of ``model`` whose MLP is this rank's ``TensorParallelMLP``
    over the mesh's ``MODEL_AXIS`` (the hidden size must divide over it).
    ``model`` itself is unchanged."""
    _require_xla_path(model)
    if isinstance(model.mlp, TensorParallelMLP):
        raise ValueError("the model is already tensor parallel")
    mlp = TensorParallelMLP(model, mesh)
    sharded = copy.deepcopy(model)
    sharded.mlp = mlp
    return sharded


def _require_sharded(model) -> None:
    _require_xla_path(model)
    if not isinstance(getattr(model, "mlp", None), TensorParallelMLP):
        raise ValueError("the model is not tensor parallel: prepare the train state with "
                         "prepare_tp_state (or the model with shard_params)")


def prepare_tp_state(state: TrainState, mesh: Mesh) -> TrainState:
    """A train state for tensor parallelism: rank 0's ``state`` brought to
    every rank (``mesh.replicate``, in place), then a new state whose model
    is ``shard_params(state.model)`` and whose optimizer (the same class
    and settings) holds the per-parameter state sliced like the
    parameters (Adam's moments), its scalars (the count) replicated."""
    replicate(state, mesh)
    model = shard_params(state.model, mesh)
    opt = state.optimizer
    new_opt = type(opt)(model.parameters(), **opt.defaults)
    new_opt.param_groups[0].update({k: v for k, v in opt.param_groups[0].items() if k != "params"})
    full = dict(state.model.mlp.named_parameters())
    local = dict(model.mlp.named_parameters())
    per_param = {key for p in full.values() for key, v in opt.state.get(p, {}).items()
                 if torch.is_tensor(v) and v.shape == p.shape}
    sliced = {key: _local(state.model, {n: opt.state[p][key] for n, p in full.items()},
                          model.mlp.jax_layout)
              for key in per_param}
    for name, p in full.items():
        if p in opt.state:
            new_opt.state[local[name]] = {
                key: sliced[key][name] if key in sliced else
                (v.clone() if torch.is_tensor(v) else v)
                for key, v in opt.state[p].items()
            }
    return TrainState(step=state.step, model=model, optimizer=new_opt, seed=state.seed)


def make_tp_render_rays(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """``render_fn(rays_o, rays_d) -> rgb [rays, 3]``: the global ray batch
    (its rows divisible over the batch axis) with this rank's rows rendered
    through the tensor-parallel MLP (``model`` itself when it is sharded,
    else ``shard_params(model)``), and the finest stage's rgb of every row
    gathered on every rank over the batch axis.  The render is
    deterministic (``randomly_sample=False``), as JAX's renders without a
    key."""
    _require_xla_path(model)
    sharded = model if isinstance(model.mlp, TensorParallelMLP) else shard_params(model, mesh)

    @torch.no_grad()
    def render_fn(rays_o, rays_d):
        n = rays_o.shape[0]
        rows = local_rows(n, mesh)
        out = sharded.render_rays(rays_o[rows], rays_d[rows], render)
        full = torch.zeros((n, out.rgb.shape[-1]), dtype=out.rgb.dtype, device=out.rgb.device)
        full[rows] = out.rgb[..., -1, :]
        (full,) = flat_collective([full], mesh, "sum", axis=BATCH_AXIS)
        return full

    return render_fn


def make_tp_loss_and_grads(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """``fn(local_batch, local_draws) -> (loss, grads, aux)`` for a
    tensor-parallel ``model`` (``prepare_tp_state``'s): the loss of
    ``train.loop.make_loss_fn`` with the segmentation weight 0.0 that JAX's
    step fixes, this rank's gradients (its slices; see the module's
    docstring), and ``aux`` the global batch's, with the gradients' global
    norm as ``grad_norm``."""
    _require_sharded(model)
    loss_fn = loop.make_loss_fn(model, render, 0.0)
    replicated = {f"mlp.{k}" for k in model.mlp.replicated}

    def fn(batch, draws: sampling.StepDraws):
        names, params = zip(*model.named_parameters())
        with torch.enable_grad():
            loss, aux = loss_fn(batch, draws)
            grads = torch.autograd.grad(loss / mesh.size, params)
        grads = dict(zip(names, flat_collective(list(grads), mesh, "sum", axis=BATCH_AXIS)))
        split = [k for k in names if k not in replicated]
        whole = [k for k in names if k in replicated]
        split_sq = sum(torch.sum(grads[k] * grads[k]) for k in split) + torch.zeros(
            1, device=loss.device)
        *summed, split_sq = flat_collective([grads[k] for k in whole] + [split_sq], mesh, "sum",
                                            axis=MODEL_AXIS)
        grads.update(zip(whole, summed))
        keys = list(aux)
        aux = dict(zip(keys, flat_collective([aux[k].detach() for k in keys], mesh, "mean",
                                             axis=BATCH_AXIS)))
        aux["grad_norm"] = torch.sqrt(split_sq[0] + sum(torch.sum(g * g) for g in summed))
        return aux["loss"], grads, aux

    return fn


def make_tp_train_step(model, render: RenderConfig, mesh: Mesh) -> Callable:
    """One tensor-parallel step on this rank's rows of a global batch
    (``shard_batch``): ``step(state, local_batch, local_draws=None) ->
    aux``, updating ``state`` in place.  ``state`` and ``model`` come from
    ``prepare_tp_state`` (a model whose MLP was never sharded is refused,
    where JAX would run it replicated); Adam's moments stay sharded with
    their parameters.  Without draws, the global batch's draws are made
    from ``step_generator(state)`` and this rank keeps its rows."""
    loss_and_grads = make_tp_loss_and_grads(model, render, mesh)

    def step(state: TrainState, batch, draws=None) -> Dict[str, torch.Tensor]:
        if draws is None:
            draws = _global_draws(state, model, render, batch["rays_o"].shape[0], mesh,
                                  batch["rays_o"].device)
        _, grads, aux = loss_and_grads(batch, draws)
        norm = aux.pop("grad_norm")
        aux = loop._apply(state, grads, aux)
        aux["grad_norm"] = norm
        return aux

    return step
