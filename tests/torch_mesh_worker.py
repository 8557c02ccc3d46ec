"""One rank of the port's sample- and tensor-parallel runs on the CPU
(gloo), for ``test_torch_sample_parallel.py``, ``test_torch_tensor_parallel.py``
and ``test_torch_checkpoint_sharded.py``.  Imports no JAX: it reads its
inputs from ``<work>/inputs.npz`` and writes what it computed to
``<work>/rank<r>_<phase>.npz`` for the parent test to compare.

    python torch_mesh_worker.py <rank> <world> <init_method> <work> <phase>

``sp2`` (2 ranks: meshes 1x2 and 2x1) and ``sp4`` (2x2): the sample-parallel
renders of ``RENDERS`` on the parent's rays and weights; the
sample-parallel loss and gradients of ``SP_STEPS`` on ``train_inputs``;
3 Adam steps of each, their weights.

``tp2`` (1x2, batch x model) and ``tp4`` (2x2): the tensor-parallel renders
of ``TP_RENDERS``; the loss and gradients of ``TP_STEPS``; one SGD step on
the parent's batch (``TP_SGD``).  Tensors of a sharded model are written as
this rank's slices.

``ckpt`` (1x2): a tensor-parallel run of 6 Adam steps saving the sharded
layout at 3 and 6, and a run of 3 steps in a second directory (the run that
is killed).  ``resume``: that second directory resumed to 6, and the JAX
package's checkpoint (``<work>/jax``) restored onto the mesh.
"""

import os
import sys

import numpy as np
import torch

TINY = dict(normalize_position=6.0, x_positional_encoding_size=12, d_positional_encoding_size=8,
            hidden_size=32, trunk_blocks=(2, 2), view_branch_depth=1)
TRAIN = dict(hidden_size=32, normalize_position=6.0)
MIP = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
DETERMINISTIC = dict(randomly_sample=False, density_noise_std=0.0)
# case: RenderConfig keywords, on the parent's 64 rays and the JAX weights.
RENDERS = {
    "coarse": dict(num_coarse_samples=16, **DETERMINISTIC),
    "reevaluate": dict(num_coarse_samples=8, num_fine_samples=8, reuse_coarse_in_fine=False,
                       **DETERMINISTIC),
    "reuse": dict(num_coarse_samples=8, num_fine_samples=8, **DETERMINISTIC),
    "reuse_white": dict(num_coarse_samples=8, num_fine_samples=8, white_background=True,
                        **DETERMINISTIC),
}
TP_RENDERS = {
    "classic": ("classic", dict(num_coarse_samples=8, **DETERMINISTIC)),
    "hierarchical": ("classic", dict(num_coarse_samples=8, num_fine_samples=8, **DETERMINISTIC)),
    "mip": ("mip", dict(num_coarse_samples=8, **DETERMINISTIC)),
}
# Steps with stratified draws and density noise on ``train_inputs``.
STOCHASTIC = dict(num_coarse_samples=8, num_fine_samples=8, density_noise_std=0.5)
SP_STEPS = {
    "reuse": dict(STOCHASTIC),
    "reevaluate": dict(STOCHASTIC, reuse_coarse_in_fine=False),
}
TP_STEPS = {
    "classic": ("classic", dict(STOCHASTIC)),
    "mip": ("mip", dict(num_coarse_samples=8, density_noise_std=0.5)),
}
TP_SGD = dict(num_coarse_samples=8, **DETERMINISTIC)
LR = 0.1  # the SGD step of TP_SGD
MESHES = {"sp2": [(1, 2), (2, 1)], "sp4": [(2, 2)], "tp2": [(1, 2)], "tp4": [(2, 2)],
          "ckpt": [(1, 2)], "resume": [(1, 2)]}
TRAIN_RAYS = 32
CKPT_STEPS = 6


def train_model(family: str, use_pallas: bool = False, seed: int = 0):
    """The small model of the steps, its weights from ``seed``; the
    classic density head biased positive, so that no coarse bin is empty
    (a 1-ulp change of an empty bin's weight moves the fine samples)."""
    from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig

    gen = torch.Generator().manual_seed(seed)
    if family == "mip":
        return MipNeRF(MipNeRFConfig(**MIP, use_pallas=use_pallas), generator=gen, device="cpu")
    model = ClassicNeRF(ClassicNeRFConfig(**TRAIN, use_pallas=use_pallas), generator=gen,
                        device="cpu")
    with torch.no_grad():
        model.mlp.density.bias.fill_(0.5)
        model.mlp.density.weight.mul_(0.05)
    return model


def scene_bank():
    from nerf_tpu_torch.data import RayBank, synthesize_scene

    scene = synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96, device="cpu")
    return RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)


def train_inputs(model, render, bank, seed: int = 12):
    """A global batch of ``TRAIN_RAYS`` rays and its draws, from ``seed``."""
    from nerf_tpu_torch.train import loop

    gen = torch.Generator().manual_seed(seed)
    batch = bank.sample_batch(gen, TRAIN_RAYS)
    return batch, loop.draws_for_model(gen, model, render, TRAIN_RAYS, "cpu")


def render_model(inputs, family: str):
    """The JAX package's weights (the parent's) in a port model."""
    from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig

    if family == "mip":
        model = MipNeRF(MipNeRFConfig(**MIP), device="cpu")
        prefix = "mip_sd/"
    else:
        model = ClassicNeRF(ClassicNeRFConfig(**TINY), device="cpu")
        model.x_scales.copy_(torch.from_numpy(inputs["x_scales"]))
        model.d_scales.copy_(torch.from_numpy(inputs["d_scales"]))
        prefix = "sd/"
    model.mlp.load_state_dict({k[len(prefix):]: torch.from_numpy(inputs[k])
                               for k in inputs.files if k.startswith(prefix)})
    return model


def weights(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


def named(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.mlp.state_dict().items()}


def main(rank: int, world: int, init_method: str, work: str, phase: str) -> None:
    torch.set_num_threads(1)
    from nerf_tpu_torch.parallel import distributed, make_mesh_2d

    distributed.initialize(init_method=init_method, world_size=world, rank=rank, device="cpu",
                           timeout_s=120.0)
    out = {}
    try:
        inputs = np.load(os.path.join(work, "inputs.npz"))
        rays = [torch.from_numpy(inputs[k]) for k in ("rays_o", "rays_d")]
        for shape in MESHES[phase]:
            tag = f"{shape[0]}x{shape[1]}"
            if phase.startswith("sp"):
                mesh = make_mesh_2d(*shape)
                sample_parallel(mesh, tag, inputs, rays, out)
            elif phase.startswith("tp"):
                mesh = make_mesh_2d(*shape, second_axis="model")
                tensor_parallel(mesh, tag, inputs, rays, out)
            else:
                mesh = make_mesh_2d(*shape, second_axis="model")
                sharded_checkpoints(mesh, work, phase, out)
    finally:
        np.savez(os.path.join(work, f"rank{rank}_{phase}.npz"), **out)
        distributed.shutdown()


def sample_parallel(mesh, tag, inputs, rays, out) -> None:
    from nerf_tpu_torch import RenderConfig
    from nerf_tpu_torch.parallel import (
        make_sample_parallel_loss_and_grads,
        make_sample_parallel_render,
        make_sample_parallel_train_step,
        prepare_parallel_state,
        shard_batch,
        shard_draws,
    )
    from nerf_tpu_torch.train import create_train_state, loop

    model = render_model(inputs, "classic")
    for case, kwargs in RENDERS.items():
        out[f"{tag}/render/{case}"] = make_sample_parallel_render(
            model, RenderConfig(**kwargs), mesh)(*rays).numpy()
    bank = scene_bank()
    for case, kwargs in SP_STEPS.items():
        render = RenderConfig(**kwargs)
        model = train_model("classic", use_pallas=True)
        batch, draws = train_inputs(model, render, bank)
        loss, grads, _ = make_sample_parallel_loss_and_grads(model, render, mesh)(
            shard_batch(batch, mesh), shard_draws(draws, mesh))
        out[f"{tag}/{case}/loss"] = loss.numpy()
        out.update({f"{tag}/{case}/grad/{k}": g.numpy() for k, g in grads.items()})
        state = prepare_parallel_state(create_train_state(model, 1e-3, seed=4), mesh)
        step = make_sample_parallel_train_step(model, render, mesh)
        losses = []
        for _ in range(3):
            batch, draws = loop._sample(state, bank, TRAIN_RAYS, render)
            losses.append(step(state, shard_batch(batch, mesh), shard_draws(draws, mesh))["loss"])
        out[f"{tag}/{case}/losses"] = torch.stack(losses).numpy()
        out[f"{tag}/{case}/weights"] = weights(model)


def tensor_parallel(mesh, tag, inputs, rays, out) -> None:
    from nerf_tpu_torch import RenderConfig
    from nerf_tpu_torch.parallel import (
        make_tp_loss_and_grads,
        make_tp_render_rays,
        make_tp_train_step,
        prepare_tp_state,
        shard_batch,
        shard_draws,
    )
    from nerf_tpu_torch.train import create_train_state

    for case, (family, kwargs) in TP_RENDERS.items():
        out[f"{tag}/render/{case}"] = make_tp_render_rays(
            render_model(inputs, family), RenderConfig(**kwargs), mesh)(*rays).numpy()
    bank = scene_bank()
    for case, (family, kwargs) in TP_STEPS.items():
        render = RenderConfig(**kwargs)
        model = train_model(family)
        batch, draws = train_inputs(model, render, bank)
        state = prepare_tp_state(create_train_state(model, 1e-3), mesh)
        loss, grads, aux = make_tp_loss_and_grads(state.model, render, mesh)(
            shard_batch(batch, mesh), shard_draws(draws, mesh))
        out[f"{tag}/{case}/loss"] = loss.numpy()
        out[f"{tag}/{case}/grad_norm"] = aux["grad_norm"].numpy()
        out.update({f"{tag}/{case}/grad/{k}": g.numpy() for k, g in grads.items()})
    model = render_model(inputs, "classic")
    state = prepare_tp_state(create_train_state(
        model, optimizer=torch.optim.SGD(model.parameters(), lr=LR)), mesh)
    batch = {k: torch.from_numpy(inputs[k]) for k in ("rays_o", "rays_d", "pixels")}
    aux = make_tp_train_step(state.model, RenderConfig(**TP_SGD), mesh)(state,
                                                                       shard_batch(batch, mesh))
    out[f"{tag}/sgd/loss"] = aux["loss"].numpy()
    out.update({f"{tag}/sgd/weights/{k}": v for k, v in named(state.model).items()})


def sharded_checkpoints(mesh, work, phase, out) -> None:
    from nerf_tpu_torch import RenderConfig
    from nerf_tpu_torch.parallel import make_tp_train_step, prepare_tp_state, shard_batch
    from nerf_tpu_torch.train import checkpoint, create_train_state, loop

    render = RenderConfig(**STOCHASTIC)
    bank = scene_bank()

    def fresh():
        return prepare_tp_state(create_train_state(train_model("classic"), 1e-3, seed=2), mesh)

    def run(state, directory, until):
        step = make_tp_train_step(state.model, render, mesh)
        while state.step < until:
            batch, draws = loop._sample(state, bank, TRAIN_RAYS, render)
            step(state, shard_batch(batch, mesh), draws)
            if state.step % 3 == 0:
                checkpoint.save_checkpoint(directory, state, keep=1)
        return state

    def record(state, name):
        count, mu, nu = checkpoint.adam_state(state)
        out.update({f"{name}/weights/{k}": v for k, v in named(state.model).items()})
        out.update({f"{name}/mu/{k}": v.numpy() for k, v in mu.items()})
        out.update({f"{name}/nu/{k}": v.numpy() for k, v in nu.items()})
        out[f"{name}/step_count"] = np.asarray([state.step, count])

    if phase == "ckpt":
        record(run(fresh(), os.path.join(work, "straight"), CKPT_STEPS), "straight")
        run(fresh(), os.path.join(work, "restart"), 3)
        return
    state = fresh()
    assert checkpoint.restore_latest(os.path.join(work, "restart"), state) is state
    out["resumed_from"] = np.asarray(state.step)
    record(run(state, os.path.join(work, "restart"), CKPT_STEPS), "restart")
    state = fresh()
    checkpoint.restore_latest(os.path.join(work, "jax"), state)
    record(state, "from_jax")


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
