"""One rank of the port's two-rank data-parallel runs on the CPU (gloo),
for ``test_torch_multiprocess.py``.  Imports no JAX: it reads its inputs
from ``<work>/inputs.npz`` and writes what it computed to
``<work>/rank<r>_<phase>.npz`` for the parent test to compare.

    python torch_dp_worker.py <rank> <world> <init_method> <work> <phase>

``first``: (a) ``make_parallel_loss_and_grads`` and one
``make_parallel_train_step`` with SGD on the parent's weights and batch, and ``render_image_sharded`` at 15 x 13; ``replicate``
of each rank's own state; (b) the fused
steps (reuse, coarse-only, mip with the segmentation CE) through
``make_parallel_loss_and_grads`` on a global batch and its draws, then 3
fused ``Trainer``-style steps; (c) ``Trainer.fit`` to 6 steps straight,
and to 3 steps in a second directory.  ``resume``: (c) that directory
resumed to 6.
"""

import os
import sys

import numpy as np
import torch


def main(rank: int, world: int, init_method: str, work: str, phase: str) -> None:
    torch.set_num_threads(1)
    from nerf_tpu_torch import (
        ClassicNeRF,
        ClassicNeRFConfig,
        MipNeRF,
        MipNeRFConfig,
        RenderConfig,
        TrainConfig,
    )
    from nerf_tpu_torch.data import RayBank, synthesize_scene
    from nerf_tpu_torch.ops import sampling
    from nerf_tpu_torch.parallel import (
        distributed,
        host_local_slice,
        make_mesh,
        make_parallel_loss_and_grads,
        make_parallel_multi_step_train_fn,
        make_parallel_train_step,
        prepare_parallel_state,
        render_image_sharded,
        shard_batch,
        shard_draws,
    )
    from nerf_tpu_torch.train import Trainer, create_train_state, make_train_step

    distributed.initialize(init_method=init_method, world_size=world, rank=rank, device="cpu",
                           timeout_s=60.0)
    out = {}
    try:
        mesh = make_mesh(num_devices=world)
        scene = synthesize_scene(num_views=3, image_hw=12, focal=15.0, num_samples=96,
                                 with_labels=True, device="cpu")
        cfg = TrainConfig(batch_size=32, learning_rate=1e-3, num_steps=6, log_interval=3,
                          eval_interval=3, checkpoint_interval=3, seed=2)
        fit_render = RenderConfig(num_coarse_samples=8, num_fine_samples=8,
                                  density_noise_std=0.5)

        def trainer(logdir):
            model = ClassicNeRF(ClassicNeRFConfig(hidden_size=32, normalize_position=6.0,
                                                  use_pallas=True), device="cpu")
            return Trainer(model, fit_render, cfg, logging_dir=logdir, mesh=mesh)

        bank = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal)
        if phase == "resume":
            state = trainer(os.path.join(work, "restart")).fit(bank, eval_scene=scene)
            out["restart_weights"] = weights(state.model)
            return

        # (a) Against JAX's 2-device step and sharded render.
        inputs = np.load(os.path.join(work, "inputs.npz"))
        model = ClassicNeRF(ClassicNeRFConfig(hidden_size=32, normalize_position=6.0),
                            device="cpu")
        model.mlp.load_state_dict({k[3:]: torch.from_numpy(inputs[k]) for k in inputs.files
                                   if k.startswith("sd/")})
        model.x_scales.copy_(torch.from_numpy(inputs["x_scales"]))
        model.d_scales.copy_(torch.from_numpy(inputs["d_scales"]))
        render = RenderConfig(num_coarse_samples=8, randomly_sample=False, density_noise_std=0.0)
        image = render_image_sharded(model, mesh, torch.from_numpy(inputs["pose_o"]),
                                     torch.from_numpy(inputs["pose_r"]), 15, 13,
                                     float(inputs["focal"]), render)
        out["image"] = image.numpy()
        state = create_train_state(model, optimizer=torch.optim.SGD(model.parameters(), lr=0.1))
        state = prepare_parallel_state(state, mesh)
        batch = {k: torch.from_numpy(inputs[k]) for k in ("rays_o", "rays_d", "pixels")}
        draws = shard_draws(sampling.draw_step(None, render, len(batch["rays_o"]), "cpu"), mesh)
        _, grads, _ = make_parallel_loss_and_grads(model, render, mesh)(shard_batch(batch, mesh),
                                                                        draws)
        out.update({f"sgd_grads/{k}": g.numpy() for k, g in grads.items()})
        aux = make_parallel_train_step(model, render, mesh)(state, shard_batch(batch, mesh))
        out["sgd_loss"] = aux["loss"].numpy()
        out["sgd_weights"] = weights(model)
        sl = host_local_slice(32, 32)
        out["host_local_slice"] = np.asarray([sl.start, sl.stop])
        try:
            host_local_slice(33, 33)
        except ValueError:
            out["host_local_slice_refused"] = np.asarray(True)

        # replicate: rank r's own weights (seed r), moments and step after
        # one local step on its own rows, then rank 0's everywhere.
        own = create_train_state(ClassicNeRF(ClassicNeRFConfig(hidden_size=32,
                                                               normalize_position=6.0),
                                             generator=torch.Generator().manual_seed(rank),
                                             device="cpu"), 1e-3, seed=rank)
        make_train_step(own.model, render)(own, {k: v[16 * rank:16 * rank + 8]
                                                 for k, v in batch.items()})
        own.step += 5 * rank
        out["own_weights"] = weights(own.model)
        prepare_parallel_state(own, mesh)
        out["replicated_weights"] = weights(own.model)
        out["replicated_moments"] = torch.cat(
            [own.optimizer.state[p][k].reshape(-1) for p in own.model.parameters()
             for k in ("exp_avg", "exp_avg_sq", "step")]).numpy()
        out["replicated_step_seed"] = np.asarray([own.step, own.seed])

        # (b) The fused steps against the single-process step (the parent's).
        labelled = RayBank.from_images(scene.images, scene.pose_o, scene.pose_r, scene.focal,
                                       labels=scene.labels)
        for case, (family, n_fine, seg) in FUSED_CASES.items():
            gen = torch.Generator().manual_seed(11)
            if family == "mip":
                model = MipNeRF(MipNeRFConfig(**MIP, use_pallas=True), generator=gen,
                                device="cpu")
            else:
                model = ClassicNeRF(ClassicNeRFConfig(hidden_size=32, normalize_position=6.0,
                                                      use_pallas=True), generator=gen,
                                    device="cpu")
            render = RenderConfig(num_coarse_samples=8, num_fine_samples=n_fine,
                                  density_noise_std=0.5)
            gen = torch.Generator().manual_seed(12)
            batch = labelled.sample_batch(gen, 32)
            bbox = model.cfg.bbox_diagonal if family == "mip" else None
            draws = sampling.draw_step(gen, render, 32, "cpu", bbox_diagonal=bbox)
            if rank == 0:
                out.update({f"{case}/batch/{k}": v.numpy() for k, v in batch.items()})
                out.update({f"{case}/draws/{i}": d.numpy() for i, d in enumerate(draws)
                            if d is not None})
                out.update({f"{case}/sd/{k}": v.numpy().copy()  # before the steps below
                            for k, v in model.mlp.state_dict().items()})
            fn = make_parallel_loss_and_grads(model, render, mesh, seg, fused=True)
            loss, grads, _ = fn(shard_batch(batch, mesh), shard_draws(draws, mesh))
            out[f"{case}/loss"] = loss.numpy()
            out.update({f"{case}/grad/{k}": g.numpy() for k, g in grads.items()})
            state = prepare_parallel_state(create_train_state(model, 1e-3, seed=4), mesh)
            bank_case = labelled if family == "mip" else bank
            _, aux = make_parallel_multi_step_train_fn(model, render, bank_case, 32, mesh, 3, seg,
                                                       fused=True)(state)
            out[f"{case}/losses"] = aux["loss"].numpy()
            out[f"{case}/weights"] = weights(model)

        # (c) Trainer.fit straight to 6, and to 3 (the run that is killed).
        state = trainer(os.path.join(work, "straight")).fit(bank, eval_scene=scene)
        out["straight_weights"] = weights(state.model)
        t = trainer(os.path.join(work, "restart"))
        t.fit(bank, eval_scene=scene, num_steps=3)
    finally:
        np.savez(os.path.join(work, f"rank{rank}_{phase}.npz"), **out)
        distributed.shutdown()


MIP = dict(hidden_size=32, num_hidden_layers=3, encoding_size=8, segmentation_outputs=5)
# case: (family, fine samples, segmentation weight)
FUSED_CASES = {"reuse": ("classic", 8, 0.0), "coarse": ("classic", 0, 0.0),
               "mip": ("mip", 0, 0.1)}


def weights(model) -> np.ndarray:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).numpy()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
