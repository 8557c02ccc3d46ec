"""Latent-conditioned ("conditional NeRF") trainer: the reference's
``train_conditional_nerf.py`` (counterpart of
``nerf_tpu/cli/train_conditional.py``).

The reference's flags (``train_conditional_nerf.py:20-47``) and data
contract: a pickle of ``{images, poses, states}`` with 6-DoF poses (xyz
translation ++ viewing direction, ``:71-87``), the focal length
``W * (focal_mm / ccd_width_mm)`` (``:79-80``), the states divided by pi
(``:84``) and appended to the position inputs (``density_inputs = 3 +
state width``), the last image held out (``:89-95``), Adam and the
stage-mean MSE (``:114-135``), an eval render and PSNR with ``.npy`` dumps
(``:137-174``) and a ``model.pth`` export (``:160-161``); plus full-state
checkpoints with ``--resume`` and JSONL metrics.

    python -m nerf_tpu_torch.cli.train_conditional --data data_for_nerf.pkl --use-pallas
    torchrun --nproc_per_node=N -m nerf_tpu_torch.cli.train_conditional --data-parallel

Runs on the card unless ``--device cpu`` is given; ``--use-pallas``
trains and evaluates through the hand-written CUDA kernels.
``--data-parallel`` splits each batch over the ranks torchrun starts, as
``train_tiny_nerf``'s does; rank 0 alone writes the logs, checkpoints and
the export.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np

from nerf_tpu_torch.cli.train_tiny_nerf import data_parallel_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    # The reference's flags (train_conditional_nerf.py:20-47).
    p.add_argument("--logging-dir", type=str, default="experiment")
    p.add_argument("--data", type=str, default="examples/data_for_nerf.pkl")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--camera-focal-length", type=float, default=50.0)
    p.add_argument("--camera-ccd-width", type=float, default=36.0)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--normalize-position", type=float, default=20.0)
    p.add_argument("--learning-rate", type=float, default=0.0001)
    p.add_argument("--near-plane", type=float, default=0.0)
    p.add_argument("--far-plane", type=float, default=20.0)
    p.add_argument("--num-samples-per-ray", type=int, default=64)
    p.add_argument("--density-noise-std", type=float, default=1.0)
    p.add_argument("--log-interval", type=int, default=1000)
    # Framework extensions.
    p.add_argument("--num-fine-samples", type=int, default=0)
    p.add_argument("--use-pallas", action="store_true",
                   help="train and render through the hand-written CUDA kernels")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="split the ray batch over the process group's ranks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> None:
    from nerf_tpu_torch.parallel import distributed

    args = build_parser().parse_args(argv)
    mesh = data_parallel_mesh(args)
    try:
        train(args, mesh)
    finally:
        if mesh is not None:
            distributed.shutdown()


def train(args, mesh) -> None:
    import torch

    from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig, TrainConfig
    from nerf_tpu_torch.data import RayBank, SceneData
    from nerf_tpu_torch.ops import cameras
    from nerf_tpu_torch.parallel import is_coordinator
    from nerf_tpu_torch.train import Trainer
    from nerf_tpu_torch.train.checkpoint import export_reference_pth

    os.makedirs(args.logging_dir, exist_ok=True)
    if is_coordinator():
        with open(os.path.join(args.logging_dir, "params.json"), "w") as f:
            json.dump(vars(args), f)

    with open(args.data, "rb") as f:
        payload = pickle.load(f)
    images = np.asarray(payload["images"], np.float32)
    poses = np.asarray(payload["poses"], np.float32)  # [B, 6]: xyz ++ dir
    states = np.asarray(payload["states"], np.float32)

    h, w = images[0].shape[:2]
    focal = float(w) * (args.camera_focal_length / args.camera_ccd_width)
    states = states / np.pi  # reference :84

    def on_device(a):
        return torch.as_tensor(a, device=args.device)

    pose_o = on_device(poses[:, :3])
    pose_r = cameras.direction_to_rotation_matrix(on_device(poses[:, 3:]))
    scene = SceneData(images=on_device(images), pose_o=pose_o, pose_r=pose_r, focal=focal,
                      states_x=on_device(states))
    bank = RayBank.from_images(
        scene.images[:-1], pose_o[:-1], pose_r[:-1], focal, states_x=scene.states_x[:-1],
    )

    cfg = ClassicNeRFConfig(
        normalize_position=args.normalize_position,
        density_inputs=3 + states.shape[-1],
        use_pallas=args.use_pallas,
    )
    model = ClassicNeRF(cfg, device=args.device)
    render = RenderConfig(
        num_coarse_samples=args.num_samples_per_ray,
        num_fine_samples=args.num_fine_samples,
        near=args.near_plane,
        far=args.far_plane,
        density_noise_std=args.density_noise_std,
    )
    steps_per_epoch = max(1, bank.num_rays // args.batch_size)
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        num_steps=args.epochs * steps_per_epoch,
        density_noise_std=args.density_noise_std,
        log_interval=args.log_interval,
        eval_interval=args.log_interval,
        checkpoint_interval=args.log_interval,
        seed=args.seed,
    )
    trainer = Trainer(model, render, train_cfg, logging_dir=args.logging_dir, mesh=mesh)
    state = trainer.init_state(resume=args.resume)
    state = trainer.fit(bank, eval_scene=scene, state=state, eval_view=-1)
    # Reference-compatible weight export (torch.save layout, :160-161).
    if is_coordinator():
        export_reference_pth(os.path.join(args.logging_dir, "model.pth"), state.model)


if __name__ == "__main__":
    main()
