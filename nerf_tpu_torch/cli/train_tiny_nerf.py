"""tiny_nerf trainer: the reference notebook's canonical run
(``examples/example.ipynb`` cells 3-9; counterpart of
``nerf_tpu/cli/train_tiny_nerf.py``).

Loads ``tiny_nerf_data.npz`` (or synthesizes the stand-in scene when the
file is absent), holds out the last view, and trains
``NeRF(normalize_position=6.0)`` on 1024-ray batches with Adam at lr
1e-4, 64 stratified samples in [2, 6] and density noise 1.0, with an eval
render and PSNR, metrics and a full-state checkpoint every
``--log-interval`` steps, then exports a reference-layout ``nerf.pth``.

    python -m nerf_tpu_torch.cli.train_tiny_nerf --use-pallas --logging-dir run
    python -m nerf_tpu_torch.cli.train_tiny_nerf --use-pallas --logging-dir run --resume
    torchrun --nproc_per_node=N -m nerf_tpu_torch.cli.train_tiny_nerf --use-pallas --data-parallel

Runs on the card unless ``--device cpu`` is given; ``--use-pallas``
trains and evaluates through the hand-written CUDA kernels.
``--data-parallel`` splits each batch over the ranks torchrun starts (one
GPU each; a group of one without torchrun, over gloo with ``--device
cpu``); rank 0 alone writes the logs, checkpoints and the export.
"""

from __future__ import annotations

import argparse
import json
import os


def data_parallel_mesh(args):
    """With ``--data-parallel``, the process group from torchrun's
    environment (a group of one without it) on ``--device`` and the mesh
    over it; else ``None``."""
    if not args.data_parallel:
        return None
    from nerf_tpu_torch.parallel import distributed, make_mesh

    distributed.initialize(device=None if args.device == "cuda" else args.device)
    return make_mesh()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--logging-dir", type=str, default="tiny_nerf_experiment")
    p.add_argument("--data", type=str, default="tiny_nerf_data.npz",
                   help="tiny_nerf npz; synthesized scene if missing")
    p.add_argument("--num-steps", type=int, default=40_000)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--normalize-position", type=float, default=6.0)
    p.add_argument("--learning-rate", type=float, default=1e-4)
    p.add_argument("--near-plane", type=float, default=2.0)
    p.add_argument("--far-plane", type=float, default=6.0)
    p.add_argument("--num-samples-per-ray", type=int, default=64)
    p.add_argument("--num-fine-samples", type=int, default=0)
    p.add_argument("--density-noise-std", type=float, default=1.0)
    p.add_argument("--log-interval", type=int, default=1000)
    p.add_argument("--use-pallas", action="store_true",
                   help="train and render through the hand-written CUDA kernels")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", action="store_true",
                   help="split the ray batch over the process group's ranks")
    # Synthetic-fallback scene size (used only when --data is absent).
    p.add_argument("--synthetic-views", type=int, default=24)
    p.add_argument("--synthetic-hw", type=int, default=100)
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
    from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig, TrainConfig
    from nerf_tpu_torch.data import RayBank, load_tiny_nerf, synthesize_scene
    from nerf_tpu_torch.parallel import is_coordinator
    from nerf_tpu_torch.train import Trainer
    from nerf_tpu_torch.train.checkpoint import export_reference_pth

    os.makedirs(args.logging_dir, exist_ok=True)
    if is_coordinator():
        with open(os.path.join(args.logging_dir, "params.json"), "w") as f:
            json.dump(vars(args), f)

    if os.path.exists(args.data):
        scene = load_tiny_nerf(args.data, device=args.device)
        print(f"loaded {args.data}: {tuple(scene.images.shape)}")
    else:
        print(f"{args.data} not found; synthesizing the offline scene")
        scene = synthesize_scene(num_views=args.synthetic_views,
                                 image_hw=args.synthetic_hw,
                                 focal=1.389 * args.synthetic_hw,
                                 num_samples=512, device=args.device)

    bank = RayBank.from_images(
        scene.images[:-1], scene.pose_o[:-1], scene.pose_r[:-1], scene.focal
    )
    model = ClassicNeRF(
        ClassicNeRFConfig(
            normalize_position=args.normalize_position,
            use_pallas=args.use_pallas,
        ),
        device=args.device,
    )
    render = RenderConfig(
        num_coarse_samples=args.num_samples_per_ray,
        num_fine_samples=args.num_fine_samples,
        near=args.near_plane,
        far=args.far_plane,
        density_noise_std=args.density_noise_std,
    )
    train_cfg = TrainConfig(
        batch_size=args.batch_size,
        learning_rate=args.learning_rate,
        num_steps=args.num_steps,
        log_interval=args.log_interval,
        eval_interval=args.log_interval,
        checkpoint_interval=args.log_interval,
        seed=args.seed,
    )
    trainer = Trainer(model, render, train_cfg, logging_dir=args.logging_dir, mesh=mesh)
    state = trainer.init_state(resume=args.resume)
    state = trainer.fit(bank, eval_scene=scene, state=state)
    if is_coordinator():
        export_reference_pth(os.path.join(args.logging_dir, "nerf.pth"), state.model)


if __name__ == "__main__":
    main()
