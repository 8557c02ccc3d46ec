"""Render CLI: a camera orbit of novel views from a trained checkpoint,
written as PNG files (counterpart of ``nerf_tpu/cli/render.py``).  Loads
either a full-state ``checkpoint_*.npz`` (of either package) or a
reference-layout ``.pth``.

    python -m nerf_tpu_torch.cli.render --checkpoint run/checkpoint_40000.npz \\
        --device cuda --use-pallas --num-fine-samples 128
"""

from __future__ import annotations

import argparse
import os
import struct
import zlib

import numpy as np


def write_png(path: str, arr: np.ndarray) -> None:
    """Dependency-free 8-bit RGB PNG writer."""
    a = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    h, w, _ = a.shape
    raw = b"".join(b"\x00" + a[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--checkpoint", type=str, required=True,
                   help=".pth (reference layout) or checkpoint_*.npz")
    p.add_argument("--output-dir", type=str, default="renders")
    p.add_argument("--image-size", type=int, default=100)
    p.add_argument("--focal", type=float, default=138.89)
    p.add_argument("--num-views", type=int, default=8)
    p.add_argument("--radius", type=float, default=4.0)
    p.add_argument("--elevation", type=float, default=0.5)
    p.add_argument("--near-plane", type=float, default=2.0)
    p.add_argument("--far-plane", type=float, default=6.0)
    p.add_argument("--num-samples-per-ray", type=int, default=64)
    p.add_argument("--num-fine-samples", type=int, default=0)
    p.add_argument("--normalize-position", type=float, default=6.0)
    p.add_argument("--use-pallas", action="store_true",
                   help="render through the hand-written CUDA kernels")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return p


def main(argv=None) -> None:
    from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig
    from nerf_tpu_torch.data.scenes import spherical_poses
    from nerf_tpu_torch.train import checkpoint as ckpt_lib
    from nerf_tpu_torch.train.state import create_train_state
    from nerf_tpu_torch.utils.pth_import import load_classic_checkpoint

    args = build_parser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)

    cfg = ClassicNeRFConfig(
        normalize_position=args.normalize_position, use_pallas=args.use_pallas
    )
    model = ClassicNeRF(cfg, device=args.device)
    if args.checkpoint.endswith(".pth"):
        model.mlp = load_classic_checkpoint(args.checkpoint, cfg, device=args.device)
    else:
        # The full train state; its Adam moments are restored too, unused.
        ckpt_lib.restore_checkpoint(args.checkpoint, create_train_state(model))

    render = RenderConfig(
        num_coarse_samples=args.num_samples_per_ray,
        num_fine_samples=args.num_fine_samples,
        near=args.near_plane,
        far=args.far_plane,
        randomly_sample=False,
        density_noise_std=0.0,
    )
    pose_o, pose_r = spherical_poses(
        args.num_views, args.radius, args.elevation, device=args.device
    )
    for i in range(args.num_views):
        img = model.render_image(
            pose_o[i : i + 1], pose_r[i : i + 1],
            args.image_size, args.image_size, args.focal, render,
        )
        path = os.path.join(args.output_dir, f"view_{i:03d}.png")
        write_png(path, img[0].cpu().numpy())
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
