#!/usr/bin/env python3
"""Why the render CLI's kernel PNGs and the plain path's differ at a few
pixels of a trained checkpoint (``chip_smoke.py`` phase 14c), on one GPU.

Trains the full-width model 60 steps at the notebook recipe through
``cli.train_tiny_nerf`` (``chip_smoke.TINY_RECIPE``), then renders the
two views phase 14c asks of the render CLI (``chip_smoke.RENDER_ARGS``:
64 + 128 samples) and prints, per view:

* the kernel path against the plain path: the largest difference, in
  8-bit levels, at the pixels whose fine samples the two renders place
  more than ``chip_smoke.T_FINE_ATOL`` apart in t (recorded from the
  renders) and at the others;
* the plain path against itself with every weight scaled by 1 + 2^-23
  (one float32 ulp), and the kernel path likewise;
* the 64 coarse samples alone, kernel against plain;
* K4 and K1-fwd against their plain versions on the arguments of the
  kernel render's first tile.

    python scripts/torch_render_sensitivity.py
"""

from __future__ import annotations

import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the phase's recipe, recorders and tolerance)
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, RenderConfig  # noqa: E402
from nerf_tpu_torch.cli import render as render_cli  # noqa: E402
from nerf_tpu_torch.cli import train_tiny_nerf  # noqa: E402
from nerf_tpu_torch.data.scenes import spherical_poses  # noqa: E402
from nerf_tpu_torch.ops import sampling  # noqa: E402
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, union_eval  # noqa: E402
from nerf_tpu_torch.train import checkpoint, create_train_state  # noqa: E402


def levels(a: torch.Tensor) -> torch.Tensor:
    """``write_png``'s 8-bit quantisation."""
    return (a.clamp(0.0, 1.0) * 255).to(torch.uint8).int()


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_render_sensitivity: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = "cuda"
    print(chip_smoke.nvidia_smi("name,power.limit"))
    _build.build([classic_mlp.NAME, union_eval.NAME, "train_grads"])
    with tempfile.TemporaryDirectory() as tmp:
        train_tiny_nerf.main(["--logging-dir", tmp, "--num-steps", "60",
                              "--data", os.path.join(tmp, "missing.npz")]
                             + chip_smoke.TINY_RECIPE)
        ckpt = os.path.join(tmp, "checkpoint_60.npz")
        args = render_cli.build_parser().parse_args(["--checkpoint", ckpt]
                                                    + chip_smoke.RENDER_ARGS)

        def model(use_pallas: bool, scale: float = 1.0) -> ClassicNeRF:
            m = ClassicNeRF(ClassicNeRFConfig(normalize_position=args.normalize_position,
                                              use_pallas=use_pallas), device=device)
            checkpoint.restore_checkpoint(ckpt, create_train_state(m))
            with torch.no_grad():
                for p in m.mlp.parameters():
                    p.mul_(scale)
            return m.eval().requires_grad_(False)

        render = RenderConfig(num_coarse_samples=args.num_samples_per_ray,
                              num_fine_samples=args.num_fine_samples,
                              near=args.near_plane, far=args.far_plane, randomly_sample=False)
        coarse = RenderConfig(num_coarse_samples=args.num_samples_per_ray, near=args.near_plane,
                              far=args.far_plane, randomly_sample=False)
        pose_o, pose_r = spherical_poses(args.num_views, args.radius, args.elevation,
                                         device=device)
        size, ulp = args.image_size, 1.0 + 2.0 ** -23
        kernel, plain = model(True), model(False)
        kernel_ulp, plain_ulp = model(True, ulp), model(False, ulp)

        def image(m, view, cfg=render, t_fine=None):
            with chip_smoke.recording_results(sampling, "sample_pdf",
                                              [] if t_fine is None else t_fine):
                return m.render_image(pose_o[view:view + 1], pose_r[view:view + 1], size, size,
                                      args.focal, cfg)[0]

        for view in range(args.num_views):
            t_k, t_p = [], []
            img_k, img_p = image(kernel, view, t_fine=t_k), image(plain, view, t_fine=t_p)
            moved = ((torch.cat(t_k) - torch.cat(t_p)).abs().amax(-1)
                     > chip_smoke.T_FINE_ATOL).reshape(size, size)
            diff = (levels(img_k) - levels(img_p)).abs().amax(-1)
            print(f"view {view}: kernel vs plain, {int(moved.sum())} pixels with fine samples "
                  f"moved beyond {chip_smoke.T_FINE_ATOL} in t up to "
                  f"{int(diff[moved].max()) if moved.any() else 0} levels, the rest up to "
                  f"{int(diff[~moved].max())}")
            for name, a, b in (("plain", plain, plain_ulp), ("kernel", kernel, kernel_ulp)):
                d = (levels(image(a, view)) - levels(image(b, view))).abs().max()
                print(f"view {view}: {name} vs {name} with its weights x (1 + 2^-23): "
                      f"up to {int(d)} levels")
            d = (image(kernel, view, coarse) - image(plain, view, coarse)).abs().max()
            print(f"view {view}: 64 coarse samples alone, kernel vs plain: {float(d):.3e}")

        store = {}
        with torch.no_grad(), \
                chip_smoke.capture_args(union_eval, "union_eval", store), \
                chip_smoke.capture_args(classic_mlp, "classic_mlp_fwd", store):
            image(kernel, 0)
            k4_args = store["union_eval"][0]
            k4 = [float((g - r).abs().max()) for g, r in zip(
                union_eval.union_eval(*k4_args), union_eval.union_eval_plain(*k4_args))]
            k1_args = store["classic_mlp_fwd"][0][:3]
            k1 = float((classic_mlp.classic_mlp_fwd(*k1_args)
                        - classic_mlp.classic_mlp_fwd_plain(*k1_args)).abs().max())
        print(f"tile 0 of view 0: K4 vs its plain version (rgb, depth, acc) "
              f"{', '.join(f'{e:.3e}' for e in k4)}; K1-fwd vs its plain version {k1:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
