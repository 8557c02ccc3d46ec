"""How far K7's outputs on a mip frame tile sit from its plain version and
from float64, and why: the MLP's rounding or the compositing.

    python scripts/torch_mip_conditioning.py [--encodings 32,48,200]

For the full-width MipNeRF (random weights from seed 0, as ``chip_smoke.py``
makes it) at each ``encoding_size`` (96, 144 and 600 IPE features), on the
first 4000-ray tile of ``chip_smoke.py``'s 400x400 frame at 64 fenceposts:

* K5-fwd's outputs on the tile's feature rows: the kernel's and the plain
  float32 version's largest distance from a float64 evaluation;
* for each of K7's outputs (rgb, the class log-probabilities, depth, acc):
  how many elements leave K7's check (rtol 1e-4, atol 1e-4) against the
  plain version, and the worst element's ratio to that bound, beside the
  kernel's, the plain version's, and the float64 value, and the value of
  the plain compositing on the kernel's MLP outputs (what the kernel's MLP
  alone moves), with the ray's acc;
* the depth's worst ratio to K7's bound relative to the ray's mean
  termination distance, atol + rtol x depth / acc (``chip_smoke.py``
  phase 20's depth check).

Prints the card's name and power limit first.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the models, the frame's rays, the card line)
from nerf_tpu_torch.data.scenes import spherical_poses  # noqa: E402
from nerf_tpu_torch.ops.cameras import pose_to_rays  # noqa: E402
from nerf_tpu_torch.ops.kernels import mip_mlp, mip_train  # noqa: E402

TOL = chip_smoke.TOL["mip_eval"]
OUTPUTS = ("rgb", "seg", "depth", "acc")


def run(device, encoding: int) -> None:
    model = chip_smoke.make_mip_model(True, device, encoding_size=encoding)
    model.eval().requires_grad_(False)
    pose_o, pose_r = spherical_poses(1, radius=4.0, device=device)
    rays_o, rays_d = (r.reshape(-1, 3)[: chip_smoke.MIP_RENDER.rays_per_tile] for r in
                      pose_to_rays(pose_o, pose_r, chip_smoke.IMAGE, chip_smoke.IMAGE,
                                   chip_smoke.FOCAL))
    store = {}
    with torch.no_grad(), chip_smoke.capture_args(mip_train, "mip_eval", store):
        model.render_rays(rays_o, rays_d, chip_smoke.MIP_RENDER, fused_eval=True)
    args = store["mip_eval"][0]
    packed = mip_mlp.pack_mip_params(model.mlp)
    feat, dists, t_mids = args[1:4]
    colors = model.cfg.color_outputs
    shape = (feat.shape[0], feat.shape[1], -1)
    x = feat.reshape(-1, feat.shape[-1])
    p64 = {k: v.double() for k, v in packed.items()}

    def f64(u, v):
        return u.double() @ v.double()

    with torch.no_grad():
        got = mip_train.mip_eval(packed, *args[1:])
        ref = mip_train.mip_eval_plain(packed, *args[1:])
        out_k = mip_mlp.mip_mlp_fwd(packed, x)
        out_p = mip_mlp.mip_mlp_fwd_plain(packed, x)
        out_64 = mip_mlp.mip_mlp_fwd_plain(p64, x, matmul=f64)
        hybrid = mip_train.mip_composite_plain(out_k.reshape(shape), dists, t_mids, None, colors)
        exact = mip_train.mip_composite_plain(out_64.reshape(shape), dists.double(),
                                              t_mids.double(), None, colors)
    print(f"{feat.shape[-1]} features: MLP outputs from float64: kernel "
          f"{float((out_k.double() - out_64).abs().max()):.3e}, plain "
          f"{float((out_p.double() - out_64).abs().max()):.3e}", flush=True)
    for name, g, r, h, e in zip(OUTPUTS, got, ref, hybrid, exact):
        ratio = ((g - r).abs() / (TOL["atol"] + TOL["rtol"] * r.abs())).reshape(-1)
        j = int(ratio.argmax())
        ray = j // (r.numel() // r.shape[0])
        print(f"  {name}: {int((ratio > 1).sum())} of {ratio.numel()} past rtol {TOL['rtol']}, "
              f"atol {TOL['atol']}; worst ratio {float(ratio[j]):.3f}: kernel "
              f"{float(g.reshape(-1)[j]):.7e}, plain {float(r.reshape(-1)[j]):.7e}, kernel's MLP "
              f"with the plain compositing {float(h.reshape(-1)[j]):.7e}, float64 "
              f"{float(e.reshape(-1)[j]):.7e}; the ray's acc {float(ref[3][ray]):.4e}", flush=True)
    scaled = (got[2] - ref[2]).abs() / (TOL["atol"] + TOL["rtol"] * ref[2].abs()
                                        / ref[3].clamp_min(1e-30))
    print(f"  depth relative to depth / acc: worst ratio {float(scaled.max()):.3f}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--encodings", default="32,48,200",
                        help="MipNeRFConfig.encoding_size values, comma-separated")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_mip_conditioning: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(chip_smoke.nvidia_smi("name,power.limit"))
    for encoding in args.encodings.split(","):
        run(device, int(encoding))
    return 0


if __name__ == "__main__":
    sys.exit(main())
