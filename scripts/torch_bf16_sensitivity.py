"""How closely bf16 K1-bwd can be held to its plain version, on the card.

    python scripts/torch_bf16_sensitivity.py

For K1-bwd in compute_dtype bfloat16 (``classic_mlp.classic_mlp_bwd`` on
bfloat16 encodings, with the encodings' cotangents) at a few widths and
row counts, on uniform random rows from a seed, prints the relative L2
distance from the plain bf16 version (``classic_mlp_bwd_plain``) of

* the kernel's weight gradients, its ``dx`` and its ``dd``;
* the float32 kernel's weight gradients on the same inputs (what a kernel
  without bf16's roundings gives: the check must fail it);

for three kinds of cotangent: uniform random in [-1, 1] (the weight
gradients are sums of terms of either sign), the gradient of a loss
(``test_pallas.py``'s bf16 objective, mean(density^2) + mean(sin(color)),
at the plain forward), and the loss's on rows whose every ReLU input lies
farther than 1e-3 from 0 in the plain bf16 forward (a bf16-scale margin
from the kinks).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from nerf_tpu_torch import ClassicNeRFConfig  # noqa: E402
from nerf_tpu_torch.models.mlp import ClassicMLP  # noqa: E402
from nerf_tpu_torch.ops.kernels import classic_mlp, tc_mlp  # noqa: E402
from test_torch_cuda import kink_margin, loss_cotangent  # noqa: E402

CASES = ((64, True), (128, False), (256, True))
ROWS = (200, 16384, 131072)
KINK_MARGIN = 1e-3


def rel(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float((a - b).norm() / b.norm())


def flat_rel(got: dict, ref: dict) -> float:
    return rel(torch.cat([got[k].ravel() for k in ref]), torch.cat([ref[k].ravel() for k in ref]))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_bf16_sensitivity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    for hidden, view in CASES:
        cfg = ClassicNeRFConfig(hidden_size=hidden, use_viewdirs=view)
        mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
        packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
        for rows in ROWS:
            gen = torch.Generator(device=device).manual_seed(hidden + rows)

            def rand(*shape):
                return torch.rand(shape, generator=gen, device=device) * 2 - 1

            x = rand(rows, cfg.x_encoding_dim).bfloat16()
            d = rand(rows, cfg.d_encoding_dim).bfloat16() if view else None
            keep = kink_margin(packed, x.float(), None if d is None else d.float(),
                               tc_mlp.bf16_matmul) > KINK_MARGIN
            far = (x[keep].contiguous(), None if d is None else d[keep].contiguous())
            for kind, (xs, ds) in (("random", (x, d)), ("loss", (x, d)),
                                   (f"loss, kink margin > {KINK_MARGIN}", far)):
                if xs.shape[0] < 2:
                    print(f"hidden {hidden}, view {view}, {rows} rows, {kind}: no rows kept")
                    continue
                g = (rand(xs.shape[0], 1 + cfg.color_outputs) if kind == "random"
                     else loss_cotangent(packed, xs, ds))
                dx, dd, kernel = classic_mlp.classic_mlp_bwd(packed, xs, ds, g)
                rdx, rdd, plain = classic_mlp.classic_mlp_bwd_plain(packed, xs, ds, g)
                f32 = classic_mlp.classic_mlp_bwd(
                    packed, xs.float(), None if ds is None else ds.float(), g)[2]
                torch.cuda.synchronize()
                dd_err = f", dd {rel(dd, rdd):.2e}" if view else ""
                print(f"hidden {hidden}, view {view}, {xs.shape[0]} rows, {kind} cotangents: "
                      f"kernel from plain: weights {flat_rel(kernel, plain):.2e}, dx "
                      f"{rel(dx, rdx):.2e}{dd_err}; float32 kernel from plain bf16: weights "
                      f"{flat_rel(f32, plain):.2e}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
