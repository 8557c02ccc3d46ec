"""How closely the bf16 kernels can be held to their plain versions, on the
card.

    python scripts/torch_bf16_sensitivity.py [--family classic|mip|all]

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
from the kinks).

``--family mip``: the mip family in bf16 (``MipNeRFConfig()`` at hidden 64
and 256, its LayerNorms drawn off identity from a seeded generator) at a
few row counts: K5-fwd's outputs, K5-bwd's weight gradients and ``dfeat``
(uniform random cotangents, and a loss's: mean(density^2) +
mean(sin(the other outputs)) at the plain forward), K6's gradients (63 rows
a ray, seg weight 0.1) and K7's outputs (63 rows a ray), each beside the
float32 kernel's distance from the plain bf16 version on the same inputs.
Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from nerf_tpu_torch import ClassicNeRFConfig, MipNeRFConfig  # noqa: E402
from nerf_tpu_torch.models.mlp import ClassicMLP  # noqa: E402
from nerf_tpu_torch.ops.kernels import classic_mlp, mip_mlp, mip_train, tc_mlp  # noqa: E402
from test_torch_cuda import kink_margin, loss_cotangent, mip_inputs, mip_packed  # noqa: E402

CASES = ((64, True), (128, False), (256, True))
ROWS = (200, 16384, 131072)
KINK_MARGIN = 1e-3
MIP_HIDDEN = (64, 256)
MIP_RAYS = (4, 256, 4096)  # of 63 rows: 252, 16,128 and 258,048 rows


def rel(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float((a - b).norm() / b.norm())


def flat_rel(got: dict, ref: dict) -> float:
    return rel(torch.cat([got[k].ravel() for k in ref]), torch.cat([ref[k].ravel() for k in ref]))


def mip_loss_cotangent(packed, x) -> torch.Tensor:
    """K5's output cotangents under mean(density^2) + mean(sin(the other
    outputs)), at the plain forward (bf16 for bfloat16 features)."""
    out = mip_mlp.mip_mlp_fwd_plain(packed, x)
    n, c = out.shape[0], out.shape[1] - 1
    return torch.cat([2 * out[:, :1] / n, torch.cos(out[:, 1:]) / (n * c)], -1)


def outputs_rel(got, ref) -> float:
    return rel(torch.cat([g.ravel() for g in got]), torch.cat([r.ravel() for r in ref]))


def mip_family(device) -> None:
    for hidden in MIP_HIDDEN:
        cfg, packed = mip_packed("full_width", device, hidden_size=hidden)
        for rays in MIP_RAYS:
            a = mip_inputs(cfg, device, rays, 63, seed=rays + hidden)
            rows = rays * 63
            x = a["features"].reshape(rows, -1).bfloat16()
            what = f"mip hidden {hidden}, {rows} rows"
            f32 = mip_mlp.mip_mlp_fwd(packed, x.float())
            plain = mip_mlp.mip_mlp_fwd_plain(packed, x)
            print(f"{what}: K5-fwd from plain {rel(mip_mlp.mip_mlp_fwd(packed, x), plain):.2e}; "
                  f"float32 kernel {rel(f32, plain):.2e}", flush=True)
            gen = torch.Generator(device=device).manual_seed(rows)
            for kind, g in (("random", torch.rand(f32.shape, generator=gen, device=device) * 2 - 1),
                            ("loss", mip_loss_cotangent(packed, x))):
                dx, kernel = mip_mlp.mip_mlp_bwd(packed, x, g)
                rdx, ref = mip_mlp.mip_mlp_bwd_plain(packed, x, g)
                f32 = mip_mlp.mip_mlp_bwd(packed, x.float(), g)
                print(f"{what}, {kind} cotangents: K5-bwd from plain: weights "
                      f"{flat_rel(kernel, ref):.2e}, dfeat {rel(dx, rdx):.2e}; float32 kernel "
                      f"from plain bf16: weights {flat_rel(f32[1], ref):.2e}, dfeat "
                      f"{rel(f32[0], rdx):.2e}", flush=True)
            a16 = {**a, "features": a["features"].bfloat16()}
            args = [a16[k] for k in ("features", "dists", "noise", "pixels", "labels")]
            kw = dict(color_outputs=cfg.color_outputs, seg_weight=0.1)
            got = mip_train.mip_train_grads(packed, *args, **kw)
            ref = mip_train.mip_train_grads_plain(packed, *args, **kw)
            f32 = mip_train.mip_train_grads(packed, a["features"], *args[1:], **kw)
            print(f"{what}: K6 from plain: loss {rel(got[0], ref[0]):.2e}, gradients "
                  f"{flat_rel(got[2], ref[2]):.2e}; float32 kernel from plain bf16: gradients "
                  f"{flat_rel(f32[2], ref[2]):.2e}", flush=True)
            ev = (a["dists"], a["t_mids"], None, cfg.color_outputs)
            got = mip_train.mip_eval(packed, a16["features"], *ev)
            ref = mip_train.mip_eval_plain(packed, a16["features"], *ev)
            f32 = mip_train.mip_eval(packed, a["features"], *ev)
            print(f"{what}: K7 from plain {outputs_rel(got, ref):.2e}; float32 kernel "
                  f"{outputs_rel(f32, ref):.2e}", flush=True)
            torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--family", choices=("classic", "mip", "all"), default="classic")
    family = parser.parse_args().family
    if not torch.cuda.is_available():
        print("torch_bf16_sensitivity: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    if family in ("mip", "all"):
        mip_family(device)
    if family == "mip":
        return 0
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
