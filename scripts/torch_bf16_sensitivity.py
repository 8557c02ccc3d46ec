"""How closely the bf16 kernels can be held to their plain versions, on the
card.

    python scripts/torch_bf16_sensitivity.py [--family classic|mip|point|widths|mega-widths|
                                                      latent-cotangents|mip-widths|hidden|all]

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

``--family point``: K8 and K9 in bf16 at hidden 64 and 256 (the classic
model, view branch on): K8-fwd's outputs and K8-bwd's weight gradients and
raw inputs' cotangents on 16,384 and 262,144 raw points (uniform in
[-2, 2]^3, directions in [-1, 1]^3), for uniform random cotangents and a
loss's (mean(density^2) + mean(sin(color)) at the plain bf16 forward);
K9's gradients at 64 and 2048 rays x (64 + 128) (the plain bf16 step with
the kernel's fine t-values held); each beside the float32 kernel's
distance from the plain bf16 version on the same inputs (K9's at the
float32 kernel's own fine t-values).

``--family mega-widths``: K9 in bf16 at hidden 256 and x encodings 60, 120
and 702 + 36 (``x_positional_encoding_size`` 20, 40, 234), at 512 and 2048
rays x (64 + 128): its weight gradients' distance from the plain bf16
step (the kernel's fine t-values held), beside the float32 kernel's and
the plain version's own with its sums in float64 (``Bf16Float64Sums``).

``--family latent-cotangents``: ``chip_smoke.py`` phase 13's check of bf16
K1-bwd's encodings' cotangents (its full-width model from seed 0 with 3 +
s density inputs, s = 7 and 32; 65,536 rows away from the bf16 kinks
under a loss's cotangents, ``chip_smoke.bf16_cotangent_distances``) for
three seeds each: the kernel's, the float32 kernel's and the plain
version's own distance with float64 sums, and the ratio the check holds.
``--family mip-widths``: the mip family in bf16 at hidden 256 with 96, 144
and 600 features (``encoding_size`` 32, 48 and 200; the LayerNorms drawn
off identity, as the card tests draw them): K5-fwd's outputs and K5-bwd's
weight gradients with the features' cotangent on 16,128 rows (256 rays x
63, uniform cotangents), K6's gradients (seg weight 0.1) and K7's outputs
on those rays: the kernel's relative L2 distance from the plain bf16
version, beside the float32 kernel's and the plain version's own with its
sums in float64 (``Bf16Float64Sums``).  Run from two trees, it compares two
ways of summing the bf16 feature product (``csrc/mip_mlp.cuh``,
``kChunkedSums``).

``--family hidden``: the card tests' bf16 check of the inputs' cotangents
(``test_bf16_kernels_match_plain_at_every_width``: K1-bwd's ``dx`` and
``dd`` on BF16_ROWS rows away from the bf16 kinks under a loss's
cotangents; ``test_bf16_point_and_mega_kernels_match_plain_at_every_width``:
K8-bwd's raw inputs' cotangents) at hidden 256, 512 and 1024 (past 256 the
column blocks of ``csrc/tc_mlp.cuh`` note 11) for three seeds: the
kernel's, the float32 kernel's and the plain version's own distance with
float64 sums (``Bf16Float64Sums``) from the plain bf16 version.  Run from
two trees, it compares two ways of summing the wide products.
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
from nerf_tpu_torch.testing import Bf16Float64Sums  # noqa: E402
from nerf_tpu_torch.ops.kernels import (  # noqa: E402
    classic_mlp,
    mega_train,
    mip_mlp,
    mip_train,
    point_mlp,
    tc_mlp,
)
from test_torch_cuda import (  # noqa: E402
    BF16_ROWS,
    POINT_BF16_VARIANTS,
    kink_margin,
    loss_cotangent,
    mega_setup,
    mip_inputs,
    mip_packed,
    packed_weights,
    point_bf16_case,
    point_consts,
    point_loss_cotangent,
    rows_away_from_kinks,
    width_packed,
)

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


def point_family(device) -> None:
    bf = torch.bfloat16
    for hidden in (64, 256):
        cfg = ClassicNeRFConfig(hidden_size=hidden, normalize_position=6.0)
        mlp = ClassicMLP(cfg, generator=torch.Generator().manual_seed(0), device=device)
        packed = classic_mlp.pack_classic_params(mlp.requires_grad_(False))
        consts = point_consts(cfg, device)
        for rows in (16384, 262144):
            gen = torch.Generator(device=device).manual_seed(hidden + rows)
            pts = torch.rand((rows, 3), generator=gen, device=device) * 4 - 2
            dirs = torch.rand((rows, 3), generator=gen, device=device) * 2 - 1
            what = f"K8 hidden {hidden}, {rows} points"
            plain = point_mlp.classic_pointmlp_fwd_plain(packed, pts, dirs, consts, dtype=bf)
            got = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts, dtype=bf)
            f32 = point_mlp.classic_pointmlp_fwd(packed, pts, dirs, consts)
            print(f"{what}: K8-fwd from plain {rel(got, plain):.2e}; float32 kernel "
                  f"{rel(f32, plain):.2e}", flush=True)
            n, c = plain.shape[0], plain.shape[1] - 1
            for kind, g in (
                    ("random", torch.rand(plain.shape, generator=gen, device=device) * 2 - 1),
                    ("loss", torch.cat([2 * plain[:, :1] / n, torch.cos(plain[:, 1:]) / (n * c)],
                                       -1))):
                dp, dd, kernel = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g,
                                                                dtype=bf)
                rdp, rdd, ref = point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts,
                                                                     g, dtype=bf)
                fdp, fdd, f32 = point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g)
                raw = lambda a, b: {"dp": a, "dd": b}  # noqa: E731
                print(f"{what}, {kind} cotangents: K8-bwd from plain: weights "
                      f"{flat_rel(kernel, ref):.2e}, raw inputs "
                      f"{flat_rel(raw(dp, dd), raw(rdp, rdd)):.2e}; float32 kernel from plain "
                      f"bf16: weights {flat_rel(f32, ref):.2e}, raw inputs "
                      f"{flat_rel(raw(fdp, fdd), raw(rdp, rdd)):.2e}", flush=True)
        for rays in (64, 2048):
            model, _, batch, draws = mega_setup(device, True, 64, 128, False, rays=rays,
                                                hidden=hidden, compute_dtype="bfloat16")
            inputs = mega_train.mega_inputs(model, batch, draws)
            pk = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
            *_, kernel, t_fine = mega_train.mega_train(pk, *inputs)
            ref = mega_train.mega_train_plain(pk, *inputs, t_fine=t_fine)[2]
            *_, f32, f32_t = mega_train.mega_train(pk, inputs[0].float(), inputs[1].float(),
                                                   *inputs[2:])
            f32_ref = mega_train.mega_train_plain(pk, *inputs, t_fine=f32_t)[2]
            print(f"K9 hidden {hidden}, {rays} rays x (64 + 128): kernel from plain "
                  f"{flat_rel(kernel, ref):.2e}; float32 kernel from plain bf16 "
                  f"{flat_rel(f32, f32_ref):.2e}", flush=True)
        torch.cuda.synchronize()


def widths_family(device) -> None:
    bf = torch.bfloat16
    f64 = Bf16Float64Sums.apply
    for variant in ("full_width", "latent_full_width", "latent_7", "latent_32"):
        cfg, packed = packed_weights(variant, device)
        for seed in (3, 4, 5):
            gen = torch.Generator(device=device).manual_seed(seed)
            d = torch.rand((BF16_ROWS, cfg.d_encoding_dim), generator=gen, device=device) * 2 - 1
            x = rows_away_from_kinks(packed, gen, BF16_ROWS, 1, cfg.x_encoding_dim, d,
                                     tc_mlp.bf16_matmul).reshape(BF16_ROWS, -1).bfloat16()
            d = d.bfloat16()
            g = loss_cotangent(packed, x, d)
            dx, dd, _ = classic_mlp.classic_mlp_bwd(packed, x, d, g)
            rdx, rdd, _ = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g)
            fdx, fdd, _ = classic_mlp.classic_mlp_bwd(packed, x.float(), d.float(), g)
            ddx, ddd, _ = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g, matmul=f64)
            ref = {"dx": rdx, "dd": rdd}
            print(f"K1-bwd bf16 {cfg.x_encoding_dim} + {cfg.d_encoding_dim}, seed {seed}: dx, dd "
                  f"from plain: kernel {flat_rel({'dx': dx, 'dd': dd}, ref):.3e}, float32 "
                  f"kernel {flat_rel({'dx': fdx, 'dd': fdd}, ref):.3e}, plain with float64 "
                  f"sums {flat_rel({'dx': ddx, 'dd': ddd}, ref):.3e}", flush=True)
    for variant in ("full_width", "wide", "latent_7", "latent_32"):
        for seed in (7, 8, 9):
            cfg, packed, consts, pts, dirs = point_bf16_case(device, BF16_ROWS, seed,
                                                             **POINT_BF16_VARIANTS[variant])
            g = point_loss_cotangent(packed, pts, dirs, consts)
            raw = lambda r: {"dp": r[0], "dd": r[1]}  # noqa: E731
            ref = raw(point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g,
                                                           dtype=bf))
            got = raw(point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g, dtype=bf))
            f32 = raw(point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g))
            d64 = raw(point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g,
                                                           matmul=f64, dtype=bf))
            print(f"K8-bwd bf16 x {cfg.x_encoding_dim} + {cfg.d_encoding_dim}, seed {seed}: raw "
                  f"inputs' cotangents from plain: kernel {flat_rel(got, ref):.3e}, float32 "
                  f"kernel {flat_rel(f32, ref):.3e}, plain with float64 sums "
                  f"{flat_rel(d64, ref):.3e}", flush=True)
    torch.cuda.synchronize()


def hidden_family(device) -> None:
    bf = torch.bfloat16
    f64 = Bf16Float64Sums.apply
    for hidden in (256, 512, 1024):
        cfg, packed = width_packed(device, hidden, True)
        for seed in (hidden, hidden + 1, hidden + 2):
            gen = torch.Generator(device=device).manual_seed(seed)
            d = torch.rand((BF16_ROWS, cfg.d_encoding_dim), generator=gen, device=device) * 2 - 1
            x = rows_away_from_kinks(packed, gen, BF16_ROWS, 1, cfg.x_encoding_dim, d,
                                     tc_mlp.bf16_matmul).reshape(BF16_ROWS, -1).bfloat16()
            d = d.bfloat16()
            g = loss_cotangent(packed, x, d)
            dx, dd, _ = classic_mlp.classic_mlp_bwd(packed, x, d, g)
            rdx, rdd, _ = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g)
            fdx, fdd, _ = classic_mlp.classic_mlp_bwd(packed, x.float(), d.float(), g)
            ddx, ddd, _ = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g, matmul=f64)
            ref = {"dx": rdx, "dd": rdd}
            print(f"K1-bwd bf16 hidden {hidden}, seed {seed}: dx, dd from plain: kernel "
                  f"{flat_rel({'dx': dx, 'dd': dd}, ref):.3e}, float32 kernel "
                  f"{flat_rel({'dx': fdx, 'dd': fdd}, ref):.3e}, plain with float64 sums "
                  f"{flat_rel({'dx': ddx, 'dd': ddd}, ref):.3e}", flush=True)
        for seed in (hidden, hidden + 1, hidden + 2):
            cfg, packed, consts, pts, dirs = point_bf16_case(device, BF16_ROWS, seed,
                                                             hidden_size=hidden)
            g = point_loss_cotangent(packed, pts, dirs, consts)
            raw = lambda r: {"dp": r[0], "dd": r[1]}  # noqa: E731
            ref = raw(point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g,
                                                           dtype=bf))
            got = raw(point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g, dtype=bf))
            f32 = raw(point_mlp.classic_pointmlp_bwd(packed, pts, dirs, consts, g))
            d64 = raw(point_mlp.classic_pointmlp_bwd_plain(packed, pts, dirs, consts, g,
                                                           matmul=f64, dtype=bf))
            print(f"K8-bwd bf16 hidden {hidden}, seed {seed}: raw inputs' cotangents from "
                  f"plain: kernel {flat_rel(got, ref):.3e}, float32 kernel "
                  f"{flat_rel(f32, ref):.3e}, plain with float64 sums {flat_rel(d64, ref):.3e}",
                  flush=True)
    torch.cuda.synchronize()


def mega_widths_family(device) -> None:
    for lanes in (20, 40, 234):
        for rays in (512, 2048):
            model, _, batch, draws = mega_setup(device, True, 64, 128, False, rays=rays,
                                                hidden=256, compute_dtype="bfloat16",
                                                x_positional_encoding_size=lanes)
            inputs = mega_train.mega_inputs(model, batch, draws)
            pk = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
            *_, kernel, t_fine = mega_train.mega_train(pk, *inputs)
            ref = mega_train.mega_train_plain(pk, *inputs, t_fine=t_fine)[2]
            d64 = mega_train.mega_train_plain(pk, *inputs, t_fine=t_fine,
                                              matmul=Bf16Float64Sums.apply)[2]
            *_, f32, f32_t = mega_train.mega_train(pk, inputs[0].float(), inputs[1].float(),
                                                   *inputs[2:])
            f32_ref = mega_train.mega_train_plain(pk, *inputs, t_fine=f32_t)[2]
            print(f"K9 bf16 x {model.cfg.x_encoding_dim} + {model.cfg.d_encoding_dim}, {rays} "
                  f"rays x (64 + 128): weight gradients from plain: kernel "
                  f"{flat_rel(kernel, ref):.3e}, float32 kernel {flat_rel(f32, f32_ref):.3e}, "
                  f"plain with float64 sums {flat_rel(d64, ref):.3e}", flush=True)
            del model, inputs, kernel, ref, d64, f32, f32_ref
            torch.cuda.empty_cache()


def latent_cotangents_family(device) -> None:
    import chip_smoke

    for s in chip_smoke.LATENT_STATES:
        model = chip_smoke.make_model(True, device, density_inputs=3 + s)
        packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
        for seed in (0, 1, 2):
            gen = torch.Generator(device=device).manual_seed(seed)
            err, f32, floor = chip_smoke.bf16_cotangent_distances(packed, model.cfg, gen)
            print(f"K1-bwd bf16 {model.cfg.x_encoding_dim} + {model.cfg.d_encoding_dim}, phase "
                  f"13's rows, seed {seed}: dx, dd from plain: kernel {err:.3e}, float32 kernel "
                  f"{f32:.3e}, plain with float64 sums {floor:.3e}; kernel / plain "
                  f"{err / floor:.3f}", flush=True)


def mip_widths_family(device) -> None:
    f64 = Bf16Float64Sums.apply
    for features in (96, 144, 600):
        cfg, packed = mip_packed("full_width", device, encoding_size=features // 3)
        a = mip_inputs(cfg, device, 256, 63, seed=features)
        rows = 256 * 63
        x = a["features"].reshape(rows, -1).bfloat16()
        g = torch.rand((rows, cfg.num_outputs), device=device,
                       generator=torch.Generator(device=device).manual_seed(features)) * 2 - 1
        what = f"mip bf16 {features} features, {rows} rows"
        plain = mip_mlp.mip_mlp_fwd_plain(packed, x)
        print(f"{what}: K5-fwd from plain: kernel {rel(mip_mlp.mip_mlp_fwd(packed, x), plain):.3e}, "
              f"float32 kernel {rel(mip_mlp.mip_mlp_fwd(packed, x.float()), plain):.3e}, plain "
              f"with float64 sums {rel(mip_mlp.mip_mlp_fwd_plain(packed, x, matmul=f64), plain):.3e}",
              flush=True)
        both = lambda r: {"dfeat": r[0].float(), **r[1]}  # noqa: E731
        ref = both(mip_mlp.mip_mlp_bwd_plain(packed, x, g))
        print(f"{what}: K5-bwd with dfeat from plain: kernel "
              f"{flat_rel(both(mip_mlp.mip_mlp_bwd(packed, x, g)), ref):.3e}, float32 kernel "
              f"{flat_rel(both(mip_mlp.mip_mlp_bwd(packed, x.float(), g)), ref):.3e}, plain with "
              f"float64 sums {flat_rel(both(mip_mlp.mip_mlp_bwd_plain(packed, x, g, matmul=f64)), ref):.3e}",
              flush=True)
        args = [a["features"].bfloat16()] + [a[k] for k in ("dists", "noise", "pixels", "labels")]
        kw = dict(color_outputs=cfg.color_outputs, seg_weight=0.1)
        ref = mip_train.mip_train_grads_plain(packed, *args, **kw)[2]
        got = mip_train.mip_train_grads(packed, *args, **kw)[2]
        f32 = mip_train.mip_train_grads(packed, a["features"], *args[1:], **kw)[2]
        d64 = mip_train.mip_train_grads_plain(packed, *args, **kw, matmul=f64)[2]
        print(f"{what}: K6 gradients from plain: kernel {flat_rel(got, ref):.3e}, float32 kernel "
              f"{flat_rel(f32, ref):.3e}, plain with float64 sums {flat_rel(d64, ref):.3e}",
              flush=True)
        ev = (a["dists"], a["t_mids"], None, cfg.color_outputs)
        ref = mip_train.mip_eval_plain(packed, args[0], *ev)
        print(f"{what}: K7 from plain: kernel "
              f"{outputs_rel(mip_train.mip_eval(packed, args[0], *ev), ref):.3e}, float32 kernel "
              f"{outputs_rel(mip_train.mip_eval(packed, a['features'], *ev), ref):.3e}, plain with "
              f"float64 sums {outputs_rel(mip_train.mip_eval_plain(packed, args[0], *ev, matmul=f64), ref):.3e}",
              flush=True)
        torch.cuda.synchronize()


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--family",
                        choices=("classic", "mip", "point", "widths", "mega-widths",
                                 "latent-cotangents", "mip-widths", "hidden", "all"),
                        default="classic")
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
    if family in ("point", "all"):
        point_family(device)
    if family in ("widths", "all"):
        widths_family(device)
    if family in ("mega-widths", "all"):
        mega_widths_family(device)
    if family in ("latent-cotangents", "all"):
        with torch.no_grad():
            latent_cotangents_family(device)
    if family in ("mip-widths", "all"):
        with torch.no_grad():
            mip_widths_family(device)
    if family in ("hidden", "all"):
        hidden_family(device)
    if family in ("mip", "point", "widths", "mega-widths", "latent-cotangents", "mip-widths",
                  "hidden"):
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
