"""Times the classic kernels' tensor-core tile on the card at the encoding
widths of the full-width model and of the conditional trainer, or the mip
kernels' at feature widths of the mip model.

    python scripts/torch_tile_timing.py [--widths 0,7,32] [--dtypes float32,bfloat16]
    python scripts/torch_tile_timing.py --family mip [--features 96,144,600]
    python scripts/torch_tile_timing.py --widths 0 --hidden 48,64,200,256,512,1024
    python scripts/torch_tile_timing.py --widths 0 --colors 16 --samples 64,384

The full-width ClassicNeRF (hidden 256, view branch on, random weights from
seed 0) with 3 + s density inputs, s = 0, 7 and 32 state scalars: encodings
60 + 36, 200 + 36 and 700 + 36 (the conditional trainer's, whose density
branch takes the state).  For each width and dtype, each kernel called as a
user calls its wrapper (the operand images built by the call), on uniform
inputs in [-1, 1) from a seed:

* K1-fwd at 262,144 and 65,536 rows, each also with its operand image
  built beforehand (the kernel alone, where the call's own image build
  and launch weigh less);
* K4 at a 4000-ray tile of 64 + 128 samples;
* K1-bwd at 131,072 rows, without and with the encodings' cotangents;
  where the tree has it (slice 22), the reuse step's route: the forward
  that keeps the chain (counted as K1-fwd) and K1-bwd from that chain,
  without and with the cotangents (its bound the direct call's less one
  forward);
* K2 at 4096 x 64 and at the conditional trainer's 1024 x 64;
* K3 at 2048 x (64 + 128);
* K8-fwd and K8-bwd (with the raw inputs' cotangents) at 262,144 points,
  x encodings of 3 x 20, 3 x 68 and 3 x 234 lanes (60, 204, 702);
* K9 at 2048 x (64 + 128), at 60 + 36 only (it takes no state).

``--hidden`` runs the model at other hidden widths (each listed width for
each state width; 256 by default): a width the tiles do not instantiate
runs on weights padded to one, past 256 in column blocks (``csrc/tc_mlp.cuh``
note 11).  ``--colors`` sets the colour outputs (3 by default), and
``--samples sc,sf`` the coarse and fine samples of K3, K4 and K9 (64,128).
``--outputs PATH`` also saves each call's outputs (``torch.save``, by
dtype and kernel) to compare two trees' bit for bit: ``--compare A B``
prints, call by call, whether two such files agree bitwise (no GPU).

``--family mip``: the full-width MipNeRF (hidden 256, 5 layers, 3 + 50
outputs, random weights from seed 0) with ``encoding_size`` F / 3 for each
feature width F (96: the default model; 144 and 600 past the widths the
mip tiles once took), at PERF.md section 6's shapes: K5-fwd at 258,048 and
65,536 rows, K5-bwd at 258,048 rows without and with the features'
cotangent, K6 at 4096 x 63 interval rows (seg weight 0.1) and K7 at a
4000-ray tile of 63 rows.

Each time is the mean over repeated calls of CUDA events after two warm-up
calls, beside its operations' bounds (FLOP as ``utils.profiling`` counts
them: a forward's, or a training kernel's ``train_kernel_flops``, which
leaves out the inputs' cotangents where the call asks none; at the 3xTF32
and the bf16 rate).  The policy each kernel's calls recorded (``_build.policy_counts``)
stands beside its time; a call that raises a ``ValueError`` (widths a tree
does not take) is recorded as null with the error.  Prints the card's name
and power limit, then one JSON object.  The file runs unchanged from
another checkout's ``scripts/`` directory (it imports the package of the
tree it sits in), so two trees are compared in one call, each run twice in
turns (A, B, B, A).  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line, the event timer)
from nerf_tpu_torch import (  # noqa: E402
    ClassicNeRF,
    ClassicNeRFConfig,
    MipNeRF,
    MipNeRFConfig,
    RenderConfig,
)
from nerf_tpu_torch.ops import compositing, sampling  # noqa: E402
from nerf_tpu_torch.utils.profiling import (  # noqa: E402
    classic_flops_per_point,
    mip_flops_per_point,
    train_kernel_flops,
)
from nerf_tpu_torch.ops.kernels import (  # noqa: E402
    _build,
    classic_mlp,
    fine_stage_train,
    mega_train,
    mip_mlp,
    mip_train,
    point_mlp,
    tc_mlp,
    train_grads,
    union_eval,
)

K8_LANES = {0: 20, 7: 68, 32: 234}  # x_positional_encoding_size of K8's model per width
# With --outputs: (kernel, its first call's outputs) of each timed call, in
# call order.
SAVE: list = []
KEEP_OUTPUTS = False


def tensors_of(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu()]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in tensors_of(out[k])]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors_of(o)]
    return []


def timed(name: str, fn, iters: int, flops: float, key: str = None) -> dict:
    """The mean ms of ``fn`` beside its operations' bounds: 3xTF32 (FLOP at
    165 TFLOP/s) and bf16 (989 TFLOP/s); with ``--outputs`` the first
    call's outputs are kept in SAVE (under ``key``, by default the kernel's
    name)."""
    bounds = {"bound_3xtf32_ms": flops / chip_smoke.PEAK_3XTF32_FLOPS * 1e3,
              "bound_bf16_ms": flops / chip_smoke.PEAK_BF16_FLOPS * 1e3}
    _build.policy_counts.clear()
    try:
        if KEEP_OUTPUTS:
            SAVE.append((key or name, tensors_of(fn())))
        ms = chip_smoke.cuda_ms(fn, iters=iters)
    except ValueError as e:
        return {"ms": None, "error": str(e).split(",")[0], **bounds}
    policies = sorted({p for (k, p) in _build.policy_counts if k == name})
    return {"ms": ms, "policy": "/".join(policies), **bounds}


def run(device, s: int, dtype: str, hidden: int = 256, colors: int = 3,
        samples=(64, 128)) -> dict:
    bf16 = dtype == "bfloat16"
    tdt = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=device).manual_seed(s)

    def rand(*shape, lo=-1.0, hi=1.0, enc=False):
        out = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
        return out.to(tdt) if enc else out

    cfg = ClassicNeRFConfig(normalize_position=6.0, density_inputs=3 + s, compute_dtype=dtype,
                            hidden_size=hidden, color_outputs=colors)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    xe, de = cfg.x_encoding_dim, cfg.d_encoding_dim
    per_row = classic_flops_per_point(cfg)
    out = {}
    with torch.no_grad():
        img = tc_mlp.tc_images(packed, dtype=tdt)[0]
        for rows in (262_144, 65_536):
            x, d = rand(rows, xe, enc=True), rand(rows, de, enc=True)
            out[f"K1-fwd {rows}"] = timed(classic_mlp.NAME,
                                          lambda: classic_mlp.classic_mlp_fwd(packed, x, d), 10,
                                          rows * per_row)
            # The kernel alone: its operand image built once, beforehand.
            out[f"K1-fwd {rows} image built beforehand"] = timed(
                classic_mlp.NAME, lambda: classic_mlp.classic_mlp_fwd(packed, x, d, tc_fwd=img),
                20, rows * per_row)
        rays, (sc, sf) = 4000, samples
        t_c = torch.sort(rand(rays, sc, lo=2.0, hi=6.0), -1).values
        t_f = torch.sort(rand(rays, sf, lo=2.0, hi=6.0), -1).values
        k4 = (packed, rand(rays, sf, xe, enc=True), rand(rays, de, enc=True), t_c, t_f,
              rand(rays, sc, 1, lo=-3.0, hi=6.0), rand(rays, sc, colors, lo=-3.0, hi=3.0),
              rand(rays, lo=0.5, hi=2.0))
        out[f"K4 4000 x ({sc} + {sf})"] = timed(union_eval.NAME,
                                                lambda: union_eval.union_eval(*k4), 10,
                                                rays * sf * per_row)
        rows = 131_072
        x, d, g = rand(rows, xe, enc=True), rand(rows, de, enc=True), rand(rows, 1 + colors)
        for grads in (False, True):
            out[f"K1-bwd {rows} input_grads={grads}"] = timed(
                classic_mlp.BWD_NAME,
                lambda: classic_mlp.classic_mlp_bwd(packed, x, d, g, input_grads=grads), 5,
                train_kernel_flops(cfg, rows, 1, input_grads=grads))
        # The reuse step's route (a tree that has it): the forward that keeps
        # the chain, counted as K1-fwd, and K1-bwd from the chain.
        if hasattr(classic_mlp, "classic_mlp_fwd_chain"):
            fwd, bwd = tc_mlp.tc_images(packed, backward=True, dtype=tdt)
            _, chain = classic_mlp.classic_mlp_fwd_chain(packed, x, d, fwd)
            out[f"K1-fwd {rows} keeping the chain"] = timed(
                classic_mlp.NAME, lambda: classic_mlp.classic_mlp_fwd_chain(packed, x, d, fwd)[0],
                10, rows * per_row, key="K1-fwd keeping the chain")
            for grads in (False, True):
                out[f"K1-bwd {rows} input_grads={grads} from the chain"] = timed(
                    classic_mlp.BWD_NAME,
                    lambda: classic_mlp.classic_mlp_bwd(packed, x, d, g, grads, fwd, bwd,
                                                        chain=chain), 5,
                    train_kernel_flops(cfg, rows, 1, input_grads=grads) - rows * per_row,
                    key=f"K1-bwd from the chain input_grads={grads}")
            del chain
        for rays, s_ in ((4096, 64), (1024, 64)):
            t = torch.sort(rand(rays, s_, lo=2.0, hi=6.0), -1).values
            a = dict(x_enc=rand(rays, s_, xe, enc=True),
                     d_enc=rand(rays, 1, de, enc=True).expand(rays, s_, de).contiguous(),
                     dists=compositing.distances_from_tvals(t, rand(rays, 3)).contiguous(),
                     noise=rand(rays, s_), pixels=rand(rays, colors, lo=0.0, hi=1.0))
            out[f"K2 {rays} x {s_}"] = timed(
                train_grads.NAME,
                lambda: train_grads.classic_train_grads(packed, **a, num_samples=s_), 5,
                train_kernel_flops(cfg, rays, s_))
        rays = 2048
        t_c = torch.sort(rand(rays, sc, lo=2.0, hi=6.0), -1).values
        t_f = torch.sort(rand(rays, sf, lo=2.0, hi=6.0), -1).values
        a = dict(x_enc=rand(rays, sf, xe, enc=True),
                 d_enc=rand(rays, 1, de, enc=True).expand(rays, sf, de).contiguous(),
                 t_coarse=t_c, t_fine=t_f, dens_c=rand(rays, sc, 1, lo=-3.0, hi=6.0),
                 col_c=rand(rays, sc, colors, lo=-3.0, hi=3.0), dnorm=rand(rays, lo=0.5, hi=2.0),
                 noise_f=rand(rays, sf), pixels=rand(rays, colors, lo=0.0, hi=1.0))
        out[f"K3 2048 x ({sc} + {sf})"] = timed(
            fine_stage_train.NAME, lambda: fine_stage_train.fine_stage_train(packed, **a), 5,
            train_kernel_flops(cfg, rays, sf))

        pcfg = ClassicNeRFConfig(normalize_position=6.0, x_positional_encoding_size=K8_LANES[s],
                                 hidden_size=hidden, color_outputs=colors)
        pmodel = ClassicNeRF(pcfg, generator=torch.Generator().manual_seed(0), device=device)
        ppacked = classic_mlp.pack_classic_params(pmodel.mlp.requires_grad_(False))
        consts = point_mlp.encoding_consts(pcfg.x_positional_encoding_size,
                                           pcfg.normalize_position,
                                           pcfg.d_positional_encoding_size, pcfg.direction_bound,
                                           device)
        n = 262_144
        pts, dirs, g = rand(n, 3, lo=-2.0, hi=2.0), rand(n, 3), rand(n, 1 + colors)
        width = f"{pcfg.x_encoding_dim} + {pcfg.d_encoding_dim}"
        out[f"K8-fwd {n} ({width})"] = timed(
            point_mlp.NAME,
            lambda: point_mlp.classic_pointmlp_fwd(ppacked, pts, dirs, consts, dtype=tdt), 10,
            n * classic_flops_per_point(pcfg))
        out[f"K8-bwd {n} ({width})"] = timed(
            point_mlp.BWD_NAME,
            lambda: point_mlp.classic_pointmlp_bwd(ppacked, pts, dirs, consts, g, dtype=tdt), 5,
            train_kernel_flops(pcfg, n, 1, input_grads=True))

        if s == 0:
            render = RenderConfig(num_coarse_samples=sc, num_fine_samples=sf, near=2.0,
                                  far=6.0, randomly_sample=True, density_noise_std=1.0,
                                  reuse_coarse_in_fine=True)
            rays = 2048
            batch = {"rays_o": rand(rays, 3, lo=-0.5, hi=0.5), "rays_d": rand(rays, 3),
                     "pixels": rand(rays, colors, lo=0.0, hi=1.0)}
            draws = sampling.draw_step(gen, render, rays, device)
            inputs = mega_train.mega_inputs(model, batch, draws)
            out[f"K9 2048 x ({sc} + {sf})"] = timed(
                mega_train.NAME, lambda: mega_train.mega_train(packed, *inputs), 5,
                train_kernel_flops(cfg, rays, sc + sf))
    return {"encodings": f"{xe} + {de}", "hidden": hidden, "colors": colors, "dtype": dtype,
            "kernels": out}


def run_mip(device, features: int, dtype: str, hidden: int = 256, colors: int = 3) -> dict:
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(features)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    cfg = MipNeRFConfig(encoding_size=features // 3, hidden_size=hidden, color_outputs=colors)
    model = MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = mip_mlp.pack_mip_params(model.mlp.requires_grad_(False))
    per_row = mip_flops_per_point(cfg)
    out = {}
    with torch.no_grad():
        rays, rows = 4096, 63
        x = rand(rays * rows, cfg.feature_dim).to(tdt)
        g = rand(rays * rows, cfg.num_outputs)
        for n in (rays * rows, 65_536):
            xn = x[:n]
            out[f"K5-fwd {n}"] = timed(mip_mlp.NAME, lambda: mip_mlp.mip_mlp_fwd(packed, xn), 10,
                                       n * per_row)
        for grads in (False, True):
            out[f"K5-bwd {rays * rows} input_grads={grads}"] = timed(
                mip_mlp.BWD_NAME,
                lambda: mip_mlp.mip_mlp_bwd(packed, x, g, input_grads=grads), 5,
                train_kernel_flops(cfg, rays * rows, 1, mip=True, input_grads=grads))
        points = torch.cumsum(rand(rays, rows, 3, lo=0.0, hi=1.0), dim=1)
        a = (x.reshape(rays, rows, -1), compositing.distances_from_points(points).contiguous(),
             rand(rays, rows), rand(rays, cfg.color_outputs, lo=0.0, hi=1.0),
             torch.randint(0, cfg.segmentation_outputs, (rays,), generator=gen, device=device))
        out[f"K6 {rays} x {rows}"] = timed(
            mip_train.TRAIN_NAME,
            lambda: mip_train.mip_train_grads(packed, *a, cfg.color_outputs, 0.1), 5,
            train_kernel_flops(cfg, rays, rows, mip=True))
        rays = 4000
        ev = (packed, a[0][:rays], a[1][:rays], rand(rays, rows, lo=0.1, hi=60.0), None,
              cfg.color_outputs)
        out[f"K7 {rays} x {rows}"] = timed(mip_train.EVAL_NAME,
                                           lambda: mip_train.mip_eval(*ev), 10,
                                           rays * rows * per_row)
    return {"features": features, "hidden": hidden, "colors": colors, "dtype": dtype,
            "kernels": out}


def compare(path_a: str, path_b: str) -> int:
    """Prints, call by call, whether two ``--outputs`` files hold bitwise
    the same outputs (and the largest difference where not); one JSON
    object.  Calls are matched by their key and its count (the n-th call of
    a kernel in each); a call only one tree makes is listed apart.  Returns
    0 when every call both made is bitwise the same."""
    def keyed(saved):
        seen, out = {}, {}
        for key, tensors in saved:
            seen[key] = seen.get(key, 0) + 1
            out[f"{key} #{seen[key]}"] = tensors
        return out

    a, b = keyed(torch.load(path_a)), keyed(torch.load(path_b))
    rows, same = [], True
    for key in [k for k in a if k in b]:
        ta, tb = a[key], b[key]
        equal = len(ta) == len(tb) and all(
            x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(ta, tb))
        diff = max((float((x.float() - y.float()).abs().max()) for x, y in zip(ta, tb)
                    if x.shape == y.shape and x.numel()), default=0.0)
        rows.append({"kernel": key, "bitwise": equal, "max_abs_diff": diff})
        same = same and equal
    print(json.dumps({"a": path_a, "b": path_b, "calls": len(rows), "bitwise": same,
                      "only_in_a": [k for k in a if k not in b],
                      "only_in_b": [k for k in b if k not in a], "outputs": rows}))
    return 0 if same else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--widths", default="0,7,32",
                        help="state scalars of the density inputs (3 + s), comma-separated")
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--family", choices=("classic", "mip"), default="classic")
    parser.add_argument("--features", default="96,144,600",
                        help="mip feature widths (multiples of 3), comma-separated")
    parser.add_argument("--hidden", default="256", help="hidden widths, comma-separated")
    parser.add_argument("--colors", type=int, default=3)
    parser.add_argument("--samples", default="64,128",
                        help="coarse and fine samples of K3, K4 and K9")
    parser.add_argument("--outputs", default=None,
                        help="save each call's outputs to this file (torch.save)")
    parser.add_argument("--compare", nargs=2, metavar=("A", "B"), default=None,
                        help="compare two --outputs files bit for bit (no GPU) and exit")
    args = parser.parse_args()
    if args.compare is not None:
        return compare(*args.compare)
    if not torch.cuda.is_available():
        print("torch_tile_timing: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    _build.build()
    global KEEP_OUTPUTS
    KEEP_OUTPUTS = args.outputs is not None
    hidden = [int(h) for h in args.hidden.split(",")]
    if args.family == "mip":
        results = [run_mip(device, int(f), dtype, h, args.colors)
                   for f in args.features.split(",") for h in hidden
                   for dtype in args.dtypes.split(",")]
    else:
        samples = tuple(int(n) for n in args.samples.split(","))
        results = [run(device, int(s), dtype, h, args.colors, samples)
                   for s in args.widths.split(",") for h in hidden
                   for dtype in args.dtypes.split(",")]
    if args.outputs is not None:
        torch.save(SAVE, args.outputs)
    print(card)
    print(json.dumps({"card": card, "tree": str(REPO), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
