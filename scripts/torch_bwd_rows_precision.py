"""How far K1-bwd's gradients sit from a float64 evaluation as the rows
grow, beside the plain float32 version's: the full-width ClassicNeRF
(random weights from seed 0) on rows drawn as the card tests draw them
(``tests/test_torch_cuda.py``'s ``k1_inputs``: every row's ReLU inputs
farther than 1e-5 from 0 under float32), random output cotangents, with
and without the encodings' cotangents.

    python scripts/torch_bwd_rows_precision.py [--rows 8384,65536,262144]

For each packed weight (and dx, dd) it prints, normalised by the float64
gradient's largest entry, the kernel's distance from float64, plain
float32's, plain float32's with 3xTF32 products (``tc_mlp.tc_matmul``,
as the tensor cores compute them), and the kernel's from each plain
version.  It also counts the rows whose ReLU masks (any layer, any
column) differ from float64's: the kernel's, read from the chain its
forward keeps (``classic_mlp_fwd_chain``: xhat > -mu/sigma), plain
float32's and the 3xTF32 emulation's, and the kernel's from plain
float32's: the 3xTF32 kernel and plain float32 take the ReLU branches
alike only while the rows stay farther from the kinks than their
differences.  The file runs unchanged
from another checkout's ``scripts/`` directory (it imports the package
and the card tests of the tree it sits in).  Prints the card's name and
power limit, then one JSON object.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

import chip_smoke  # noqa: E402  (the card line)
import test_torch_cuda as card  # noqa: E402  (the card tests' weights and rows)
from nerf_tpu_torch.ops.kernels import classic_mlp, tc_mlp  # noqa: E402


def forward64(p, x, d, matmul=torch.matmul, masks=None):
    """The classic MLP (view branch on) as ``classic_mlp_fwd_plain``
    computes it, in the dtype of its inputs (float64 here); ``masks``, a
    list, takes each layer's ReLU mask (pre-activation > 0)."""
    def layer(i, pre):
        pre = pre + p["b"][i]
        if masks is not None:
            masks.append(pre > 0)
        a = torch.relu(pre)
        return F.layer_norm(a, a.shape[-1:], p["g"][i], p["beta"][i], 1e-5)

    whh = p["whh"]
    h = layer(0, matmul(x, p["w0"]))
    for i in (1, 2, 3):
        h = layer(i, matmul(h, whh[i - 1]))
    h = layer(4, matmul(h, whh[3]) + matmul(x, p["wx"]))
    for i in (5, 6, 7):
        h = layer(i, matmul(h, whh[i - 1]))
    dens = h @ p["w_dens"] + p["b_dens"]
    h = layer(8, matmul(h, whh[7]) + matmul(d, p["wd_in"]))
    h = layer(9, matmul(h, whh[8]))
    return torch.cat([dens, h @ p["w_col"] + p["b_col"]], -1)


def flipped_rows(packed, x, d) -> dict:
    """Rows whose ReLU masks (any layer, any column) differ: the kernel's
    (from its kept chain), plain float32's and the 3xTF32 emulation's
    against float64's, and the kernel's against plain float32's and the
    emulation's."""
    with torch.no_grad():
        _, chain = classic_mlp.classic_mlp_fwd_chain(packed, x, d)
        kernel = [chain["xhat"][i] > chain["stats"][i][:, 1:2]
                  for i in range(chain["xhat"].shape[0])]
        del chain
        f64, f32, tc = [], [], []
        forward64({k: v.double() for k, v in packed.items()}, x.double(), d.double(), masks=f64)
        forward64(packed, x, d, masks=f32)
        forward64(packed, x, d, tc_mlp.tc_matmul, masks=tc)

    def rows(a, b):
        return int(torch.stack([(u != v).any(-1) for u, v in zip(a, b)]).any(0).sum())

    return {"kernel_f64": rows(kernel, f64), "f32_f64": rows(f32, f64),
            "tc_emulated_f64": rows(tc, f64), "kernel_f32": rows(kernel, f32),
            "kernel_tc_emulated": rows(kernel, tc), "rows": x.shape[0]}


def backward64(packed, x, d, g, input_grads):
    with torch.enable_grad():
        leaves = {k: v.double().requires_grad_(True) for k, v in packed.items()}
        xs = x.double().requires_grad_(input_grads)
        ds = d.double().requires_grad_(input_grads)
        wrt = ([xs, ds] if input_grads else []) + list(leaves.values())
        grads = list(torch.autograd.grad(forward64(leaves, xs, ds), wrt, g.double()))
    ins = (grads.pop(0), grads.pop(0)) if input_grads else (None, None)
    return ins + (dict(zip(leaves, grads)),)


def named(r, input_grads):
    out = {k: v.double() for k, v in r[2].items()}
    if input_grads:
        out.update(dx=r[0].double(), dd=r[1].double())
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--rows", default="8384,65536,262144")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_rows_precision: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card_line = chip_smoke.nvidia_smi("name,power.limit")
    out = {}
    for rows in (int(r) for r in args.rows.split(",")):
        cfg, packed = card.packed_weights("full_width", device)
        x, d, g = card.k1_inputs(cfg, packed, device, rows // 64, 64, seed=rows)
        flips = flipped_rows(packed, x, d)
        out[f"{rows} rows, rows whose ReLU masks differ"] = flips
        print(rows, "rows whose ReLU masks differ", json.dumps(flips), flush=True)
        for input_grads in (True, False):
            got = named(classic_mlp.classic_mlp_bwd(packed, x, d, g, input_grads), input_grads)
            f32 = named(classic_mlp.classic_mlp_bwd_plain(packed, x, d, g, input_grads),
                        input_grads)
            tc = named(classic_mlp.classic_mlp_bwd_plain(
                packed, x, d, g, input_grads, matmul=tc_mlp.tc_matmul_autograd), input_grads)
            f64 = named(backward64(packed, x, d, g, input_grads), input_grads)
            row = {}
            for k, ref in f64.items():
                scale = float(ref.abs().max()) + 1e-30
                row[k] = {"kernel_f64": float((got[k] - ref).abs().max()) / scale,
                          "f32_f64": float((f32[k] - ref).abs().max()) / scale,
                          "tc_emulated_f64": float((tc[k] - ref).abs().max()) / scale,
                          "kernel_f32": float((got[k] - f32[k]).abs().max()) / scale,
                          "kernel_tc_emulated": float((got[k] - tc[k]).abs().max()) / scale}
            out[f"{rows} rows, input_grads={input_grads}"] = row
            print(rows, input_grads, json.dumps({k: {n: round(v, 7) for n, v in r.items()}
                                                 for k, r in row.items()}), flush=True)
    print(card_line)
    print(json.dumps({"card": card_line, "tree": str(REPO), "distances": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
