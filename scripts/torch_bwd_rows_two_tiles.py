"""Measures, on the card, a prototype of the row pass with two row tiles in
flight (``scripts/bwd_rows_two_tiles.cu``: each consumer warpgroup its own
64-row tile over all 256 columns, the LayerNorm backward in the wgmma
accumulator layout) under three schedules: ``lockstep`` (both warpgroups'
products and epilogues in step: no overlap), ``shared`` (one ring of B
chunks, the warpgroups free but at most the ring's slots apart) and
``two_rings`` (a ring each, fed with the same chunks from L2, the
warpgroups free).  The hidden layers of the classic order only: no heads,
no inputs' cotangents; a random chain (xhat, LayerNorm statistics), scales,
weights and last-layer cotangent from seed 0 at the shapes of K1-bwd (the
reuse step: 131,072 rows, 10 layers) and K6 (4096 x 63 = 258,048 rows,
5 layers), hidden 256, in float32 (3xTF32) and bf16.

    python scripts/torch_bwd_rows_two_tiles.py [--cases k1bwd,k6] [--dtypes float32,bfloat16]
                                               [--spins 0,4000,8000,16000] [--iters 5]

For each case, dtype, schedule and batch (1 or 2 chunks between waits):

* ``all``: the pass; its dpre (every layer) and column sums (db, dg,
  dbeta) held against a plain PyTorch evaluation of the same function
  (products 3xTF32 as ``tc_mlp.tc_matmul`` computes them, or bf16 as
  ``tc_mlp.bf16_matmul``), as the largest difference over the largest
  entry, against 1e-4 (float32) or 1e-2 (bf16);
* ``epilogues``: the epilogues alone (no products, no chunk copied);
* ``products``: the products, each epilogue replaced by a wait of each
  ``--spins`` clock cycles and the accumulator's stores as dpre (the
  products' A operand, and what keeps ptxas from dropping the products):
  whether a schedule hides a given epilogue time behind the other tile's
  products (lockstep adds it; a free schedule hides it while the ring
  lets one tile run ahead).

Times are the mean of CUDA events over ``--iters`` calls after two
warm-ups, beside the products' FLOP floor (165 or 989 TFLOP/s) and the
chain's bytes floor (xhat read and dpre written, float32, 3.35 TB/s).
Prints ptxas's registers and spills, the card's name and power limit,
then one JSON object.  Exits non-zero without a GPU or when a check
fails.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line, the event timer, the peaks, ptxas_usage)
from nerf_tpu_torch.ops.kernels import _build, tc_mlp  # noqa: E402

SRC = REPO / "scripts" / "bwd_rows_two_tiles.cu"
WORK = REPO / "build" / "bwd_rows_two_tiles"
H = 256
MODES = {"lockstep": 0, "shared": 1, "two_rings": 2}
PARTS = {"all": 0, "products": 1, "epilogues": 2}
CASES = {"k1bwd": (131_072, 10), "k6": (258_048, 5)}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}
BATCHES = (1, 2)


def build() -> tuple:
    """One library for each dtype and batch, the nvcc runs started together."""
    WORK.mkdir(parents=True, exist_ok=True)
    procs = {}
    for dtype in ("float32", "bfloat16"):
        for batch in BATCHES:
            lib = WORK / f"libtwo_tiles_{dtype}_{batch}.so"
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-DTT_BF16={int(dtype == 'bfloat16')}",
                   f"-DTT_BATCH={batch}", "-I", str(_build.CSRC), "-o", str(lib), str(SRC)]
            procs[(dtype, batch)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                           stderr=subprocess.STDOUT, text=True))
    libs, usage = {}, []
    ptr = ctypes.c_void_p
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        (WORK / f"nvcc_{key[0]}_{key[1]}.txt").write_text(out)
        if proc.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {key}")
        usage += [f"{key[0]} batch {key[1]}: {label}: {u}"
                  for label, u in chip_smoke.ptxas_usage(out)]
        libs[key] = ctypes.CDLL(str(lib))
        libs[key].two_tiles_rows.argtypes = ([ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                                             + [ptr] * 7 + [ctypes.c_int] * 3)
    return libs, sorted(set(usage))


def k_permutation(k: int) -> torch.Tensor:
    """Image row k' of each k-step of 8 holds column 2k' (k' < 4) or 2(k' -
    4) + 1: the TF32 A fragment's slots as the accumulator holds them."""
    step = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7])
    return (torch.arange(k // 8)[:, None] * 8 + step).reshape(-1)


def inputs(rows: int, layers: int, device) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    return {"xhat": rand(layers, rows, H) * 1.7,
            "stats": torch.stack([rand(layers, rows, lo=0.5, hi=1.5),
                                  rand(layers, rows, lo=-1.0, hi=0.2)], -1).contiguous(),
            "g": rand(layers, H, lo=0.5, hi=1.5), "dh0": rand(rows, H) * 0.1,
            "w": rand(layers - 1, H, H) / 16}


def image(w: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return tc_mlp.operand_image(w, torch.bfloat16).contiguous()
    return tc_mlp.operand_image(w[..., k_permutation(H).to(w.device)]).contiguous()


def reference(a: dict, dtype: str):
    """dpre [L][P][H] and the column sums [3][L][H] (db, dg, dbeta)."""
    matmul = tc_mlp.bf16_matmul if dtype == "bfloat16" else tc_mlp.tc_matmul
    layers = a["xhat"].shape[0]
    dpre = torch.empty_like(a["xhat"])
    sums = torch.empty(3, layers, H, device=dpre.device)
    dh = a["dh0"]
    for i in range(layers - 1, -1, -1):
        xh, st = a["xhat"][i], a["stats"][i]
        dxh = dh * a["g"][i]
        m1 = dxh.mean(-1, keepdim=True)
        m2 = (dxh * xh).mean(-1, keepdim=True)
        dp = torch.where(xh > st[:, 1:], st[:, :1] * (dxh - m1 - xh * m2), torch.zeros_like(xh))
        dpre[i] = dp
        sums[0, i], sums[1, i], sums[2, i] = dp.sum(0), (dh * xh).sum(0), dh.sum(0)
        if i:
            dh = matmul(dp, a["w"][i - 1].t())
    return dpre, sums


def distance(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).abs().max()) / (float(ref.abs().max()) + 1e-30)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cases", default="k1bwd,k6")
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--spins", default="0,4000,8000,16000")
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_rows_two_tiles: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    libs, usage = build()
    print("ptxas:", *usage, sep="\n  ", flush=True)
    spins = [int(v) for v in args.spins.split(",")]
    results, ok = {"ptxas": usage}, True
    for case in args.cases.split(","):
        rows, layers = CASES[case]
        a = inputs(rows, layers, device)
        for dtype in args.dtypes.split(","):
            img = image(a["w"], dtype)
            ref_dpre, ref_sums = reference(a, dtype)
            blocks = min(132, rows // 128)
            rate = chip_smoke.PEAK_BF16_FLOPS if dtype == "bfloat16" else chip_smoke.PEAK_3XTF32_FLOPS
            row = {"rows": rows, "layers": layers, "blocks": blocks,
                   "flop_floor_ms": 2 * rows * (layers - 1) * H * H / rate * 1e3,
                   "bytes_floor_ms": 2 * rows * layers * H * 4 / chip_smoke.PEAK_BYTES_PER_S * 1e3}
            dpre = torch.zeros_like(a["xhat"])
            part = torch.empty(2 * blocks, 3, layers, H, device=device)
            runs = [(m, b, "all", 0) for m in MODES for b in BATCHES]
            runs += [(m, 1, "epilogues", 0) for m in MODES]
            runs += [(m, b, "products", sp) for m in MODES for b in BATCHES for sp in spins]
            for mode, batch, parts, sp in runs:
                lib = libs[(dtype, batch)]

                def call():
                    rc = lib.two_tiles_rows(
                        MODES[mode], PARTS[parts], sp, a["xhat"].data_ptr(),
                        a["stats"].data_ptr(), a["g"].data_ptr(), a["dh0"].data_ptr(),
                        img.data_ptr(), dpre.data_ptr(), part.data_ptr(), rows, layers, blocks)
                    if rc:
                        raise RuntimeError(f"two_tiles_rows returned {rc}")

                key = f"{mode} batch {batch} {parts}" + (f" spin {sp}" if parts == "products" else "")
                entry = {}
                if parts == "all":
                    call()
                    torch.cuda.synchronize()
                    entry["dpre_err"] = max(distance(dpre[i], ref_dpre[i]) for i in range(layers))
                    entry["colsum_err"] = distance(part.sum(0), ref_sums)
                    entry["ok"] = max(entry["dpre_err"], entry["colsum_err"]) <= TOL[dtype]
                    ok &= entry["ok"]
                entry["ms"] = chip_smoke.cuda_ms(call, iters=args.iters)
                row[key] = entry
                errs = (f"; dpre {entry['dpre_err']:.2e}, column sums {entry['colsum_err']:.2e} "
                        f"({'ok' if entry['ok'] else 'FAILED'})" if parts == "all" else "")
                print(f"{case} {dtype} {key}: {entry['ms']:.3f} ms{errs}", flush=True)
            print(f"{case} {dtype}: FLOP floor {row['flop_floor_ms']:.3f} ms, bytes floor "
                  f"{row['bytes_floor_ms']:.3f} ms", flush=True)
            results[f"{case} {dtype}"] = row
    print(card)
    print(json.dumps({"card": card, "ok": ok, "results": results}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
