"""How the float32 wide products' sums move K1 past hidden 256, on the card.

    python scripts/torch_wide_sums.py [--groups 0,1,2,4,8] [--hidden 512,1024]
                                      [--out wide_sums.json]

Past hidden 256 each layer's product runs K = padded hidden values long
(``csrc/tc_mlp.cuh`` note 11: 64 k-chunks of 16 at 1024), and the tensor
cores truncate as they accumulate (note 7).  ``tc_gemm`` sums those
products in groups of ``kF32GroupChunks`` chunks, each group in a cleared
accumulator added to the sum so far in float32.  This script builds K1-fwd
and K1-bwd (``csrc/classic_mlp_fwd.cu``, ``csrc/classic_mlp_bwd.cu``) once
for each group size G given, from a copy of ``csrc/`` with the constant
set to G (G = 0: ``kGroupedSums`` off, each product in one accumulator),
and, for each hidden width, on the full-width
ClassicNeRF (view branch on, random weights from seed 0) with uniform
inputs in [-1, 1) from a seed:

* K1-fwd on 262,144 rows: its largest distance from the plain float32
  version (``classic_mlp_fwd_plain``) and from the plain version with its
  sums in float64, the largest ratio of that distance to K1's tolerance
  (rtol 1e-4, atol 1e-4; at most 1 passes), and the plain float32
  version's own distance from float64 sums;
* K1-bwd on 65,536 rows (uniform output cotangents, no inputs'
  cotangents): its weight gradients' worst relative L2 distance from the
  plain float32 version's;

each timed (mean of CUDA events after two warm-up calls).  Prints the
card's name and power limit, one JSON line a measurement, and writes them
all to ``--out``.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line, the event timer)
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig  # noqa: E402
from nerf_tpu_torch.ops.kernels import _build, classic_mlp  # noqa: E402

K1_TOL = 1e-4  # rtol and atol
GROUP_LINE = "constexpr int kF32GroupChunks = 4;"
GROUPED_LINE = "inline constexpr bool kGroupedSums<RowsLoadT<T>> = true;"


def variant_sources(g: int, where: Path) -> Path:
    """A copy of ``csrc/`` whose wide float32 products sum in groups of
    ``g`` chunks (0: in one accumulator)."""
    src = where / f"csrc_g{g}"
    shutil.copytree(_build.CSRC, src)
    header = src / "tc_mlp.cuh"
    text = header.read_text()
    if GROUP_LINE not in text or GROUPED_LINE not in text:
        raise RuntimeError("csrc/tc_mlp.cuh no longer declares the group size this script sets")
    if g == 0:
        text = text.replace(GROUPED_LINE, GROUPED_LINE.replace("true", "false"))
    else:
        text = text.replace(GROUP_LINE, GROUP_LINE.replace("4", str(g)))
    header.write_text(text)
    return src


def build_variants(names, groups, where: Path) -> dict:
    """(kernel, G) -> the loaded library built from ``variant_sources(G)``;
    all nvcc started together."""
    procs = {}
    for g in groups:
        src = variant_sources(g, where)
        for name in names:
            lib = where / f"lib{name}_g{g}.so"
            procs[(name, g)] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        loaded = ctypes.CDLL(str(lib))
        for fn_name in _build.FUNCTIONS[key[0]]:
            fn = getattr(loaded, fn_name)
            fn.argtypes = _build.ARGTYPES[fn_name]
            fn.restype = ctypes.c_int
        libs[key] = loaded
    return libs


def float64_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.double() @ b.double()).float()


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--groups", default="0,1,2,4,8")
    parser.add_argument("--hidden", default="512,1024")
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wide_sums: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    groups = [int(g) for g in args.groups.split(",")]
    device = torch.device("cuda")
    print(f"card: {chip_smoke.nvidia_smi('name,power.limit')}", flush=True)
    results = []
    with tempfile.TemporaryDirectory() as where:
        libs = build_variants((classic_mlp.NAME, classic_mlp.BWD_NAME), groups, Path(where))
        for hidden in (int(h) for h in args.hidden.split(",")):
            gen = torch.Generator(device=device).manual_seed(hidden)
            cfg = ClassicNeRFConfig(normalize_position=6.0, hidden_size=hidden)
            model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
            packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))

            def rand(*shape):
                return torch.rand(shape, generator=gen, device=device) * 2 - 1

            x, d = rand(262_144, cfg.x_encoding_dim), rand(262_144, cfg.d_encoding_dim)
            with torch.no_grad():
                ref = classic_mlp.classic_mlp_fwd_plain(packed, x, d)
                ref64 = classic_mlp.classic_mlp_fwd_plain(packed, x, d, matmul=float64_sums)
                own = float((ref - ref64).abs().max())
                for g in groups:
                    _build._LIBS[classic_mlp.NAME] = libs[(classic_mlp.NAME, g)]
                    got = classic_mlp.classic_mlp_fwd(packed, x, d)
                    err = (got - ref).abs()
                    results.append(dict(
                        kernel="K1-fwd", hidden=hidden, rows=x.shape[0], group=g,
                        ms=chip_smoke.cuda_ms(lambda: classic_mlp.classic_mlp_fwd(packed, x, d),
                                              iters=5),
                        max_abs_err=float(err.max()),
                        tol_ratio=float((err / (K1_TOL + K1_TOL * ref.abs())).max()),
                        err_from_float64_sums=float((got - ref64).abs().max()),
                        plain_err_from_float64_sums=own))
                    print(json.dumps(results[-1]), flush=True)
            del ref, ref64
            x, d, g_out = rand(65_536, cfg.x_encoding_dim), rand(65_536, cfg.d_encoding_dim), \
                rand(65_536, 1 + cfg.color_outputs)
            with torch.no_grad():
                ref = classic_mlp.classic_mlp_bwd_plain(packed, x, d, g_out, input_grads=False)[2]
                for g in groups:
                    _build._LIBS[classic_mlp.BWD_NAME] = libs[(classic_mlp.BWD_NAME, g)]

                    def call():
                        return classic_mlp.classic_mlp_bwd(packed, x, d, g_out, input_grads=False)

                    got = call()[2]
                    rel = {k: float((got[k] - ref[k]).norm() / ref[k].norm()) for k in ref}
                    worst = max(rel, key=rel.get)
                    results.append(dict(kernel="K1-bwd", hidden=hidden, rows=x.shape[0], group=g,
                                        ms=chip_smoke.cuda_ms(call, iters=3),
                                        worst_rel_l2=rel[worst], worst=worst))
                    print(json.dumps(results[-1]), flush=True)
        _build._LIBS.clear()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
