"""Splits the time of the row pass of the MLP backward (``csrc/tc_mlp.cuh``'s
``bwd_rows_tc_kernel`` and ``csrc/mip_mlp.cuh``'s ``mip_bwd_rows_tc_kernel``)
on the card: K6 at its cell (4096 rays x 63 interval rows, seg weight 0.1,
the full-width MipNeRF), K1-bwd at the reuse step's 2048 x 64 = 131,072
rows (the full-width ClassicNeRF, no encodings' cotangents) and, with
``--kernels k2``, K2 at 4096 x 64 (``chip_smoke.py`` phase 22's inputs),
random weights from seed 0, in both dtypes, built from copies of ``csrc/`` with one part of
the pass taken out at a time.

    python scripts/torch_bwd_rows_split.py [--variants base,...] [--dtypes float32,bfloat16]
                                           [--kernels k6,k1bwd,k2] [--iters 10] [--compile-only]

Variants of the source (each a copy under ``build/bwd_rows_split/``; the
committed sources are not touched):

* ``base``: the pass as it stands;
* ``no_products``: no ``dh = dpre W^T`` product of the layer loop (the
  producer copies no B chunk for it either);
* ``no_loads``: the xhat rows and LayerNorm statistics of ``layer_bwd`` not
  read (made up in registers);
* ``no_stores``: no dpre row stored;
* the other ways of storing dpre, text patches of the copy:
  ``bulk_stores``, both passes' dpre by bulk stores from the activation
  tile where the product reads it (they store it from registers);
  ``no_null_test``, ``layer_bwd``'s stores without their null test;
  joined by ``+``;
* ``no_colsum``: no column sums of the tile (``tile_colsum`` empty);
* ``no_heads``: no heads' backward (``head_bwd``, the mip ``head_dh`` or
  the head's product);
* ``no_roundtrip``: no ``tc_store_rows`` / ``tc_to_rows`` trip through the
  activation tile (the accumulator copied into the row layout in
  registers, the products reading the tile as it stands).

Only ``base`` computes the gradients; the other variants' outputs are
meaningless and only times are kept.  Each time is device ms per call from
``torch.profiler`` over ``--iters`` calls, by pass: ``fwd_store``
(``*fwd_store_tc_kernel``), ``bwd_rows`` (``*bwd_rows_tc_kernel``),
``wgrad`` (``wgrad_tc_kernel``) and ``colsum`` (``colsum_kernel``), and the
whole call from CUDA events; ``base`` runs first and last (the spread of
one build in the call).  K1-bwd is called directly (``classic_mlp_bwd``,
which runs the forward that stores the chain first) and, where the tree
has it, from a stored chain (``classic_mlp_fwd_chain`` then
``classic_mlp_bwd(..., chain=...)``, the route autograd takes).  The
passes' floors beside them: the products' FLOP at 165 TFLOP/s (3xTF32) or
989 (bf16), and the chain's bytes (xhat read, dpre written, float32) at
3.35 TB/s.  ``--compile-only`` builds the variants and reports ptxas's
registers, spills and C75xx notes of the row pass.  Prints the card's name
and power limit, then one JSON object.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line, the event timer, ptxas_usage)
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig, MipNeRF, MipNeRFConfig  # noqa: E402
from nerf_tpu_torch.ops import compositing  # noqa: E402
from nerf_tpu_torch.ops.kernels import (  # noqa: E402
    _build, classic_mlp, mip_mlp, mip_train, tc_mlp, train_grads)

WORK = REPO / "build" / "bwd_rows_split"
VARIANTS = ("base", "no_products", "no_loads", "no_stores", "no_colsum", "no_heads",
            "no_roundtrip")
# The other ways of storing dpre (``--variants base,bulk_stores,...``;
# joined with "+" they apply together): both passes' dpre by bulk stores
# from the activation tile, and layer_bwd's register stores without their
# null test.
EXTRA_VARIANTS = ("bulk_stores", "no_null_test")
PASSES = {"fwd_store": "fwd_store_tc_kernel", "bwd_rows": "bwd_rows_tc_kernel",
          "wgrad": "wgrad_tc_kernel", "colsum": "colsum_kernel"}
LIBS = {"k6": mip_train.TRAIN_NAME, "k1bwd": classic_mlp.BWD_NAME, "k2": train_grads.NAME}

# The accumulator of dh copied into the row-per-warp layout without the
# trip through shared memory (no_roundtrip; the values land in the wrong
# rows and columns, the time is what counts).
_REGS_TO_ROWS = """
template <int H>
__device__ __forceinline__ void regs_to_rows(const float (&d)[H / 4],
                                             float (&acc)[kRowsPerWarp][H / 32]) {
#pragma unroll
  for (int k = 0; k < H / 4; ++k) acc[k / (H / 32)][k % (H / 32)] = d[k];
}
"""


# dpre by bulk stores from the activation tile (the bulk_stores variant):
# this warp's rows of the tile -> layer `layer`'s dpre rows, one bulk
# store a row in one bulk group of each thread, after a fence of the
# lanes' stores into the tile; waits for the group to have read the tile
# (before it is written again) and to be done (before dpre is read).
_BULK_HELPERS = """
template <int H>
__device__ __forceinline__ void store_dpre_rows(const float* act, float* dpre, int layer,
                                                size_t P, size_t row0, int nvalid) {
  constexpr int ld = act_ld<H>();
  fence_async_smem();
  __syncwarp();
  const int lane = threadIdx.x & 31, row = (threadIdx.x >> 5) * kRowsPerWarp + lane;
  if (lane < kRowsPerWarp && row < nvalid)
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\\n" ::"l"(
                     dpre + (static_cast<size_t>(layer) * P + row0 + row) * H),
                 "r"(smem_u32(act + row * ld)), "r"(static_cast<uint32_t>(H * sizeof(float)))
                 : "memory");
  asm volatile("cp.async.bulk.commit_group;\\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_visible() {
  asm volatile("cp.async.bulk.wait_group 0;\\nfence.proxy.async.global;\\n" ::: "memory");
}
"""


def _body(src: str, heads: tuple) -> tuple:
    for head in heads:
        if head in src:
            start = src.index(head)
            return start, src.index("\n}\n", start)
    raise RuntimeError(f"none of {heads} found")


def _sub(text: str, old: str, new: str, what: str, regex: bool = False) -> str:
    if regex:
        out, n = re.subn(old, new, text, flags=re.S)
    else:
        n = text.count(old)
        out = text.replace(old, new)
    if n < 1:
        raise RuntimeError(f"{what}: patch site not found: {old!r}")
    return out


def patch(files: dict, variant: str) -> dict:
    """The sources (``{file name: text}``) with the variant's part of the
    row pass taken out (or built the other way).  The sites name the
    kernels of the tree the script sits in: the classic pass as it is since
    commit 776d22a, the mip pass with the SIMT head (as at that commit) or
    with the head's product on the tensor cores."""
    if variant == "base":
        return files
    if "+" in variant:  # several variants, one after the other
        for v in variant.split("+"):
            files = patch(files, v)
        return files
    tc, mip, train = files["tc_mlp.cuh"], files["mip_mlp.cuh"], files["classic_mlp_train.cuh"]
    ca, cb = _body(tc, ("bwd_rows_tc_kernel(Weights w",))
    ma, mb = _body(mip, ("mip_bwd_rows_tc_kernel(MipWeights w",))
    ck, mk = tc[ca:cb], mip[ma:mb]
    tc_head = "kHeadK" in mk  # the mip head's product on the tensor cores
    store = r"if \((dpre != nullptr && )?row < nvalid\) dpre\[at \* H \+ lane \+ 32 \* j\] = dp;"
    if variant == "bulk_stores":  # both passes' dpre by bulk stores from the activation tile
        store_site = (r"(stats, )dpre(, p_b, p_g, p_beta, red\);\n      )if \(i == 0\) break;\n"
                      r"      if constexpr \(kC\) tc_store_rows<H>\(acc, act\);")
        bulk = (r"\1nullptr\2if constexpr (kC) {\n        tc_store_rows<H>(acc, act);\n"
                r"        store_dpre_rows<H>(act, dpre, i, PP, row0, nvalid);\n      }\n"
                r"      if (i == 0) break;")
        ck = _sub(ck, store_site, bulk, variant, regex=True)
        mk = _sub(mk, store_site, bulk, variant, regex=True)
        ck = _sub(ck, "      if constexpr (kC) {\n        tc_to_rows<H>(d, act, acc);",
                  "      if constexpr (kC) {\n        bulk_wait_read();\n        tile_sync();\n"
                  "        tc_to_rows<H>(d, act, acc);", variant)
        mk = _sub(mk, "      if constexpr (kC) tc_to_rows<H>(d, act, acc);\n",
                  "      if constexpr (kC) {\n        bulk_wait_read();\n        tile_sync();\n"
                  "        tc_to_rows<H>(d, act, acc);\n      }\n", variant)
        ck = _sub(ck, "    if (dx != nullptr)\n", "    if constexpr (kC) bulk_wait_visible();\n"
                  "    if (dx != nullptr)\n", variant)
        mk = _sub(mk, "    if (dx != nullptr)\n", "    if constexpr (kC) bulk_wait_visible();\n"
                  "    if (dx != nullptr)\n", variant)
        at = tc.rindex("\n// bwd is the backward operand images", 0, ca)
        tc = tc[:at] + _BULK_HELPERS + tc[at:]
        ca, cb = ca + len(_BULK_HELPERS), cb + len(_BULK_HELPERS)
    elif variant == "no_null_test":  # layer_bwd's store without its (always true) null test
        train = _sub(train, "if (dpre != nullptr && row < nvalid)", "if (row < nvalid)", variant)
    elif variant == "no_products":
        old = "tc_gemm<H, kBf16>(pipe, d, act, act_ld<H>(), H, bwd + (i - 1) * slab);"
        ck, mk = _sub(ck, old, "", variant), _sub(mk, old, "", variant)
    elif variant == "no_loads":
        train = _sub(train, "st[r] = valid ? reinterpret_cast<const float2*>(stats)[at] : "
                            "make_float2(0.f, 0.f);",
                     "st[r] = make_float2(1.f + row, -0.5f);", variant)
        train = _sub(train, "xh[r][j] = valid ? xhat[at * H + lane + 32 * j] : 0.f;",
                     "xh[r][j] = 0.01f * (lane + 32 * j + row);", variant)
    elif variant == "no_stores":  # both ways of storing dpre taken out
        train = _sub(train, store, "", variant, regex=True)
    elif variant == "no_colsum":
        a, b = _body(train, ("__device__ void tile_colsum(",))
        brace = train.index("{", a)
        train = train[:brace] + "{\n  (void)s; (void)red; (void)out; (void)stride;" + train[b:]
    elif variant == "no_heads":
        ck = _sub(ck, r"head_bwd<H, kBf16>\(acc, gs,.*?\);", "(void)0;", variant, regex=True)
        if tc_head:  # the head's product on the tensor cores: no chunk, in both roles
            mk = _sub(mk, "for (int q0 = 0; q0 < O; q0 += H) {",
                      "for (int q0 = 0; q0 < 0; q0 += H) {", variant)
        else:
            mk = _sub(mk, r"head_dh<H, kBf16>\(acc, gout.*?\);", "(void)0;", variant, regex=True)
    elif variant == "no_roundtrip":
        ck = _sub(ck, "if constexpr (kC) tc_store_rows<H>(acc, act);", "", variant)
        mk = _sub(mk, "if constexpr (kC) tc_store_rows<H>(acc, act);", "", variant)
        ck = _sub(ck, "tc_to_rows<H>(d, act, acc);", "regs_to_rows<H>(d, acc);", variant)
        mk = _sub(mk, "tc_to_rows<H>(d, act, acc);", "regs_to_rows<H>(d, acc);", variant)
        at = tc.rindex("\n// bwd is the backward operand images", 0, ca)
        tc = tc[:at] + _REGS_TO_ROWS + tc[at:]
        ca, cb = ca + len(_REGS_TO_ROWS), cb + len(_REGS_TO_ROWS)
    else:
        raise ValueError(f"unknown variant {variant}")
    return {**files, "tc_mlp.cuh": tc[:ca] + ck + tc[cb:], "mip_mlp.cuh": mip[:ma] + mk + mip[mb:],
            "classic_mlp_train.cuh": train}


def variant_dir(variant: str) -> Path:
    root = WORK / variant
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    names = ("tc_mlp.cuh", "mip_mlp.cuh", "classic_mlp_train.cuh")
    files = patch({n: (csrc / n).read_text() for n in names}, variant)
    for n in names:
        (csrc / n).write_text(files[n])
    return root


def k6_inputs(device, dtype: str):
    """K6's arguments at its cell, as ``scripts/torch_tile_timing.py`` draws
    them; the floors of its row pass."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(96)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    cfg = MipNeRFConfig()
    model = MipNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = mip_mlp.pack_mip_params(model.mlp.requires_grad_(False))
    rays, rows = 4096, 63
    x = rand(rays * rows, cfg.feature_dim).to(tdt)
    points = torch.cumsum(rand(rays, rows, 3, lo=0.0, hi=1.0), dim=1)
    a = (x.reshape(rays, rows, -1), compositing.distances_from_points(points).contiguous(),
         rand(rays, rows), rand(rays, cfg.color_outputs, lo=0.0, hi=1.0),
         torch.randint(0, cfg.segmentation_outputs, (rays,), generator=gen, device=device))
    h, layers, n_out = cfg.hidden_size, cfg.num_hidden_layers, cfg.num_outputs
    call = lambda: mip_train.mip_train_grads(packed, *a, cfg.color_outputs, 0.1)  # noqa: E731
    return call, None, floors(rays * rows, (layers - 1) * h * h + n_out * h, layers, h)


def k1bwd_inputs(device, dtype: str):
    """K1-bwd's arguments at the reuse step's rows; the direct call, the
    stored-chain call where the tree has one, and the row pass's floors."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, lo=-1.0, hi=1.0):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    cfg = ClassicNeRFConfig(normalize_position=6.0, compute_dtype=dtype)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    rows, h = 131_072, cfg.hidden_size
    x = rand(rows, cfg.x_encoding_dim).to(tdt)
    d = rand(rows, cfg.d_encoding_dim).to(tdt)
    g = rand(rows, 4)
    fwd, bwd = tc_mlp.tc_images(packed, backward=True, dtype=tdt)
    direct = lambda: classic_mlp.classic_mlp_bwd(packed, x, d, g, False, fwd, bwd)  # noqa: E731
    stored = None
    if hasattr(classic_mlp, "classic_mlp_fwd_chain"):
        _, chain = classic_mlp.classic_mlp_fwd_chain(packed, x, d, fwd)
        stored = lambda: classic_mlp.classic_mlp_bwd(  # noqa: E731
            packed, x, d, g, False, fwd, bwd, chain=chain)
    # dh of the nine hidden slabs and the heads' dW and input cotangents
    # (1 + 3 outputs; the reuse step asks no encodings' cotangents).
    macs = 9 * h * h + 2 * 4 * h
    return direct, stored, floors(rows, macs, 10, h)


def k2_inputs(device, dtype: str):
    """K2 at 4096 x 64 on ``chip_smoke.py`` phase 22's inputs; the floors
    of its row pass."""
    call, rows = chip_smoke.wgrad_cases(device, dtype)[train_grads.NAME][:2]
    h = 256  # dh of the nine hidden slabs and the heads' (1 + 3 outputs)
    return call, None, floors(rows, 9 * h * h + 2 * 4 * h, 10, h)


def floors(rows: int, macs_per_row: int, layers: int, hidden: int) -> dict:
    flops = 2 * rows * macs_per_row
    chain = rows * layers * hidden * 4 * 2  # xhat read, dpre written
    return {"flop_floor_3xtf32_ms": flops / chip_smoke.PEAK_3XTF32_FLOPS * 1e3,
            "flop_floor_bf16_ms": flops / chip_smoke.PEAK_BF16_FLOPS * 1e3,
            "chain_bytes_floor_ms": chain / chip_smoke.PEAK_BYTES_PER_S * 1e3}


def pass_ms(fn, iters: int) -> dict:
    """Device ms per call of each pass's kernels."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(PASSES, 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for key, name in PASSES.items():
            if name in e.name:
                out[key] += e.time_range.elapsed_us() / 1e3 / iters
    if out["bwd_rows"] == 0:
        raise RuntimeError("the profiler recorded no bwd_rows kernel")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--kernels", default="k6,k1bwd")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--compile-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_bwd_rows_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    variants = tuple(args.variants.split(","))
    kernels = tuple(args.kernels.split(","))
    roots = {v: variant_dir(v) for v in variants}
    procs = {}
    for v, root in roots.items():  # one nvcc a library and variant, all started together
        (root / "build").mkdir(parents=True, exist_ok=True)
        for k in kernels:
            lib = LIBS[k]
            cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                   str(root / "build" / f"lib{lib}.so"), str(root / "csrc" / f"{lib}.cu")]
            procs[(v, k)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for (v, k), p in procs.items():
        out, _ = p.communicate()
        (WORK / f"{v}.{k}.nvcc.txt").write_text(out)
        if p.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {v} {k}")
        ptxas[f"{v} {k}"] = sorted({f"{label}: {usage}" for label, usage in
                                    chip_smoke.ptxas_usage(out) if "bwd_rows" in label})
    results = {"ptxas_bwd_rows": ptxas}
    if args.compile_only:
        print(card)
        print(json.dumps({"card": card, "results": results}))
        return 0
    for k in kernels:
        for dtype in args.dtypes.split(","):
            inputs = {"k6": k6_inputs, "k1bwd": k1bwd_inputs, "k2": k2_inputs}[k]
            direct, stored, row = inputs(device, dtype)
            for v in variants + variants[:1]:
                _build.CSRC = roots[v] / "csrc"
                _build.BUILD_DIR = roots[v] / "build"
                _build._LIBS.pop(LIBS[k], None)
                with torch.no_grad():
                    row.setdefault(f"{v} passes_ms", []).append(pass_ms(direct, args.iters))
                    row.setdefault(f"{v} call_ms", []).append(
                        chip_smoke.cuda_ms(direct, iters=args.iters))
                    if stored is not None:
                        row.setdefault(f"{v} stored passes_ms", []).append(
                            pass_ms(stored, args.iters))
                        row.setdefault(f"{v} stored call_ms", []).append(
                            chip_smoke.cuda_ms(stored, iters=args.iters))
            results[f"{k} {dtype}"] = row
            print(k, dtype, json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
