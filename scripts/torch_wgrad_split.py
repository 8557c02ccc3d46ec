"""Splits the time of the weight-gradient pass (``csrc/tc_mlp.cuh``'s
``wgrad_tc_kernel``) on the card: K2 at its cell (4096 rays x 64 samples,
the full-width ClassicNeRF, random weights from seed 0) in both dtypes,
built from copies of ``csrc/`` with parts of the pass taken out.

    python scripts/torch_wgrad_split.py [--variants base,...] [--dtypes float32,bfloat16]
                                        [--iters 10] [--compile-only]

Variants of the source (each a copy under ``build/wgrad_split/``; the
committed sources are not touched):

* ``base``: the pass as it stands;
* ``no_wait``: the consumers do not wait for a chunk's raw rows (the
  copies still run; the products read whatever the buffers hold);
* ``no_transform``: B's transform (transposition, split or rounding into
  the operand image) and A's widening or image left out;
* ``no_products``: no ``wgmma`` issued (the operands still staged and
  transformed, the accumulators summed);
* ``no_copies``: no raw rows copied (the buffers as they stand);
* ``regsN`` (the pipelined kernel): the consumer warpgroups at N
  registers a thread and the staging ones at 256 - N (``setmaxnreg``);
  ``rawN``: N raw slots in bf16.

The patch sites name the kernel of the tree the script sits in: the
parent's (one chunk of ``cp.async`` copies in flight, two block-wide
barriers a chunk, commit db2f9aa) or the pipelined kernel that replaced it
(a bulk-copy producer warp, a ring of raw chunks, two chunks of products in
flight).  ``--compile-only`` builds the variants and reports ptxas's
registers, spills and C75xx notes for ``wgrad_tc_kernel``.

Only ``base`` computes the gradients; the other variants' outputs are
meaningless and only times are kept.  Each time is the pass's device time
per K2 call from ``torch.profiler`` (the kernels named
``wgrad_tc_kernel``) over ``--iters`` calls, and K2's whole call from CUDA
events; ``base`` runs first and last (the spread of one build in the
call).  Prints the card's name and power limit, then one JSON object.
Exits non-zero without a GPU.
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
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig  # noqa: E402
from nerf_tpu_torch.ops import compositing  # noqa: E402
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, train_grads  # noqa: E402
from nerf_tpu_torch.utils.profiling import train_kernel_flops  # noqa: E402

WORK = REPO / "build" / "wgrad_split"
VARIANTS = ("base", "no_wait", "no_transform", "no_products", "no_copies")


def _wgrad_fn(src: str) -> tuple:
    for head in ("wgrad_tc_kernel(const __grid_constant__", "wgrad_tc_kernel(WProds"):
        if head in src:
            start = src.index(head)
            return start, src.index("\n}\n", start)
    raise RuntimeError("no wgrad_tc_kernel in tc_mlp.cuh")


def patch(src: str, variant: str) -> str:
    """tc_mlp.cuh's text with the variant's part of the pass taken out."""
    if variant == "base":
        return src
    if variant.startswith("raw"):  # rawN: N raw slots in bf16
        src, a = re.subn(r"return kBf16 \? \d+ : 3;", f"return kBf16 ? {int(variant[3:])} : 3;", src)
        if a != 1:
            raise RuntimeError(f"{variant}: wg_raw_slots not found")
        return src
    if variant.startswith("regs"):  # regsN: the consumers at N registers, the staging at 256 - N
        n = int(variant[len("regs"):])
        src, a = re.subn(r"constexpr int kWgConsumerRegs = \d+;", f"constexpr int kWgConsumerRegs = {n};", src)
        src, b = re.subn(r"constexpr int kWgStagingRegs = \d+;", f"constexpr int kWgStagingRegs = {256 - n};", src)
        if a != 1 or b != 1:
            raise RuntimeError(f"{variant}: register constants not found")
        return src
    a, b = _wgrad_fn(src)
    body = src[a:b]
    pipelined = "wg_transform" in body
    if pipelined:
        sites = {
            "no_wait": [("mbar_wait(wg_full(rs), (c / kRawSlots) & 1);", "")],
            "no_transform": [("wg_transform(c, rs, is);", "")],
            "no_products": [("wg_issue(is, d);", "wgmma_commit();")],
            "no_copies": [("ca.bytes + cb.bytes", "0u"), ("blk.a.copy(", "if (false) blk.a.copy("),
                          ("blk.b.copy(", "if (false) blk.b.copy(")],
            "no_fence": [("fence_async_smem();   // the image's stores", "// the image's stores")],
            "no_sync": [("wg_staging_sync(sw);", "")],
            "no_a": [("wg_transform_operand<kBf16, true, true>(", "if (false) wg_transform_operand<kBf16, true, true>("),
                     ("wg_transform_operand<kBf16, true>(", "if (false) wg_transform_operand<kBf16, true>(")],
            "no_b": [("wg_transform_operand<kBf16, false>(", "if (false) wg_transform_operand<kBf16, false>(")],
        }[variant]
    else:
        sites = {
            "no_wait": [('asm volatile("cp.async.wait_group 0;\\n" ::);', "")],
            "no_transform": [("transform_b(c);", ""), ("if (a_pairs) widen_a(c);", "")],
            "no_products": [("wgmma_rs(d, ahi[s], bh);", ""), ("wgmma_rs(d, ahi[s], bl);", ""),
                            ("wgmma_rs(d, alo[s], bh);", ""),
                            ("wgmma_rs_bf16(d, ahi[s], smem_desc_sw64(b + 8 * s));", "")],
            "no_copies": [("if (chunks > 0) copy_raw(0);", ""),
                          ("if (c + 1 < chunks) copy_raw(c + 1);", "")],
        }[variant]
    for old, new in sites:
        if body.count(old) < 1:
            raise RuntimeError(f"{variant}: patch site not found: {old!r}")
        body = body.replace(old, new)
    return src[:a] + body + src[b:]


def variant_dir(variant: str) -> Path:
    root = WORK / variant
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    tc = csrc / "tc_mlp.cuh"
    tc.write_text(patch(tc.read_text(), variant))
    return root


def k2_inputs(device, dtype: str):
    """K2's arguments at its cell, as ``scripts/torch_tile_timing.py`` draws
    them."""
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, lo=-1.0, hi=1.0, enc=False):
        out = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
        return out.to(tdt) if enc else out

    cfg = ClassicNeRFConfig(normalize_position=6.0, compute_dtype=dtype)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    rays, s = 4096, 64
    xe, de = cfg.x_encoding_dim, cfg.d_encoding_dim
    t = torch.sort(rand(rays, s, lo=2.0, hi=6.0), -1).values
    a = dict(x_enc=rand(rays, s, xe, enc=True),
             d_enc=rand(rays, 1, de, enc=True).expand(rays, s, de).contiguous(),
             dists=compositing.distances_from_tvals(t, rand(rays, 3)).contiguous(),
             noise=rand(rays, s), pixels=rand(rays, 3, lo=0.0, hi=1.0))
    return packed, a, s, train_kernel_flops(cfg, rays, s)


def pass_ms(fn, iters: int) -> float:
    """Device ms per call of the kernels named wgrad_tc_kernel."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and "wgrad_tc_kernel" in e.name)
    if us == 0:
        raise RuntimeError("the profiler recorded no wgrad_tc_kernel")
    return us / 1e3 / iters


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--compile-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_wgrad_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    variants = tuple(args.variants.split(","))
    roots = {v: variant_dir(v) for v in variants}
    procs = {}
    for v, root in roots.items():  # one nvcc a variant, all started together
        (root / "build").mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
               str(root / "build" / f"lib{train_grads.NAME}.so"),
               str(root / "csrc" / f"{train_grads.NAME}.cu")]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ptxas = {}
    for v, p in procs.items():
        out, _ = p.communicate()
        (WORK / f"{v}.nvcc.txt").write_text(out)
        if p.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {v}")
        ptxas[v] = sorted({f"{label}: {usage}" for label, usage in chip_smoke.ptxas_usage(out)
                           if label.startswith("wgrad_tc_kernel")})
    results = {"ptxas_wgrad": ptxas}
    if args.compile_only:
        print(card)
        print(json.dumps({"card": card, "results": results}))
        return 0
    for dtype in args.dtypes.split(","):
        packed, a, s, flops = k2_inputs(device, dtype)
        row = {"k2_flops": flops}
        for v in variants + variants[:1]:
            _build.CSRC = roots[v] / "csrc"
            _build.BUILD_DIR = roots[v] / "build"
            _build._LIBS.pop(train_grads.NAME, None)
            with torch.no_grad():
                call = lambda: train_grads.classic_train_grads(packed, **a, num_samples=s)  # noqa: E731
                row.setdefault(f"{v} wgrad_ms", []).append(pass_ms(call, args.iters))
                row.setdefault(f"{v} k2_ms", []).append(chip_smoke.cuda_ms(call, iters=args.iters))
        results[dtype] = row
        print(dtype, json.dumps(row), flush=True)
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
