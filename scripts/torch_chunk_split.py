"""Splits the time of a B chunk of the row-tile product (``csrc/tc_mlp.cuh``'s
``tc_gemm``) on the card: K4 at its default tile (4000 rays of 64 + 128
samples, the full-width ClassicNeRF, random weights from seed 0) in both
dtypes, built from copies of ``csrc/`` with parts of the tile taken out, and
the card's own L2 read rate for the operand images.

    python scripts/torch_chunk_split.py [--variants tile,...] [--dtypes float32,bfloat16]
                                        [--iters 10] [--compile-only]

Variants of the source (each a copy under ``build/chunk_split/``; the
committed sources are not touched):

* ``tile``: the tile as it stands;
* ``no_epilogue``: ``mlp_tile_tc`` without its epilogues and heads (the
  accumulators' round trip through shared memory, the LayerNorm, the stores
  of the activation tile), the products and their copies kept;
* ``resident_b``: every B chunk taken from the buffers as they stand, no
  copy issued (no L2 read of B; the encodings still stream);
* ``zero_fill_b``: the B copies issued but reading nothing (``cp.async``
  with a source size of 0, which fills zeros), so their issue and wait cost
  without the L2 reads;
* ``bare``: ``no_epilogue`` and ``resident_b`` together: the products, the
  encodings' copies and the per-chunk waits alone.

The last four take apart the ``tc_gemm`` whose consumers copied B
themselves with ``cp.async`` (commit 6d97513, before the producer
warpgroup): run ``--variants tile,no_epilogue,resident_b,zero_fill_b,bare``
from a copy of that tree (``git archive`` into an ignored directory); by
default ``tile`` alone.
Other variants: ``batchT`` issues T TF32 chunks' products between two waits
(``kTcBatchTf32`` of the tree's pipeline; a bf16 batch is one chunk).
``--compile-only`` builds the variants
and reports ptxas's wgmma notes (C7512, C7513, C7515: every wgmma of the
kernel serialized) for K4's hidden-256 instantiations without running
them.  Each variant's rgb is held against the first variant's (max abs).

The outputs of every variant but ``tile`` are meaningless; only times are
kept.  The L2 rate: one block an SM (132) each reading the whole float32 (or
bf16) forward image of the model again and again, a chunk (32 KB, 16 KB) a
``cp.async.bulk`` into a ring of 4 chunk buffers completed on ``mbarrier``s,
as the tile reads B; bytes over CUDA-event time.  Prints the card's name
and power limit, then one JSON object.  Exits non-zero without a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (the card line, the event timer)
from nerf_tpu_torch import ClassicNeRF, ClassicNeRFConfig  # noqa: E402
from nerf_tpu_torch.ops.kernels import _build, classic_mlp, tc_mlp, union_eval  # noqa: E402
from nerf_tpu_torch.utils.profiling import classic_flops_per_point  # noqa: E402

WORK = REPO / "build" / "chunk_split"

_EPILOGUE = """    tc_to_rows<H>(d, act, acc);
    layer_epilogue<H, kSave>(acc, w.b + i * H, w.g + i * H, w.beta + i * H, w.inv_h, w.padded,
                             save, i);
"""
_SINK = """#pragma unroll
    for (int j = 0; j < H / 4; ++j) sink += d[j];
"""
_B_COPIES = "      if constexpr (kHalf4 % 128 == 0) {"


def _tile_fn(src: str) -> tuple:
    start = src.index("__device__ void mlp_tile_tc(")
    return start, src.index("\n// ----", start)


def patch(src: str, variant: str) -> str:
    """tc_mlp.cuh's text with the variant's parts taken out."""
    def once(text: str, old: str, new: str) -> str:
        if text.count(old) < 1:
            raise RuntimeError(f"{variant}: patch site not found: {old[:60]!r}")
        return text.replace(old, new)

    if variant in ("no_epilogue", "bare"):
        a, b = _tile_fn(src)
        # The accumulators stay live through a sum stored where no row is
        # valid (never), else ptxas drops the products whose results no one
        # reads.
        body = once(src[a:b], _EPILOGUE, _SINK)
        body = once(body, "  auto epilogue = [&](int i) {", "  float sink = 0.f;\n  auto epilogue = [&](int i) {")
        body = once(body, "  tc_store_rows<H>(acc, act);\n", "")
        body = once(body, "      if (i == 8) tc_store_rows<H>(acc, act);\n", "")
        body = once(body, "  head<H, kBf16>(acc, w.w_dens, w.b_dens, 1, out, ld, 0, nvalid);\n", "")
        body = once(body, "  head<H, kBf16>(acc, w.w_col, w.b_col, w.c, out, ld, 1, nvalid);\n",
                    "  if (nvalid < -1) out[threadIdx.x] = sink;\n")
        src = src[:a] + body + src[b:]
    if variant in ("resident_b", "bare"):
        src = once(src, _B_COPIES, "      if constexpr (true) {\n      } else if constexpr (kHalf4 % 128 == 0) {")
    if variant.startswith("batch"):  # batchT: T TF32 chunks a batch
        src, hits = re.subn(r"constexpr int kTcBatchTf32 = \d+;",
                            f"constexpr int kTcBatchTf32 = {variant[len('batch'):]};", src)
        if hits != 1:
            raise RuntimeError(f"{variant}: kTcBatchTf32 not found")
    if variant == "zero_fill_b":
        a = src.index("auto stage = [&](int c) {")
        b = src.index("asm volatile(\"cp.async.commit_group;", a)
        body = src[a:b]
        if body.count(", true);") != 4:
            raise RuntimeError("zero_fill_b: expected 4 B copies in tc_gemm's stage")
        src = src[:a] + body.replace(", true);", ", false);") + src[b:]
    return src


def variant_dir(variant: str) -> Path:
    root = WORK / variant
    csrc = root / "csrc"
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(_build.CSRC, csrc)
    tc = csrc / "tc_mlp.cuh"
    tc.write_text(patch(tc.read_text(), variant))
    return root


L2_SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
constexpr int kStages = 4;
__global__ void __launch_bounds__(32, 1) l2_read(const char* img, unsigned chunk, int chunks,
                                                 int reps, unsigned long long* sink) {
  extern __shared__ __align__(1024) unsigned char buf[];
  __shared__ __align__(8) uint64_t full[kStages];
  const uint32_t bar0 = static_cast<uint32_t>(__cvta_generic_to_shared(full));
  const uint32_t dst0 = static_cast<uint32_t>(__cvta_generic_to_shared(buf));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8 * s));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  if (threadIdx.x != 0) return;
  const int n = chunks * reps;
  auto wait = [&](int s, uint32_t parity) {
    uint32_t done = 0;
    while (!done)
      asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                   "selp.u32 %0, 1, 0, p;\n}\n"
                   : "=r"(done) : "r"(bar0 + 8 * s), "r"(parity) : "memory");
  };
  for (int i = 0; i < n; ++i) {
    const int s = i % kStages;
    if (i >= kStages) wait(s, ((i / kStages) - 1) & 1);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(bar0 + 8 * s), "r"(chunk) : "memory");
    const char* src = img + static_cast<size_t>(i % chunks) * chunk;
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 ::"r"(dst0 + s * chunk), "l"(src), "r"(chunk), "r"(bar0 + 8 * s) : "memory");
  }
  for (int i = n; i < n + kStages; ++i) {
    const int s = i % kStages;
    if (i >= kStages) wait(s, ((i / kStages) - 1) & 1);
  }
  sink[blockIdx.x] = buf[0];
}
extern "C" int l2_read_launch(const void* img, unsigned chunk, int chunks, int reps, int blocks,
                              void* sink, void* stream) {
  const int smem = kStages * chunk;
  cudaError_t err = cudaFuncSetAttribute(l2_read, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  l2_read<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(img), chunk, chunks, reps, static_cast<unsigned long long*>(sink));
  return cudaGetLastError();
}
"""


def build_l2() -> subprocess.Popen:
    WORK.mkdir(parents=True, exist_ok=True)
    (WORK / "l2_read.cu").write_text(L2_SOURCE)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(WORK / "libl2_read.so"),
           str(WORK / "l2_read.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def l2_rate(img: torch.Tensor, chunk: int, iters: int) -> dict:
    lib = ctypes.CDLL(str(WORK / "libl2_read.so"))
    lib.l2_read_launch.argtypes = (ctypes.c_void_p, ctypes.c_uint, ctypes.c_int, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    chunks = img.numel() * img.element_size() // chunk
    reps = 16
    sink = torch.empty(blocks, dtype=torch.int64, device=img.device)

    def call():
        err = lib.l2_read_launch(img.data_ptr(), chunk, chunks, reps, blocks, sink.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        _build.check_launch("l2_read", err)

    ms = chip_smoke.cuda_ms(call, iters=iters)
    nbytes = blocks * chunks * reps * chunk
    return {"chunk_bytes": chunk, "image_bytes": chunks * chunk, "blocks": blocks, "ms": ms,
            "tb_per_s": nbytes / ms / 1e9, "us_per_chunk_per_sm": ms * 1e3 / (chunks * reps)}


def k4_inputs(device, dtype: str):
    bf16 = dtype == "bfloat16"
    tdt = torch.bfloat16 if bf16 else torch.float32
    gen = torch.Generator(device=device).manual_seed(0)

    def rand(*shape, lo=-1.0, hi=1.0, enc=False):
        out = torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo
        return out.to(tdt) if enc else out

    cfg = ClassicNeRFConfig(normalize_position=6.0, compute_dtype=dtype)
    model = ClassicNeRF(cfg, generator=torch.Generator().manual_seed(0), device=device)
    packed = classic_mlp.pack_classic_params(model.mlp.requires_grad_(False))
    rays, sc, sf = 4000, 64, 128
    t_c = torch.sort(rand(rays, sc, lo=2.0, hi=6.0), -1).values
    t_f = torch.sort(rand(rays, sf, lo=2.0, hi=6.0), -1).values
    args = (packed, rand(rays, sf, cfg.x_encoding_dim, enc=True),
            rand(rays, cfg.d_encoding_dim, enc=True), t_c, t_f, rand(rays, sc, 1, lo=-3.0, hi=6.0),
            rand(rays, sc, 3, lo=-3.0, hi=3.0), rand(rays, lo=0.5, hi=2.0))
    flops = rays * sf * classic_flops_per_point(cfg)
    return cfg, packed, args, flops


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--dtypes", default="float32,bfloat16")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--variants", default="tile")
    parser.add_argument("--compile-only", action="store_true")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("torch_chunk_split: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    card = chip_smoke.nvidia_smi("name,power.limit")
    variants = tuple(args.variants.split(","))
    roots = {v: variant_dir(v) for v in variants}
    l2 = build_l2()
    procs = {}
    for v, root in roots.items():  # one nvcc a variant, all started together
        (root / "build").mkdir(parents=True, exist_ok=True)
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(root / "build" / "libunion_eval.so"),
               str(root / "csrc" / "union_eval.cu")]
        procs[v] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    warnings = {}
    for v, p in list(procs.items()) + [("l2_read", l2)]:
        out, _ = p.communicate()
        (WORK / f"{v}.nvcc.txt").write_text(out)  # ptxas -v: registers, spills
        if p.returncode != 0:
            print(out, file=sys.stderr)
            raise RuntimeError(f"nvcc failed for {v}")
        warnings[v] = {f"{k} {'bf16' if b else 'float32'}": len(re.findall(rf"\({k}\).*union_eval_kernelILi256ELb{b}E", out))
                       for k in ("C7512", "C7513", "C7515") for b in (0, 1)}
    results = {"ptxas_warnings_union_eval_256": warnings}
    if args.compile_only:
        print(card)
        print(json.dumps({"card": card, "results": results}))
        return 0
    for dtype in args.dtypes.split(","):
        cfg, packed, k4, flops = k4_inputs(device, dtype)
        row = {"flops": flops}
        # the first variant first and last: the spread of one build in the call
        first = None
        for v in variants + variants[:1]:
            _build.CSRC = roots[v] / "csrc"
            _build.BUILD_DIR = roots[v] / "build"
            _build._LIBS.pop(union_eval.NAME, None)
            with torch.no_grad():
                got = union_eval.union_eval(*k4)[0].clone()
                ms = chip_smoke.cuda_ms(lambda: union_eval.union_eval(*k4), iters=args.iters)
            if first is None:
                first = got
            row.setdefault(v, []).append(ms)
            row.setdefault(f"{v} max_abs_vs_{variants[0]}", (got - first).abs().max().item())
        bf16 = dtype == "bfloat16"
        img = tc_mlp.tc_images(packed, dtype=torch.bfloat16 if bf16 else torch.float32)
        img = img[0] if isinstance(img, tuple) else img
        row["l2_read"] = l2_rate(img.contiguous(), 16384 if bf16 else 32768, args.iters)
        results[dtype] = row
    print(card)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
