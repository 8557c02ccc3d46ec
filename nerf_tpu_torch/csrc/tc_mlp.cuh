// Tensor-core products for the MLP passes of K2 (train_grads.cu), K3
// (fine_stage_train.cu), K9 (mega_train.cu), K4 (union_eval.cu), K1-fwd
// (classic_mlp_fwd.cu), K1-bwd (classic_mlp_bwd.cu), K8-fwd and K8-bwd
// (classic_pointmlp_{fwd,bwd}.cu), and of K6 (mip_train_grads.cu), K7
// (mip_eval.cu), K5-fwd and K5-bwd (mip_mlp_{fwd,bwd}.cu) through
// mip_mlp.cuh's MipTc
// policy, which composes the same pieces in the mip order: every
// hidden and encoding product as 3xTF32 on Hopper's
// wgmma, A.B = hi(A)hi(B) + hi(A)lo(B) + lo(A)hi(B) with lo = x - hi, both
// cut to TF32 by bit masking (hi keeps 10 mantissa bits, hi + lo about 21;
// the dropped lo.lo term is about 2^-22 of a product), each product a
// wgmma.mma_async ... .f32.tf32.tf32 into float32 accumulators.  Written by
// hand in PTX (wgmma, fences, smem descriptors); no CUTLASS.  The policy
// TcProducts gives classic_mlp_train.cuh's launch_fwd_store_with and
// launch_mlp_backward these passes, the encodings' cotangents included
// (bwd_rows' tc_input_grad).  fwd_tc_kernel is K1-fwd's tile (and
// K8-fwd's, with encode.cuh's PointEncodeLoad): fwd_store_tc_kernel with
// nothing saved.
//
// Bounds at the full-width model (H = 256, xe 60, de 36, view branch on):
// 630,784 multiply-adds a row each for the forward, dh and dW.  Against
// the float32 SIMT rate (67 TFLOP/s) and the 3xTF32 rate (three TF32
// products at 495 TFLOP/s, so FLOP / 165 TFLOP/s): K9 at 2048 x (64 + 128)
// 22.212 and 9.019 ms; K2 at 4096 x 64 and K3 at 2048 x 128 14.808 and
// 6.013 ms each; K4 at a 4000-ray tile 9.641 and 3.915 ms; K1-fwd at
// 262,144 rows 4.936 and 2.004 ms, K8-fwd at 262,144 points the same;
// K1-bwd (forward recomputed) at 131,072 rows 7.404 and 3.006 ms, K8-bwd
// at 262,144 points 14.808 and 6.013 ms.  The mip chain (F = 96, 5
// layers, O = 54): 300,544 a row; K6 at 4096 x 63 and K5-bwd at 258,048
// rows 6.945 and 2.820 ms, K5-fwd at 258,048 rows 2.315 and 0.940 ms, K7
// at a 4000-ray tile of 63 rows 2.261 and 0.918 ms.
//
// The constraints the design answers:
// 1. TF32 wgmma takes both operands K-major (the transpose flags exist only
//    for f16/bf16).  The forward's B is the slab as [out][in] (nn.Linear's
//    layout), bwd_rows' B (dh = dpre W^T) the packed [in][out] slab as it
//    stands: the transpose moves from the backward to the forward, it does
//    not multiply.  Both are built once per call on the card as operand
//    images (ops/kernels/tc_mlp.py::operand_image): K zero-padded to a
//    multiple of 16 (xe 60 -> 64, de 36 -> 48), split into hi and lo, in
//    chunks of kTcK = 16 k-values laid out as wgmma's 64-byte-swizzled
//    K-major operand (a row of 16 TF32 values is one swizzle row; an
//    unswizzled layout puts the eight rows the tensor cores read together
//    on one bank), so a chunk is one contiguous copy (2 x 2.5 MB a
//    direction, resident in L2).  The input cotangents dx = dpre_0 w0^T
//    (+ dpre_4 wx^T; dd = dpre_8 wd^T; the mip dx = dpre_0 w_in^T) take
//    the input slabs as stored, [in][out] = [N][K] with K = H: their
//    images pad N with zero rows to a multiple of kTcInPad = 64 and hold
//    each pass of tc_in_cols<H>() rows (64, or H below 64) as its own
//    image (tc_input_grad).  wgrad's dW = h_in^T dpre sums over the
//    points while both are stored [P][H]: its staging warpgroup transposes
//    a chunk of 32 points of both into the K-major swizzled order (split
//    in TF32, rounded in bf16) and the products read both from shared
//    memory (wgmma SS).
// 2. Shared memory (227 KB a block; one 256 x 256 float32 slab is 256 KB)
//    and the pipeline of B: the weights stream chunk by chunk through a
//    ring in the 128 KB of tc_bbuf_floats<256>() (tc_block, tc_gemm): 4
//    slots of a TF32 chunk (hi and lo of 16 k-values, 32 KB at H = 256) or 8
//    of a bf16 one (32 k-values, 16 KB), each with a full and an empty
//    mbarrier.  A producer warpgroup beside the two consumer warpgroups
//    (kTcThreads = 384) walks the block's products in the consumers' order,
//    one thread copying each chunk of the operand image (one contiguous
//    swizzled chunk, tc_mlp.py::operand_image) with one bulk copy into the
//    next slot both consumer warpgroups have released, whichever product it
//    belongs to: the next product's chunks land while this one's last
//    products and the epilogue run.  scripts/torch_chunk_split.py measured
//    the card's L2 rate for these reads at 21 TB/s against the 4.7 the
//    tile needs (PERF.md section 5), so B is not multicast across a
//    cluster.  The A operand comes from registers, loaded from the float32
//    activation tile [64][H + 4] (66,560 B; the 4 floats of padding make
//    the fragment loads free of bank conflicts) and split as it is loaded,
//    so no hi/lo copy of the tile is kept.  Bytes a block at H = 256, 1024 bytes of alignment slack
//    included (and 136 of static barriers): fwd_store (K1-fwd's, K8-fwd's
//    and K4's tile) and the mip forward tile 219,136 (with the encodings'
//    ring, note 9; K4's fine outputs and compositing scratch lie in device
//    memory), bwd_rows 207,872 (its colsum scratch beside the ring, which
//    prefetches through the epilogues), wgrad 230,400 (three raw chunks of
//    32 KB and two operand images of 64 KB in float32, six and two of 16 KB
//    in bf16: pass 3 below); the mip bwd_rows 206,848 (the head's output
//    cotangents staged through the activation tile, the colsum scratch).
//    Both row passes store dpre from registers (by bulk stores from the
//    activation tile, each pass was slower: scripts/torch_bwd_rows_split.py's
//    bulk_stores).  Where a wide head stages its
//    weights through the ring's buffers (the mip forward heads, past 256 a
//    head of more than kFewOutputs outputs) the consumers borrow them
//    (TcPipe::lend) and the producer waits; the mip head's input cotangent
//    up to 256 is a product on the tensor cores (mip_bwd_rows_tc_kernel),
//    which lends nothing.  The input cotangents add nothing to either
//    bwd_rows: their A rows (dpre) and their outputs pass through the
//    activation tile, their B chunks (2 x 64 x 16 floats) through the ring.
// 3. Accumulators and LayerNorm: in a wgmma accumulator a row's values sit
//    in a quad of one warp and, here, in both warpgroups (each takes H / 2
//    columns).  Each product's accumulators go once through the activation
//    tile in shared memory into the row-per-warp layout of
//    classic_mlp.cuh, so the epilogues (layer_epilogue, head, layer_bwd,
//    head_bwd) run unchanged: two-pass mean and variance as warp
//    reductions, and xhat and dpre stored coalesced, 32 consecutive floats
//    a warp.  That costs
//    one 64 x H x 4 B round trip through shared memory a layer against 64 x
//    H x H x 6 FLOP of tensor-core work (nothing in the float32 row pass,
//    18 % of K6's bf16 one: scripts/torch_bwd_rows_split.py).  A row pass
//    with a 64-row tile a warpgroup (m64n256, the epilogue in the
//    accumulator layout, two tiles in flight; scripts/bwd_rows_two_tiles.cu)
//    ran 1.6x slower than this one at H = 256 whatever its ring schedule:
//    its epilogue spills and its products wait on their A rows.
// 4. Widths not a multiple of 16: the images pad K with zeros; A fragments
//    past the width read 0.  The density and colour heads stay SIMT (head,
//    head_bwd), and so does the mip 54-wide head's forward (head_wide,
//    mip_mlp.cuh; its weights staged through the B chunk buffers once the
//    last product has retired); its input cotangent is a tc_gemm on the
//    image of w_out (K = 54 padded to 64; past 256 head_dh_rows, SIMT), its
//    dW a wgrad product with N = 54, the columns past N zero in the B image
//    and each stored alone where N is odd.  Tails of P are zero-filled (the
//    encodings' slabs).
// 5. The chain (xhat, dpre: ~4 GB each at 393,216 rows) stays float32 in
//    global memory: no hi/lo copy, no extra pass.  wgrad keeps the tiles of
//    one chunk of points adjacent in launch order (blockIdx.x runs over the
//    output tiles first), so the re-reads of a chunk hit L2; its copier
//    warp brings each chunk's rows (a TMA box of the chain, a bulk copy of
//    the encodings) up to three (bf16: six) chunks ahead.
// 6. Registers: the forward and bwd_rows hold H / 4 accumulator floats a
//    thread (64 at H = 256; an m64n128 product per warpgroup) plus the A
//    fragments and B descriptors of a batch (TF32: two chunks, 32 + 16;
//    bf16: two sets of one chunk, 16 + 4), not both the wgmma and the
//    row-per-warp accumulators at once.  The SM allocates registers by
//    warpgroup, so the 384-thread block starts at 168 a thread; the
//    producer warpgroup drops to kTcProducerRegs = 40 and the consumers
//    rise to kTcConsumerRegs = 232 (setmaxnreg), against the 255 a
//    256-thread block had.  An m64n256 accumulator a warpgroup (128
//    floats a thread) leaves too few for its epilogue: about 1 KB a thread
//    spills (scripts/bwd_rows_two_tiles.cu).  wgrad's block is 512 threads (kWgThreads: two
//    consumer and two staging warpgroups, 128 registers a thread at
//    launch): its consumers hold two chunks' accumulators (2 x 64) and
//    their 64-float float32 sum, no fragments (both operands come from
//    shared memory), at kWgConsumerRegs = 200; its staging warpgroups
//    (copies and transform) run at kWgStagingRegs = 56.
// 7. The tensor cores accumulate with truncation below the accumulator's
//    leading bits (scripts/torch_tc_accuracy.py: a K = 256 product within
//    about 3e-6 of the largest entry against 7e-7 for float32, its error
//    biased toward zero).  Over the few hundred products of a row tile that
//    is within the kernels' tolerances; wgrad's sums over thousands of
//    points would drift, so each 32-point chunk's products go to a fresh
//    accumulator that is then added to a float32 sum, in chunk order (two
//    chunks' accumulators in flight).
// 8. 3xTF32 rounds otherwise than SIMT float32: rows within rounding of a
//    ReLU kink and fine samples in bins of ~1e-5 mass move, as the checks
//    of K1-K9 already allow (card tests draw rows away from kinks; K9's
//    fine samples are compared in probability).
// 9. The encodings stream through the classic tile.  The tile's bytes do
//    not depend on the encoding widths: the layer products' A operand is
//    the activation tile, and the three encoding products (layer 0 on x,
//    the skip at layer 4 on x, the view layer 8 on d) take theirs through
//    a ring of kTcStages slabs beside the B chunks (EncA, kEncRingFloats:
//    20,480 bytes), one k-chunk of the 64 rows' encodings a slab, staged
//    by the consumers two chunks ahead (the producer copies B alone).  The
//    loader of a kernel fills a slab (Load::stage): TileLoad (K1, K2, K3, K4, K9's
//    coarse stage) copies the chunk from the encodings in device memory
//    with cp.async (stage_enc; the per-ray view rows broadcast by d_div),
//    encode.cuh's loaders (K8, K9's fine stage) compute its sines, and copy
//    them for the skip layer from the scratch encodings the first product
//    wrote (K8-fwd, which keeps none, computes them again).  Both
//    warpgroups read every row of a slab, so a chunk of an encoding
//    product waits at a barrier of the consumers where the layer products
//    wait only on their slot's mbarrier.  A slab holds float32 values, or under kBf16
//    the bf16 pairs as a fragment register holds them (the encodings'
//    own, or the sines rounded to nearest even where they enter: the
//    rounding the fragment load of note 10 applies), so each k-step's
//    fragments are plain 32-bit loads; rows of 20 words keep the loads
//    free of bank conflicts.  fwd_store's tile (and K1-fwd's, K8-fwd's,
//    K4's) takes 219,136 bytes at H = 256 at every width, sample count and
//    colour count, against the 232,448 a block may opt in to; a wider
//    encoding only adds chunks (700 + 36: 44 + 44 + 3 chunks of 16 values
//    beside the 144 of the hidden layers).  Every classic launcher, K4's
//    too, opts in to its tile's fixed bytes (tc_tile_bytes) and returns
//    the runtime's error on a device that allows fewer.  The mip forward tile
//    (mip_mlp.cuh) is the same tile with the features as its one
//    encoding, which only layer 0 reads (MipFeatLoadT), so it too takes
//    tc_tile_bytes at every feature width.  bwd_rows' and wgrad's tiles
//    never depended on the widths (the input cotangents' passes loop over
//    them).
//
// 10. compute_dtype="bfloat16" (the template parameter kBf16 of tc_gemm,
//    mlp_tile_tc, the passes' kernels and TcProductsT: K1-fwd, K1-bwd, K2,
//    K3, K4, K8-fwd, K8-bwd and K9; and of mip_mlp.cuh's tiles, kernels and
//    MipTcT: K5-fwd, K5-bwd, K6 and K7).  bf16 is the tensor cores' own operand type: each k-step of
//    16 values is ONE wgmma.mma_async ... .f32.bf16.bf16 (k = 16; 3xTF32
//    takes three of k = 8 for half the values), at 989 TFLOP/s dense.  The
//    rounding points are the JAX package's _dot, _dot_t and _dot_tn: the A
//    fragments are rounded from the float32 tiles as they are loaded
//    (cvt.rn.bf16x2.f32: the activation tile, the encodings and dpre stay
//    float32 in memory, note 2), the B operands come from bf16 images of
//    the weights (tc_mlp.py::operand_image with dtype bfloat16); wgrad
//    rounds both its operands, the rebuilt h_in and dpre, as its staging
//    warpgroup transposes them;
//    the SIMT heads round h, W and the output cotangents (head<H, true>,
//    head_bwd<H, true>; the mip head_wide and head_dh_rows likewise; the
//    mip head's tc_gemm rounds its fragments and reads a bf16 image of
//    w_out).  Everything else (LayerNorm and its statistics,
//    biases, ReLU masks, compositing, losses, the chain, every sum of
//    partials) is float32, as in JAX.  The encodings cross device memory
//    as bf16 (TileLoadT<__nv_bfloat16>'s slabs, wgrad's bf16 raw rows;
//    K8 and K9 compute theirs in the block, encode.cuh, and write them
//    rounded for wgrad).
//    Layout: a bf16 chunk holds kTcKB = 32 k-values, 64 bytes a row: the
//    byte layout of one TF32 hi block, so the 64-byte swizzle (16-byte group
//    j of row n at j ^ ((n / 2) % 4)), the descriptor (SBO 512: 8 rows of
//    64 B; LBO unused within the swizzle atom) and the k-step's 32-byte
//    start offset (16 values of 2 bytes) are the TF32 ones re-derived for
//    2-byte values.  K pads to a multiple of 32 (xe 60 -> 64, de 36 -> 64).
//    The chunk buffers keep their TF32 size (a bf16 chunk fills half of
//    one), so every tile's bytes are the float32 tile's (note 9).  wgrad keeps its
//    32-point chunks (two k-steps, 64-byte rows, the same 64-byte swizzle)
//    summed in float32 (note 7: bf16 products also accumulate with
//    truncation).  bwd_rows keeps its own [in][out] images rather than
//    reading the forward images transposed (bf16 wgmma has a transpose flag
//    for a shared-memory B, but one image layout for both directions keeps
//    the TF32 and bf16 passes alike).  Bounds at the full-width model
//    (FLOP / 989 TFLOP/s): K1-fwd at 262,144 rows 0.334 ms, K4 at a
//    4000-ray tile 0.653 ms, K1-bwd at 131,072 rows 0.501 ms, K2 at 4096 x
//    64 and K3 at 2048 x 128 1.003 ms each, K8-fwd and K8-bwd at 262,144
//    points 0.334 and 1.003 ms, K9 at 2048 x (64 + 128) 1.505 ms; K5-fwd
//    at 258,048 rows 0.157 ms, K7 at a 4000-ray tile of 63 rows 0.153 ms,
//    K5-bwd at 258,048 rows and K6 at 4096 x 63 0.470 ms each; the
//    training kernels' float32 chain (xhat and dpre, written once and read
//    once) then bounds them by bytes instead.
// 11. Every hidden width (classic_mlp.cuh's padded_hidden).  A width h up to
//    256 runs the smallest instantiated tile H >= h (32, 64, 128, 256) on
//    slabs zero-padded to H: the padded columns come out 0 after the bias,
//    ReLU and LayerNorm in either order (their weights, bias, g and beta are
//    0), the LayerNorm statistics and the backward's row means are taken
//    over the first h columns (layer_epilogue, layer_bwd) and the padded
//    dpre is 0, so the padded slots add nothing to any product and their
//    gradients are 0, which the wrappers drop.  The cost is (H / h)^2 in
//    products (48 -> 64: 1.78x, 200 -> 256: 1.64x).  Past 256 the tile
//    cannot grow (the activation tile [64][516] alone is 132 KB at 512, the
//    B chunks 256 KB; wgmma's N stops at 256), so h pads to hp, a multiple
//    of kColBlock = 256, and runs at the template width kWideH: one block
//    still owns 64 rows in tc_tile_bytes<256>() of shared memory, and each
//    layer's output is computed in hp / 256 column blocks, each an
//    m64n256 tc_gemm whose A operand streams through the ring (RowsLoadT,
//    note 9) from the tile's rows in device memory (WideRows: the
//    pre-LayerNorm rows `pre`, float32, and the LayerNorm'd rows `nrm` in
//    the compute dtype, [64][hp] each, written and read by the same block:
//    the 132 resident blocks' rows take 35 MB at 512, within the 50 MB L2,
//    and 69 MB at 1024, past it, so there part of the round trip reaches
//    device memory (not measured apart); the wrappers allocate a slot for each
//    64-row tile of the call, 2.1 GB for K1-fwd's 262,144 rows at 1024,
//    though only the resident blocks use theirs at a time); each block's
//    product plus the bias (and ReLU) goes to pre, the row statistics over
//    the whole width are taken from pre
//    (wide_norm, which also writes xhat), and nrm feeds the next layer's
//    products and the heads (head_rows).  The operand images hold each
//    slab as hp / 256 images of 256 rows (tc_mlp.py::operand_image_blocks),
//    so a column block is one image.  bwd_rows mirrors it (bwd_rows_wide):
//    dh in column blocks with dpre streamed from device memory, each layer's
//    dh written into its dpre rows and turned into dpre there
//    (layer_bwd_wide), the heads' backward and the input cotangents over
//    the same rows.  The training kernels keep the forward's rows in the
//    dpre scratch (free until bwd_rows), the others in a scratch the
//    wrapper allocates, 2 x 64 x hp floats a tile.
//
// The products are deterministic: a fixed order of wgmma per k-chunk, no
// atomics; wgrad's partials go through colsum's fixed order as before.
#pragma once

#include <cuda.h>

#include <cstdint>

#include "classic_mlp_train.cuh"

namespace nerf_mlp {

constexpr int kTcK = 16;                 // k-values per chunk of a TF32 operand image
constexpr int kTcKB = 32;                // k-values per chunk of a bf16 operand image
constexpr int kTcStages = 4;             // chunk buffers of the row-tile product
constexpr int kTcBatchTf32 = 2;          // chunks whose TF32 products tc_gemm issues together
constexpr unsigned kTf32Mask = 0xffffe000u;
constexpr int kWgK = 32;                 // points per staged chunk of wgrad_tc_kernel

__host__ __device__ inline int round_up_chunk(int n) { return (n + kTcK - 1) / kTcK * kTcK; }

// The k-values of a chunk of the image type (note 10) and K rounded up to it.
template <bool kBf16>
__host__ __device__ constexpr int tc_chunk() { return kBf16 ? kTcKB : kTcK; }
template <bool kBf16>
__host__ __device__ inline int round_up_tc(int n) {
  return (n + tc_chunk<kBf16>() - 1) / tc_chunk<kBf16>() * tc_chunk<kBf16>();
}
// Floats (4-byte words) of the operand image of a [n][k] B operand: hi and
// lo in TF32, or one bf16 array.
template <bool kBf16>
__host__ __device__ inline size_t tc_image_floats(int n, int k) {
  return kBf16 ? static_cast<size_t>(n) * round_up_tc<true>(k) / 2
               : 2 * static_cast<size_t>(n) * round_up_chunk(k);
}

// The swizzled operands' 1024-byte alignment: the dynamic shared memory is
// requested kSmemAlign bytes larger and its start rounded up.
constexpr size_t kSmemAlign = 1024;
__device__ __forceinline__ float* tc_smem_base(float4* smem) {
  const size_t a = reinterpret_cast<size_t>(smem);
  return reinterpret_cast<float*>((a + kSmemAlign - 1) & ~(kSmemAlign - 1));
}

// Row stride of the activation tile, padded against bank conflicts.
template <int H>
__host__ __device__ constexpr int act_ld() { return H + 4; }

// Floats of the kTcStages buffers of B chunks.
template <int H>
__host__ __device__ constexpr int tc_bbuf_floats() { return kTcStages * 2 * H * kTcK; }

// The encodings' ring of the classic tile (note 9): kTcStages slabs, each
// one k-chunk of the 64 rows' encodings, 16 words a row (a TF32 chunk's 16
// floats, or a bf16 chunk's 32 values as 16 pairs) padded to kEncLd words
// so the fragment loads are free of bank conflicts.
constexpr int kEncLd = 20;
// Chunks of a bf16 encoding product summed in one accumulator (tc_gemm):
// 2, the full-width model's 60 and 36 values; a longer one sums each chunk
// apart.
constexpr int kFreshChunks = 2;
constexpr int kEncSlab = kTileRows * kEncLd;
constexpr int kEncRingFloats = kTcStages * kEncSlab;

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 4 : 0));
}

// ---------------------------------------------------------------------------
// PTX: the split, descriptors, fences and the wgmma instructions.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = __float_as_uint(x) & kTf32Mask;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h)) & kTf32Mask;
}

// Two floats rounded to bfloat16 (nearest even) as one register of a bf16
// A fragment: lo in the low half (the smaller k), hi in the high half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// Shared-memory matrix descriptors of K-major operands with a swizzle
// (an unswizzled layout puts the eight rows the tensor cores read together
// on one bank).  128-byte swizzle (layout type 1, wgrad's images): rows of
// 32 TF32 values, the 16-byte group j of row r stored at group j ^ (r %
// 8), 8-row groups 1024 bytes apart.  64-byte swizzle (layout type 2, the
// weight chunks of tc_gemm): rows of 16 values, group j of row r at j ^
// ((r / 2) % 4), 8-row groups 512 bytes apart.  A tile starts 1024-byte
// aligned, and a k-step of 8 values moves the start by 32 bytes inside the
// swizzle atom.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t sbo, uint64_t layout) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ uint64_t smem_desc_sw128(const float* p) { return smem_desc(p, 1024, 1); }
__device__ __forceinline__ uint64_t smem_desc_sw64(const float* p) { return smem_desc(p, 512, 2); }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// Generic-proxy writes to shared memory (stores, cp.async) made visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of the accumulators across a
// wgmma wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for A fragments: used again after a wait, they stay allocated
// while the products that read them run (else the compiler reuses their
// registers and ptxas has to wait for the products first).
template <int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[s][j])::"memory");
}

template <int B, int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[B][S][4]) {
#pragma unroll
  for (int b = 0; b < B; ++b) fence_regs(a[b]);
}
template <int T, int B, int S>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[T][B][S][4]) {
#pragma unroll
  for (int t = 0; t < T; ++t) fence_regs(a[t]);
}
// The same for B descriptors: computed before the wgmma fence, so that no
// instruction between the fence and the products defines a product's input
// (ptxas serializes every wgmma of a kernel where one does: C7513).
template <int B, int S>
__device__ __forceinline__ void fence_regs(uint64_t (&d)[B][S]) {
#pragma unroll
  for (int b = 0; b < B; ++b)
#pragma unroll
    for (int s = 0; s < S; ++s) asm volatile("" : "+l"(d[b][s])::"memory");
}

// m64nNk8 with A from registers (a0 = A[g][q], a1 = A[g + 8][q], a2 =
// A[g][q + 4], a3 = A[g + 8][q + 4] of the warp's 16 rows; g = lane / 4,
// q = lane % 4) and B from shared memory; d += A B.  One overload per N in
// 16, 32, 64, 128 (d holds N / 2 floats), and the all-shared m64n128k8,
// d = A B + (scale_d ? d : 0), its descriptors a + kA and b + kB (kA, kB
// in 16-byte units, added in the instruction's own block so that a
// chunk's products hold two descriptors rather than sixteen).
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int kA, int kB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kA), "n"(kB));
}

template <int kA, int kB>
__device__ __forceinline__ void wgmma_ss_bf16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, da, db, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kA), "n"(kB));
}

// The bf16 products (note 10): m64nNk16 with A from registers (a0 = A[g][2q,
// 2q + 1], a1 = A[g + 8][2q, 2q + 1], a2 = A[g][2q + 8, 2q + 9], a3 =
// A[g + 8][2q + 8, 2q + 9], two bf16 a register, the smaller k low) and B
// K-major from shared memory (transpose flag 0); d += A B in float32.
__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[8], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---------------------------------------------------------------------------
// The row-tile product: d += A[64][0:K] @ B^T for a B image [H][round_up_chunk(K)].
// ---------------------------------------------------------------------------

// The weights of a call as forward operand images (tc_mlp.py::tc_images):
// w0, wx, wd ([H][round_up_chunk(width)] each, wd absent without the view
// branch), then the hidden slabs [H][H], each 2 H round_up_chunk(K) floats
// (kBf16: bf16 images, tc_image_floats<true> each).
struct TcImages {
  const float* w0;
  const float* wx;
  const float* wd;
  const float* whh;
  template <bool kBf16 = false>
  __host__ static TcImages forward(const Weights& w, const float* base, int H) {
    const size_t x = tc_image_floats<kBf16>(H, w.xe);
    const size_t d = w.wd != nullptr ? tc_image_floats<kBf16>(H, w.de) : 0;
    return TcImages{base, base + x, base + 2 * x, base + 2 * x + d};
  }
};

template <int N>
__device__ __forceinline__ void tc_zero(float (&d)[N / 4]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i) d[i] = 0.f;
}

// tc_gemm's A operand where it is a shared-memory tile (a layer's
// activations, or dpre in the input cotangents' passes): row stride lda;
// columns past K are not read.
struct TileA {
  const float* A;
  int lda;
};

// tc_gemm's A operand where it is the tile's encodings (note 9; the mip
// tile's features): chunk c of encoding `which` (0: x, 1: d) of the tile's
// rows row0 ..
// row0 + nvalid - 1 goes through the ring, staged by
// load.stage<kBf16>(w, which, c, row0, nvalid, first, slab) beside the B
// chunk of the same k (zero past the width and past nvalid).  `first`
// marks the product that reads these encodings first: a loader that
// computes them writes its copy to device memory there.
template <class Load, class W = Weights>
struct EncA {
  using Loader = Load;
  const Load& load;
  const W& w;  // the loader's weights: the widths (Weights, or mip_mlp.cuh's MipWeights)
  int which;
  size_t row0;
  int nvalid;
  bool first;
  float* ring;
};

// Whether a loader's long bf16 encoding products sum chunk by chunk
// (tc_gemm).  K9's fine stage (encode.cuh) keeps its products pipelined:
// there the second call site of its sines puts a function call inside the
// wgmma pipeline (C7510: K9 4.6 % slower at 60 + 36), and its weight
// gradients stand as far from the plain version either way, at the plain
// version's own distance under float64 sums (702 + 36, 512 rays: 2.94e-2
// pipelined, 2.88e-2 chunked, the plain version 2.50e-2;
// scripts/torch_bf16_sensitivity.py --family mega-widths).  Merging the
// chunked sums into the pipelined chunk step (one call site) cost K1-fwd's
// bf16 tile 11 % at every width.  The mip features' loader keeps its
// products pipelined too (mip_mlp.cuh).
template <class Load>
inline constexpr bool kChunkedSums = true;

// Whether a loader's float32 (3xTF32) products sum in groups of
// kF32GroupChunks k-chunks, each group pipelined into a cleared
// accumulator and added to the sum so far in float32 (tc_gemm): the wide
// rows' (RowsLoadT, note 11), whose K = hp runs to 64 chunks at 1024.  The
// tensor cores truncate as they accumulate (note 7): with one accumulator
// K1-fwd at hidden 1024 sat past K1's 1e-4 from its plain version, 7x as
// far from float64 sums as cuBLAS float32; in groups of 4 chunks it sits
// at cuBLAS's distance, for a few per cent of its time (PERF.md section 6;
// scripts/torch_wide_sums.py builds copies at other group sizes).
template <class Load>
inline constexpr bool kGroupedSums = false;
constexpr int kF32GroupChunks = 4;

template <class Src, bool kBf16>
__host__ __device__ constexpr bool grouped_sums() {
  if constexpr (kBf16 || std::is_same_v<Src, TileA>)
    return false;
  else
    return kGroupedSums<typename Src::Loader>;
}

// ---------------------------------------------------------------------------
// The pipeline of B chunks (note 2): one producer thread, an mbarrier ring.
// ---------------------------------------------------------------------------

// A tensor-core tile's block: kThreads consumer threads (two warpgroups,
// which run the products and everything else) and a producer warpgroup, of
// which one thread issues the copies of B.  The SM's registers are
// allocated by warpgroup (a block of 288 threads gets the 168 a thread of
// 384 does), so the producer warpgroup hands its registers to the
// consumers: it drops to kTcProducerRegs, they rise to kTcConsumerRegs
// (setmaxnreg; 128 x 40 + 256 x 232 = 64,512 of 65,536).
constexpr int kTcThreads = kThreads + 128;
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;
#define NERF_TC_KERNEL __global__ void __launch_bounds__(kTcThreads, 1)
// Slots of the ring: the kTcStages buffers of tc_bbuf_floats hold 4 TF32
// chunks (hi and lo of 16 k-values) or 8 bf16 ones (32 k-values) of H rows.
constexpr int kTcMaxSlots = 2 * kTcStages;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Returns once the phase of the barrier with this parity has completed.
// The loop is inside the asm: a loop the compiler sees is a divergent path
// to ptxas, which then serializes the wgmma in flight around it (C7520).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"  // a label is local to its { } scope
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// The arrival of the threads where `lead` is 0, predicated rather than
// branched around (no divergent path beside wgmma in flight, C7520).
__device__ __forceinline__ void mbar_arrive_if_zero(uint32_t bar, uint32_t lead) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(lead)
      : "memory");
}
// The arrival of each warp's lane 0 unless `skip`, the lane read in the
// instruction's own block (no register holds it beside live accumulators;
// a predicate, no branch, as mbar_arrive_if_zero).
__device__ __forceinline__ void mbar_arrive_lane0(uint32_t bar, uint32_t skip) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b32 l;\nmov.u32 l, %%laneid;\nor.b32 l, l, %1;\n"
      "setp.eq.u32 p, l, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(skip)
      : "memory");
}
// The producer's arrival on a full barrier, with the bytes the copy brings.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// to shared dst, completed on bar's transaction count.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The ring as one role sees it.  Both roles walk the same sequence of
// products (the tile functions run once in each role, note 2) and so agree
// on every chunk's slot: chunk k of the block's walk lands in slot k %
// kSlots, on its round k / kSlots.  full[s] completes when the producer's
// copy into slot s has landed (one arrival with the bytes); empty[s] when
// both consumer warpgroups' products that read slot s have retired (two
// arrivals); lend when the consumers are done with bbuf as scratch (kThreads
// arrivals), after which the producer copies on.
template <bool kProducer_, int HT, bool kBf16>
struct TcPipe {
  static constexpr bool kProducer = kProducer_;
  static constexpr bool kConsumer = !kProducer_;
  static constexpr int kSlots = kBf16 ? kTcMaxSlots : kTcStages;
  static constexpr int kSlotFloats = tc_bbuf_floats<HT>() / kSlots;
  float* buf;     // slot 0 (bbuf)
  uint32_t bars;  // full[kTcMaxSlots], empty[kTcMaxSlots], lend
  int slot = 0;
  uint32_t phase = 0;  // parity of the slot's current round
  uint32_t lend_phase = 0;

  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (kTcMaxSlots + s); }
  __device__ uint32_t lend_bar() const { return bars + 16 * kTcMaxSlots; }
  __device__ float* at(int s) const { return buf + s * kSlotFloats; }
  __device__ void advance() {
    if (++slot == kSlots) {
      slot = 0;
      phase ^= 1;
    }
  }
  // bbuf as the consumers' scratch: they run use() (which may write and
  // read any of bbuf, every product before it having retired) and release
  // bbuf; the producer waits until then before it copies the next chunk.
  // Two lends need a product between them (the lend barrier's phases).
  template <class F>
  __device__ void lend(F&& use) {
    if constexpr (kConsumer) {
      use();
      fence_async_smem();  // the scratch's stores before the copies that overwrite them
      mbar_arrive(lend_bar());
    } else {
      mbar_wait(lend_bar(), lend_phase);
      lend_phase ^= 1;
    }
  }
};

// Runs body(pipe) in both roles of a tensor-core tile's block (kTcThreads
// threads, bbuf its B chunk buffers of tile width HT): the consumers with a
// TcPipe<false>, the producer warpgroup's first thread with a TcPipe<true>;
// the producer's other threads have nothing to do.  body walks the block's
// products in one order in both roles: every tc_gemm, and every lend, with
// the same arguments.  The role is warp-uniform (the warp index through a
// shuffle), so the consumers' wgmma stay in converged code.
template <int HT, bool kBf16, class Body>
__device__ __forceinline__ void tc_block(float* bbuf, Body&& body) {
  __shared__ __align__(8) uint64_t bars[2 * kTcMaxSlots + 1];
  const uint32_t b0 = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcMaxSlots; ++s) {
      mbar_init(b0 + 8 * s, 1);
      mbar_init(b0 + 8 * (kTcMaxSlots + s), 2);
    }
    mbar_init(b0 + 16 * kTcMaxSlots, kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (__shfl_sync(kFull, threadIdx.x >> 7, 0) == kThreads / 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    if (threadIdx.x == kThreads) {
      TcPipe<true, HT, kBf16> pipe{bbuf, b0};
      body(pipe);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));
    TcPipe<false, HT, kBf16> pipe{bbuf, b0};
    body(pipe);
  }
}

// d += A[tile rows, 0:K] @ B[0:N, 0:K]^T.  A is src: a shared tile (TileA)
// or the encodings streamed through the ring (EncA); img is B's operand
// image in global memory, whose chunks the pipe's ring brings (N <= the
// pipe's HT).  Warpgroup wg (threads 128 wg ..) computes the output columns
// [wg N / 2, (wg + 1) N / 2) of the tile's 64 rows, warp w of it rows 16 w
// .. 16 w + 15: d holds that warp's m64n(N/2) accumulator fragment
// (classic mma layout: d[4 j ..4 j + 1] row g, columns 8 j + 2 q, + 1;
// d[4 j + 2 ..] row g + 8).  N is H for the layers' products,
// tc_in_cols<H>() for the input cotangents'.  In the producer's role it
// only copies the chunks.
//
// The pipeline (note 2): the producer thread copies each chunk of img (one
// contiguous swizzled chunk of the image, tc_mlp.py::operand_image) with
// one bulk copy into the next slot of the ring once both warpgroups have
// released it, whichever product it belongs to, so the next product's
// chunks land while this one's last products and the epilogue run.  A
// consumer warpgroup takes the chunks in batches (kTcBatchTf32 = 2 TF32, one
// bf16 chunk): it waits on each chunk's full barrier, loads the
// batch's A fragments and B descriptors, issues the batch's products
// (three per k-step of 8 in 3xTF32, one per k-step of 16 in bf16) between
// one wgmma fence and one commit, and releases the slots on their empty
// barriers once they have retired; nothing else waits per chunk.  TF32: a
// batch retires before the next one's fragments load.  ptxas serializes
// every wgmma of a kernel (each product waiting for the one before, C7513)
// where a product's input is defined while products are in flight, which
// the TF32 split of the next chunk's fragments was when it ran beside the
// last chunk's products (every HGMMA then waited for); the two
// warpgroups run their batches independently, so one's loads overlap the
// other's products.  bf16: a batch stays in flight while the next batch's
// fragments load into a second register set (ptxas keeps those pipelined).
// With EncA both warpgroups read every row of the ring's slab, which the
// consumers stage with cp.async two chunks ahead, so a chunk of an encoding
// product waits at a barrier of the consumers.
// Every branch here is uniform and the fragments load without branches:
// ptxas serializes all wgmma of a kernel whose wgmma operands come from
// divergent code.  Starts and ends with a barrier of the consumers (A and
// the activation tile are written and read by all eight warps).  kBf16
// (note 10): img is a bf16 image, chunks of 32 k-values (one 64-byte row
// each), one bf16 product per k-step of 16 and no lo fragments; an encoding
// product of more than kFreshChunks chunks (a latent-conditioned model's)
// sums each chunk's products in a fresh accumulator and adds it to d in
// float32, as wgrad sums its chunks (note 7), the chunks then not
// overlapped: the tensor cores' truncation over its 44 k-steps at 700
// values moved the inputs' cotangents 1.2-1.6x farther from the plain
// version than at 60.
template <int N, bool kBf16 = false, class Pipe, class Src>
__device__ void tc_gemm(Pipe& pipe, float (&d)[N / 4], const Src& src, int K,
                        const float* __restrict__ img) {
  constexpr bool kRing = !std::is_same_v<Src, TileA>;
  constexpr int kK = tc_chunk<kBf16>();  // k-values of a chunk
  constexpr int kChunkFloats = kBf16 ? N * kK / 2 : 2 * N * kTcK;  // floats of a chunk of img
  static_assert(kChunkFloats <= Pipe::kSlotFloats, "a chunk fills at most one slot");
  const int chunks = round_up_tc<kBf16>(K) / kK;
  if constexpr (Pipe::kProducer) {
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(pipe.empty(pipe.slot), pipe.phase ^ 1);  // the first round passes
      mbar_expect_tx(pipe.full(pipe.slot), kChunkFloats * sizeof(float));
      bulk_copy(smem_u32(pipe.at(pipe.slot)), img + static_cast<size_t>(c) * kChunkFloats,
                kChunkFloats * sizeof(float), pipe.full(pipe.slot));
      pipe.advance();
    }
  } else {
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
    const int g = lane >> 2, q = lane & 3;
    // This thread's A rows: of the tile, or of a ring slab (plus the slab's
    // offset).
    const float* a0;
    int lda;
    if constexpr (kRing) {
      a0 = src.ring;
      lda = kEncLd;
    } else {
      a0 = src.A;
      lda = src.lda;
    }
    a0 += (((tid >> 5) & 3) * 16 + g) * lda;
    const float* a1 = a0 + 8 * lda;
    const bool fresh = kBf16 && chunks > kFreshChunks;
    auto stage = [&](int c) {  // the encodings' slab of chunk c; a group, empty past the last
      if constexpr (kRing) {
        if (c < chunks)
          src.load.template stage<kBf16>(src.w, src.which, c, src.row0, src.nvalid, src.first,
                                         src.ring + (c % kTcStages) * kEncSlab);
        asm volatile("cp.async.commit_group;\n" ::);
      }
    };
    // Chunk c's slot has landed; with EncA also its slab (staged by every
    // consumer), and every consumer is done with chunk c - 2's slab, which
    // takes chunk c + 2.
    auto arrive = [&](int c) {
      mbar_wait(pipe.full(pipe.slot), pipe.phase);
      if constexpr (kRing) {
        asm volatile("cp.async.wait_group 1;\n" ::);
        tile_sync();
        stage(c + 2);
      }
    };
    // k-steps of a chunk: two of 8 (TF32) or of 16 (bf16) values.
    constexpr int kSteps = kBf16 ? kTcKB / 16 : kTcK / 8;
    constexpr int kBatch = kBf16 ? 1 : kTcBatchTf32;
    // bf16 batches overlap: a batch's products stay in flight while the
    // next batch's fragments load into the other register set (ptxas keeps
    // such bf16 products pipelined; it serializes the TF32 ones, whose
    // split defines their fragments: C7513).
    constexpr bool kOverlap = kBf16;
    constexpr int kSets = kOverlap ? 2 : 1;
    uint32_t ahi[kSets][kBatch][kSteps][4];
    uint32_t alo[kBf16 ? 1 : kSets][kBatch][kSteps][4];
    int held[kBatch] = {}, held_n = 0;  // slots of the batch in flight (kOverlap)
    // Chunk c's A fragments into entry b of register set `set`, once its
    // slot (and slab) landed.
    auto fragments = [&](int c, int set, int b) {
      arrive(c);
      const int k0 = c * kK;
      const int slab = kRing ? (c % kTcStages) * kEncSlab : 0;
      if constexpr (kBf16) {
        // a_j: row g + 8 (j & 1), k-values kk, kk + 1 with kk = k + 8 (j >> 1).
        if constexpr (kRing) {  // the slab holds the pairs: word kk / 2 of the row
          const uint32_t* w0 = reinterpret_cast<const uint32_t*>(a0 + slab);
          const uint32_t* w1 = reinterpret_cast<const uint32_t*>(a1 + slab);
#pragma unroll
          for (int s = 0; s < kSteps; ++s)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              ahi[set][b][s][j] = ((j & 1) ? w1 : w0)[8 * s + q + 4 * (j >> 1)];
        } else {
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            const int k = k0 + 16 * s + 2 * q;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float* row = (j & 1) ? a1 : a0;
              const int kk = k + 8 * (j >> 1);
              const float v0 = row[min(kk, K - 1)], v1 = row[min(kk + 1, K - 1)];
              ahi[set][b][s][j] = pack_bf16x2(kk < K ? v0 : 0.f, kk + 1 < K ? v1 : 0.f);
            }
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < kTcK / 8; ++s) {
          if constexpr (kRing) {  // zero past K in the slab
            const int k = slab + 8 * s + q;
            const float v[4] = {a0[k], a1[k], a0[k + 4], a1[k + 4]};
#pragma unroll
            for (int j = 0; j < 4; ++j) split_tf32(v[j], ahi[set][b][s][j], alo[set][b][s][j]);
          } else {
            const int k = k0 + 8 * s + q, ka = min(k, K - 1), kb = min(k + 4, K - 1);
            const float v[4] = {a0[ka], a1[ka], a0[kb], a1[kb]};
#pragma unroll
            for (int j = 0; j < 4; ++j)
              split_tf32((j < 2 ? k : k + 4) < K ? v[j] : 0.f, ahi[set][b][s][j], alo[set][b][s][j]);
          }
        }
      }
    };
    // Slot s released (one arrival a warpgroup) unless `keep`: every thread
    // runs the same instructions (a predicated arrival, no branch beside
    // wgmma in flight: ptxas would serialize the products, C7520).
    auto release = [&](int s, bool keep = false) {
      mbar_arrive_if_zero(pipe.empty(s), (tid & 127) | static_cast<uint32_t>(keep));
    };
    // The batch in flight retired and its slots released.
    auto drain = [&](float (&acc)[N / 4]) {
      if constexpr (kOverlap) {
        wgmma_wait0();
        fence_regs(acc);
        fence_regs(ahi);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) release(held[b], b >= held_n);
        held_n = 0;
      }
    };
    // acc += the products of nb <= kBatch chunks from c0 (register set SET,
    // a compile-time constant: a set indexed at run time would live in
    // local memory).  Every input of the batch's wgmma (A fragments, B
    // descriptors) is defined before its wgmma fence and nothing between
    // the fence and the products defines one.  TF32: the batch retires
    // before the next batch's fragments load (ptxas serializes every wgmma
    // of a kernel where one is defined while products are in flight,
    // C7513), its slots released; the two warpgroups run their batches
    // independently, so one's loads overlap the other's products.  bf16
    // (kOverlap): the batch stays in flight and the batch before it
    // retires.
    auto batch = [&](auto set_c, float (&acc)[N / 4], int c0, int nb) {
      constexpr int set = decltype(set_c)::value;
      int slots[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        slots[b] = pipe.slot;
        if (b < nb) {
          fragments(c0 + b, set, b);
          pipe.advance();
        }
      }
      // This warpgroup's half of each chunk: rows n of B are 16 floats
      // apart (kBf16: 16 words of pairs); TF32: hi block, then lo block.
      uint64_t bd[kBatch][kBf16 ? kSteps : 2 * kSteps];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float* hi = pipe.at(slots[b]) + wg * (N / 2) * kTcK;
#pragma unroll
        for (int s = 0; s < kSteps; ++s) {
          bd[b][s] = smem_desc_sw64(hi + 8 * s);
          if constexpr (!kBf16) bd[b][kSteps + s] = smem_desc_sw64(hi + N * kTcK + 8 * s);
        }
      }
      fence_regs(bd);
      fence_regs(ahi[set]);
      if constexpr (!kBf16) fence_regs(alo[set]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (b < nb) {
#pragma unroll
          for (int s = 0; s < kSteps; ++s) {
            if constexpr (kBf16) {
              wgmma_rs_bf16(acc, ahi[set][b][s], bd[b][s]);
            } else {
              wgmma_rs(acc, ahi[set][b][s], bd[b][s]);
              wgmma_rs(acc, ahi[set][b][s], bd[b][kSteps + s]);
              wgmma_rs(acc, alo[set][b][s], bd[b][s]);
            }
          }
        }
      }
      wgmma_commit();
      if constexpr (kOverlap) {
        wgmma_wait1();  // the batch before this one is done
        fence_regs(acc);
        fence_regs(ahi[1 - set]);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          release(held[b], b >= held_n);
          held[b] = slots[b];
        }
        held_n = nb;
      } else {
        wgmma_wait0();
        fence_regs(acc);
        fence_regs(ahi);
        fence_regs(alo);
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (b < nb) release(slots[b]);
      }
    };
    using Set0 = std::integral_constant<int, 0>;
    using Set1 = std::integral_constant<int, kSets - 1>;
    // The chunks c0 .. c1 - 1: TF32 in batches of kBatch; bf16 chunk by
    // chunk, the register sets alternating (the loop unrolled by two).
    auto run = [&](float (&acc)[N / 4], int c0, int c1) {
      if constexpr (kOverlap) {
        int c = c0;
        for (; c + 2 <= c1; c += 2) {
          batch(Set0{}, acc, c, 1);
          batch(Set1{}, acc, c + 1, 1);
        }
        if (c < c1) batch(Set0{}, acc, c, 1);
        drain(acc);
      } else {
        for (int c = c0; c < c1; c += kBatch) batch(Set0{}, acc, c, min(kBatch, c1 - c));
      }
    };
    stage(0);
    stage(1);
    tile_sync();  // A was written by all eight warps; both warpgroups read all of it
    bool chunked = false;  // a long bf16 encoding product
    if constexpr (kRing && kBf16) {
      if constexpr (kChunkedSums<typename Src::Loader>) chunked = fresh;
    }
    if (chunked) {
      // Each chunk's products into a fresh accumulator, added to d in
      // float32 before the next.
      for (int c = 0; c < chunks; ++c) {
        float e[N / 4];
        tc_zero<N>(e);
        batch(Set0{}, e, c, 1);
        drain(e);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) d[i] += e[i];
      }
    } else if constexpr (grouped_sums<Src, kBf16>()) {
      // Each group of chunks into d cleared, the sum so far kept in s and
      // added back in float32 once the group's products are done.
      for (int c0 = 0; c0 < chunks; c0 += kF32GroupChunks) {
        const int c1 = min(c0 + kF32GroupChunks, chunks);
        float s[N / 4];
#pragma unroll
        for (int i = 0; i < N / 4; ++i) {
          s[i] = d[i];
          d[i] = 0.f;
        }
        run(d, c0, c1);
#pragma unroll
        for (int i = 0; i < N / 4; ++i) d[i] += s[i];
      }
    } else {
      run(d, 0, chunks);
    }
    if constexpr (kRing) asm volatile("cp.async.wait_group 0;\n" ::);  // the empty groups
    tile_sync();
  }
}

// The same on a shared tile A with row stride lda.
template <int N, bool kBf16 = false, class Pipe>
__device__ __forceinline__ void tc_gemm(Pipe& pipe, float (&d)[N / 4], const float* A, int lda,
                                        int K, const float* __restrict__ img) {
  tc_gemm<N, kBf16>(pipe, d, TileA{A, lda}, K, img);
}

// The wgmma fragments d of tc_gemm<N> -> columns 0 .. N - 1 of act [64][ld]
// (ld even), then a barrier of the tile's threads.  Called by the tile's threads after
// tc_gemm.
template <int N>
__device__ __forceinline__ void tc_to_act(const float (&d)[N / 4], float* act, int ld) {
  const int tid = threadIdx.x, lane = tid & 31;
  float* r0 = act + (((tid >> 5) & 3) * 16 + (lane >> 2)) * ld + (tid >> 7) * (N / 2) +
              2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
    *reinterpret_cast<float2*>(r0 + 8 * j) = make_float2(d[4 * j], d[4 * j + 1]);
    *reinterpret_cast<float2*>(r0 + 8 * ld + 8 * j) = make_float2(d[4 * j + 2], d[4 * j + 3]);
  }
  tile_sync();
}

// The wgmma fragments d -> act [64][act_ld<H>()] -> this warp's rows in the
// row-per-warp layout of classic_mlp.cuh (acc[r][j]: row 8 warp + r,
// column lane + 32 j).  Called by the whole block after tc_gemm.
template <int H>
__device__ __forceinline__ void tc_to_rows(const float (&d)[H / 4], float* act,
                                           float (&acc)[kRowsPerWarp][H / 32]) {
  constexpr int ld = act_ld<H>();
  const int tid = threadIdx.x, lane = tid & 31;
  tc_to_act<H>(d, act, ld);
  const float* rows = act + (tid >> 5) * kRowsPerWarp * ld;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < H / 32; ++j) acc[r][j] = rows[r * ld + lane + 32 * j];
}

// This warp's rows of acc -> act [64][act_ld<H>()].
template <int H>
__device__ __forceinline__ void tc_store_rows(const float (&acc)[kRowsPerWarp][H / 32],
                                              float* act) {
  constexpr int ld = act_ld<H>();
  const int lane = threadIdx.x & 31;
  float* rows = act + (threadIdx.x >> 5) * kRowsPerWarp * ld;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < H / 32; ++j) rows[r * ld + lane + 32 * j] = acc[r][j];
}

// Bytes of shared memory of the tensor-core MLP tile (fwd_store, K1-fwd,
// K8-fwd; the mip forward tile): the B chunks, the activation tile, the
// encodings' ring and the alignment slack, at every encoding width (note
// 9).
template <int H>
__host__ __device__ constexpr size_t tc_tile_bytes() {
  return (static_cast<size_t>(tc_bbuf_floats<H>()) + static_cast<size_t>(kTileRows) * act_ld<H>() +
          kEncRingFloats) *
             sizeof(float) +
         kSmemAlign;
}

// Chunk c of the encoding src [rows][width] (tile row r reads row (row0 +
// r) / div) into a ring slab (EncA), zero past the width and past nvalid:
// float32 values (kBf16 false), or bfloat16 pairs as stored.  Copied with
// cp.async (joining the chunk's group of B copies) where the rows allow
// it: 16 bytes a copy for float32 widths that are a multiple of 4, 4
// bytes (a float, a pair) otherwise; a bfloat16 encoding of odd width,
// whose pairs straddle words, is loaded and packed directly.  Called by
// the whole block.
template <bool kBf16, class T>
__device__ __forceinline__ void stage_enc(float* slab, const T* __restrict__ src, int width,
                                          int div, int c, size_t row0, int nvalid) {
  static_assert(std::is_same_v<T, enc_t<kBf16>>, "the encodings are stored in the compute dtype");
  const int r = threadIdx.x >> 2, j4 = 4 * (threadIdx.x & 3);  // row, first word
  float* dst = slab + r * kEncLd + j4;
  const size_t row = (row0 + r) / div;
  const bool rv = r < nvalid;
  if constexpr (!kBf16) {
    const int k = c * kTcK + j4;
    const float* at = src + row * width + k;
    if (width % 4 == 0 && reinterpret_cast<size_t>(src) % 16 == 0) {
      const bool v = rv && k < width;
      cp_async16(reinterpret_cast<float4*>(dst), reinterpret_cast<const float4*>(v ? at : src), v);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = rv && k + e < width;
        cp_async4(dst + e, v ? at + e : src, v);
      }
    }
  } else {
    const int k = c * kTcKB + 2 * j4;  // the first of the thread's 8 values
    const __nv_bfloat16* at = src + row * width + k;
    if (width % 2 == 0 && reinterpret_cast<size_t>(src) % 4 == 0) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool v = rv && k + 2 * e < width;
        cp_async4(dst + e, reinterpret_cast<const float*>(v ? at + 2 * e : src), v);
      }
    } else {
      uint32_t* words = reinterpret_cast<uint32_t*>(dst);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k + 2 * e;
        const uint32_t lo = rv && kk < width ? __bfloat16_as_ushort(at[2 * e]) : 0u;
        const uint32_t hi = rv && kk + 1 < width ? __bfloat16_as_ushort(at[2 * e + 1]) : 0u;
        words[e] = lo | hi << 16;
      }
    }
  }
}

// The encodings of a tile read from global memory: x [P][xe] and d, whose
// row r / d_div serves row r (d_div > 1: per-ray view encodings); T is
// float or __nv_bfloat16, the compute dtype's.  An EncA loader.
template <class T>
struct TileLoadT {
  const T* x;
  const T* d;
  int d_div;
  template <bool kBf16>
  __device__ __forceinline__ void stage(const Weights& w, int which, int c, size_t row0,
                                        int nvalid, bool, float* slab) const {
    if (which == 0)
      stage_enc<kBf16>(slab, x, w.xe, 1, c, row0, nvalid);
    else
      stage_enc<kBf16>(slab, d, w.de, d_div, c, row0, nvalid);
  }
};
using TileLoad = TileLoadT<float>;

// The network on one 64-row tile with the products on the tensor cores:
// the tile's rows row0 .. row0 + nvalid - 1 of the
// encodings that `load` stages (EncA), [density, color...] rows to out
// (row stride ld).  act is the [64][act_ld<H>()] activation tile, ring the
// encodings' ring (kEncRingFloats), pipe the B chunks' ring (tc_block); with
// kSave every layer's xhat and statistics go to save.  kBf16: bf16 images
// and products, bf16 heads (note 10).  In the producer's role only the
// products' copies.
template <int H, bool kSave = false, bool kBf16 = false, class Pipe, class Load>
__device__ void mlp_tile_tc(Pipe& pipe, const Weights& w, const TcImages& im, const Load& load,
                            size_t row0, int nvalid, float* act, float* ring, float* out,
                            int ld, const Save* save = nullptr) {
  constexpr bool kC = Pipe::kConsumer;
  constexpr int ald = act_ld<H>();
  const size_t slab = tc_image_floats<kBf16>(H, H);
  float d[H / 4];
  float acc[kRowsPerWarp][H / 32];
  auto epilogue = [&](int i, bool store) {
    if constexpr (kC) {
      tc_to_rows<H>(d, act, acc);
      layer_epilogue<H, kSave>(acc, w.b + i * H, w.g + i * H, w.beta + i * H, w.inv_h, w.padded,
                               save, i);
      if (store) tc_store_rows<H>(acc, act);
    }
  };
  auto enc = [&](int which, bool first) {
    return EncA<Load>{load, w, which, row0, nvalid, first, ring};
  };

  tc_zero<H>(d);
  tc_gemm<H, kBf16>(pipe, d, enc(0, true), w.xe, im.w0);
  epilogue(0, true);
  for (int i = 1; i < 8; ++i) {
    tc_zero<H>(d);
    tc_gemm<H, kBf16>(pipe, d, act, ald, H, im.whh + (i - 1) * slab);
    if (i == 4) tc_gemm<H, kBf16>(pipe, d, enc(0, false), w.xe, im.wx);
    epilogue(i, true);
  }
  if constexpr (kC) head<H, kBf16>(acc, w.w_dens, w.b_dens, 1, out, ld, 0, nvalid);
  if (w.wd != nullptr) {
    for (int i = 8; i < 10; ++i) {
      tc_zero<H>(d);
      tc_gemm<H, kBf16>(pipe, d, act, ald, H, im.whh + (i - 1) * slab);
      if (i == 8) tc_gemm<H, kBf16>(pipe, d, enc(1, true), w.de, im.wd);
      epilogue(i, i == 8);
    }
  }
  if constexpr (kC) head<H, kBf16>(acc, w.w_col, w.b_col, w.c, out, ld, 1, nvalid);
}

// ---------------------------------------------------------------------------
// Hidden widths past 256 (note 11): column blocks, the rows in device memory.
// ---------------------------------------------------------------------------

// Where a wide tile keeps its rows: tile t's pre-LayerNorm rows at pre + t
// * stride and its LayerNorm'd rows at nrm + t * stride (floats; the
// compute dtype's values), [64][hp] each.
struct WideRows {
  float* pre;
  float* nrm;
  size_t stride;
};
// A scratch of 2 x 64 x hp floats a tile as WideRows.
__host__ inline WideRows wide_rows(float* base, int hp) {
  const size_t rows = static_cast<size_t>(kTileRows) * hp;
  return WideRows{base, base == nullptr ? nullptr : base + rows, 2 * rows};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// An EncA loader over rows in device memory written by this kernel: src
// [rows][width] (row0 counts from src), float32 or the compute dtype's.
// Rows of the compute dtype go through stage_enc; float32 rows under kBf16
// (dpre, bwd_rows_wide) are rounded to bfloat16 pairs as they are staged,
// the rounding of tc_gemm's fragment loads.
template <class T>
struct RowsLoadT {
  const T* src;
  int width;
  template <bool kBf16, class W>
  __device__ __forceinline__ void stage(const W&, int, int c, size_t row0, int nvalid, bool,
                                        float* slab) const {
    if constexpr (std::is_same_v<T, enc_t<kBf16>>) {
      stage_enc<kBf16>(slab, src, width, 1, c, row0, nvalid);
    } else {
      const int r = threadIdx.x >> 2, j4 = 4 * (threadIdx.x & 3);
      const int k = c * kTcKB + 2 * j4;  // the first of the thread's 8 values
      const T* at = src + (row0 + r) * width + k;
      uint32_t* words = reinterpret_cast<uint32_t*>(slab + r * kEncLd + j4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kk = k + 2 * e;
        const float lo = r < nvalid && kk < width ? at[2 * e] : 0.f;
        const float hi = r < nvalid && kk + 1 < width ? at[2 * e + 1] : 0.f;
        words[e] = pack_bf16x2(lo, hi);
      }
    }
  }
};
// A wide product is long (K = hp: 512 values are 16 bf16 chunks), so its
// bf16 chunks sum apart, each in a fresh accumulator added in float32, as
// a long encoding product's do: the tensor cores' truncation over 32
// k-steps moved bf16 K1-bwd's inputs' cotangents at hidden 512 to 1.45x
// the plain version's own float64-sum distance pipelined, 1.12x chunked
// (K8-bwd's the same; scripts/torch_bf16_sensitivity.py --family hidden).
template <class T>
inline constexpr bool kChunkedSums<RowsLoadT<T>> = true;
template <class T>
inline constexpr bool kGroupedSums<RowsLoadT<T>> = true;

// Column block cb of a wide product, d (tc_gemm<kColBlock>'s fragments),
// through act to dst's columns cb * 256 .. (row stride hp) for the tile's
// valid rows: plus the bias b where given, then ReLU where kRelu.  Called by
// the whole block; ends with a barrier of the tile's threads.
template <bool kRelu>
__device__ void wide_store_block(const float (&d)[kColBlock / 4], float* act, float* dst, int hp,
                                 int cb, const float* __restrict__ b, int nvalid) {
  constexpr int ld = act_ld<kColBlock>();
  tc_to_act<kColBlock>(d, act, ld);
  for (int i = threadIdx.x; i < nvalid * kColBlock; i += kThreads) {
    const int r = i / kColBlock, c = i - r * kColBlock;
    float v = act[r * ld + c];
    if (b != nullptr) v += __ldg(b + cb * kColBlock + c);
    dst[static_cast<size_t>(r) * hp + cb * kColBlock + c] = kRelu ? fmaxf(v, 0.f) : v;
  }
  tile_sync();
}

// A wide layer's LayerNorm (layer_epilogue over rows in device memory):
// each valid row of pre [64][hp], its two-pass statistics over the first h
// columns, nrm = xhat * g + beta (then ReLU where kLnFirst, the mip order)
// in the compute dtype; with kSave also layer `layer`'s xhat and
// statistics.  One warp a row; ends with a barrier of the tile's threads.
template <bool kSave, bool kLnFirst, class T>
__device__ void wide_norm(const float* pre, T* nrm, int hp, int h, float inv_h, int nvalid,
                          const float* __restrict__ g, const float* __restrict__ beta,
                          const Save* save, int layer) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nvalid; r += kWarps) {
    const float* row = pre + static_cast<size_t>(r) * hp;
    float s = 0.f;
    for (int k = lane; k < h; k += 32) s += row[k];
    const float mu = warp_sum(s) * inv_h;
    float q = 0.f;
    for (int k = lane; k < h; k += 32) {
      const float dv = row[k] - mu;
      q = fmaf(dv, dv, q);
    }
    const float inv = rsqrtf(warp_sum(q) * inv_h + kLnEps);
    T* out = nrm + static_cast<size_t>(r) * hp;
    float* xh = nullptr;
    if constexpr (kSave) {
      const size_t at = static_cast<size_t>(layer) * save->P + save->row0 + r;
      xh = save->xhat + at * hp;
      if (lane == 0) {
        save->stats[2 * at] = inv;
        save->stats[2 * at + 1] = (0.f - mu) * inv;
      }
    }
    for (int k = lane; k < hp; k += 32) {
      const float x = (row[k] - mu) * inv;
      if constexpr (kSave) xh[k] = x;
      const float y = x * __ldg(g + k) + __ldg(beta + k);
      from_f32(out + k, kLnFirst ? fmaxf(y, 0.f) : y);
    }
  }
  tile_sync();
}

// head over rows in device memory: out[row * ld + col0 + i] = nrm[row] .
// W[:, i] + bias[i] for i < n and the tile's valid rows, W row-major [hp,
// n]; kBf16 rounds h and W (head<H, true>).  A head of at most kFewOutputs
// (the classic density and colours): one warp a row, the lanes over k, as
// head<H> sums.  A wider one (the mip head): the rows staged through act
// ([64][act_ld<kColBlock>()]) a kColBlock-column block at a time and W
// through wbuf a [64][64] chunk at a time, each lane two outputs of a
// 64-output block, as head_wide sums, so W is read once a tile and block.
// Called by the whole block (act and wbuf free); ends with a barrier.
constexpr int kFewOutputs = 8;
template <bool kBf16, class T>
__device__ void head_rows(const T* nrm, int hp, float* act, float* wbuf,
                          const float* __restrict__ W, const float* __restrict__ bias, int n,
                          float* out, int ld, int col0, int nvalid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (n <= kFewOutputs) {
    for (int r = warp; r < nvalid; r += kWarps) {
      const T* row = nrm + static_cast<size_t>(r) * hp;
      for (int i = 0; i < n; ++i) {
        float s = 0.f;
        for (int k = lane; k < hp; k += 32)
          s = fmaf(operand<kBf16>(to_f32(row[k])),
                   operand<kBf16>(__ldg(W + static_cast<size_t>(k) * n + i)), s);
        s = warp_sum(s);
        if (lane == 0) out[r * ld + col0 + i] = s + __ldg(bias + i);
      }
    }
    tile_sync();
    return;
  }
  constexpr int LD = act_ld<kColBlock>();
  const float* a_rows = act + warp * kRowsPerWarp * LD;
  for (int c0 = 0; c0 < n; c0 += 64) {
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int kb = 0; kb < hp; kb += kColBlock) {
      tile_sync();  // act's last readers are done
      for (int i = threadIdx.x; i < kTileRows * kColBlock; i += kThreads) {
        const int r = i / kColBlock, c = i - r * kColBlock;
        act[r * LD + c] =
            r < nvalid ? operand<kBf16>(to_f32(nrm[static_cast<size_t>(r) * hp + kb + c])) : 0.f;
      }
      for (int k0 = 0; k0 < kColBlock; k0 += 64) {
        tile_sync();  // the chunk before is consumed (and act staged)
        for (int i = threadIdx.x; i < 64 * 64; i += kThreads) {
          const int c = c0 + (i & 63);
          wbuf[i] = c < n ? operand<kBf16>(__ldg(W + static_cast<size_t>(kb + k0 + (i >> 6)) * n + c))
                          : 0.f;
        }
        tile_sync();
        for (int kk = 0; kk < 64; kk += 4) {
          float4 a[kRowsPerWarp];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r)
            a[r] = *reinterpret_cast<const float4*>(a_rows + r * LD + k0 + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float wa = wbuf[(kk + q) * 64 + lane], wb = wbuf[(kk + q) * 64 + 32 + lane];
#pragma unroll
            for (int r = 0; r < kRowsPerWarp; ++r) {
              const float av = q == 0 ? a[r].x : q == 1 ? a[r].y : q == 2 ? a[r].z : a[r].w;
              acc[r][0] = fmaf(av, wa, acc[r][0]);
              acc[r][1] = fmaf(av, wb, acc[r][1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (row >= nvalid) continue;
      if (c0 + lane < n) out[row * ld + col0 + c0 + lane] = acc[r][0] + __ldg(bias + c0 + lane);
      if (c0 + 32 + lane < n)
        out[row * ld + col0 + c0 + 32 + lane] = acc[r][1] + __ldg(bias + c0 + 32 + lane);
    }
  }
  tile_sync();
}

// mlp_tile_tc past 256 (note 11): the same network on one 64-row tile in
// hp / 256 column blocks a layer, the tile's rows in `rows` (tile 0 of a
// WideRows).  Each block's product streams its A operand through the ring:
// the encodings (EncA on `load`; `first` on the first column block only) or
// the previous layer's nrm rows (RowsLoadT).  A head wider than
// kFewOutputs stages its weights through bbuf, lent by the pipe.
template <bool kSave, bool kBf16, class Pipe, class Load>
__device__ void mlp_tile_wide(Pipe& pipe, const Weights& w, const TcImages& im, const Load& load,
                              size_t row0, int nvalid, float* act, float* ring, float* out,
                              int ld, const Save* save, float* pre, float* nrm_f) {
  constexpr bool kC = Pipe::kConsumer;
  using T = enc_t<kBf16>;
  constexpr int B = kColBlock;
  T* nrm = reinterpret_cast<T*>(nrm_f);
  const int hp = w.hp, nb = hp / B, L = num_layers(w);
  const size_t blk_x = tc_image_floats<kBf16>(B, w.xe), blk_d = tc_image_floats<kBf16>(B, w.de);
  const size_t blk_h = tc_image_floats<kBf16>(B, hp), slab = tc_image_floats<kBf16>(hp, hp);
  const RowsLoadT<T> rows{nrm, hp};
  const EncA<RowsLoadT<T>> prev{rows, w, 0, 0, nvalid, false, ring};
  auto head = [&](const float* W, const float* bias, int n, int col0) {
    auto run = [&] { head_rows<kBf16>(nrm, hp, act, pipe.buf, W, bias, n, out, ld, col0, nvalid); };
    if (n > kFewOutputs)
      pipe.lend(run);
    else if constexpr (kC)
      run();
  };
  float d[B / 4];
  for (int i = 0; i < L; ++i) {
    for (int cb = 0; cb < nb; ++cb) {
      tc_zero<B>(d);
      if (i == 0)
        tc_gemm<B, kBf16>(pipe, d, EncA<Load>{load, w, 0, row0, nvalid, cb == 0, ring}, w.xe,
                          im.w0 + cb * blk_x);
      else
        tc_gemm<B, kBf16>(pipe, d, prev, hp, im.whh + (i - 1) * slab + cb * blk_h);
      if (i == 4)
        tc_gemm<B, kBf16>(pipe, d, EncA<Load>{load, w, 0, row0, nvalid, false, ring}, w.xe,
                          im.wx + cb * blk_x);
      if (i == 8)
        tc_gemm<B, kBf16>(pipe, d, EncA<Load>{load, w, 1, row0, nvalid, cb == 0, ring}, w.de,
                          im.wd + cb * blk_d);
      if constexpr (kC) wide_store_block<true>(d, act, pre, hp, cb, w.b + i * hp, nvalid);
    }
    if constexpr (kC)
      wide_norm<kSave, false>(pre, nrm, hp, w.h, w.inv_h, nvalid, w.g + i * hp, w.beta + i * hp,
                              save, i);
    if (i == 7) head(w.w_dens, w.b_dens, 1, 0);
  }
  head(w.w_col, w.b_col, w.c, 1);
}

// ---------------------------------------------------------------------------
// Pass 1: the stored-chain forward of the P rows of a call.
// ---------------------------------------------------------------------------

// Tile row r of block b is row 64 b + r of the call and row base + 64 b +
// r of the chain, whose layers are `stride` rows apart (base 0 and stride
// P but where two calls fill one chain, as K9's coarse and fine stages
// do).  `load` stages the tile's encodings (EncA): TileLoad reads them
// from global memory, the K8 and K9 loaders (encode.cuh) compute them.
// wide: the rows of a width past 256 (note 11), unused below it.
template <int H, class Load, bool kBf16 = false>
NERF_TC_KERNEL
    fwd_store_tc_kernel(Weights w, TcImages im, Load load, float* __restrict__ out, int P,
                        float* xhat, float* stats, size_t stride, size_t base, WideRows wide) {
  constexpr int HT = col_width<H>();
  extern __shared__ float4 smem4[];
  float* bbuf = tc_smem_base(smem4);
  float* act = bbuf + tc_bbuf_floats<HT>();
  float* ring = act + kTileRows * act_ld<HT>();
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  const Save save{xhat, stats, stride, base + row0, nvalid};
  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    if constexpr (H > kColBlock)
      mlp_tile_wide<true, kBf16>(pipe, w, im, load, row0, nvalid, act, ring,
                                 out + row0 * (1 + w.c), 1 + w.c, &save,
                                 wide.pre + blockIdx.x * wide.stride,
                                 wide.nrm + blockIdx.x * wide.stride);
    else
      mlp_tile_tc<H, true, kBf16>(pipe, w, im, load, row0, nvalid, act, ring,
                                  out + row0 * (1 + w.c), 1 + w.c, &save);
  });
}

// The forward alone (K1-fwd, K8-fwd): the tile of fwd_store_tc_kernel,
// nothing saved.  `load` as in fwd_store_tc_kernel.
template <int H, class Load, bool kBf16 = false>
NERF_TC_KERNEL
    fwd_tc_kernel(Weights w, TcImages im, Load load, float* __restrict__ out, int P,
                  WideRows wide) {
  constexpr int HT = col_width<H>();
  extern __shared__ float4 smem4[];
  float* bbuf = tc_smem_base(smem4);
  float* act = bbuf + tc_bbuf_floats<HT>();
  float* ring = act + kTileRows * act_ld<HT>();
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    if constexpr (H > kColBlock)
      mlp_tile_wide<false, kBf16>(pipe, w, im, load, row0, nvalid, act, ring,
                                  out + row0 * (1 + w.c), 1 + w.c, nullptr,
                                  wide.pre + blockIdx.x * wide.stride,
                                  wide.nrm + blockIdx.x * wide.stride);
    else
      mlp_tile_tc<H, false, kBf16>(pipe, w, im, load, row0, nvalid, act, ring,
                                   out + row0 * (1 + w.c), 1 + w.c);
  });
}

// ---------------------------------------------------------------------------
// Pass 2: the backward over the rows of a tile.
// ---------------------------------------------------------------------------

// The input cotangents' products (note 1): the rows of an input slab's
// image are padded to a multiple of kTcInPad, and a pass computes
// tc_in_cols<H>() output columns: its B chunk fits one of the kTcStages
// buffers and its output one activation tile, and each warpgroup's half
// starts on a swizzle atom.
constexpr int kTcInPad = 64;
template <int H>
__host__ __device__ constexpr int tc_in_cols() { return H < kTcInPad ? H : kTcInPad; }
// Floats of an input slab's image: [width rounded up to kTcInPad][H] in hi
// and lo (kBf16: one bf16 array).
template <bool kBf16 = false>
__host__ __device__ inline size_t tc_input_image_floats(int width, int H) {
  return tc_image_floats<kBf16>((width + kTcInPad - 1) / kTcInPad * kTcInPad, H);
}
// The input slabs' images within the backward images (tc_mlp.py::tc_images
// with backward=True): after the `slabs` hidden slabs' images.
template <bool kBf16 = false>
__host__ __device__ inline const float* tc_input_images(const float* bwd, int slabs, int H) {
  return bwd + static_cast<size_t>(slabs) * tc_image_floats<kBf16>(H, H);
}

// act [64][act_ld<H>()] = layer `layer`'s dpre rows of the tile (stored by
// layer_bwd, [L][P][H]), zero past nvalid; 16-byte loads, coalesced.
template <int H>
__device__ __forceinline__ void tc_load_dpre(float* act, const float* dpre, int layer, size_t P,
                                             size_t row0, int nvalid) {
  constexpr int ld = act_ld<H>(), kV = H / 4;
  const float4* src = reinterpret_cast<const float4*>(dpre + (layer * P + row0) * H);
  for (int i = threadIdx.x; i < kTileRows * kV; i += kThreads) {
    const int r = i / kV, c = i - r * kV;
    *reinterpret_cast<float4*>(act + r * ld + 4 * c) =
        r < nvalid ? src[static_cast<size_t>(r) * kV + c] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// input_grad (classic_mlp_train.cuh) on the tensor cores: out [P][n] = the
// tile's dpre_la @ Wa^T (+ dpre_lb @ Wb^T where img_b is not null) for an
// input slab W [n][H] (as stored, [in][out]) through its image (note 1).
// Per pass of tc_in_cols<H>() columns: each dpre is loaded from scratch
// into act, and both products accumulate in one wgmma accumulator; the
// sum goes through act to coalesced stores of the pass's columns below n.
// act and bbuf are the tile's; called by the whole block, which has
// written the dpre rows it reads (its barriers make them visible).  kBf16:
// bf16 images and products.  out is OutT: by default the encodings' dtype
// (bfloat16 under kBf16, as JAX's VJP returns a bf16 input's cotangent);
// K8-bwd takes float32 in both, the cotangent of float32 raw inputs.
template <int H, bool kBf16 = false, class OutT = enc_t<kBf16>, class Pipe>
__device__ void tc_input_grad(Pipe& pipe, float* act, const float* dpre, size_t P, size_t row0,
                              int nvalid, int la, const float* img_a, int lb,
                              const float* img_b, int n, void* __restrict__ out) {
  constexpr bool kC = Pipe::kConsumer;
  constexpr int NT = tc_in_cols<H>(), ld = act_ld<H>();
  const size_t kPass = tc_image_floats<kBf16>(NT, H);  // floats of a pass's image
  float d[NT / 4];
  for (int c0 = 0; c0 < n; c0 += NT) {
    const size_t at = static_cast<size_t>(c0 / NT) * kPass;
    if constexpr (kC) {
      tile_sync();  // act is free: its last readers are done
      tc_load_dpre<H>(act, dpre, la, P, row0, nvalid);
    }
    tc_zero<NT>(d);
    tc_gemm<NT, kBf16>(pipe, d, act, ld, H, img_a + at);  // ends with a barrier
    if (img_b != nullptr) {
      if constexpr (kC) tc_load_dpre<H>(act, dpre, lb, P, row0, nvalid);
      tc_gemm<NT, kBf16>(pipe, d, act, ld, H, img_b + at);
    }
    if constexpr (!kC) continue;
    tc_to_act<NT>(d, act, ld);
    const int cols = min(NT, n - c0);
    for (int i = threadIdx.x; i < nvalid * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const size_t o = (row0 + r) * n + c0 + c;
      if constexpr (std::is_same_v<OutT, __nv_bfloat16>)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(act[r * ld + c]);
      else
        static_cast<float*>(out)[o] = act[r * ld + c];
    }
  }
}

// Bytes of bwd_rows_tc_kernel: the B chunks, the activation tile, the
// colsum scratch (kWarps x H floats: the B chunks' ring prefetches through
// the epilogues, so they are no scratch), the output cotangents [64][1 + c]
// and the alignment slack; past 256 (note 11) the ring that streams dpre in
// place of the colsum scratch.
template <int H>
__host__ inline size_t bwd_rows_tc_smem(const Weights& w) {
  constexpr int HT = col_width<H>();
  return (static_cast<size_t>(tc_bbuf_floats<HT>()) + static_cast<size_t>(kTileRows) * act_ld<HT>() +
          (H > kColBlock ? kEncRingFloats : kWarps * H) + static_cast<size_t>(kTileRows) * (1 + w.c)) *
             sizeof(float) +
         kSmemAlign;
}

// The tile's rows of dpre layer `layer` ([L][P][hp]) from row0.
__device__ __forceinline__ float* dpre_rows(float* dpre, int layer, size_t P, size_t row0, int hp) {
  return dpre + (static_cast<size_t>(layer) * P + row0) * hp;
}

// head_bwd over rows in device memory (note 11): dh [64][hp] (+ where
// accumulate) = gs[:, col0:col0+n] @ W^T for the tile's valid rows, and
// the tile's column sums of h * gs (the head's dW) into part[k * n + q],
// h = xhat * g + beta; kBf16 rounds h, W and gs.  A thread a column, its
// 64 rows in registers (h, then dh), each weight read once; gs's rows past
// nvalid are 0.  Ends with a barrier of the tile's threads.
template <bool kBf16>
__device__ void head_bwd_rows(const float* gs, int ldo, int col0, int n,
                              const float* __restrict__ W, const float* xh,
                              const float* __restrict__ g, const float* __restrict__ beta,
                              int hp, int nvalid, float* part, float* dh, bool accumulate) {
  for (int k = threadIdx.x; k < hp; k += kThreads) {
    const float gk = __ldg(g + k), bk = __ldg(beta + k);
    float v[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      v[r] = r < nvalid ? operand<kBf16>(fmaf(xh[static_cast<size_t>(r) * hp + k], gk, bk)) : 0.f;
    for (int q = 0; q < n; ++q) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) s = fmaf(v[r], operand<kBf16>(gs[r * ldo + col0 + q]), s);
      part[static_cast<size_t>(k) * n + q] = s;
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      v[r] = accumulate && r < nvalid ? dh[static_cast<size_t>(r) * hp + k] : 0.f;
    for (int q = 0; q < n; ++q) {
      const float wq = operand<kBf16>(__ldg(W + static_cast<size_t>(k) * n + q));
#pragma unroll
      for (int r = 0; r < kTileRows; ++r)
        v[r] = fmaf(operand<kBf16>(gs[r * ldo + col0 + q]), wq, v[r]);
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      if (r < nvalid) dh[static_cast<size_t>(r) * hp + k] = v[r];
  }
  tile_sync();
}

// layer_bwd over rows in device memory (note 11): rows [64][hp] holds the
// tile's dL/dh_i (valid rows) on entry and dL/dpre_i on exit, in place;
// the row means over the first h columns, the padded columns' dpre 0, the
// tile's column sums of dpre, dy * xhat and dy to part_b, part_g,
// part_beta (dy = dh, masked on xhat * g + beta > 0 where kLnFirst).
// Called by the whole block after rows is written; ends with a barrier.
template <bool kLnFirst>
__device__ void layer_bwd_wide(float* rows, int i, const float* __restrict__ g,
                               const float* __restrict__ beta, int h, float inv_h, int hp,
                               size_t P, size_t row0, int nvalid, const float* xhat,
                               const float* stats, float* part_b, float* part_g,
                               float* part_beta) {
  const float* xh = xhat + (static_cast<size_t>(i) * P + row0) * hp;
  auto dy = [&](size_t at, float gk, float bk) {
    return kLnFirst && !(fmaf(xh[at], gk, bk) > 0.f) ? 0.f : rows[at];
  };
  for (int k = threadIdx.x; k < hp; k += kThreads) {  // a column each
    const float gk = __ldg(g + k), bk = __ldg(beta + k);
    float sg = 0.f, sb = 0.f;
    for (int r = 0; r < nvalid; ++r) {
      const size_t at = static_cast<size_t>(r) * hp + k;
      const float v = dy(at, gk, bk);
      sb += v;
      sg = fmaf(v, xh[at], sg);
    }
    part_g[static_cast<size_t>(i) * hp + k] = sg;
    part_beta[static_cast<size_t>(i) * hp + k] = sb;
  }
  tile_sync();
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < nvalid; r += kWarps) {  // a warp a row
    const float2 st = reinterpret_cast<const float2*>(stats)[static_cast<size_t>(i) * P + row0 + r];
    const size_t at0 = static_cast<size_t>(r) * hp;
    float m1 = 0.f, m2 = 0.f;
    for (int k = lane; k < h; k += 32) {
      const float dxh = dy(at0 + k, __ldg(g + k), __ldg(beta + k)) * __ldg(g + k);
      m1 += dxh;
      m2 = fmaf(dxh, xh[at0 + k], m2);
    }
    m1 = warp_sum(m1) * inv_h;
    m2 = warp_sum(m2) * inv_h;
    for (int k = lane; k < hp; k += 32) {
      const float x = xh[at0 + k];
      const float dxh = dy(at0 + k, __ldg(g + k), __ldg(beta + k)) * __ldg(g + k);
      rows[at0 + k] = k < h && (kLnFirst || x > st.y) ? st.x * (dxh - m1 - x * m2) : 0.f;
    }
  }
  tile_sync();
  for (int k = threadIdx.x; k < hp; k += kThreads) {
    float sb = 0.f;
    for (int r = 0; r < nvalid; ++r) sb += rows[static_cast<size_t>(r) * hp + k];
    part_b[static_cast<size_t>(i) * hp + k] = sb;
  }
  tile_sync();
}

// dh = dpre_i @ W^T of a wide layer into dst's rows, in column blocks: A
// (the tile's dpre rows of layer i, float32) streams through the ring,
// img the slab's backward image (hp / 256 images of 256 rows).
template <bool kBf16, class Pipe, class W>
__device__ void wide_dh(Pipe& pipe, const W& w, const float* src, float* dst, int hp, int nvalid,
                        const float* img, float* act, float* ring) {
  constexpr int B = kColBlock;
  const RowsLoadT<float> rows{src, hp};
  const EncA<RowsLoadT<float>, W> a{rows, w, 0, 0, nvalid, false, ring};
  const size_t blk = tc_image_floats<kBf16>(B, hp);
  float d[B / 4];
  for (int cb = 0; cb < hp / B; ++cb) {
    tc_zero<B>(d);
    tc_gemm<B, kBf16>(pipe, d, a, hp, img + cb * blk);
    if constexpr (Pipe::kConsumer) wide_store_block<false>(d, act, dst, hp, cb, nullptr, nvalid);
  }
}

// tc_input_grad past 256 (note 11): the dpre rows stream through the ring
// from device memory instead of the activation tile; passes of kTcInPad
// columns.
template <bool kBf16, class OutT, class Pipe, class W>
__device__ void tc_input_grad_wide(Pipe& pipe, const W& w, float* act, float* ring,
                                   const float* dpre, size_t P, size_t row0, int nvalid, int hp,
                                   int la, const float* img_a, int lb, const float* img_b, int n,
                                   void* __restrict__ out) {
  constexpr int NT = kTcInPad, ld = act_ld<kColBlock>();
  const size_t kPass = tc_image_floats<kBf16>(NT, hp);
  auto src = [&](int layer) {
    return RowsLoadT<float>{dpre + (static_cast<size_t>(layer) * P + row0) * hp, hp};
  };
  const RowsLoadT<float> ra = src(la), rb = src(lb < 0 ? la : lb);
  float d[NT / 4];
  for (int c0 = 0; c0 < n; c0 += NT) {
    const size_t at = static_cast<size_t>(c0 / NT) * kPass;
    if constexpr (Pipe::kConsumer) tile_sync();  // act is free: its last readers are done
    tc_zero<NT>(d);
    tc_gemm<NT, kBf16>(pipe, d, EncA<RowsLoadT<float>, W>{ra, w, 0, 0, nvalid, false, ring}, hp,
                       img_a + at);
    if (img_b != nullptr)
      tc_gemm<NT, kBf16>(pipe, d, EncA<RowsLoadT<float>, W>{rb, w, 0, 0, nvalid, false, ring},
                         hp, img_b + at);
    if constexpr (!Pipe::kConsumer) continue;
    tc_to_act<NT>(d, act, ld);
    const int cols = min(NT, n - c0);
    for (int i = threadIdx.x; i < nvalid * cols; i += kThreads) {
      const int r = i / cols, c = i - r * cols;
      const size_t o = (row0 + r) * n + c0 + c;
      if constexpr (std::is_same_v<OutT, __nv_bfloat16>)
        static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(act[r * ld + c]);
      else
        static_cast<float*>(out)[o] = act[r * ld + c];
    }
  }
}

// bwd_rows_tc_kernel past 256 (note 11): each layer's dh goes to the
// tile's rows of its dpre, where layer_bwd_wide turns it into dpre.
template <bool kBf16, class InGradT, class Pipe>
__device__ void bwd_rows_wide(Pipe& pipe, const Weights& w, const float* __restrict__ gout, int P,
                              const float* xhat, const float* stats, const float* __restrict__ bwd,
                              float* dpre, float* tpart, void* dx, void* dd, float* act,
                              float* ring, float* gs) {
  constexpr bool kC = Pipe::kConsumer;
  const int L = num_layers(w), last = L - 1, ldo = 1 + w.c, hp = w.hp;
  const size_t slab = tc_image_floats<kBf16>(hp, hp), PP = static_cast<size_t>(P);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  float* part = tpart + blockIdx.x * tile_floats(w, hp);
  float* p_b = part;
  float* p_g = p_b + L * hp;
  float* p_beta = p_g + L * hp;
  float* p_wdens = p_beta + L * hp;
  float* p_wcol = p_wdens + hp;
  float* p_bdens = p_wcol + static_cast<size_t>(hp) * w.c;
  float* p_bcol = p_bdens + 1;
  auto rows = [&](int layer) { return dpre_rows(dpre, layer, PP, row0, hp); };
  auto xh_of = [&](int layer) { return xhat + (layer * PP + row0) * hp; };

  if constexpr (kC) {
    for (int i = threadIdx.x; i < kTileRows * ldo; i += kThreads)
      gs[i] = i / ldo < nvalid ? gout[row0 * ldo + i] : 0.f;
    tile_sync();
    if (threadIdx.x < ldo) {
      float s = 0.f;
      for (int r = 0; r < kTileRows; ++r) s += gs[r * ldo + threadIdx.x];
      if (threadIdx.x == 0) *p_bdens = s; else p_bcol[threadIdx.x - 1] = s;
    }
    head_bwd_rows<kBf16>(gs, ldo, 1, w.c, w.w_col, xh_of(last), w.g + last * hp,
                         w.beta + last * hp, hp, nvalid, p_wcol, rows(last), false);
    if (w.wd == nullptr)
      head_bwd_rows<kBf16>(gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * hp, w.beta + 7 * hp, hp,
                           nvalid, p_wdens, rows(7), true);
  }
  for (int i = last; i >= 0; --i) {
    if constexpr (kC)
      layer_bwd_wide<false>(rows(i), i, w.g + i * hp, w.beta + i * hp, w.h, w.inv_h, hp, PP,
                            row0, nvalid, xhat, stats, p_b, p_g, p_beta);
    if (i == 0) break;
    wide_dh<kBf16>(pipe, w, rows(i), rows(i - 1), hp, nvalid, bwd + (i - 1) * slab, act, ring);
    if (kC && i == 8)
      head_bwd_rows<kBf16>(gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * hp, w.beta + 7 * hp, hp,
                           nvalid, p_wdens, rows(7), true);
  }
  const float* img_w0 = tc_input_images<kBf16>(bwd, L - 1, hp);
  const float* img_wx = img_w0 + tc_input_image_floats<kBf16>(w.xe, hp);
  const float* img_wd = img_wx + tc_input_image_floats<kBf16>(w.xe, hp);
  if (dx != nullptr)
    tc_input_grad_wide<kBf16, InGradT>(pipe, w, act, ring, dpre, PP, row0, nvalid, hp, 0, img_w0,
                                       4, img_wx, w.xe, dx);
  if (dd != nullptr)
    tc_input_grad_wide<kBf16, InGradT>(pipe, w, act, ring, dpre, PP, row0, nvalid, hp, 8, img_wd,
                                       -1, nullptr, w.de, dd);
}

// bwd is the backward operand images: the hidden slabs' (the packed
// [in][out] slabs, 2 H H floats each), then w0's, wx's and wd's for the
// encodings' cotangents dx [P][xe] and dd [P][de], written when not null.
// kBf16: bf16 images and products, the heads' backward in bf16 (note 10);
// dx and dd are InGradT (tc_input_grad's OutT).
template <int H, bool kBf16 = false, class InGradT = enc_t<kBf16>>
NERF_TC_KERNEL
    bwd_rows_tc_kernel(Weights w, const float* __restrict__ gout, int P, const float* xhat,
                       const float* stats, const float* __restrict__ bwd, float* dpre,
                       float* tpart, void* dx, void* dd) {
  extern __shared__ float4 smem4[];
  constexpr int HT = col_width<H>();
  float* bbuf = tc_smem_base(smem4);       // the B chunks' ring
  float* act = bbuf + tc_bbuf_floats<HT>();  // dpre of the current layer
  if constexpr (H > kColBlock) {
    float* ring = act + kTileRows * act_ld<kColBlock>();
    tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
      bwd_rows_wide<kBf16, InGradT>(pipe, w, gout, P, xhat, stats, bwd, dpre, tpart, dx, dd, act,
                                    ring, ring + kEncRingFloats);
    });
  } else {
  float* red = act + kTileRows * act_ld<H>();  // [kWarps][H] colsum scratch
  float* gs = red + kWarps * H;                // [64][1 + c] output cotangents
  const int L = num_layers(w), last = L - 1, ldo = 1 + w.c;
  const size_t slab = tc_image_floats<kBf16>(H, H), PP = static_cast<size_t>(P);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  float* part = tpart + blockIdx.x * tile_floats(w, H);
  float* p_b = part;
  float* p_g = p_b + L * H;
  float* p_beta = p_g + L * H;
  float* p_wdens = p_beta + L * H;
  float* p_wcol = p_wdens + H;
  float* p_bdens = p_wcol + H * w.c;
  float* p_bcol = p_bdens + 1;
  const float* img_w0 = tc_input_images<kBf16>(bwd, L - 1, H);
  const float* img_wx = img_w0 + tc_input_image_floats<kBf16>(w.xe, H);
  const float* img_wd = img_wx + tc_input_image_floats<kBf16>(w.xe, H);
  auto xh_of = [&](int layer) { return xhat + (layer * PP + row0) * H; };

  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    constexpr bool kC = std::decay_t<decltype(pipe)>::kConsumer;
    float acc[kRowsPerWarp][H / 32];
    float d[H / 4];
    if constexpr (kC) {
      for (int i = threadIdx.x; i < kTileRows * ldo; i += kThreads)
        gs[i] = i / ldo < nvalid ? gout[row0 * ldo + i] : 0.f;
      tile_sync();
      if (threadIdx.x < ldo) {
        float s = 0.f;
        for (int r = 0; r < kTileRows; ++r) s += gs[r * ldo + threadIdx.x];
        if (threadIdx.x == 0) *p_bdens = s; else p_bcol[threadIdx.x - 1] = s;
      }
      zero<H>(acc);
      head_bwd<H, kBf16>(acc, gs, ldo, 1, w.c, w.w_col, xh_of(last), w.g + last * H,
                         w.beta + last * H, nvalid, p_wcol, red);
      if (w.wd == nullptr)
        head_bwd<H, kBf16>(acc, gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * H, w.beta + 7 * H,
                           nvalid, p_wdens, red);
    }
    for (int i = last; i >= 0; --i) {
      if constexpr (kC)
        layer_bwd<H>(acc, i, w.g + i * H, w.beta + i * H, w.h, w.inv_h, PP, row0, nvalid, xhat,
                     stats, dpre, p_b, p_g, p_beta, red);
      if (i == 0) break;
      if constexpr (kC) tc_store_rows<H>(acc, act);
      tc_zero<H>(d);
      tc_gemm<H, kBf16>(pipe, d, act, act_ld<H>(), H, bwd + (i - 1) * slab);
      if constexpr (kC) {
        tc_to_rows<H>(d, act, acc);
        if (i == 8)
          head_bwd<H, kBf16>(acc, gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * H, w.beta + 7 * H,
                             nvalid, p_wdens, red);
      }
    }
    // The encodings' cotangents: dx = dpre_0 @ w0^T + dpre_4 @ wx^T and dd =
    // dpre_8 @ wd^T, from the stored dpre.
    if (dx != nullptr)
      tc_input_grad<H, kBf16, InGradT>(pipe, act, dpre, PP, row0, nvalid, 0, img_w0, 4, img_wx,
                                       w.xe, dx);
    if (dd != nullptr)
      tc_input_grad<H, kBf16, InGradT>(pipe, act, dpre, PP, row0, nvalid, 8, img_wd, -1, nullptr,
                                       w.de, dd);
  });
  }
}

// ---------------------------------------------------------------------------
// Pass 3: dW = h_in^T dpre on the tensor cores.
// ---------------------------------------------------------------------------

// A block of kWgThreads threads owns one 128 x 128 output tile of a product
// over one split of the points (blockIdx.x: the products' tiles, in order,
// so the tiles of one chunk of points run together and share its rows in
// L2; blockIdx.y: the split) and walks the split's chunks of kWgK = 32
// points through two rings in shared memory:
//   * raw: wg_raw_slots() slots, each one chunk's rows as stored (A's, then
//     B's, 16 KB each), copied by the first warp of the staging warpgroups
//     (WgOperand::plan: one TMA box of 32 rows x 128 columns from a tensor
//     map of the chain, one bulk copy of a chunk's contiguous rows, or one
//     bulk copy a point), each completed on its full mbarrier: up to
//     wg_raw_slots() chunks in flight ahead of the transform (3 in float32,
//     6 in bf16);
//   * images: kWgImgSlots = 2 slots of a chunk's operands in the K-major
//     swizzled order wgmma reads from shared memory (TF32: A and B each as
//     hi and lo, rows of 32 values in the 128-byte swizzle, 64 KB; bf16: A
//     and B rounded, rows of 32 values in the 64-byte swizzle, 16 KB),
//     written by the staging warpgroups (ready mbarrier) and released by
//     both consumer warpgroups once the products that read them have
//     retired (free mbarrier).
// The two staging warpgroups transform each chunk, thread (half, r) taking
// row r of A (h = xhat g + beta, relu(h) in the mip order, 0 past M and
// past the split's points) and of B at 16 of the chunk's points: loads from
// the raw slot with a warp's lanes on 32 consecutive columns, all 16 in
// flight, and 16-byte stores into the image with a quarter-warp's lanes on
// eight rows of one swizzle atom, both free of bank conflicts.  They run a
// chunk ahead of the products, so neither the copies nor the transform sit
// between two chunks' products.  The two consumer warpgroups only issue products,
// warpgroup wg its 64 rows of A against all 128 columns of B, with A and B
// both from shared memory (wgmma SS: no fragments in registers, so no
// instruction defines a product's input while products are in flight).
// Each chunk's products go to a fresh accumulator, d0 and d1 in turn;
// after issuing chunk c a warpgroup waits for chunk c - 1's (wgmma_wait1)
// and adds them to the float32 sum acc: two chunks of products in flight
// and the sum in chunk order (the tensor cores add with truncation below
// the accumulator's leading bits, so a sum over thousands of points in one
// accumulator drifts: measured 1e-5 of the largest entry at 1000 points;
// note 7).  No barrier of the whole block runs in the chunk loop.  TF32:
// four k-steps of 8 points a chunk, three products each (hi hi, hi lo, lo
// hi); bf16 (note 10): two k-steps of 16 points, one product each.  The
// operand values, the products of each k-step in this order, the chunks of
// 32 from each split's first point and the sum in chunk order fix the
// gradients' bits: change any of them and the bits change.
constexpr int kWgThreads = 512;  // two consumer and two staging warpgroups
constexpr int kWgStaging = 256;  // the staging warpgroups' threads
constexpr int kWgRawBytes = 2 * kWgK * kWT * 4;  // A's rows, then B's: 32 points x 128 floats each
constexpr int kWgImgSlots = 2;
template <bool kBf16>
__host__ __device__ constexpr int wg_raw_slots() { return kBf16 ? 6 : 3; }
template <bool kBf16>
__host__ __device__ constexpr int wg_img_bytes() {
  return kBf16 ? 2 * kWT * kWgK * 2 : 4 * kWT * kWgK * 4;
}
// 230,400 bytes in either dtype, with the alignment slack: one block an SM.
template <bool kBf16>
__host__ __device__ constexpr size_t wgrad_tc_smem() {
  return static_cast<size_t>(wg_raw_slots<kBf16>()) * kWgRawBytes +
         static_cast<size_t>(kWgImgSlots) * wg_img_bytes<kBf16>() + kSmemAlign;
}
// The registers: 512 threads start at 128; the staging warpgroups drop to
// 56 and the consumers (acc, d0, d1: 192 floats) rise to 200 (2 x 128 x 56
// + 2 x 128 x 200 = 65,536).
constexpr int kWgStagingRegs = 56;
constexpr int kWgConsumerRegs = 200;

// Up to two float32 buffers [rows][cols] whose rows the pass reads through
// TMA tensor maps (boxes of kWgK rows x kWT columns, zero past the
// buffer's edges): the chain's xhat and dpre in the MLP launchers, the two
// operands in tc_product.cu.
struct WgMaps {
  CUtensorMap map[2];
  const float* base[2];
  long long rows[2];
  int cols[2];
  int n;
};

// Appends a map of base [rows][cols] to m where TMA can read it (16-byte
// aligned base and rows); otherwise the pass copies those rows another way.
inline cudaError_t wg_add_map(WgMaps& m, const float* base, long long rows, int cols) {
  if (m.n == 2 || reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols % 4 != 0 || rows < 1)
    return cudaSuccess;
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(float)};
  const cuuint32_t box[2] = {kWT, kWgK}, steps[2] = {1, 1};
  if (encode(&m.map[m.n], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base), dims,
             strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) !=
      CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  m.base[m.n] = base;
  m.rows[m.n] = rows;
  m.cols[m.n] = cols;
  ++m.n;
  return cudaSuccess;
}

// How a chunk of one operand reaches shared memory (WgOperand::plan; the
// copier warp and the transform compute the same, tc_mlp.py::wgrad_copies
// mirrors it):
//   kWgChunk: the tile spans the rows and the chunk's rows row(p0) ..
//     row(p0 + valid - 1) are contiguous (a row a point, or a ray's row
//     for its points), their start and bytes 16-byte aligned: one bulk
//     copy, slot row row(p) - row0, ld elements apart;
//   kWgTma: the operand lies in a mapped buffer (the chain past 128
//     columns): one TMA box, slot row p - p0, kWT floats apart;
//   kWgRows: every row start and the tile's width 16-byte aligned: one bulk
//     copy of the tile's columns a point, slot row p - p0, kWT apart;
//   kWgDirect: none of these (a bf16 encoding of 36 values, 72 bytes a
//     row, read per ray; a float32 one of 702; a chunk whose bytes are no
//     multiple of 16): no copy, the transform reads device memory.
enum WgMode : int { kWgChunk = 0, kWgTma = 1, kWgRows = 2, kWgDirect = 3 };
struct WgCopy {
  int mode;
  int ld;          // elements between two slot rows
  uint32_t bytes;  // bytes the chunk's copies bring
  int row0;        // kWgChunk: the first row copied; kWgTma: the box's first row
};

__device__ __forceinline__ void tma_copy_2d(uint32_t dst, const CUtensorMap* map, int col, int row,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// One operand of a block's product: the tile's columns col0 .. col0 + width
// - 1 of rows ld elements apart, es bytes an element; point p reads row p,
// or WProd's per-ray row; map >= 0: its rows are rows map_row .. of mapped
// buffer `map`.
struct WgOperand {
  const char* base;
  int es, ld, col0, width, div, split, div2;
  int map, map_row;

  __device__ int row(int p) const {
    if (div == 1) return p;  // no division on the common path
    return split > 0 && p >= split ? (p - split) / div2 : p / div;
  }
  // The copy plan of the chunk of `valid` points from p0.
  __device__ WgCopy plan(int p0, int valid) const {
    const bool base16 = reinterpret_cast<uintptr_t>(base) % 16 == 0;
    const size_t row_bytes = static_cast<size_t>(ld) * es;
    const int last = p0 + valid - 1;
    const bool straddle = div != 1 && split > 0 && p0 < split && last >= split;
    if (base16 && !straddle && col0 == 0 && width == ld) {
      const int r0 = row(p0);
      const size_t bytes = static_cast<size_t>(row(last) - r0 + 1) * row_bytes;
      if (r0 * row_bytes % 16 == 0 && bytes % 16 == 0)
        return {kWgChunk, ld, static_cast<uint32_t>(bytes), r0};
    }
    if (map >= 0) return {kWgTma, kWT, static_cast<uint32_t>(kWgK * kWT * 4), map_row + p0};
    if (base16 && row_bytes % 16 == 0 && col0 * es % 16 == 0 && width * es % 16 == 0)
      return {kWgRows, kWT, static_cast<uint32_t>(valid * width * es), 0};
    return {kWgDirect, kWT, 0u, 0};
  }
  // The copier warp's copies of the chunk into dst, completed on bar.
  __device__ void copy(const WgCopy& cp, const WgMaps& maps, int p0, int valid, char* dst,
                       uint32_t bar, int lane) const {
    if (cp.mode == kWgChunk) {
      if (lane == 0)
        bulk_copy(smem_u32(dst), base + static_cast<size_t>(cp.row0) * ld * es, cp.bytes, bar);
    } else if (cp.mode == kWgTma) {
      if (lane == 0) tma_copy_2d(smem_u32(dst), &maps.map[map], col0, cp.row0, bar);
    } else if (cp.mode == kWgRows && lane < valid) {  // lane: the point (kWgK = 32)
      bulk_copy(smem_u32(dst + lane * kWT * es),
                base + (static_cast<size_t>(row(p0 + lane)) * ld + col0) * es, width * es, bar);
    }
  }
};

// Column r of an operand at the kN points pl0 .. of the chunk as floats
// (bf16 widened exactly) on the plans whose rows are not a fixed stride
// apart: kWgChunk with rows per ray (point pl at slot element rows[pl] +
// r) and kWgDirect (device memory: point pl's row rows[pl], or p0 + pl
// where rows is null).  rows: the copier warp's table for the chunk
// (wg_rows), so no point's row is divided out here.
template <int kN, bool kVolatile>
__device__ __forceinline__ void wg_listed(const WgOperand& op, const WgCopy& cp, const char* slot,
                                          const int* rows, int p0, int valid, int pl0, int r,
                                          bool ok, float (&v)[kN]) {
  // Past the valid points (rows not written for this chunk) and past the
  // tile's width, the reads stay in bounds: the slot's first element, the
  // operand's first.  kVolatile (float32, whose transform has fewer spare
  // registers): each value's address is formed and loaded in turn, the
  // loads volatile so the compiler does not hoist them together; bf16 lets
  // it overlap them.
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const bool in = ok && pl0 + k < valid;
    uint32_t bits;
    if (cp.mode == kWgChunk) {
      const int e = in ? rows[pl0 + k] + r : 0;
      if constexpr (kVolatile) {
        const uint32_t at = smem_u32(slot) + static_cast<uint32_t>(e * op.es);
        if (op.es == 2)
          asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(bits) : "r"(at));
        else
          asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(bits) : "r"(at));
      } else {
        bits = op.es == 2 ? reinterpret_cast<const uint16_t*>(slot)[e]
                          : reinterpret_cast<const uint32_t*>(slot)[e];
      }
    } else {
      const int row = rows != nullptr ? rows[pl0 + k] : p0 + pl0 + k;
      const size_t e = in ? static_cast<size_t>(row) * op.ld + op.col0 + r : 0;
      const char* at = op.base + e * op.es;
      if constexpr (kVolatile) {
        if (op.es == 2)
          asm volatile("ld.global.nc.u16 %0, [%1];\n" : "=r"(bits) : "l"(at));
        else
          asm volatile("ld.global.nc.b32 %0, [%1];\n" : "=r"(bits) : "l"(at));
      } else {
        bits = op.es == 2 ? __ldg(reinterpret_cast<const unsigned short*>(at))
                          : __ldg(reinterpret_cast<const unsigned int*>(at));
      }
    }
    v[k] = __uint_as_float(op.es == 2 ? bits << 16 : bits);
  }
}

// Group e of row r of an operand's image: TF32 (kG = 4 points), the hi
// array at im and the lo array kWT x kWgK floats after it, 16-byte group e
// of row r at e ^ (r % 8) (128-byte swizzle), word j point 4 e + j; bf16 (kG
// = 8), one array, group e at e ^ ((r / 2) % 4) (64-byte swizzle), word j
// points 8 e + 2 j and + 1.
template <bool kBf16, int kG>
__device__ __forceinline__ void wg_store(char* im, int r, int e, const float (&v)[kG]) {
  if constexpr (kBf16) {
    uint32_t* row = reinterpret_cast<uint32_t*>(im) + r * (kWgK / 2);
    *reinterpret_cast<uint4*>(row + ((e ^ ((r >> 1) & 3)) << 2)) =
        make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]), pack_bf16x2(v[4], v[5]),
                   pack_bf16x2(v[6], v[7]));
  } else {
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split_tf32(v[j], hi[j], lo[j]);
    float* at = reinterpret_cast<float*>(im) + r * kWgK + ((e ^ (r & 7)) << 2);
    *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(at + kWT * kWgK) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A block's operands and A's rebuild, written once by its first thread and
// read from shared memory where needed, so the staging warpgroups (56
// registers a thread) hold none of them.
struct WgBlock {
  WgOperand a, b;
  const float* g;  // A's LayerNorm scale and bias at the tile's rows (nullptr: a raw encoding)
  const float* beta;
  int relu;        // the mip order: relu(xhat g + beta)
};

// This thread's half of the points (16 (half) .. + 15) of row r of one
// operand of the chunk in the raw slot, copied by plan cp, into the image
// im: A rebuilt (kA: h = xhat g + beta, relu in the mip order, 0 past M and
// past the valid points), B as stored.  The 16 loads are issued before any
// value is used.
template <bool kBf16, bool kA, bool kRelu = false>
__device__ __forceinline__ void wg_transform_operand(const WgOperand& op, const WgCopy& cp,
                                                     const int* rows, int p0, int valid,
                                                     const char* slot, char* im, int r, int half,
                                                     bool ok, float g, float beta) {
  constexpr int kG = kBf16 ? 8 : 4;  // points of a 16-byte group of the image
  constexpr int kN = kWgK / 2;       // this thread's points
  const int pl0 = kN * half;
  float v[kN];
  const int es = op.es, ld = cp.ld;
  if (cp.mode == kWgTma || (cp.mode == kWgRows && es == 4)) {  // rows kWT floats apart
    const float* s = reinterpret_cast<const float*>(slot) + pl0 * kWT + r;
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = s[k * kWT];
  } else if (cp.mode == kWgRows) {  // the same, bf16
    const uint16_t* s = reinterpret_cast<const uint16_t*>(slot) + pl0 * kWT + r;
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = __uint_as_float(static_cast<uint32_t>(s[k * kWT]) << 16);
  } else if (cp.mode == kWgChunk && op.div == 1 && es == 4) {  // a row a point, ld apart
    const float* s = reinterpret_cast<const float*>(slot) + pl0 * ld + r;
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = s[k * ld];
  } else if (cp.mode == kWgChunk && op.div == 1) {  // the same, bf16
    const uint16_t* s = reinterpret_cast<const uint16_t*>(slot) + pl0 * ld + r;
#pragma unroll
    for (int k = 0; k < kN; ++k) v[k] = __uint_as_float(static_cast<uint32_t>(s[k * ld]) << 16);
  } else {
    wg_listed<kN, !kBf16>(op, cp, slot, op.div == 1 ? nullptr : rows, p0, valid, pl0, r, ok, v);
  }
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const bool in = ok && pl0 + k < valid;
    if constexpr (kA) {
      const float h = in ? fmaf(v[k], g, beta) : 0.f;
      v[k] = kRelu ? fmaxf(h, 0.f) : h;
    } else {
      v[k] = in ? v[k] : 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < kN / kG; ++i) {
    float w[kG];
#pragma unroll
    for (int j = 0; j < kG; ++j) w[j] = v[kG * i + j];
    wg_store<kBf16, kG>(im, r, pl0 / kG + i, w);
  }
}

// The named barrier of the staging warpgroups (tile_sync is barrier 1).
__device__ __forceinline__ void wg_staging_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(kWgStaging) : "memory");
}

// The operand of a product as the pass reads it, with its mapped buffer.
__device__ __forceinline__ WgOperand wg_operand(const WgMaps& maps, const void* p, int es, int ld,
                                                int col0, int size, int div, int split,
                                                int div2) {
  WgOperand op{static_cast<const char*>(p), es, ld, col0, min(kWT, size - col0), div, split, div2,
               -1, 0};
  for (int i = 0; i < maps.n; ++i) {
    const long long off = static_cast<long long>(reinterpret_cast<uintptr_t>(p)) -
                          static_cast<long long>(reinterpret_cast<uintptr_t>(maps.base[i]));
    const long long row_bytes = 4ll * ld;
    if (es == 4 && div == 1 && ld == maps.cols[i] && off >= 0 && off % row_bytes == 0 &&
        off / row_bytes < maps.rows[i]) {
      op.map = i;
      op.map_row = static_cast<int>(off / row_bytes);
    }
  }
  return op;
}

template <bool kBf16 = false>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgrad_tc_kernel(const __grid_constant__ WgMaps maps, WProds prods, int P, int k_chunk,
                    float* __restrict__ wpart, size_t wfloats) {
  constexpr int kRawSlots = wg_raw_slots<kBf16>();
  constexpr int kImgBytes = wg_img_bytes<kBf16>();
  constexpr int kImgSlots = kWgImgSlots;
  extern __shared__ float4 smem4[];
  // [kRawSlots][A, B][kWgK][kWT], 1024-byte aligned: an offset from the
  // shared array (not an integer cast), so the compiler keeps its accesses
  // 32-bit shared ones.
  char* raw = reinterpret_cast<char*>(smem4);
  raw += (kSmemAlign - (smem_u32(raw) & (kSmemAlign - 1))) & (kSmemAlign - 1);
  char* img = raw + kRawSlots * kWgRawBytes;                  // [kImgSlots][image]
  __shared__ __align__(8) uint64_t bars[kRawSlots + 2 * kImgSlots];
  const uint32_t b0 = smem_u32(bars);
  auto wg_full = [&](int s) { return b0 + 8 * s; };                // raw slot s landed
  auto wg_ready = [&](int s) { return b0 + 8 * (kRawSlots + s); };  // image s written
  auto wg_free = [&](int s) { return b0 + 8 * (kRawSlots + kImgSlots + s); };  // image s read

  int t = blockIdx.x, pi = 0;
  while (t >= prods.p[pi].tiles_m * prods.p[pi].tiles_n) {
    t -= prods.p[pi].tiles_m * prods.p[pi].tiles_n;
    ++pi;
  }
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(P, k_begin + k_chunk);
  const int chunks = max(0, (k_end - k_begin + kWgK - 1) / kWgK);
  __shared__ WgBlock blk;
  __shared__ int rows[kRawSlots][kWgK];  // A's per-ray rows of the chunks in the raw slots
  __shared__ WgCopy plans[kRawSlots][2];  // the copy plans of the chunks in the raw slots

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRawSlots; ++s) mbar_init(wg_full(s), 1);
    for (int s = 0; s < kImgSlots; ++s) {
      mbar_init(wg_ready(s), 1);
      mbar_init(wg_free(s), 2 * 4);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const WProd pr = prods.p[pi];
    const int m0 = (t / pr.tiles_n) * kWT, n0 = (t % pr.tiles_n) * kWT;
    blk.a = wg_operand(maps, pr.a, kBf16 && pr.a_bf16 ? 2 : 4, pr.a_ld, m0, pr.M, pr.div,
                       pr.split, pr.div2);
    blk.b = wg_operand(maps, pr.b, 4, pr.n, n0, pr.n, 1, 0, 1);
    blk.g = pr.g == nullptr ? nullptr : pr.g + m0;
    blk.beta = pr.g == nullptr ? nullptr : pr.beta + m0;
    blk.relu = pr.relu;
  }
  __syncthreads();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The staging warpgroups: the first warp copies chunk c into raw slot c %
  // kRawSlots, kRawSlots chunks ahead; all eight warps transform each chunk
  // into image slot c % kImgSlots once both consumer warpgroups have
  // retired the products that last read it, thread s taking row s % 128 of
  // A and of B at points 16 (s / 128) .. + 15.
  if (__shfl_sync(kFull, tid >> 8, 0) == 1) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kWgStagingRegs));
    const int st = tid - kWgStaging, r = st & (kWT - 1), half = st >> 7;
    const bool copier = st < 32;
    auto wg_copy = [&](int c) {  // chunk c into its slot, by the copier warp
      const int slot = c % kRawSlots;
      const int p0 = k_begin + c * kWgK, valid = min(kWgK, k_end - p0);
      const WgCopy ca = blk.a.plan(p0, valid), cb = blk.b.plan(p0, valid);
      // The plans and A's per-ray rows (wg_listed), for the transform, before
      // the barrier's arrival.
      if (blk.a.div != 1 && lane < valid) {
        const int row = blk.a.row(p0 + lane);
        rows[slot][lane] = ca.mode == kWgChunk ? (row - ca.row0) * blk.a.ld : row;
      }
      __syncwarp();
      if (lane == 0) {
        plans[slot][0] = ca;
        plans[slot][1] = cb;
        mbar_expect_tx(wg_full(slot), ca.bytes + cb.bytes);
      }
      __syncwarp();
      char* dst = raw + slot * kWgRawBytes;
      blk.a.copy(ca, maps, p0, valid, dst, wg_full(slot), lane);
      blk.b.copy(cb, maps, p0, valid, dst + kWgRawBytes / 2, wg_full(slot), lane);
    };
    const bool a_ok = r < blk.a.width, b_ok = r < blk.b.width;
    // Chunk c from raw slot rs into image slot is.
    auto wg_transform = [&](int c, int rs, int is) {
      const int p0 = k_begin + c * kWgK, valid = min(kWgK, k_end - p0);
      const char* slot = raw + rs * kWgRawBytes;
      char* im = img + is * kImgBytes;
      // A's LayerNorm scale and bias at row r, read again each chunk (L1
      // hits; volatile, so no register holds them across the loop).
      float ga = 1.f, ba = 0.f;
      if (a_ok && blk.g != nullptr) {
        asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(ga) : "l"(blk.g + r));
        asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(ba) : "l"(blk.beta + r));
      }
      if (blk.relu)
        wg_transform_operand<kBf16, true, true>(blk.a, plans[rs][0], rows[rs], p0, valid, slot,
                                                im, r, half, a_ok, ga, ba);
      else
        wg_transform_operand<kBf16, true>(blk.a, plans[rs][0], rows[rs], p0, valid, slot, im, r,
                                          half, a_ok, ga, ba);
      wg_transform_operand<kBf16, false>(blk.b, plans[rs][1], nullptr, p0, valid,
                                         slot + kWgRawBytes / 2, im + kImgBytes / 2, r, half,
                                         b_ok, 1.f, 0.f);
    };
    if (copier)
      for (int c = 0; c < min(chunks, kRawSlots); ++c) wg_copy(c);
    for (int c = 0; c < chunks; ++c) {
      const int rs = c % kRawSlots, is = c % kImgSlots;
      mbar_wait(wg_full(rs), (c / kRawSlots) & 1);
      mbar_wait(wg_free(is), ((c / kImgSlots) & 1) ^ 1);  // the first round passes
      wg_transform(c, rs, is);
      fence_async_smem();  // the image's stores before the products read them
      wg_staging_sync();   // every row written; raw slot rs read
      if (st == 0) mbar_arrive(wg_ready(is));
      if (copier && c + kRawSlots < chunks) wg_copy(c + kRawSlots);
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kWgConsumerRegs));

  // The consumers: warpgroup wg's 64 rows of A (the image's rows 64 wg ..)
  // against all 128 columns of B, chunk after chunk.
  const int wg = tid >> 7;
  auto wg_issue = [&](int is, float (&d)[64]) {  // image slot is into d, cleared first
    // The descriptors of A's and B's first arrays; the others lie whole
    // arrays (kWT x kWgK values) and k-steps (32 bytes) from them.
    const char* im = img + is * kImgBytes;
    constexpr int kArr = kWT * kWgK * (kBf16 ? 2 : 4) / 16;  // an array, in 16-byte units
    if constexpr (kBf16) {
      const uint64_t a = smem_desc_sw64(reinterpret_cast<const float*>(im) + wg * 64 * (kWgK / 2));
      const uint64_t b = smem_desc_sw64(reinterpret_cast<const float*>(im + kImgBytes / 2));
      wgmma_fence();
      wgmma_ss_bf16<0, 0>(d, a, b, 0);
      wgmma_ss_bf16<2, 2>(d, a, b, 1);
      wgmma_commit();
    } else {
      const uint64_t a = smem_desc_sw128(reinterpret_cast<const float*>(im) + wg * 64 * kWgK);
      const uint64_t b = smem_desc_sw128(reinterpret_cast<const float*>(im + kImgBytes / 2));
      wgmma_fence();
      // k-step s: hi hi, hi lo, lo hi (lo: the next array).
      wgmma_ss<0, 0>(d, a, b, 0);
      wgmma_ss<0, kArr>(d, a, b, 1);
      wgmma_ss<kArr, 0>(d, a, b, 1);
      wgmma_ss<2, 2>(d, a, b, 1);
      wgmma_ss<2, kArr + 2>(d, a, b, 1);
      wgmma_ss<kArr + 2, 2>(d, a, b, 1);
      wgmma_ss<4, 4>(d, a, b, 1);
      wgmma_ss<4, kArr + 4>(d, a, b, 1);
      wgmma_ss<kArr + 4, 4>(d, a, b, 1);
      wgmma_ss<6, 6>(d, a, b, 1);
      wgmma_ss<6, kArr + 6>(d, a, b, 1);
      wgmma_ss<kArr + 6, 6>(d, a, b, 1);
      wgmma_commit();
    }
  };
  float acc[64], d0[64], d1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = d0[i] = d1[i] = 0.f;
  // Chunk c into d once staged; chunk c - 1's products (in dprev) retire,
  // release their image slot and join the sum.
  auto body = [&](int c, float (&d)[64], float (&dprev)[64]) {
    const int is = c % kImgSlots;
    mbar_wait(wg_ready(is), (c / kImgSlots) & 1);
    wg_issue(is, d);
    wgmma_wait1();
    fence_regs(dprev);
    mbar_arrive_lane0(wg_free((c + kImgSlots - 1) % kImgSlots), static_cast<uint32_t>(c == 0));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += dprev[i];
  };
  // Pairs of chunks, so that d0 and d1 are named at compile time.
  int c = 0;
  for (; c + 1 < chunks; c += 2) {
    body(c, d0, d1);
    body(c + 1, d1, d0);
  }
  if (c < chunks) {
    body(c, d0, d1);
    wgmma_wait0();
    fence_regs(d0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d0[i];
  } else {
    wgmma_wait0();
    fence_regs(d1);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += d1[i];  // 0 where no chunk ran
  }

  const WProd pr = prods.p[pi];
  const int N = pr.n, m0 = blk.a.col0, n0 = blk.b.col0;
  const int g = lane >> 2, q = lane & 3, ar = 64 * wg + 16 * (warp & 3) + g;
  float* out = wpart + blockIdx.y * wfloats + pr.out_off;
#pragma unroll
  for (int hrow = 0; hrow < 2; ++hrow) {
    const int m = m0 + ar + 8 * hrow;
    if (m >= pr.M) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = n0 + 8 * j + 2 * q;
      float* at = out + static_cast<size_t>(m) * N + n;
      if (N % 2 == 0) {  // a pair of columns, 8-byte aligned
        if (n < N) *reinterpret_cast<float2*>(at) = make_float2(acc[4 * j + 2 * hrow],
                                                                acc[4 * j + 2 * hrow + 1]);
      } else {  // an odd N (a head as wide as its outputs): each column alone
        if (n < N) at[0] = acc[4 * j + 2 * hrow];
        if (n + 1 < N) at[1] = acc[4 * j + 2 * hrow + 1];
      }
    }
  }
}

// The forward alone over P rows (K1-fwd, K8-fwd): fwd_tc_kernel on the
// forward images tc_fwd.
// wide: past 256 (note 11) the scratch of 2 x 64 x hp floats a tile
// (wide_rows), else unused.
template <int H, class Load, bool kBf16 = false>
cudaError_t launch_fwd(const Weights& w, const Load& load, float* out, int P,
                       const float* tc_fwd, float* wide, cudaStream_t stream) {
  if (tc_fwd == nullptr || (H > kColBlock && wide == nullptr)) return cudaErrorInvalidValue;
  constexpr size_t smem = tc_tile_bytes<col_width<H>()>();
  cudaError_t err = cudaFuncSetAttribute(fwd_tc_kernel<H, Load, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (P + kTileRows - 1) / kTileRows;
  fwd_tc_kernel<H, Load, kBf16><<<blocks, kTcThreads, smem, stream>>>(
      w, TcImages::forward<kBf16>(w, tc_fwd, w.hp), load, out, P, wide_rows(wide, w.hp));
  return cudaGetLastError();
}

// Pass 3 over `splits` splits of P points (wgrad_k_chunk's k_chunk each),
// the partials to wpart [splits][wfloats].
template <bool kBf16>
cudaError_t launch_wgrad(const WgMaps& maps, const WProds& prods, int total_tiles, int P,
                         int k_chunk, int splits, float* wpart, size_t wfloats,
                         cudaStream_t stream) {
  constexpr size_t smem = wgrad_tc_smem<kBf16>();
  cudaError_t err = cudaFuncSetAttribute(wgrad_tc_kernel<kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  wgrad_tc_kernel<kBf16><<<dim3(total_tiles, splits), kWgThreads, smem, stream>>>(
      maps, prods, P, k_chunk, wpart, wfloats);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The policy.
// ---------------------------------------------------------------------------

// The tensor-core passes for launch_fwd_store_with and launch_mlp_backward:
// the Scratch's tc_fwd and tc_bwd hold the call's operand images (tc_bwd
// with the input slabs' images, which bwd_rows reads where the encodings'
// cotangents dx, dd are asked for).  kBf16: compute_dtype bfloat16 (note
// 10): bf16 images, encodings, products and heads.  InGradT: the type of
// the encodings' cotangents dx, dd (the encodings' own by default; K8-bwd's
// are float32 in both dtypes).
template <bool kBf16_ = false, class InGradT = enc_t<kBf16_>>
struct TcProductsT {
  static constexpr bool kBf16 = kBf16_;

  template <int H, class Load>
  static cudaError_t fwd_store(const Weights& w, const Load& load, float* out, int P,
                               const Scratch& s, cudaStream_t stream, size_t stride,
                               size_t base) {
    if (s.tc_fwd == nullptr) return cudaErrorInvalidValue;
    constexpr size_t smem = tc_tile_bytes<col_width<H>()>();
    cudaError_t err = cudaFuncSetAttribute(fwd_store_tc_kernel<H, Load, kBf16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int tiles = (P + kTileRows - 1) / kTileRows;
    // Past 256 the tiles keep their rows in dpre (layers 0 and 1 of the
    // chain's rows), which bwd_rows writes only later.
    const size_t hp = w.hp;
    const WideRows wide{s.dpre + base * hp, s.dpre + (stride + base) * hp, kTileRows * hp};
    fwd_store_tc_kernel<H, Load, kBf16><<<tiles, kTcThreads, smem, stream>>>(
        w, TcImages::forward<kBf16>(w, s.tc_fwd, w.hp), load, out, P, s.xhat, s.stats, stride,
        base, wide);
    return cudaGetLastError();
  }

  template <int H>
  static cudaError_t bwd_rows(const Weights& w, const float* gout, int P, const Scratch& s,
                              void* dx, void* dd, cudaStream_t stream) {
    if (s.tc_bwd == nullptr) return cudaErrorInvalidValue;
    const size_t smem = bwd_rows_tc_smem<H>(w);
    cudaError_t err =
        cudaFuncSetAttribute(bwd_rows_tc_kernel<H, kBf16, InGradT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int tiles = (P + kTileRows - 1) / kTileRows;
    bwd_rows_tc_kernel<H, kBf16, InGradT><<<tiles, kTcThreads, smem, stream>>>(
        w, gout, P, s.xhat, s.stats, s.tc_bwd, s.dpre, s.tpart, dx, dd);
    return cudaGetLastError();
  }

  // The chain's xhat and dpre hold chain_rows rows of chain_cols floats
  // each (the launchers' L x P rows of the padded width): the pass reads
  // the products' rows that lie in them through tensor maps (WgMaps).
  static cudaError_t wgrad(const WProds& prods, int total_tiles, int P, int k_chunk,
                           const Scratch& s, size_t wfloats, cudaStream_t stream,
                           long long chain_rows = 0, int chain_cols = 0) {
    WgMaps maps{};
    cudaError_t err = cudaSuccess;
    if (chain_rows > 0 && (err = wg_add_map(maps, s.xhat, chain_rows, chain_cols)) == cudaSuccess)
      err = wg_add_map(maps, s.dpre, chain_rows, chain_cols);
    if (err != cudaSuccess) return err;
    return launch_wgrad<kBf16>(maps, prods, total_tiles, P, k_chunk, s.splits, s.wpart, wfloats,
                               stream);
  }
};
using TcProducts = TcProductsT<false>;
using TcProductsBf16 = TcProductsT<true>;

}  // namespace nerf_mlp
