// Device code of the classic NeRF point MLP: the row-per-warp layout, the
// layers' epilogues and the heads that the tensor-core tiles of every
// classic kernel run (tc_mlp.cuh's mlp_tile_tc; the mip tile's too,
// mip_mlp.cuh).
//
// The network (nerf_tpu_torch/models/mlp.py): ten layers of
// Linear -> ReLU -> LayerNorm(eps 1e-5),
//   L0  x_enc -> H, L1..L3 H -> H,
//   L4  [h, x_enc] -> H (the skip, run as a second product into the same
//       accumulators), L5..L7 H -> H, density head off L7,
//   L8  [h, d_enc] -> H (the view branch, again a second product),
//   L9  H -> H, color head.
// Without the view branch (wd == nullptr) the color head reads L7.
//
// Design.  A block of 256 threads (8 warps) owns a tile of 64 rows.  Warp w
// owns rows 8w..8w+7 for the whole network: each lane holds an 8 x (H/32)
// register sub-tile of the layer output (columns lane + 32 j), so a row's
// H values sit in one warp and LayerNorm is a warp reduction in registers
// (two-pass mean and variance, like torch's).  The products themselves run
// on the tensor cores (tc_mlp.cuh), their accumulators brought into this
// layout through the activation tile.
//
// compute_dtype="bfloat16" (kBf16, the JAX package's _dot with a bf16
// dtype): every product's operands, the heads' included, are rounded to
// bfloat16 (round to nearest even) and multiplied and summed in float32.
// The LayerNorms, biases and everything else stay float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace nerf_mlp {

constexpr int kTileRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

// The barrier of a tile's kThreads threads (named barrier 1): in a
// tensor-core tile's block they are its consumers, beside a producer warp
// that never waits here (tc_mlp.cuh note 2); elsewhere they are the block.
__device__ __forceinline__ void tile_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory"); }

struct Weights {
  const float* w0;      // [xe, H]
  const float* wx;      // [xe, H], skip tail of block_1.0
  const float* wd;      // [de, H], view tail of block_2.0; nullptr: no view branch
  const float* whh;     // [n_hh, H, H]: L1..L3, head of L4, L5..L7, head of L8, L9
  const float* b;       // [n_layers, H] Linear biases
  const float* g;       // [n_layers, H] LayerNorm scales
  const float* beta;    // [n_layers, H] LayerNorm biases
  const float* w_dens;  // [H]
  const float* b_dens;  // [1]
  const float* w_col;   // [H, c]
  const float* b_col;   // [c]
  int xe, de, c;
  // The model's hidden width h, the width hp the slabs are padded to
  // (padded_hidden), 1 / h and hp - h, set by sized() on the host (kernel
  // parameters the epilogues read as operands; a division in the kernel
  // would call its slow path between the wgmma pipelines).  Every slab is
  // packed at hp with zeros past h (note 11 of tc_mlp.cuh).
  int h = 0, hp = 0;
  float inv_h = 0.f, padded = 0.f;
};

// Hidden widths: the tiles are instantiated at 32, 64, 128 and 256 (one
// row-per-warp column per lane and 32 columns), and a model's width h
// runs the smallest of them that holds it, on weights zero-padded to it,
// with the LayerNorm statistics over the first h columns (layer_epilogue,
// layer_bwd).  Past 256 the width pads to a multiple of kColBlock and runs
// in column blocks (the template width kWideH, tc_mlp.cuh note 11).
constexpr int kColBlock = 256;
constexpr int kWideH = 2 * kColBlock;
__host__ __device__ constexpr int tile_width(int hidden) {
  return hidden <= 32 ? 32 : hidden <= 64 ? 64 : hidden <= 128 ? 128 : hidden <= kColBlock ? kColBlock : kWideH;
}
__host__ __device__ inline int padded_hidden(int hidden) {
  return hidden <= kColBlock ? tile_width(hidden) : (hidden + kColBlock - 1) / kColBlock * kColBlock;
}
// The tile width a template width H runs at: H, or kColBlock for kWideH.
template <int H>
__host__ __device__ constexpr int col_width() { return H > kColBlock ? kColBlock : H; }

// A copy of w with the hidden width h, its padded width and 1 / h.
template <class W>
__host__ inline W sized(W w, int hidden) {
  w.h = hidden;
  w.hp = padded_hidden(hidden);
  w.inv_h = 1.0f / static_cast<float>(hidden);
  w.padded = static_cast<float>(w.hp - hidden);
  return w;
}

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// A product's operand under compute_dtype: as is (float32), or rounded to
// bfloat16 and widened back (exact in float32).
template <bool kBf16>
__device__ __forceinline__ float operand(float x) {
  if constexpr (kBf16)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// The encodings' type in device memory under compute_dtype.
template <bool kBf16>
using enc_t = std::conditional_t<kBf16, __nv_bfloat16, float>;

// One encoding value from global memory as float32 (bfloat16 widened
// exactly: its bits are the top half of the float's).
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// dst[r][k] = src[(row0 + r) / div][k] for r < nvalid and k < width, else 0;
// dst rows are round_up4(width) floats.  div > 1 broadcasts per-ray rows
// to that ray's samples.  src is float32 or bfloat16.
template <class T>
__device__ inline void load_tile(float* dst, const T* __restrict__ src,
                                 size_t row0, int nvalid, int width, int div) {
  const int ld = round_up4(width);
  for (int i = threadIdx.x; i < kTileRows * ld; i += kThreads) {
    const int r = i / ld, k = i % ld;
    dst[i] = (r < nvalid && k < width)
                 ? ldg_f32(src + ((row0 + r) / div) * width + k)
                 : 0.f;
  }
}

// 16 bytes global -> shared without a register (cp.async, L2 only); with
// valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

template <int H>
__device__ __forceinline__ void zero(float (&acc)[kRowsPerWarp][H / 32]) {
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < H / 32; ++j) acc[r][j] = 0.f;
}

// Where the training kernels keep a tile's forward for the backward: the
// normalised LayerNorm input xhat of every layer, [layers][P][H], and the
// per-row (1/sigma, -mu/sigma), [layers][P][2].  The ReLU mask of the
// backward is xhat > -mu/sigma.
struct Save {
  float* xhat;
  float* stats;
  size_t P;     // rows of the whole call
  size_t row0;  // first row of this tile
  int nvalid;   // valid rows of this tile
};

// A layer's epilogue, row by row, in registers: acc <- LayerNorm(relu(acc
// + b)) * g + beta (the classic order) or, with kLnFirst, relu(LayerNorm(acc
// + b) * g + beta) (the mip order), the statistics over the first h
// columns (the model's width; inv_h = 1 / h): the `padded` = H - h
// columns past it are padding, exactly 0 before the LayerNorm (their
// weights and bias are 0) and after it (their g and beta are 0).  So the
// sum needs no mask, and the two-pass variance takes out the padded mu^2
// the zeros added to it (at an instantiated width it subtracts 0: the
// arithmetic of a plain two-pass variance, no per-column mask).  With
// kSave, also writes layer `layer`'s xhat (the normalised LayerNorm
// input) and statistics to save.
template <int H, bool kSave = false, bool kLnFirst = false>
__device__ __forceinline__ void layer_epilogue(float (&acc)[kRowsPerWarp][H / 32],
                                             const float* __restrict__ b,
                                             const float* __restrict__ g,
                                             const float* __restrict__ beta, float inv_h,
                                             float padded, const Save* save = nullptr,
                                             int layer = 0) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31;
  float bj[kCols], gj[kCols], betaj[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    bj[j] = __ldg(b + lane + 32 * j);
    gj[j] = __ldg(g + lane + 32 * j);
    betaj[j] = __ldg(beta + lane + 32 * j);
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      acc[r][j] = kLnFirst ? acc[r][j] + bj[j] : fmaxf(acc[r][j] + bj[j], 0.f);
      s += acc[r][j];
    }
    const float mu = warp_sum(s) * inv_h;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float dv = acc[r][j] - mu;
      q = fmaf(dv, dv, q);
    }
    const float var = fmaxf(warp_sum(q) - padded * mu * mu, 0.f) * inv_h;
    const float inv = rsqrtf(var + kLnEps);
    if constexpr (kSave) {
      const int row = (threadIdx.x >> 5) * kRowsPerWarp + r;
      if (row < save->nvalid) {
        const size_t at = static_cast<size_t>(layer) * save->P + save->row0 + row;
        float* xh = save->xhat + at * H;
#pragma unroll
        for (int j = 0; j < kCols; ++j) xh[lane + 32 * j] = (acc[r][j] - mu) * inv;
        if (lane == 0) {
          save->stats[2 * at] = inv;
          save->stats[2 * at + 1] = (0.f - mu) * inv;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float y = (acc[r][j] - mu) * inv * gj[j] + betaj[j];
      acc[r][j] = kLnFirst ? fmaxf(y, 0.f) : y;
    }
  }
}

// out[row * ld + col0 + i] = h[row] . W[:, i] + bias[i] for i < n and the
// tile's rows below nvalid; W is row-major [H, n].  kBf16: h and W rounded
// to bfloat16 (the JAX package's _dot on the heads).
template <int H, bool kBf16 = false>
__device__ __forceinline__ void head(const float (&h)[kRowsPerWarp][H / 32],
                                     const float* __restrict__ W,
                                     const float* __restrict__ bias, int n,
                                     float* out, int ld, int col0, int nvalid) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < n; ++i) {
    float wj[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) wj[j] = operand<kBf16>(__ldg(W + (lane + 32 * j) * n + i));
    const float bi = __ldg(bias + i);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) s = fmaf(operand<kBf16>(h[r][j]), wj[j], s);
      s = warp_sum(s);
      const int row = warp * kRowsPerWarp + r;
      if (lane == 0 && row < nvalid) out[row * ld + col0 + i] = s + bi;
    }
  }
}

// Dispatch a templated launcher on the hidden width: the tile width that
// holds it (tile_width), kWideH past 256; cudaErrorInvalidValue for a
// width below 1.
#define NERF_DISPATCH_HIDDEN(hidden, LAUNCH)        \
  if ((hidden) < 1) return cudaErrorInvalidValue;   \
  switch (tile_width(hidden)) {                     \
    case 32: return LAUNCH(32);                     \
    case 64: return LAUNCH(64);                     \
    case 128: return LAUNCH(128);                   \
    case 256: return LAUNCH(256);                   \
    default: return LAUNCH(kWideH);                 \
  }

}  // namespace nerf_mlp
