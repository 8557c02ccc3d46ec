// Device code of the classic NeRF point MLP, shared by the K1 forward
// kernel (classic_mlp_fwd.cu) and the K4 fine-stage union kernel
// (union_eval.cu).
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
// (two-pass mean and variance, like torch's).  The activations live in ONE
// shared-memory buffer [64][H]: a warp only ever reads the rows it writes,
// and it overwrites them after the block-wide barrier that ends the
// product, so no ping-pong copy is needed.  Weights, packed (in, out)
// row-major, stream through a 16-row shared-memory buffer (16 x H x 4
// bytes) in stages of 8 rows, double-buffered: cp.async copies the next
// stage while the block multiplies the current one, one barrier a stage.
// That hides the L2 latency of the weights where one block runs per SM
// (the training backward); with two blocks per SM (the forward kernels)
// the other block already hid it.  All of the weights (about 2.5 MB at
// H = 256) stay resident in L2, so the kernel's device-memory traffic is
// its inputs and outputs.  Each product
// step reads a float4 of four k-values of a row (one broadcast per warp)
// and one weight per column (32 consecutive floats per warp, no bank
// conflicts), then runs 8 x (H/32) x 4 fp32 FMAs.  Plain fp32 FMA, no TF32:
// the bound is the card's fp32 rate.
#pragma once

#include <cuda_runtime.h>

namespace nerf_mlp {

constexpr int kTileRows = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = kTileRows / kWarps;
constexpr int kChunk = 16;  // weight rows the staging buffer holds
constexpr int kStage = kChunk / 2;  // rows per double-buffered stage of gemm_acc
constexpr float kLnEps = 1e-5f;
constexpr unsigned kFull = 0xffffffffu;

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
};

__host__ __device__ inline int round_up4(int n) { return (n + 3) & ~3; }

// Floats of shared memory the MLP tile uses besides the activation buffer:
// the weight chunk and the zero-padded x / d input tiles.
template <int H>
__host__ inline size_t mlp_side_floats(int xe, int de) {
  return static_cast<size_t>(kChunk) * H +
         static_cast<size_t>(kTileRows) * (round_up4(xe) + round_up4(de));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// dst[r][k] = src[(row0 + r) / div][k] for r < nvalid and k < width, else 0;
// dst rows are round_up4(width) floats.  div > 1 broadcasts per-ray rows
// to that ray's samples.
__device__ inline void load_tile(float* dst, const float* __restrict__ src,
                                 size_t row0, int nvalid, int width, int div) {
  const int ld = round_up4(width);
  for (int i = threadIdx.x; i < kTileRows * ld; i += kThreads) {
    const int r = i / ld, k = i % ld;
    dst[i] = (r < nvalid && k < width)
                 ? __ldg(src + ((row0 + r) / div) * width + k)
                 : 0.f;
  }
}

// acc += A[rows of this warp, k0:k0+kc4] @ wbuf[0:kc4, 0:H], wbuf the
// staged weight chunk with row stride WLD.
template <int H, int WLD>
__device__ __forceinline__ void chunk_fma(float (&acc)[kRowsPerWarp][H / 32],
                                          const float* a_rows, int lda, int k0, int kc4,
                                          const float* wbuf) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31;
  for (int kk = 0; kk < kc4; kk += 4) {
    float4 a[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
      a[r] = *reinterpret_cast<const float4*>(a_rows + r * lda + k0 + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float w[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) w[j] = wbuf[(kk + q) * WLD + lane + 32 * j];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float av = q == 0 ? a[r].x : q == 1 ? a[r].y : q == 2 ? a[r].z : a[r].w;
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(av, w[j], acc[r][j]);
      }
    }
  }
}

// 16 bytes global -> shared without a register (cp.async, L2 only); with
// valid false the 16 bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(float4* dst, const float4* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}

// acc += A[rows of this warp, 0:K] @ W[0:K, 0:H].  A is shared memory with
// row stride lda (a multiple of 4, columns K..round_up4(K) zero); W is
// global, row-major [K, H], 16-byte aligned.  wbuf holds kChunk x H floats:
// two stages of kStage rows.  Ends with a block-wide barrier.
template <int H>
__device__ __forceinline__ void gemm_acc(float (&acc)[kRowsPerWarp][H / 32],
                                         const float* A, int lda, int K,
                                         const float* __restrict__ W,
                                         float* wbuf) {
  constexpr int kVec = kStage * H / 4;  // float4s per stage
  const int tid = threadIdx.x;
  const float* a_rows = A + (tid >> 5) * kRowsPerWarp * lda;
  const int stages = (K + kStage - 1) / kStage;
  auto copy_stage = [&](int st) {  // stage st -> half st & 1 of wbuf
    float4* dst = reinterpret_cast<float4*>(wbuf) + (st & 1) * kVec;
    for (int i = tid; i < kVec; i += kThreads) {
      const int k = st * kStage + i / (H / 4);
      const bool ok = k < K;
      cp_async16(dst + i,
                 reinterpret_cast<const float4*>(W + static_cast<size_t>(ok ? k : 0) * H) +
                     i % (H / 4),
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  copy_stage(0);
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    // Stage st has landed for every thread, and every warp is done with
    // stage st - 1, whose half the next copy overwrites.
    __syncthreads();
    if (st + 1 < stages) copy_stage(st + 1);
    const int k0 = st * kStage;
    chunk_fma<H, H>(acc, a_rows, lda, k0, round_up4(min(kStage, K - k0)),
                    wbuf + (st & 1) * kStage * H);
  }
  __syncthreads();
}

// Floats of the staged chunk of a transposed product (gemm_acc_t): rows
// padded to H + 1 so the transposing stores do not collide in one bank.
template <int H>
__host__ __device__ constexpr int chunk_t_floats() { return kChunk * (H + 1); }

// acc[:, j] += A[rows of this warp, 0:H] @ W[j, 0:H]^T for j < ncols (the
// other columns get 0): the product with the transpose of a weight slab W,
// row-major [ncols, H] (a forward layer's [in, out] weight read as
// [out -> in]).  A is shared memory with row stride lda; wbuf holds
// chunk_t_floats<H>() floats.  Ends with a block-wide barrier.
template <int H>
__device__ __forceinline__ void gemm_acc_t(float (&acc)[kRowsPerWarp][H / 32],
                                           const float* A, int lda,
                                           const float* __restrict__ W, int ncols,
                                           float* wbuf) {
  const int tid = threadIdx.x;
  const float* a_rows = A + (tid >> 5) * kRowsPerWarp * lda;
  for (int k0 = 0; k0 < H; k0 += kChunk) {
    for (int i = tid; i < kChunk * H; i += kThreads) {
      const int j = i / kChunk, kk = i % kChunk;
      wbuf[kk * (H + 1) + j] = j < ncols ? __ldg(W + static_cast<size_t>(j) * H + k0 + kk) : 0.f;
    }
    __syncthreads();
    chunk_fma<H, H + 1>(acc, a_rows, lda, k0, kChunk, wbuf);
    __syncthreads();
  }
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

// acc <- LayerNorm(relu(acc + b)) * g + beta, row by row, in registers.
// With kSave, also writes layer `layer`'s xhat and statistics to save.
template <int H, bool kSave = false>
__device__ __forceinline__ void bias_relu_ln(float (&acc)[kRowsPerWarp][H / 32],
                                             const float* __restrict__ b,
                                             const float* __restrict__ g,
                                             const float* __restrict__ beta,
                                             const Save* save = nullptr, int layer = 0) {
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
      acc[r][j] = fmaxf(acc[r][j] + bj[j], 0.f);
      s += acc[r][j];
    }
    const float mu = warp_sum(s) * (1.0f / H);
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float dv = acc[r][j] - mu;
      q = fmaf(dv, dv, q);
    }
    const float inv = rsqrtf(warp_sum(q) * (1.0f / H) + kLnEps);
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
    for (int j = 0; j < kCols; ++j) acc[r][j] = (acc[r][j] - mu) * inv * gj[j] + betaj[j];
  }
}

template <int H>
__device__ __forceinline__ void store_rows(const float (&acc)[kRowsPerWarp][H / 32], float* act) {
  const int lane = threadIdx.x & 31;
  float* rows = act + (threadIdx.x >> 5) * kRowsPerWarp * H;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < H / 32; ++j) rows[r * H + lane + 32 * j] = acc[r][j];
}

// out[row * ld + col0 + i] = h[row] . W[:, i] + bias[i] for i < n and the
// tile's rows below nvalid; W is row-major [H, n].
template <int H>
__device__ __forceinline__ void head(const float (&h)[kRowsPerWarp][H / 32],
                                     const float* __restrict__ W,
                                     const float* __restrict__ bias, int n,
                                     float* out, int ld, int col0, int nvalid) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = 0; i < n; ++i) {
    float wj[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) wj[j] = __ldg(W + (lane + 32 * j) * n + i);
    const float bi = __ldg(bias + i);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) s = fmaf(h[r][j], wj[j], s);
      s = warp_sum(s);
      const int row = warp * kRowsPerWarp + r;
      if (lane == 0 && row < nvalid) out[row * ld + col0 + i] = s + bi;
    }
  }
}

// The whole network on one 64-row tile whose inputs are already in shared
// memory (xs, ds; see load_tile).  Writes [density, color...] rows to out
// (global or shared memory, row stride ld).  act is the [64][H] activation
// buffer, wbuf the [kChunk][H] weight chunk.  With kSave every layer's
// xhat and statistics go to save (the training kernels' backward input).
template <int H, bool kSave = false>
__device__ void mlp_tile(const Weights& w, const float* xs, const float* ds,
                         float* act, float* wbuf, float* out, int ld, int nvalid,
                         const Save* save = nullptr) {
  const int xld = round_up4(w.xe), dld = round_up4(w.de);
  const size_t hh = static_cast<size_t>(H) * H;
  float acc[kRowsPerWarp][H / 32];

  zero<H>(acc);
  gemm_acc<H>(acc, xs, xld, w.xe, w.w0, wbuf);
  bias_relu_ln<H, kSave>(acc, w.b, w.g, w.beta, save, 0);
  store_rows<H>(acc, act);
  for (int i = 1; i < 8; ++i) {
    zero<H>(acc);
    gemm_acc<H>(acc, act, H, H, w.whh + (i - 1) * hh, wbuf);
    if (i == 4) gemm_acc<H>(acc, xs, xld, w.xe, w.wx, wbuf);
    bias_relu_ln<H, kSave>(acc, w.b + i * H, w.g + i * H, w.beta + i * H, save, i);
    store_rows<H>(acc, act);
  }
  head<H>(acc, w.w_dens, w.b_dens, 1, out, ld, 0, nvalid);
  if (w.wd != nullptr) {
    for (int i = 8; i < 10; ++i) {
      zero<H>(acc);
      gemm_acc<H>(acc, act, H, H, w.whh + (i - 1) * hh, wbuf);
      if (i == 8) gemm_acc<H>(acc, ds, dld, w.de, w.wd, wbuf);
      bias_relu_ln<H, kSave>(acc, w.b + i * H, w.g + i * H, w.beta + i * H, save, i);
      if (i == 8) store_rows<H>(acc, act);
    }
  }
  head<H>(acc, w.w_col, w.b_col, w.c, out, ld, 1, nvalid);
}

// Dispatch a templated launcher on the hidden width; returns
// cudaErrorInvalidValue for a width without an instantiation.
#define NERF_DISPATCH_HIDDEN(hidden, LAUNCH)        \
  switch (hidden) {                                 \
    case 32: return LAUNCH(32);                     \
    case 64: return LAUNCH(64);                     \
    case 128: return LAUNCH(128);                   \
    case 256: return LAUNCH(256);                   \
    default: return cudaErrorInvalidValue;          \
  }

}  // namespace nerf_mlp
