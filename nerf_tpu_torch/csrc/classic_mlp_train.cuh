// Device code of the classic NeRF MLP's backward, shared by the K1 backward
// (classic_mlp_bwd.cu), the coarse-only train kernel K2 (train_grads.cu)
// and the fine-stage train kernel K3 (fine_stage_train.cu).
//
// The TPU kernels keep a tile's whole activation chain in VMEM and carry
// the weight gradients in one VMEM block across a grid that runs in order.
// An SM has 227 KB of shared memory (one 64-row tile's chain is 640 KB at
// H = 256) and its blocks run in parallel, so the backward is four passes
// over global memory, each written by hand:
//
//   1. fwd_store: the forward (classic_mlp.cuh, 64-row tiles) that also
//      stores every layer's normalised LayerNorm input xhat, [L][P][H], and
//      the per-row (1/sigma, -mu/sigma), [L][P][2].  Storing costs 2 x L x H
//      x 4 bytes per row of HBM traffic (2.7 GB at 131,072 rows, about
//      0.8 ms at 3.35 TB/s) against about 5 ms of the operations bound, so
//      the backward does not recompute the chain once more.
//   2. bwd_rows: per 64-row tile, from the output cotangents down through
//      the layers: the LayerNorm and ReLU backward in registers (warp
//      reductions over a row, as the forward), dh = dpre @ W^T as the
//      forward's product (gemm_acc) on the hidden slabs transposed once per
//      call (transpose_slabs_kernel, 2.4 MB), every layer's dpre stored to
//      [L][P][H], and the tile's column sums (db, dg, dbeta, the two heads)
//      written to its own row of a per-tile partials buffer.  Optionally
//      the input cotangents dx, dd (gemm_acc_t transposes while staging).
//   3. wgrad: dW = h_in^T dpre for every weight slab, a float32 product
//      over the points written by hand: 128 x 128 output tiles, 8 x 8 per
//      thread, double-buffered staging, the points split into S chunks,
//      each chunk's tile written to its own partials slab.
//   4. colsum: the partials summed in a fixed order (two stages), so the
//      gradients are the same from run to run (no atomics).
//
// The flat gradient the passes produce is the packed weights' order
// (ops/kernels/classic_mlp.py): w0, wx, wd, whh | b, g, beta, w_dens,
// w_col, b_dens, b_col.
#pragma once

#include "classic_mlp.cuh"

namespace nerf_mlp {

constexpr int kMaxColors = 8;
constexpr int kColsumGroups = 64;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ inline int num_layers(const Weights& w) { return w.wd ? 10 : 8; }

// Floats of the weight-slab part (w0, wx, wd, whh) of the flat gradient.
__host__ inline size_t wgrad_floats(const Weights& w, int H) {
  return static_cast<size_t>(2 * w.xe + w.de) * H +
         static_cast<size_t>(num_layers(w) - 1) * H * H;
}

// Floats of one tile's partials: b, g, beta [L][H], w_dens [H], w_col
// [H][c], b_dens, b_col [c].
__host__ __device__ inline size_t tile_floats(const Weights& w, int H) {
  return static_cast<size_t>(3 * num_layers(w)) * H + H + static_cast<size_t>(H) * w.c + 1 +
         w.c;
}

struct Scratch {
  float* xhat;   // [L][P][H]
  float* stats;  // [L][P][2]
  float* dpre;   // [L][P][H]
  float* wpart;  // [splits][wgrad_floats]
  float* tpart;  // [tiles][tile_floats]
  float* tmp;    // [kColsumGroups][max(wgrad_floats, tile_floats)]
  float* wt;     // [L - 1][H][H]: the hidden slabs whh, each transposed
  int splits;
};

// out[s][j][k] = in[s][k][j] for the [H][H] slabs s (H a multiple of 32).
__global__ void transpose_slabs_kernel(const float* __restrict__ in, int H,
                                       float* __restrict__ out) {
  __shared__ float t[32][33];
  const size_t slab = static_cast<size_t>(blockIdx.z) * H * H;
  const int k0 = blockIdx.y * 32, j0 = blockIdx.x * 32;
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    t[r][threadIdx.x] = in[slab + static_cast<size_t>(k0 + r) * H + j0 + threadIdx.x];
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += blockDim.y)
    out[slab + static_cast<size_t>(j0 + r) * H + k0 + threadIdx.x] = t[threadIdx.x][r];
}

// ---------------------------------------------------------------------------
// 1. Forward that stores the chain.
// ---------------------------------------------------------------------------

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    fwd_store_kernel(Weights w, const float* __restrict__ x, const float* __restrict__ d,
                     int d_div, float* __restrict__ out, int P, float* xhat, float* stats) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* wbuf = act + kTileRows * H;
  float* xs = wbuf + kChunk * H;
  float* ds = xs + kTileRows * round_up4(w.xe);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  load_tile(xs, x, row0, nvalid, w.xe, 1);
  if (w.wd != nullptr) load_tile(ds, d, row0, nvalid, w.de, d_div);
  __syncthreads();
  const Save save{xhat, stats, static_cast<size_t>(P), row0, nvalid};
  mlp_tile<H, true>(w, xs, ds, act, wbuf, out + row0 * (1 + w.c), 1 + w.c, nvalid, &save);
}

// ---------------------------------------------------------------------------
// 2. Backward over the rows of a tile.
// ---------------------------------------------------------------------------

// out[j * stride] = sum over the tile's rows of the values whose in-lane
// partial sums (over this warp's rows) are s[j], for columns lane + 32 j.
// red holds kWarps * H floats.  Called by the whole block.
template <int H>
__device__ void tile_colsum(const float (&s)[H / 32], float* red, float* out, int stride = 1) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < H / 32; ++j) red[warp * H + lane + 32 * j] = s[j];
  __syncthreads();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t += red[v * H + j];
    out[static_cast<size_t>(j) * stride] = t;
  }
  __syncthreads();
}

// A linear head out[:, col0:col0+n] = h @ W + bias (W row-major [H, n]) on
// the layer output h = xhat * g + beta (xh points at the layer's row row0;
// rows past nvalid count as 0).  Backward: acc += gs[:, col0:col0+n] @
// W^T, and the tile's column sums of h[r][j] * gs[r][col0 + q] into
// part[j * n + q] (the head's dW).
template <int H>
__device__ void head_bwd(float (&acc)[kRowsPerWarp][H / 32], const float* gs, int ldo,
                         int col0, int n, const float* __restrict__ W, const float* xh,
                         const float* __restrict__ g, const float* __restrict__ beta,
                         int nvalid, float* part, float* red) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // This warp's rows of h, loaded once for all n outputs (rows past nvalid
  // hold 0; their gs is 0 too).
  float h[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      h[r][j] = row < nvalid ? xh[static_cast<size_t>(row) * H + lane + 32 * j] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const float gj = __ldg(g + lane + 32 * j), bj = __ldg(beta + lane + 32 * j);
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) h[r][j] = fmaf(h[r][j], gj, bj);
  }
  for (int q = 0; q < n; ++q) {
    float wq[kCols], s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      wq[j] = __ldg(W + (lane + 32 * j) * n + q);
      s[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float gv = gs[(warp * kRowsPerWarp + r) * ldo + col0 + q];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[r][j] = fmaf(gv, wq[j], acc[r][j]);
        s[j] = fmaf(h[r][j], gv, s[j]);
      }
    }
    tile_colsum<H>(s, red, part + q, n);
  }
}

// Layer i's LayerNorm and ReLU backward: acc holds dL/dh_i on entry and
// dL/dpre_i on exit (also stored to dpre [L][P][H]); the tile's column
// sums of dpre, dh * xhat and dh go to part_b, part_g, part_beta.
template <int H>
__device__ void layer_bwd(float (&acc)[kRowsPerWarp][H / 32], int i, const Weights& w,
                          size_t P, size_t row0, int nvalid, const float* xhat,
                          const float* stats, float* dpre, float* part_b, float* part_g,
                          float* part_beta, float* red) {
  constexpr int kCols = H / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // All of this warp's loads (xhat rows and statistics) are issued before
  // the first use, so their latencies overlap.
  float xh[kRowsPerWarp][kCols];
  float2 st[kRowsPerWarp];  // (1/sigma, -mu/sigma)
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const bool valid = row < nvalid;
    const size_t at = static_cast<size_t>(i) * P + row0 + row;
    st[r] = valid ? reinterpret_cast<const float2*>(stats)[at] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) xh[r][j] = valid ? xhat[at * H + lane + 32 * j] : 0.f;
  }
  float gj[kCols], s_b[kCols], s_g[kCols], s_beta[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    gj[j] = __ldg(w.g + i * H + lane + 32 * j);
    s_b[j] = s_g[j] = s_beta[j] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const size_t at = static_cast<size_t>(i) * P + row0 + row;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      s_beta[j] += acc[r][j];
      s_g[j] = fmaf(acc[r][j], xh[r][j], s_g[j]);
      const float dxh = acc[r][j] * gj[j];
      m1 += dxh;
      m2 = fmaf(dxh, xh[r][j], m2);
      acc[r][j] = dxh;
    }
    m1 = warp_sum(m1) * (1.0f / H);
    m2 = warp_sum(m2) * (1.0f / H);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float dp =
          xh[r][j] > st[r].y ? st[r].x * (acc[r][j] - m1 - xh[r][j] * m2) : 0.f;
      acc[r][j] = dp;
      s_b[j] += dp;
      if (row < nvalid) dpre[at * H + lane + 32 * j] = dp;
    }
  }
  tile_colsum<H>(s_b, red, part_b + i * H);
  tile_colsum<H>(s_g, red, part_g + i * H);
  tile_colsum<H>(s_beta, red, part_beta + i * H);
}

// acc[:, m] for m < n - col0 (this warp's rows) -> out[row * n + col0 + m].
template <int H>
__device__ __forceinline__ void store_cols(const float (&acc)[kRowsPerWarp][H / 32], float* out,
                                           size_t row0, int n, int col0, int nvalid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    if (row >= nvalid) continue;
#pragma unroll
    for (int j = 0; j < H / 32; ++j) {
      const int m = col0 + lane + 32 * j;
      if (m < n) out[(row0 + row) * n + m] = acc[r][j];
    }
  }
}

// This warp's rows of layer `layer`'s dpre (stored by layer_bwd) -> act.
template <int H>
__device__ __forceinline__ void load_dpre_rows(float* act, const float* dpre, int layer,
                                               size_t P, size_t row0, int nvalid) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    for (int j = lane; j < H; j += 32)
      act[row * H + j] = row < nvalid ? dpre[(layer * P + row0 + row) * H + j] : 0.f;
  }
  __syncwarp();
}

// out [P][n] = sum over the given layers' dpre @ W^T, W row-major [n, H]
// (an encoding's slab of the forward): the input cotangent of an
// encoding, computed in column blocks of H (n may exceed H).
template <int H>
__device__ void input_grad(float (&acc)[kRowsPerWarp][H / 32], float* act, float* wbuf,
                           const float* dpre, size_t P, size_t row0, int nvalid, int la,
                           const float* wa, int lb, const float* wb, int n, float* out) {
  for (int c0 = 0; c0 < n; c0 += H) {
    zero<H>(acc);
    load_dpre_rows<H>(act, dpre, la, P, row0, nvalid);
    gemm_acc_t<H>(acc, act, H, wa + static_cast<size_t>(c0) * H, n - c0, wbuf);
    if (wb != nullptr) {
      load_dpre_rows<H>(act, dpre, lb, P, row0, nvalid);
      gemm_acc_t<H>(acc, act, H, wb + static_cast<size_t>(c0) * H, n - c0, wbuf);
    }
    store_cols<H>(acc, out, row0, n, c0, nvalid);
  }
}

template <int H>
__host__ inline size_t bwd_rows_smem(const Weights& w) {
  return (static_cast<size_t>(kTileRows) * H + chunk_t_floats<H>() +
          static_cast<size_t>(kTileRows) * (1 + w.c)) *
         sizeof(float);
}

// One block per 64-row tile.  gout [P][1 + c] holds dL/d(density, color
// logits) per row; wt the hidden slabs transposed; dx [P][xe] and dd
// [P][de] are written when not null.  The registers are not capped at 128
// (one block per SM at H = 256): the LayerNorm backward keeps a warp's
// rows of xhat in registers beside the accumulators, and a cap spills
// them.
template <int H>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_rows_kernel(Weights w, const float* __restrict__ gout, int P, const float* xhat,
                    const float* stats, const float* __restrict__ wt, float* dpre,
                    float* tpart, float* dx, float* dd) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // dpre of the current layer
  float* wbuf = act + kTileRows * H;             // weight chunk, or colsum scratch
  float* gs = wbuf + chunk_t_floats<H>();        // [64][1 + c] output cotangents
  const int L = num_layers(w), last = L - 1, ldo = 1 + w.c;
  const size_t hh = static_cast<size_t>(H) * H, PP = static_cast<size_t>(P);
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

  for (int i = threadIdx.x; i < kTileRows * ldo; i += kThreads)
    gs[i] = i / ldo < nvalid ? gout[row0 * ldo + i] : 0.f;
  __syncthreads();
  if (threadIdx.x < ldo) {
    float s = 0.f;
    for (int r = 0; r < kTileRows; ++r) s += gs[r * ldo + threadIdx.x];
    if (threadIdx.x == 0) *p_bdens = s; else p_bcol[threadIdx.x - 1] = s;
  }

  float acc[kRowsPerWarp][H / 32];
  zero<H>(acc);
  auto xh_of = [&](int layer) { return xhat + (layer * PP + row0) * H; };
  // The color head reads the last layer; without the view branch the
  // density head joins there too.
  head_bwd<H>(acc, gs, ldo, 1, w.c, w.w_col, xh_of(last), w.g + last * H, w.beta + last * H,
              nvalid, p_wcol, wbuf);
  if (w.wd == nullptr)
    head_bwd<H>(acc, gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * H, w.beta + 7 * H, nvalid,
                p_wdens, wbuf);
  for (int i = last; i >= 0; --i) {
    layer_bwd<H>(acc, i, w, PP, row0, nvalid, xhat, stats, dpre, p_b, p_g, p_beta, wbuf);
    if (i == 0) break;
    store_rows<H>(acc, act);
    __syncthreads();
    zero<H>(acc);
    gemm_acc<H>(acc, act, H, H, wt + (i - 1) * hh, wbuf);
    if (i == 8)
      head_bwd<H>(acc, gs, ldo, 0, 1, w.w_dens, xh_of(7), w.g + 7 * H, w.beta + 7 * H,
                  nvalid, p_wdens, wbuf);
  }
  // The encodings' cotangents: dx = dpre_0 @ w0^T + dpre_4 @ wx^T and
  // dd = dpre_8 @ wd^T, from the stored dpre (each warp reloads its rows).
  __syncthreads();
  if (dx != nullptr)
    input_grad<H>(acc, act, wbuf, dpre, PP, row0, nvalid, 0, w.w0, 4, w.wx, w.xe, dx);
  if (dd != nullptr)
    input_grad<H>(acc, act, wbuf, dpre, PP, row0, nvalid, 8, w.wd, 0, nullptr, w.de, dd);
}

// ---------------------------------------------------------------------------
// 3. Weight gradients: dW = h_in^T dpre, summed over a chunk of points.
// ---------------------------------------------------------------------------

constexpr int kWT = 128;  // output tile edge
constexpr int kWK = 16;   // points per staged step
constexpr int kMaxProds = 12;

// One weight slab's product.  The left operand is the raw encoding a
// ([rows / div][a_ld], g == nullptr) or a layer's output rebuilt from its
// xhat ([P][H], h = xhat * g + beta); the right one is dpre of layer
// out_layer.  The result [M][N] goes to out_off of the flat gradient.
struct WProd {
  const float* a;
  const float* g;
  const float* beta;
  int a_ld, M, div, out_layer;
  size_t out_off;
  int tiles_m, tiles_n;
};

struct WProds {
  WProd p[kMaxProds];
  int n;
};

// A block of 256 threads owns one 128 x 128 output tile over one chunk of
// points; thread (ty, tx) holds rows ty*4 + {0..3, 64..67} and columns
// tx*4 + {0..3, 64..67} (so the float4 reads of a staged row fall on
// consecutive addresses, free of bank conflicts).  The staging is double
// buffered: the next step's operands are fetched into registers while the
// current step's products run.  At most 128 registers, two blocks per SM.
__global__ void __launch_bounds__(256, 2)
    wgrad_kernel(WProds prods, const float* __restrict__ dpre, int P, int N, int k_chunk,
                 float* __restrict__ wpart, size_t wfloats) {
  constexpr int kSteps = kWK * kWT / 256;  // staged values per thread and operand
  __shared__ float4 As4[2][kWK * kWT / 4];
  __shared__ float4 Bs4[2][kWK * kWT / 4];
  int t = blockIdx.x, pi = 0;
  while (t >= prods.p[pi].tiles_m * prods.p[pi].tiles_n) {
    t -= prods.p[pi].tiles_m * prods.p[pi].tiles_n;
    ++pi;
  }
  const WProd pr = prods.p[pi];
  const int m0 = (t / pr.tiles_n) * kWT, n0 = (t % pr.tiles_n) * kWT;
  const int k_begin = blockIdx.y * k_chunk;
  const int k_end = min(P, k_begin + k_chunk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // The staging thread's column (fixed) and first point row (kk0 + 2 e).
  const int sm = tid % kWT, kk0 = tid / kWT;
  const bool a_ok = m0 + sm < pr.M, b_ok = n0 + sm < N;
  const float ga = a_ok && pr.g != nullptr ? __ldg(pr.g + m0 + sm) : 1.f;
  const float ba = a_ok && pr.g != nullptr ? __ldg(pr.beta + m0 + sm) : 0.f;
  const float* A = pr.a + m0 + sm;
  const float* B = dpre + static_cast<size_t>(pr.out_layer) * P * N + n0 + sm;

  float ra[kSteps], rb[kSteps];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int e = 0; e < kSteps; ++e) {
      const int p = k0 + kk0 + 2 * e;
      const bool in_k = p < k_end;
      const int row = pr.div == 1 ? p : p / pr.div;  // no division on the common path
      ra[e] = in_k && a_ok ? fmaf(A[static_cast<size_t>(row) * pr.a_ld], ga, ba) : 0.f;
      rb[e] = in_k && b_ok ? B[static_cast<size_t>(p) * N] : 0.f;
    }
  };
  auto stage = [&](int buf) {
    float* as = reinterpret_cast<float*>(As4[buf]);
    float* bs = reinterpret_cast<float*>(Bs4[buf]);
#pragma unroll
    for (int e = 0; e < kSteps; ++e) {
      as[tid + 256 * e] = ra[e];
      bs[tid + 256 * e] = rb[e];
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  fetch(k_begin);
  stage(0);
  __syncthreads();
  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kWK) {
    const bool more = k0 + kWK < k_end;
    if (more) fetch(k0 + kWK);
#pragma unroll
    for (int kk = 0; kk < kWK; ++kk) {
      const float4* arow = As4[buf] + kk * (kWT / 4);
      const float4* brow = Bs4[buf] + kk * (kWT / 4);
      const float4 a0 = arow[ty], a1 = arow[16 + ty], b0 = brow[tx], b1 = brow[16 + tx];
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    // The other buffer was last read before the previous barrier.
    if (more) stage(buf ^ 1);
    __syncthreads();
    buf ^= 1;
  }
  float* out = wpart + blockIdx.y * wfloats + pr.out_off;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (m >= pr.M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. Fixed-order sums of partials.
// ---------------------------------------------------------------------------

// out[g][i] = sum of in[t][i] over the g-th of `groups` equal runs of t.
__global__ void colsum_kernel(const float* __restrict__ in, int T, size_t F, int groups,
                              float* __restrict__ out) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= F) return;
  const int g = blockIdx.y;
  const long long t0 = static_cast<long long>(g) * T / groups;
  const long long t1 = static_cast<long long>(g + 1) * T / groups;
  float s = 0.f;
  for (long long t = t0; t < t1; ++t) s += in[t * F + i];
  out[g * F + i] = s;
}

// out[i] = sum over t < T of in[t][i]; tmp holds kColsumGroups * F floats.
inline cudaError_t colsum(const float* in, int T, size_t F, float* out, float* tmp,
                          cudaStream_t stream) {
  const unsigned bx = static_cast<unsigned>((F + 255) / 256);
  const int groups = T < kColsumGroups ? T : kColsumGroups;
  if (groups > 1) {
    colsum_kernel<<<dim3(bx, groups), 256, 0, stream>>>(in, T, F, groups, tmp);
    colsum_kernel<<<dim3(bx, 1), 256, 0, stream>>>(tmp, groups, F, 1, out);
  } else {
    colsum_kernel<<<dim3(bx, 1), 256, 0, stream>>>(in, T, F, 1, out);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <int H>
cudaError_t launch_fwd_store(const Weights& w, const float* x, const float* d, int d_div,
                             float* out, int P, const Scratch& s, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kTileRows) * H + mlp_side_floats<H>(w.xe, w.de)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_store_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (P + kTileRows - 1) / kTileRows;
  fwd_store_kernel<H><<<tiles, kThreads, smem, stream>>>(w, x, d, d_div, out, P, s.xhat,
                                                          s.stats);
  return cudaGetLastError();
}

// Passes 2-4 from the output cotangents gout: grads (the flat gradient,
// wgrad_floats + tile_floats) and, when not null, dx and dd.  x, d and
// d_div are the forward's encoded inputs.
template <int H>
cudaError_t launch_mlp_backward(const Weights& w, const float* x, const float* d, int d_div,
                                const float* gout, int P, const Scratch& s, float* dx,
                                float* dd, float* grads, cudaStream_t stream) {
  const int L = num_layers(w);
  transpose_slabs_kernel<<<dim3(H / 32, H / 32, L - 1), dim3(32, 8), 0, stream>>>(w.whh, H,
                                                                                  s.wt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = bwd_rows_smem<H>(w);
  err = cudaFuncSetAttribute(bwd_rows_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = (P + kTileRows - 1) / kTileRows;
  bwd_rows_kernel<H><<<tiles, kThreads, smem, stream>>>(w, gout, P, s.xhat, s.stats, s.wt,
                                                         s.dpre, s.tpart, dx, dd);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t PP = static_cast<size_t>(P);
  const int tn = (H + kWT - 1) / kWT;
  const int tx = (w.xe + kWT - 1) / kWT, td = (w.de + kWT - 1) / kWT;
  WProds prods{};
  int n = 0;
  size_t off = 0;
  prods.p[n++] = WProd{x, nullptr, nullptr, w.xe, w.xe, 1, 0, off, tx, tn};
  off += static_cast<size_t>(w.xe) * H;
  prods.p[n++] = WProd{x, nullptr, nullptr, w.xe, w.xe, 1, 4, off, tx, tn};
  off += static_cast<size_t>(w.xe) * H;
  if (w.wd != nullptr) {
    prods.p[n++] = WProd{d, nullptr, nullptr, w.de, w.de, d_div, 8, off, td, tn};
    off += static_cast<size_t>(w.de) * H;
  }
  for (int k = 0; k < L - 1; ++k) {
    prods.p[n++] = WProd{s.xhat + k * PP * H, w.g + k * H, w.beta + k * H, H, H, 1, k + 1,
                         off, tn, tn};
    off += static_cast<size_t>(H) * H;
  }
  prods.n = n;
  int total_tiles = 0;
  for (int i = 0; i < n; ++i) total_tiles += prods.p[i].tiles_m * prods.p[i].tiles_n;
  const size_t wf = wgrad_floats(w, H);
  int k_chunk = (P + s.splits - 1) / s.splits;
  k_chunk = (k_chunk + kWK - 1) / kWK * kWK;
  wgrad_kernel<<<dim3(total_tiles, s.splits), 256, 0, stream>>>(prods, s.dpre, P, H, k_chunk,
                                                                 s.wpart, wf);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum(s.wpart, s.splits, wf, grads, s.tmp, stream)) != cudaSuccess) return err;
  return colsum(s.tpart, tiles, tile_floats(w, H), grads + wf, s.tmp, stream);
}

// Warp-wide exclusive prefix and suffix sums over a ray's values split in
// runs of run_len consecutive elements, lane l owning run l: returns the
// sum of the runs before (prefix) or after (suffix) this lane's run.
__device__ __forceinline__ float runs_exclusive_prefix(float part) {
  const int lane = threadIdx.x & 31;
  float incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  const float excl = __shfl_up_sync(kFull, incl, 1);
  return lane == 0 ? 0.f : excl;
}

__device__ __forceinline__ float runs_exclusive_suffix(float part) {
  const int lane = threadIdx.x & 31;
  float incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_down_sync(kFull, incl, o);
    if (lane + o < 32) incl += v;
  }
  const float excl = __shfl_down_sync(kFull, incl, 1);
  return lane == 31 ? 0.f : excl;
}

// One ray's alpha compositing, its MSE against the pixel pix [c] and the
// backward of both, on one warp (the K2 and K3 objectives).  The ray's n
// samples in depth order come from functors: sigma(p), the noised density
// logit; logit(p, ch), the colour logits; dist(p), the interval to the
// next sample.  Lane l owns a run of consecutive samples; the exclusive
// prefix of log(alpha + 1e-10) and the exclusive suffix of w * dL/dw are
// warp scans in fp32.  The results go to on_weight(p, w), on_color_grad(p,
// ch, g) and on_sigma_grad(p, g) (relu' = sigma > 0); returns loss_scale *
// mean_c(err^2), err = rgb (+ off * (1 - acc)) - pix.  scratch: 3 n floats.
template <class Sigma, class Logit, class Dist, class OnWeight, class OnColorGrad,
          class OnSigmaGrad>
__device__ float composite_ray(int n, int c, float off, const float* pix, float g_scale,
                               float loss_scale, float* scratch, Sigma sigma, Logit logit,
                               Dist dist, OnWeight on_weight, OnColorGrad on_color_grad,
                               OnSigmaGrad on_sigma_grad) {
  const int lane = threadIdx.x & 31;
  float* al = scratch;  // alpha
  float* tr = al + n;   // transmittance
  float* gw = tr + n;   // dL/dw
  for (int p = lane; p < n; p += 32) al[p] = expf(-fmaxf(sigma(p), 0.f) * dist(p));
  __syncwarp();
  const int run_len = (n + 31) / 32;
  const int begin = min(n, lane * run_len), end = min(n, begin + run_len);
  float part = 0.f;
  for (int p = begin; p < end; ++p) part += logf(al[p] + 1e-10f);
  float prefix = runs_exclusive_prefix(part);

  float rgb[kMaxColors];
#pragma unroll
  for (int ch = 0; ch < kMaxColors; ++ch) rgb[ch] = 0.f;
  float acc = 0.f;
  for (int p = begin; p < end; ++p) {
    const float t = expf(prefix);
    tr[p] = t;
    const float wgt = (1.f - al[p]) * t;
    prefix += logf(al[p] + 1e-10f);
#pragma unroll
    for (int ch = 0; ch < kMaxColors; ++ch)
      if (ch < c) rgb[ch] = fmaf(wgt, sigmoid(logit(p, ch)), rgb[ch]);
    acc += wgt;
    on_weight(p, wgt);
  }
  acc = warp_sum(acc);
  float g_rgb[kMaxColors];
  float sq = 0.f;
#pragma unroll
  for (int ch = 0; ch < kMaxColors; ++ch) {
    g_rgb[ch] = 0.f;
    if (ch < c) {
      const float err = warp_sum(rgb[ch]) + off * (1.f - acc) - pix[ch];
      sq = fmaf(err, err, sq);
      g_rgb[ch] = err * g_scale;
    }
  }

  // Backward: colour cotangents and dL/dw per sample, then the suffix of
  // dL/dlog(T) = w * dL/dw.
  part = 0.f;
  for (int p = begin; p < end; ++p) {
    const float wgt = (1.f - al[p]) * tr[p];
    float g = 0.f;
#pragma unroll
    for (int ch = 0; ch < kMaxColors; ++ch) {
      if (ch < c) {
        const float sg = sigmoid(logit(p, ch));
        g = fmaf(sg - off, g_rgb[ch], g);
        on_color_grad(p, ch, wgt * sg * (1.f - sg) * g_rgb[ch]);
      }
    }
    gw[p] = g;
    part = fmaf(wgt, g, part);
  }
  float suffix = runs_exclusive_suffix(part);
  for (int p = end - 1; p >= begin; --p) {
    const float g_alpha = -tr[p] * gw[p] + suffix / (al[p] + 1e-10f);
    suffix = fmaf((1.f - al[p]) * tr[p], gw[p], suffix);
    on_sigma_grad(p, sigma(p) > 0.f ? g_alpha * (-dist(p) * al[p]) : 0.f);
  }
  return loss_scale * (sq / c);
}

}  // namespace nerf_mlp
