// Device code of the classic NeRF MLP's backward, shared by the K1 backward
// (classic_mlp_bwd.cu), the coarse-only train kernel K2 (train_grads.cu),
// the fine-stage train kernel K3 (fine_stage_train.cu), K8-bwd
// (classic_pointmlp_bwd.cu) and K9 (mega_train.cu); the mip MLP's
// backward (mip_mlp.cuh) runs the same passes.
//
// The TPU kernels keep a tile's whole activation chain in VMEM and carry
// the weight gradients in one VMEM block across a grid that runs in order.
// An SM has 227 KB of shared memory (one 64-row tile's chain is 640 KB at
// H = 256) and its blocks run in parallel, so the backward is four passes
// over global memory, each written by hand:
//
//   1. fwd_store: the forward (64-row tiles, tc_mlp.cuh's mlp_tile_tc)
//      that also stores every layer's normalised LayerNorm input xhat,
//      [L][P][H], and the per-row (1/sigma, -mu/sigma), [L][P][2].  Storing
//      costs 2 x L x H x 4 bytes per row of HBM traffic (2.7 GB at 131,072
//      rows, about 0.8 ms at 3.35 TB/s) against about 5 ms of the
//      operations bound, so the backward does not recompute the chain once
//      more.
//   2. bwd_rows: per 64-row tile, from the output cotangents down through
//      the layers: the LayerNorm and ReLU backward in registers (warp
//      reductions over a row, as the forward; layer_bwd, head_bwd below),
//      dh = dpre @ W^T, every layer's dpre stored to [L][P][H], and the
//      tile's column sums (db, dg, dbeta, the two heads) written to its own
//      row of a per-tile partials buffer.  Optionally the input cotangents
//      dx, dd.
//   3. wgrad: dW = h_in^T dpre for every weight slab (the WProds below):
//      128 x 128 output tiles, the points cut into S splits (wgrad_k_chunk),
//      each split's tile written to its own partials slab.  A block walks
//      its split in chunks of 32 points: a copier warp brings each chunk's
//      raw rows with bulk copies a few chunks ahead, a staging warpgroup
//      transposes them into the tensor cores' operand order, and two
//      consumer warpgroups keep two chunks of products in flight, each
//      chunk summed in a fresh accumulator and added to a float32 sum in
//      chunk order (tc_mlp.cuh's wgrad_tc_kernel, 230,400 bytes of shared
//      memory: one block an SM).
//   4. colsum: the partials summed in a fixed order (two stages), so the
//      gradients are the same from run to run (no atomics).
//
// Passes 1-3 run their products through a policy: TcProducts (tc_mlp.cuh,
// 3xTF32 on the tensor cores) for K1-bwd, K2, K3, K8-bwd and K9 at every
// encoding width.  The mip passes (mip_mlp.cuh) take their own policy on
// the same pieces, MipTc (K5-fwd, K5-bwd, K6, K7), at every feature width.
//
// The flat gradient the passes produce is the packed weights' order
// (ops/kernels/classic_mlp.py): w0, wx, wd, whh | b, g, beta, w_dens,
// w_col, b_dens, b_col.
//
// compute_dtype="bfloat16" runs TcProductsT<true> (tc_mlp.cuh): the
// encodings are read as bfloat16 and every product's operands rounded to
// it, the heads' (head_bwd<H, true>) included; the chain, the gradients and
// every sum stay float32.
#pragma once

#include "classic_mlp.cuh"

namespace nerf_mlp {

constexpr int kColsumGroups = 64;
// Colours a per-ray pass sums in registers at a time: any colour count
// runs in chunks of this many (composite_ray and the eval passes).
constexpr int kColorChunk = 8;

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
  int splits;
  // The tensor-core passes' operand images (tc_mlp.cuh; TcProducts only).
  const float* tc_fwd = nullptr;
  const float* tc_bwd = nullptr;
};

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
  tile_sync();
  for (int j = threadIdx.x; j < H; j += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) t += red[v * H + j];
    out[static_cast<size_t>(j) * stride] = t;
  }
  tile_sync();
}

// A linear head out[:, col0:col0+n] = h @ W + bias (W row-major [H, n]) on
// the layer output h = xhat * g + beta (xh points at the layer's row row0;
// rows past nvalid count as 0).  Backward: acc += gs[:, col0:col0+n] @
// W^T, and the tile's column sums of h[r][j] * gs[r][col0 + q] into
// part[j * n + q] (the head's dW).  kBf16: h, W and gs rounded to
// bfloat16 in both products (the JAX package's _dot_t and _dot_tn).
template <int H, bool kBf16 = false>
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
    for (int r = 0; r < kRowsPerWarp; ++r) h[r][j] = operand<kBf16>(fmaf(h[r][j], gj, bj));
  }
  for (int q = 0; q < n; ++q) {
    float wq[kCols], s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      wq[j] = operand<kBf16>(__ldg(W + (lane + 32 * j) * n + q));
      s[j] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float gv = operand<kBf16>(gs[(warp * kRowsPerWarp + r) * ldo + col0 + q]);
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
// sums of dpre, dy * xhat and dy go to part_b, part_g, part_beta, with dy
// the cotangent of the LayerNorm's output.  The classic order (LayerNorm
// after ReLU): dy = dh, and dpre takes the ReLU mask xhat > -mu/sigma.
// kLnFirst, the mip order (ReLU after LayerNorm): dy = dh where the
// LayerNorm output xhat * g + beta > 0, else 0.  g, beta: the layer's
// LayerNorm scale and bias.  The row means are over the first h columns
// (the model's width; a padded column's dxh is exactly 0, its g being 0),
// and the padded columns' dpre is 0: in the classic order by the ReLU
// mask (a padded column's xhat is exactly -mu/sigma), in the mip order by
// a mask on the column.
template <int H, bool kLnFirst = false>
__device__ void layer_bwd(float (&acc)[kRowsPerWarp][H / 32], int i,
                          const float* __restrict__ g, const float* __restrict__ beta, int h,
                          float inv_h, size_t P, size_t row0, int nvalid, const float* xhat,
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
  float gj[kCols], bj[kCols], s_b[kCols], s_g[kCols], s_beta[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    gj[j] = __ldg(g + lane + 32 * j);
    bj[j] = kLnFirst ? __ldg(beta + lane + 32 * j) : 0.f;
    s_b[j] = s_g[j] = s_beta[j] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp * kRowsPerWarp + r;
    const size_t at = static_cast<size_t>(i) * P + row0 + row;
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      if (kLnFirst && !(fmaf(xh[r][j], gj[j], bj[j]) > 0.f)) acc[r][j] = 0.f;
      s_beta[j] += acc[r][j];
      s_g[j] = fmaf(acc[r][j], xh[r][j], s_g[j]);
      const float dxh = acc[r][j] * gj[j];  // exactly 0 in a padded column (g 0)
      m1 += dxh;
      m2 = fmaf(dxh, xh[r][j], m2);
      acc[r][j] = dxh;
    }
    m1 = warp_sum(m1) * inv_h;
    m2 = warp_sum(m2) * inv_h;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float dp = (kLnFirst ? lane + 32 * j < h : xh[r][j] > st[r].y)
                           ? st[r].x * (acc[r][j] - m1 - xh[r][j] * m2)
                           : 0.f;
      acc[r][j] = dp;
      s_b[j] += dp;
      // dpre is never null (both row passes store it here); ptxas lays the
      // classic pass out better with the test than without
      // (scripts/torch_bwd_rows_split.py's no_null_test, PERF.md section 5).
      if (dpre != nullptr && row < nvalid) dpre[at * H + lane + 32 * j] = dp;
    }
  }
  tile_colsum<H>(s_b, red, part_b + i * H);
  tile_colsum<H>(s_g, red, part_g + i * H);
  tile_colsum<H>(s_beta, red, part_beta + i * H);
}

// ---------------------------------------------------------------------------
// 3. Weight gradients: dW = h_in^T dpre, summed over a chunk of points.
// ---------------------------------------------------------------------------

constexpr int kWT = 128;  // output tile edge
constexpr int kWK = 16;   // a split's points are a multiple of this (wgrad_k_chunk)
constexpr int kMaxProds = 12;  // products of one wgrad launch

// The points of each of the `splits` splits of P (the last may hold fewer):
// every launcher of wgrad splits the points so, and the chunks of kWgK
// points (tc_mlp.cuh) start at each split's first point.
__host__ inline int wgrad_k_chunk(int P, int splits) {
  const int k = (P + splits - 1) / splits;
  return (k + kWK - 1) / kWK * kWK;
}

// One weight slab's product.  The left operand is the raw encoding a
// ([rows / div][a_ld], g == nullptr) or a layer's output rebuilt from its
// xhat ([P][H], h = xhat * g + beta, then relu(h) where relu is set: the
// mip order); the right one, b [P][n], is a layer's dpre or a head's
// output cotangents.  The result [M][n] goes to out_off of the flat
// gradient.
struct WProd {
  const float* a;
  const float* g;
  const float* beta;
  const float* b;
  int a_ld, M, n, div, relu;
  size_t out_off;
  int tiles_m, tiles_n;
  // With split > 0 the raw encoding's rows serve two stages: point p <
  // split reads row p / div, point p >= split row (p - split) / div2 (K9's
  // per-ray view encodings under its coarse-then-fine rows).
  int split, div2;
  // The raw encoding a is bfloat16 (compute_dtype bfloat16; read by
  // wgrad_tc_kernel<true> only).
  int a_bf16;
};

struct WProds {
  WProd p[kMaxProds];
  int n;
};

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

// Pass 1 on the P rows of a call, their encodings from `load`; the
// chain's rows base .. base + P - 1 of `stride` (the policy's fwd_store).
template <int H, class Products, class Load>
cudaError_t launch_fwd_store_with(const Weights& w, const Load& load, float* out, int P,
                                  const Scratch& s, cudaStream_t stream, size_t stride,
                                  size_t base) {
  return Products::template fwd_store<H, Load>(w, load, out, P, s, stream, stride, base);
}

// Passes 2-4 from the output cotangents gout: grads (the flat gradient,
// wgrad_floats + tile_floats) and, when not null, dx and dd.  x, d and
// d_div are the forward's encoded inputs (bfloat16 where Products::kBf16,
// as dx and dd then are); with d_split > 0, d's rows serve points p >=
// d_split as row (p - d_split) / d_div2 (WProd::split).
template <int H, class Products>
cudaError_t launch_mlp_backward(const Weights& w, const void* xv, const void* dv, int d_div,
                                const float* gout, int P, const Scratch& s, void* dx,
                                void* dd, float* grads, cudaStream_t stream,
                                int d_split = 0, int d_div2 = 1) {
  // The raw encodings' pointers as WProd holds them (a_bf16 marks bfloat16).
  const float* x = static_cast<const float*>(xv);
  const float* d = static_cast<const float*>(dv);
  constexpr int enc_bf16 = Products::kBf16 ? 1 : 0;
  const int L = num_layers(w), hp = w.hp;  // the slabs' padded width
  cudaError_t err = Products::template bwd_rows<H>(w, gout, P, s, dx, dd, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (P + kTileRows - 1) / kTileRows;

  const size_t PP = static_cast<size_t>(P);
  const int tn = (hp + kWT - 1) / kWT;
  const int tx = (w.xe + kWT - 1) / kWT, td = (w.de + kWT - 1) / kWT;
  WProds prods{};
  int n = 0;
  size_t off = 0;
  auto dpre = [&](int layer) { return s.dpre + layer * PP * hp; };
  prods.p[n++] =
      WProd{x, nullptr, nullptr, dpre(0), w.xe, w.xe, hp, 1, 0, off, tx, tn, 0, 1, enc_bf16};
  off += static_cast<size_t>(w.xe) * hp;
  prods.p[n++] =
      WProd{x, nullptr, nullptr, dpre(4), w.xe, w.xe, hp, 1, 0, off, tx, tn, 0, 1, enc_bf16};
  off += static_cast<size_t>(w.xe) * hp;
  if (w.wd != nullptr) {
    prods.p[n++] = WProd{d, nullptr, nullptr, dpre(8), w.de, w.de, hp, d_div, 0, off, td, tn,
                         d_split, d_div2, enc_bf16};
    off += static_cast<size_t>(w.de) * hp;
  }
  for (int k = 0; k < L - 1; ++k) {
    prods.p[n++] = WProd{s.xhat + k * PP * hp, w.g + k * hp, w.beta + k * hp, dpre(k + 1), hp,
                         hp, hp, 1, 0, off, tn, tn};
    off += static_cast<size_t>(hp) * hp;
  }
  prods.n = n;
  int total_tiles = 0;
  for (int i = 0; i < n; ++i) total_tiles += prods.p[i].tiles_m * prods.p[i].tiles_n;
  const size_t wf = wgrad_floats(w, hp);
  const int k_chunk = wgrad_k_chunk(P, s.splits);
  if ((err = Products::wgrad(prods, total_tiles, P, k_chunk, s, wf, stream, L * PP, hp)) !=
      cudaSuccess)
    return err;
  if ((err = colsum(s.wpart, s.splits, wf, grads, s.tmp, stream)) != cudaSuccess) return err;
  return colsum(s.tpart, tiles, tile_floats(w, hp), grads + wf, s.tmp, stream);
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

// A ray's alphas and transmittances on one warp: al[p] = exp(-relu(sigma(p))
// * dist(p)) and tr[p] = prod_{q<p} (al[q] + 1e-10), the latter as the
// exponential of the exclusive prefix of log(alpha + 1e-10): lane l owns
// run l of ray_run_len(n) consecutive samples, and the prefix over runs is
// a warp scan in fp32.  al and tr hold n floats each; tr[p] is written by
// the lane that owns p.
__device__ __forceinline__ int ray_run_len(int n) { return (n + 31) / 32; }

template <class Sigma, class Dist>
__device__ void ray_transmittance(int n, float* al, float* tr, Sigma sigma, Dist dist) {
  const int lane = threadIdx.x & 31;
  for (int p = lane; p < n; p += 32) al[p] = expf(-fmaxf(sigma(p), 0.f) * dist(p));
  __syncwarp();
  const int begin = min(n, lane * ray_run_len(n)), end = min(n, begin + ray_run_len(n));
  float part = 0.f;
  for (int p = begin; p < end; ++p) part += logf(al[p] + 1e-10f);
  float prefix = runs_exclusive_prefix(part);
  for (int p = begin; p < end; ++p) {
    tr[p] = expf(prefix);
    prefix += logf(al[p] + 1e-10f);
  }
}

// A term of the objective that depends on the compositing weights beyond
// the colour MSE, for composite_ray: forward(begin, end, al, tr) runs after
// the weights are known (this lane's run [begin, end); a warp-wide call),
// and grad(p, w) returns its dL/dw_p for the shared backward.  The K2 and
// K3 objectives have none.
struct NoWeightTerm {
  __device__ void forward(int, int, const float*, const float*) {}
  __device__ float grad(int, float) { return 0.f; }
};

// One ray's alpha compositing, its MSE against the pixel pix [c] and the
// backward of both, on one warp (the K2, K3 and K6 objectives).  The ray's
// n samples in depth order come from functors: sigma(p), the noised
// density logit; logit(p, ch), the colour logits; dist(p), the interval to
// the next sample.  The transmittances come from ray_transmittance; the
// exclusive suffix of w * dL/dw is a warp scan in fp32, and term adds its
// part of dL/dw (NoWeightTerm for none).  The results go to on_weight(p,
// w), on_color_grad(p, ch, g) and on_sigma_grad(p, g) (relu' = sigma >
// 0); returns loss_scale * mean_c(err^2), err = rgb (+ off * (1 - acc)) -
// pix.  scratch: 3 n floats.
template <class Sigma, class Logit, class Dist, class OnWeight, class OnColorGrad,
          class OnSigmaGrad, class Term>
__device__ float composite_ray(int n, int c, float off, const float* pix, float g_scale,
                               float loss_scale, float* scratch, Sigma sigma, Logit logit,
                               Dist dist, OnWeight on_weight, OnColorGrad on_color_grad,
                               OnSigmaGrad on_sigma_grad, Term& term) {
  const int lane = threadIdx.x & 31;
  float* al = scratch;  // alpha
  float* tr = al + n;   // transmittance
  float* gw = tr + n;   // dL/dw
  ray_transmittance(n, al, tr, sigma, dist);
  const int begin = min(n, lane * ray_run_len(n)), end = min(n, begin + ray_run_len(n));

  // The colours a chunk of kColorChunk at a time: each chunk's sums, its
  // part of the loss and its colour cotangents, its part of dL/dw into gw.
  float acc = 0.f, sq = 0.f;
  for (int ch0 = 0; ch0 < c; ch0 += kColorChunk) {
    const int nch = min(kColorChunk, c - ch0);
    float rgb[kColorChunk];
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) rgb[ch] = 0.f;
    float a = 0.f;
    for (int p = begin; p < end; ++p) {
      const float wgt = (1.f - al[p]) * tr[p];
#pragma unroll
      for (int ch = 0; ch < kColorChunk; ++ch)
        if (ch < nch) rgb[ch] = fmaf(wgt, sigmoid(logit(p, ch0 + ch)), rgb[ch]);
      if (ch0 == 0) {
        a += wgt;
        on_weight(p, wgt);
      }
    }
    if (ch0 == 0) acc = warp_sum(a);
    float g_rgb[kColorChunk];
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) {
      g_rgb[ch] = 0.f;
      if (ch < nch) {
        const float err = warp_sum(rgb[ch]) + off * (1.f - acc) - pix[ch0 + ch];
        sq = fmaf(err, err, sq);
        g_rgb[ch] = err * g_scale;
      }
    }
    // Backward: the chunk's colour cotangents and its part of dL/dw.
    for (int p = begin; p < end; ++p) {
      const float wgt = (1.f - al[p]) * tr[p];
      float g = ch0 == 0 ? 0.f : gw[p];
#pragma unroll
      for (int ch = 0; ch < kColorChunk; ++ch) {
        if (ch < nch) {
          const float sg = sigmoid(logit(p, ch0 + ch));
          g = fmaf(sg - off, g_rgb[ch], g);
          on_color_grad(p, ch0 + ch, wgt * sg * (1.f - sg) * g_rgb[ch]);
        }
      }
      gw[p] = g;
    }
  }
  term.forward(begin, end, al, tr);

  // dL/dw with the term's part, then the suffix of dL/dlog(T) = w * dL/dw.
  float part = 0.f;
  for (int p = begin; p < end; ++p) {
    const float wgt = (1.f - al[p]) * tr[p];
    const float g = gw[p] + term.grad(p, wgt);
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
