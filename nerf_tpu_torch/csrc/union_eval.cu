// K4: the forward-only fine stage of the hierarchical-reuse renderer.  The
// fine MLP on the new fine samples, then the union of the reused coarse
// samples and the fine ones composited in t order -> [rgb (c), depth, acc]
// per ray.  The caller adds a white background.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_hier.py::
// _hier_eval_kernel (pallas_call in fine_union_eval_pallas).  The TPU
// kernel avoids sorting by O(Sc*Sf) masked sums with Dekker-split matmuls;
// on the GPU one warp merges a ray's two sorted lists and scans them.
//
// Bound: operations.  The fine MLP is 630,784 multiply-adds per fine
// sample at the full-width model against 240 bytes of encoding read per
// sample; the compositing is O(Sc + Sf) per ray and the coarse inputs
// (t, density, c logits) are (2 + c) x 4 bytes per coarse sample.  At a
// 4000-ray tile of 128 fine samples: 9.641 ms at the float32 SIMT rate (67
// TFLOP/s), 3.915 ms as three TF32 products at 495 TFLOP/s.
//
// Design.  A block (8 warps) owns whole rays, 256 / Sf of them (at least
// one).  It runs the MLP over the block's fine rows in 64-row sub-tiles,
// broadcasting each ray's view encoding to its rows, with every hidden and
// encoding product as 3xTF32 on the tensor cores (mlp_tile_tc,
// tc_mlp.cuh: the weights as operand images the wrapper builds once per
// call, streamed in chunks of 16 k-values, and the encodings streamed
// beside them one chunk at a time through a ring; the epilogues and heads
// in float32 SIMT), and writes [density, color logits] per fine row to
// device memory (fout, L2-resident at a tile's sizes): the block takes
// tc_tile_bytes, 219,136 bytes at H = 256 (one block an SM), at every
// encoding width, sample count and colour count (tc_mlp.cuh, note 9; past
// hidden 256 note 11's column blocks, in tc_tile_bytes<256>).  Then one
// warp per ray:
//   1. merges the sorted coarse and fine t lists by rank (binary search in
//      the other list; a coarse sample tied with a fine one comes first);
//   2. takes each merged sample's interval to its successor, times ||d||,
//      with the 1e10 far pad on the last, and alpha = exp(-relu(sigma) dist);
//   3. runs the exclusive sum of log(alpha + 1e-10) in merged order in fp32
//      (each lane sums a contiguous run, a warp scan joins the runs), and
//      accumulates w = (1 - alpha) exp(prefix) into rgb (kColorChunk colours
//      at a time), depth and acc.
// The compositing's scratch (4 arrays of Sc + Sf a ray) lies in device
// memory, so every sample count runs.
//
// union_eval_bf16 is the same kernel in compute_dtype bfloat16 (tc_mlp.cuh,
// note 10): bf16 fine and per-ray view encodings (the view row broadcast in
// the block as before) and weight images, every product and both heads on
// bf16 operands with float32 sums; the compositing and outputs float32; the
// same tile.  Its bound at a 4000-ray tile of 128 fine
// samples: 0.653 ms of bf16 tensor-core operations (FLOP / 989 TFLOP/s).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

namespace {

using namespace nerf_mlp;

// Composite one ray with the calling warp; fo is the ray's [Sf][1 + c]
// block of fine MLP outputs, scratch the ray's 4 (Sc + Sf) floats.
__device__ void composite_ray(int ray, int Sc, int Sf, int c,
                              const float* __restrict__ t_c, const float* __restrict__ t_f,
                              const float* __restrict__ dens_c,
                              const float* __restrict__ col_c, float dn, const float* fo,
                              float* scratch, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int n = Sc + Sf, ld = 1 + c;
  float* mt = scratch;            // merged t
  float* la = scratch + n;        // log(alpha + 1e-10)
  float* om = scratch + 2 * n;    // 1 - alpha
  int* src = reinterpret_cast<int*>(scratch + 3 * n);  // coarse i, or Sc + fine j
  const float* tc = t_c + static_cast<size_t>(ray) * Sc;
  const float* tf = t_f + static_cast<size_t>(ray) * Sf;

  for (int i = lane; i < Sc; i += 32) {
    const float t = tc[i];
    int lo = 0, hi = Sf;  // fine samples strictly before t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tf[mid] < t) lo = mid + 1; else hi = mid;
    }
    mt[i + lo] = t;
    src[i + lo] = i;
  }
  for (int j = lane; j < Sf; j += 32) {
    const float t = tf[j];
    int lo = 0, hi = Sc;  // coarse samples at or before t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tc[mid] <= t) lo = mid + 1; else hi = mid;
    }
    mt[j + lo] = t;
    src[j + lo] = Sc + j;
  }
  __syncwarp();

  for (int p = lane; p < n; p += 32) {
    const float t = mt[p];
    const float dist = p + 1 < n ? (mt[p + 1] - t) * dn : 1e10f;
    const int s = src[p];
    const float sigma = s < Sc ? dens_c[static_cast<size_t>(ray) * Sc + s] : fo[(s - Sc) * ld];
    const float alpha = expf(-fmaxf(sigma, 0.f) * dist);
    la[p] = logf(alpha + 1e-10f);
    om[p] = 1.f - alpha;
  }
  __syncwarp();

  const int run_len = (n + 31) / 32;
  const int begin = min(n, lane * run_len), end = min(n, begin + run_len);
  float part = 0.f;
  for (int p = begin; p < end; ++p) part += la[p];
  float incl = part;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += v;
  }
  float prefix = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) prefix = 0.f;

  // The colours a chunk of kColorChunk at a time, each chunk walking the
  // lane's run again from its prefix; the first also sums depth and acc.
  const float prefix0 = prefix;
  float depth = 0.f, acc = 0.f;
  float* o = out + static_cast<size_t>(ray) * (c + 2);
  int ch0 = 0;
  do {
    float rgb[kColorChunk];
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) rgb[ch] = 0.f;
    prefix = prefix0;
    for (int p = begin; p < end; ++p) {
      const float wgt = om[p] * expf(prefix);
      prefix += la[p];
      const int s = src[p];
      const float* logits = s < Sc ? col_c + (static_cast<size_t>(ray) * Sc + s) * c
                                   : fo + (s - Sc) * ld + 1;
#pragma unroll
      for (int ch = 0; ch < kColorChunk; ++ch)
        if (ch0 + ch < c) rgb[ch] = fmaf(wgt, sigmoid(logits[ch0 + ch]), rgb[ch]);
      if (ch0 == 0) {
        depth = fmaf(wgt, mt[p], depth);
        acc += wgt;
      }
    }
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) {
      if (ch0 + ch < c) {
        const float v = warp_sum(rgb[ch]);
        if (lane == 0) o[ch0 + ch] = v;
      }
    }
    ch0 += kColorChunk;
  } while (ch0 < c);
  depth = warp_sum(depth);
  acc = warp_sum(acc);
  if (lane == 0) {
    o[c] = depth;
    o[c + 1] = acc;
  }
  __syncwarp();
}

__host__ __device__ inline int rays_per_block(int Sf) { return Sf >= 256 ? 1 : 256 / Sf; }
// The blocks of a call over R rays: the wide scratch's tiles (note 11).
__host__ inline int num_blocks(int R, int Sf) {
  return (R + rays_per_block(Sf) - 1) / rays_per_block(Sf);
}

template <class T>  // the encodings' type, float or __nv_bfloat16
struct Inputs {
  const T* xf;          // [R * Sf][xe] fine encodings
  const T* d;           // [R][de] view encodings, or nullptr
  const float* t_c;     // [R][Sc]
  const float* t_f;     // [R][Sf]
  const float* dens_c;  // [R][Sc]
  const float* col_c;   // [R][Sc][c]
  const float* dnorm;   // [R]
};

// fout [R * Sf][1 + c] and scratch [R][4 (Sc + Sf)] are device memory;
// wide the scratch of a width past 256 (2 x 64 x hp floats a block).
template <int H, bool kBf16>
NERF_TC_KERNEL
    union_eval_kernel(Weights w, TcImages im, Inputs<enc_t<kBf16>> in, float* __restrict__ out,
                      int R, int Sc, int Sf, float* fout, float* scratch, WideRows wide) {
  constexpr int HT = col_width<H>();
  extern __shared__ float4 smem4[];
  float* bbuf = tc_smem_base(smem4);          // the weights' B chunks
  float* act = bbuf + tc_bbuf_floats<HT>();   // MLP activations
  float* ring = act + kTileRows * act_ld<HT>();  // the encodings' ring
  const int ld = 1 + w.c;
  const int ray0 = blockIdx.x * rays_per_block(Sf);
  const int nrays = min(rays_per_block(Sf), R - ray0);
  const int rows = nrays * Sf;
  const size_t frow0 = static_cast<size_t>(ray0) * Sf;
  // The fine encodings, and each ray's view encoding broadcast to its rows.
  const TileLoadT<enc_t<kBf16>> load{in.xf, in.d, Sf};

  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    for (int sub = 0; sub < rows; sub += kTileRows) {
      if constexpr (H > kColBlock)
        mlp_tile_wide<false, kBf16>(pipe, w, im, load, frow0 + sub, min(kTileRows, rows - sub),
                                    act, ring, fout + (frow0 + sub) * ld, ld, nullptr,
                                    wide.pre + blockIdx.x * wide.stride,
                                    wide.nrm + blockIdx.x * wide.stride);
      else
        mlp_tile_tc<H, false, kBf16>(pipe, w, im, load, frow0 + sub, min(kTileRows, rows - sub),
                                     act, ring, fout + (frow0 + sub) * ld, ld);
      if constexpr (std::decay_t<decltype(pipe)>::kConsumer) tile_sync();
    }
    if constexpr (std::decay_t<decltype(pipe)>::kConsumer) {
      const int warp = threadIdx.x >> 5;
      for (int i = warp; i < nrays; i += kWarps) {
        const int ray = ray0 + i;
        composite_ray(ray, Sc, Sf, w.c, in.t_c, in.t_f, in.dens_c, in.col_c,
                      __ldg(in.dnorm + ray), fout + (frow0 + static_cast<size_t>(i) * Sf) * ld,
                      scratch + static_cast<size_t>(ray) * 4 * (Sc + Sf), out);
      }
    }
  });
}

template <int H, bool kBf16>
cudaError_t launch(const Weights& w, const float* tcw, const Inputs<enc_t<kBf16>>& in,
                   float* out, int R, int Sc, int Sf, float* fout, float* scratch, float* wide,
                   cudaStream_t stream) {
  if (tcw == nullptr || fout == nullptr || scratch == nullptr ||
      (H > kColBlock && wide == nullptr))
    return cudaErrorInvalidValue;
  // The tile's bytes (note 9), the same at every encoding width, sample
  // count and colour count: the fine outputs and the compositing scratch
  // lie in device memory.
  constexpr size_t smem = tc_tile_bytes<col_width<H>()>();
  cudaError_t err = cudaFuncSetAttribute(union_eval_kernel<H, kBf16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = num_blocks(R, Sf);
  union_eval_kernel<H, kBf16><<<blocks, kTcThreads, smem, stream>>>(
      w, TcImages::forward<kBf16>(w, tcw, w.hp), in, out, R, Sc, Sf, fout, scratch,
      wide_rows(wide, w.hp));
  return cudaGetLastError();
}

template <bool kBf16>
int run(const void* xf, const void* d, const float* t_c, const float* t_f, const float* dens_c,
        const float* col_c, const float* dnorm, float* out, int R, int Sc, int Sf, int hidden,
        const Weights& w0, const void* tcw, float* fout, float* scratch, float* wide,
        void* stream) {
  using T = enc_t<kBf16>;
  const Weights w = sized(w0, hidden);
  const Inputs<T> in{static_cast<const T*>(xf), static_cast<const T*>(d), t_c, t_f, dens_c,
                     col_c, dnorm};
  const float* img = static_cast<const float*>(tcw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(launch<H, kBf16>(w, img, in, out, R, Sc, Sf, fout, scratch, wide, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

// fout [R * Sf][1 + c] (the fine MLP outputs), scratch [R][4 (Sc + Sf)]
// (the compositing's) and, past hidden 256, wide [blocks][2][64][hp] (the
// tiles' rows; blocks = union_eval_blocks(R, Sf)) are the caller's device
// memory.
extern "C" int union_eval(const float* xf, const float* d, const float* t_c, const float* t_f,
                          const float* dens_c, const float* col_c, const float* dnorm,
                          float* out, int R, int Sc, int Sf, int xe, int de, int hidden, int c,
                          const float* w0, const float* wx, const float* wd, const float* whh,
                          const float* b, const float* g, const float* beta,
                          const float* w_dens, const float* b_dens, const float* w_col,
                          const float* b_col, const float* tcw, float* fout, float* scratch,
                          float* wide, void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  return run<false>(xf, d, t_c, t_f, dens_c, col_c, dnorm, out, R, Sc, Sf, hidden, w, tcw, fout,
                    scratch, wide, stream);
}

// The same in compute_dtype bfloat16: xf, d and tcw are bfloat16.
extern "C" int union_eval_bf16(const void* xf, const void* d, const float* t_c,
                               const float* t_f, const float* dens_c, const float* col_c,
                               const float* dnorm, float* out, int R, int Sc, int Sf, int xe,
                               int de, int hidden, int c, const float* w0, const float* wx,
                               const float* wd, const float* whh, const float* b,
                               const float* g, const float* beta, const float* w_dens,
                               const float* b_dens, const float* w_col, const float* b_col,
                               const void* tcw, float* fout, float* scratch, float* wide,
                               void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  return run<true>(xf, d, t_c, t_f, dens_c, col_c, dnorm, out, R, Sc, Sf, hidden, w, tcw, fout,
                   scratch, wide, stream);
}

// The blocks union_eval launches over R rays of Sf fine samples: the
// tiles of its wide scratch past hidden 256.
extern "C" int union_eval_blocks(int R, int Sf) { return num_blocks(R, Sf); }
