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
// (t, density, c logits) are (2 + c) x 4 bytes per coarse sample.
//
// Design.  A block (8 warps) owns whole rays, 256 / Sf of them (at least
// one).  It runs the shared MLP (classic_mlp.cuh) over the block's fine
// rows in 64-row sub-tiles, broadcasting each ray's view encoding to its
// rows, and keeps only [density, color logits] per fine row in shared
// memory.  Then one warp per ray:
//   1. merges the sorted coarse and fine t lists by rank (binary search in
//      the other list; a coarse sample tied with a fine one comes first);
//   2. takes each merged sample's interval to its successor, times ||d||,
//      with the 1e10 far pad on the last, and alpha = exp(-relu(sigma) dist);
//   3. runs the exclusive sum of log(alpha + 1e-10) in merged order in fp32
//      (each lane sums a contiguous run, a warp scan joins the runs), and
//      accumulates w = (1 - alpha) exp(prefix) into rgb, depth and acc.
// The activation buffer of the MLP phase is reused as the compositing
// scratch (4 arrays of Sc + Sf per warp).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "classic_mlp.cuh"

namespace {

using namespace nerf_mlp;

constexpr int kMaxColors = 8;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Composite one ray with the calling warp; fo is the ray's [Sf][1 + c]
// block of fine MLP outputs, scratch is this warp's 4 (Sc + Sf) floats.
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

  float rgb[kMaxColors];
#pragma unroll
  for (int ch = 0; ch < kMaxColors; ++ch) rgb[ch] = 0.f;
  float depth = 0.f, acc = 0.f;
  for (int p = begin; p < end; ++p) {
    const float wgt = om[p] * expf(prefix);
    prefix += la[p];
    const int s = src[p];
    const float* logits = s < Sc ? col_c + (static_cast<size_t>(ray) * Sc + s) * c
                                 : fo + (s - Sc) * ld + 1;
#pragma unroll
    for (int ch = 0; ch < kMaxColors; ++ch)
      if (ch < c) rgb[ch] = fmaf(wgt, sigmoid(logits[ch]), rgb[ch]);
    depth = fmaf(wgt, mt[p], depth);
    acc += wgt;
  }
  float* o = out + static_cast<size_t>(ray) * (c + 2);
#pragma unroll
  for (int ch = 0; ch < kMaxColors; ++ch) {
    if (ch < c) {
      const float v = warp_sum(rgb[ch]);
      if (lane == 0) o[ch] = v;
    }
  }
  depth = warp_sum(depth);
  acc = warp_sum(acc);
  if (lane == 0) {
    o[c] = depth;
    o[c + 1] = acc;
  }
  __syncwarp();
}

template <int H>
__host__ __device__ inline size_t scratch_floats(int Sc, int Sf) {
  const size_t act = static_cast<size_t>(kTileRows) * H;
  const size_t comp = static_cast<size_t>(kWarps) * 4 * (Sc + Sf);
  return act > comp ? act : comp;
}

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    union_eval_kernel(Weights w, const float* __restrict__ xf, const float* __restrict__ d,
                      const float* __restrict__ t_c, const float* __restrict__ t_f,
                      const float* __restrict__ dens_c, const float* __restrict__ col_c,
                      const float* __restrict__ dnorm, float* __restrict__ out, int R, int Sc,
                      int Sf, int rays_per_block) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);  // MLP activations, then scratch
  float* wbuf = act + scratch_floats<H>(Sc, Sf);
  float* xs = wbuf + kChunk * H;
  float* ds = xs + kTileRows * round_up4(w.xe);
  float* fout = ds + kTileRows * round_up4(w.de);  // [rays_per_block * Sf][1 + c]
  const int ld = 1 + w.c;
  const int ray0 = blockIdx.x * rays_per_block;
  const int nrays = min(rays_per_block, R - ray0);
  const int rows = nrays * Sf;
  const size_t frow0 = static_cast<size_t>(ray0) * Sf;

  for (int sub = 0; sub < rows; sub += kTileRows) {
    const int nvalid = min(kTileRows, rows - sub);
    load_tile(xs, xf, frow0 + sub, nvalid, w.xe, 1);
    if (w.wd != nullptr) load_tile(ds, d, frow0 + sub, nvalid, w.de, Sf);
    __syncthreads();
    mlp_tile<H>(w, xs, ds, act, wbuf, fout + sub * ld, ld, nvalid);
    __syncthreads();
  }

  const int warp = threadIdx.x >> 5;
  float* scratch = act + warp * 4 * (Sc + Sf);
  for (int i = warp; i < nrays; i += kWarps) {
    const int ray = ray0 + i;
    composite_ray(ray, Sc, Sf, w.c, t_c, t_f, dens_c, col_c, __ldg(dnorm + ray),
                  fout + i * Sf * ld, scratch, out);
  }
}

template <int H>
cudaError_t launch(const Weights& w, const float* xf, const float* d, const float* t_c,
                   const float* t_f, const float* dens_c, const float* col_c,
                   const float* dnorm, float* out, int R, int Sc, int Sf,
                   cudaStream_t stream) {
  const int rays_per_block = Sf >= 256 ? 1 : 256 / Sf;
  const size_t smem = (scratch_floats<H>(Sc, Sf) + mlp_side_floats<H>(w.xe, w.wd ? w.de : 0) +
                       static_cast<size_t>(rays_per_block) * Sf * (1 + w.c)) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      union_eval_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (R + rays_per_block - 1) / rays_per_block;
  union_eval_kernel<H><<<blocks, kThreads, smem, stream>>>(w, xf, d, t_c, t_f, dens_c, col_c,
                                                          dnorm, out, R, Sc, Sf,
                                                          rays_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int union_eval(const float* xf, const float* d, const float* t_c, const float* t_f,
                          const float* dens_c, const float* col_c, const float* dnorm,
                          float* out, int R, int Sc, int Sf, int xe, int de, int hidden, int c,
                          const float* w0, const float* wx, const float* wd, const float* whh,
                          const float* b, const float* g, const float* beta,
                          const float* w_dens, const float* b_dens, const float* w_col,
                          const float* b_col, void* stream) {
  if (c > kMaxColors) return cudaErrorInvalidValue;
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(launch<H>(w, xf, d, t_c, t_f, dens_c, col_c, dnorm, out, R, Sc, Sf, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
