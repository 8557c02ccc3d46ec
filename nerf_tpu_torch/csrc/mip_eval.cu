// K7: the forward-only mip render.  MLP forward on R rays x n interval rows
// of IPE features, alpha compositing, rgb (optional white background),
// depth = sum w t_mid, acc, and the log-space segmentation composite over
// every class, seg_c = logsumexp_i(log(w_i + 1e-10) + log_softmax(seg_i)_c)
// -> per ray [rgb (C), seg (K), depth, acc].
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mip_train.py::
// _mip_eval_kernel (pallas_call in mip_eval_pallas), which keeps the chain
// in VMEM, runs the per-ray sums as segmented shift ladders and writes its
// per-ray results to every row of the ray.
//
// Bound: operations.  300,544 multiply-adds per row at the full-width model
// (H = 256, F = 96, 5 layers, O = 54; 256 F + 275,968 at other feature
// widths): a 4000-ray tile of 63 rows is 1.515e11 FLOP, 2.261 ms at the
// float32 SIMT rate (67 TFLOP/s), 0.918 ms as three TF32 products on the
// tensor cores (FLOP / 165 TFLOP/s); its bytes (384 per row of features,
// 12 of distance and midpoint, 220 per ray of output) take under 0.1 ms.
//
// Design: the mip forward (mip_mlp.cuh, MipTc: every hidden and feature
// product as 3xTF32 wgmma on the forward images the wrapper builds once a
// frame, mip_fwd_tc_kernel, one block an SM, the features streamed through
// the tile at every width; LayerNorm and the head float32) writes the
// head's outputs [R*n][O] to a scratch buffer (0.1 ms of traffic each way
// at this shape), then one warp per ray composites: the transmittances as
// a warp scan (ray_transmittance), rgb, depth and acc by runs of rows per
// lane, each row's log-sum-exp over the classes by the lane that owns the
// row, and then the classes across the lanes, each lane a class, with the
// max and the exp-sum over the rows in two passes.  A ray's 4 n floats of
// scratch sit in device memory (ray_scratch, from the wrapper), so a ray
// may hold any number of rows.
//
// mip_eval_bf16 is the same in compute_dtype bfloat16 (MipTcBf16, tc_mlp.cuh
// note 10): bfloat16 features and images, every product and the head on
// bf16 operands with float32 sums; the compositing float32.  Its bound at
// a 4000-ray tile of 63 rows: 0.153 ms of bf16 tensor-core operations
// (FLOP / 989 TFLOP/s).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "mip_mlp.cuh"

namespace {

using namespace nerf_mlp;

// out [R*n][O] is the MLP output; per_ray [R][C + K + 2].  Scratch: 4 n
// floats a ray, ray r's at scratch + 4 n r.
__global__ void __launch_bounds__(kThreads)
    mip_eval_rays_kernel(const float* __restrict__ out, const float* __restrict__ dists,
                         const float* __restrict__ t_mids, const float* __restrict__ noise,
                         int R, int n, int C, int O, int white, float* __restrict__ per_ray,
                         float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  const int K = O - 1 - C;
  const size_t base = static_cast<size_t>(ray) * n;
  const float* o = out + base * O;
  float* al = scratch + 4 * base;  // alpha
  float* tr = al + n;                  // transmittance
  float* lw = tr + n;                  // log(w + 1e-10)
  float* lse = lw + n;                 // log-sum-exp of the row's class logits
  ray_transmittance(
      n, al, tr,
      [&](int p) { return o[p * O] + (noise != nullptr ? noise[base + p] : 0.f); },
      [&](int p) { return dists[base + p]; });

  const int begin = min(n, lane * ray_run_len(n)), end = min(n, begin + ray_run_len(n));
  const int width = C + K + 2;
  float* res = per_ray + static_cast<size_t>(ray) * width;
  // The colours a chunk of kColorChunk at a time; the first chunk's walk
  // also takes acc, depth and each row's log-sum-exp.
  float acc = 0.f, depth = 0.f;
  int ch0 = 0;
  do {
    float rgb[kColorChunk];
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) rgb[ch] = 0.f;
    for (int p = begin; p < end; ++p) {
      const float wgt = (1.f - al[p]) * tr[p];
      const float* row = o + p * O;
#pragma unroll
      for (int ch = 0; ch < kColorChunk; ++ch)
        if (ch0 + ch < C) rgb[ch] = fmaf(wgt, sigmoid(row[1 + ch0 + ch]), rgb[ch]);
      if (ch0 == 0) {
        acc += wgt;
        depth = fmaf(wgt, t_mids[base + p], depth);
        const float* s = row + 1 + C;
        float mx = s[0];
        for (int k = 1; k < K; ++k) mx = fmaxf(mx, s[k]);
        float se = 0.f;
        for (int k = 0; k < K; ++k) se += expf(s[k] - mx);
        lse[p] = mx + logf(se);
        lw[p] = logf(wgt + 1e-10f);
      }
    }
    if (ch0 == 0) {
      acc = warp_sum(acc);
      depth = warp_sum(depth);
    }
#pragma unroll
    for (int ch = 0; ch < kColorChunk; ++ch) {
      if (ch0 + ch < C) {
        const float v = warp_sum(rgb[ch]) + (white ? 1.f - acc : 0.f);
        if (lane == 0) res[ch0 + ch] = v;
      }
    }
    ch0 += kColorChunk;
  } while (ch0 < C);
  if (lane == 0) {
    res[C + K] = depth;
    res[C + K + 1] = acc;
  }
  __syncwarp();
  // Each lane a class: z_i = log(w_i + 1e-10) + (seg_ic - lse_i), then
  // max_i z_i + log(sum_i exp(z_i - max)).
  for (int k = lane; k < K; k += 32) {
    const float* s = o + 1 + C + k;
    float m = -3.0e38f;
    for (int p = 0; p < n; ++p) m = fmaxf(m, lw[p] + (s[p * O] - lse[p]));
    float se = 0.f;
    for (int p = 0; p < n; ++p) se += expf(lw[p] + (s[p * O] - lse[p]) - m);
    res[C + k] = m + logf(se);
  }
}

template <int H, class Products>
cudaError_t run(const MipWeights& w, const void* x, const float* dists, const float* t_mids,
                const float* noise, int R, int n, int C, int white, float* per_ray,
                float* mlp_out, float* ray_scratch, const float* tc_fwd, float* wide,
                cudaStream_t stream) {
  const cudaError_t err = Products::template fwd<H, false>(w, x, mlp_out, R * n, nullptr, nullptr,
                                                           tc_fwd, wide, stream);
  if (err != cudaSuccess) return err;
  mip_eval_rays_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      mlp_out, dists, t_mids, noise, R, n, C, w.O, white, per_ray, ray_scratch);
  return cudaGetLastError();
}

template <class Products>
int run_at(const void* x, const float* dists, const float* t_mids, const float* noise,
           float* per_ray, int R, int n, int F, int hidden, int L, int C, int O, int white,
           const float* w_in, const float* whh, const float* b, const float* g,
           const float* beta, const float* w_out, const float* b_out, float* mlp_out,
           float* ray_scratch, const void* tc_fwd, float* wide, void* stream) {
  if (L < 2 || C < 1 || O < C + 2) return cudaErrorInvalidValue;
  const MipWeights w = sized(MipWeights{w_in, whh, b, g, beta, w_out, b_out, F, L, O}, hidden);
  const float* img = static_cast<const float*>(tc_fwd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                      \
  static_cast<int>(run<H, Products>(w, x, dists, t_mids, noise, R, n, C, white, per_ray,    \
                                    mlp_out, ray_scratch, img, wide, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int mip_eval(const float* x, const float* dists, const float* t_mids,
                        const float* noise, float* per_ray, int R, int n, int F, int hidden,
                        int L, int C, int O, int white, const float* w_in, const float* whh,
                        const float* b, const float* g, const float* beta, const float* w_out,
                        const float* b_out, float* mlp_out, float* ray_scratch,
                        const float* tc_fwd, float* wide, void* stream) {
  return run_at<MipTc>(x, dists, t_mids, noise, per_ray, R, n, F, hidden, L, C, O, white, w_in,
                       whh, b, g, beta, w_out, b_out, mlp_out, ray_scratch, tc_fwd, wide, stream);
}

// The same in compute_dtype bfloat16: x and tc_fwd are bfloat16.
extern "C" int mip_eval_bf16(const void* x, const float* dists, const float* t_mids,
                             const float* noise, float* per_ray, int R, int n, int F,
                             int hidden, int L, int C, int O, int white, const float* w_in,
                             const float* whh, const float* b, const float* g,
                             const float* beta, const float* w_out, const float* b_out,
                             float* mlp_out, float* ray_scratch, const void* tc_fwd,
                             float* wide, void* stream) {
  return run_at<MipTcBf16>(x, dists, t_mids, noise, per_ray, R, n, F, hidden, L, C, O, white,
                           w_in, whh, b, g, beta, w_out, b_out, mlp_out, ray_scratch, tc_fwd,
                           wide, stream);
}

