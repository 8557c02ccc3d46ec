// K3: the fine stage of the hierarchical-reuse train objective with its
// gradients.  The fine MLP on the new fine samples, density noise, the
// union of the reused (noised) coarse outputs and the fine ones
// composited in t order, the fine-stage MSE, the compositing backward and
// the MLP backward -> (loss, gradient of every packed weight, and the
// cotangents g_dens_c [R, Sc], g_col_c [R, Sc, c] of the coarse inputs).
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_hier.py::_hier_kernel
// (pallas_call in fine_stage_train_pallas).  The TPU kernel avoids sorting
// with O(Sc*Sf) masked sums, Dekker-split matmuls and lane-layout ladders;
// here one warp per ray merges the two sorted t lists by rank, as K4 does
// (union_eval.cu), and scans them in fp32.
//
// Bound: operations.  Forward + dh + dW = 3 x 630,784 multiply-adds per
// fine sample at the full-width model (the forward stores its chain, no
// recompute), 14.8 ms at 2048 x 128 fine samples at 67 TFLOP/s; the
// compositing is O(Sc + Sf) per ray.
//
// Design: the MLP passes of classic_mlp_train.cuh on the fine rows (the
// per-ray view encoding is read once per ray, d_div = Sf), with one
// compositing pass between forward and backward.  Per ray and warp:
//   1. merge the sorted coarse and fine lists by rank (a coarse sample
//      tied with a fine one comes first);
//   2. each merged sample's interval to its successor times ||d|| (1e10
//      on the last), alpha = exp(-relu(sigma) dist);
//   3. the exclusive prefix of log(alpha + 1e-10) as a warp scan, the
//      weights, rgb and the loss;
//   4. backward: dL/dw, the exclusive suffix of w dL/dw, dL/dsigma with
//      relu' = (sigma > 0), and the colour cotangents, scattered back to
//      the coarse slots (g_dens_c, g_col_c) and the fine rows (the MLP's
//      output cotangent).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "classic_mlp_train.cuh"

namespace {

using namespace nerf_mlp;

// Steps 1-4 above for one ray per warp; the scan, loss and backward are
// composite_ray's.  Scratch: 5 (Sc + Sf) floats per warp.
__global__ void __launch_bounds__(kThreads)
    union_composite_kernel(const float* __restrict__ fo, const float* __restrict__ noise_f,
                           const float* __restrict__ t_c, const float* __restrict__ t_f,
                           const float* __restrict__ dens_c, const float* __restrict__ col_c,
                           const float* __restrict__ dnorm, const float* __restrict__ pix,
                           int R, int Sc, int Sf, int c, int white, float g_scale,
                           float loss_scale, float* __restrict__ gout,
                           float* __restrict__ g_dens_c, float* __restrict__ g_col_c,
                           float* __restrict__ ray_loss) {
  extern __shared__ float scratch[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  const int n = Sc + Sf, ld = 1 + c;
  float* mt = scratch + warp * 5 * n;         // merged t
  int* src = reinterpret_cast<int*>(mt + n);  // coarse i, or Sc + fine j
  const float* tc = t_c + static_cast<size_t>(ray) * Sc;
  const float* tf = t_f + static_cast<size_t>(ray) * Sf;
  const size_t cbase = static_cast<size_t>(ray) * Sc, fbase = static_cast<size_t>(ray) * Sf;
  const float dn = dnorm[ray];

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

  // Merged position p holds coarse sample s = src[p] < Sc, or fine sample
  // s - Sc.
  const float loss = composite_ray(
      n, c, white ? 1.f : 0.f, pix + static_cast<size_t>(ray) * c, g_scale, loss_scale,
      mt + 2 * n,
      [&](int p) {
        const int s = src[p];
        return s < Sc ? dens_c[cbase + s] : fo[(fbase + s - Sc) * ld] + noise_f[fbase + s - Sc];
      },
      [&](int p, int ch) {
        const int s = src[p];
        return s < Sc ? col_c[(cbase + s) * c + ch] : fo[(fbase + s - Sc) * ld + 1 + ch];
      },
      [&](int p) { return p + 1 < n ? (mt[p + 1] - mt[p]) * dn : 1e10f; },
      [](int, float) {},
      [&](int p, int ch, float gl) {
        const int s = src[p];
        if (s < Sc) g_col_c[(cbase + s) * c + ch] = gl;
        else gout[(fbase + s - Sc) * ld + 1 + ch] = gl;
      },
      [&](int p, float gs) {
        const int s = src[p];
        if (s < Sc) g_dens_c[cbase + s] = gs;
        else gout[(fbase + s - Sc) * ld] = gs;
      });
  if (lane == 0) ray_loss[ray] = loss;
}

template <int H>
cudaError_t run(const Weights& w, const float* xf, const float* d, const float* t_c,
                const float* t_f, const float* dens_c, const float* col_c, const float* dnorm,
                const float* noise_f, const float* pix, int R, int Sc, int Sf, int white,
                float g_scale, float loss_scale, float* out, float* gout, float* ray_loss,
                float* loss, float* grads, float* g_dens_c, float* g_col_c, const Scratch& s,
                cudaStream_t stream) {
  const int P = R * Sf;
  cudaError_t err = launch_fwd_store<H>(w, xf, d, Sf, out, P, s, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(kWarps) * 5 * (Sc + Sf) * sizeof(float);
  err = cudaFuncSetAttribute(union_composite_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  union_composite_kernel<<<(R + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      out, noise_f, t_c, t_f, dens_c, col_c, dnorm, pix, R, Sc, Sf, w.c, white, g_scale,
      loss_scale, gout, g_dens_c, g_col_c, ray_loss);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum(ray_loss, R, 1, loss, s.tmp, stream)) != cudaSuccess) return err;
  return launch_mlp_backward<H>(w, xf, d, Sf, gout, P, s, nullptr, nullptr, grads, stream);
}

}  // namespace

extern "C" int fine_stage_train(const float* xf, const float* d, const float* t_c,
                                const float* t_f, const float* dens_c, const float* col_c,
                                const float* dnorm, const float* noise_f, const float* pix,
                                float* loss, float* grads, float* g_dens_c, float* g_col_c,
                                int R, int Sc, int Sf, int xe, int de, int hidden, int c,
                                int white, float loss_weight, const float* w0, const float* wx,
                                const float* wd, const float* whh, const float* b,
                                const float* g, const float* beta, const float* w_dens,
                                const float* b_dens, const float* w_col, const float* b_col,
                                float* xhat, float* stats, float* dpre, float* wpart,
                                float* tpart, float* tmp, float* wt, float* out, float* gout,
                                float* ray_loss, int splits, void* stream) {
  if (c > kMaxColors || c < 1) return cudaErrorInvalidValue;
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  const Scratch s{xhat, stats, dpre, wpart, tpart, tmp, wt, splits};
  const float g_scale = loss_weight * 2.f / (static_cast<float>(c) * R);
  const float loss_scale = loss_weight / R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                        \
  static_cast<int>(run<H>(w, xf, d, t_c, t_f, dens_c, col_c, dnorm, noise_f, pix, R, Sc, Sf, \
                          white, g_scale, loss_scale, out, gout, ray_loss, loss, grads,      \
                          g_dens_c, g_col_c, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
