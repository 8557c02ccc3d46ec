// K2: the coarse-only classic train objective with its gradients.  MLP
// forward on R rays x S samples, density noise, alpha compositing, sigmoid
// colour (optional white background), the stage-weighted MSE against the
// ray's pixel, the compositing backward and the MLP backward -> (loss,
// gradient of every packed weight[, compositing weights [R, S]]).
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_train.py::_train_kernel
// with _compositing_fwd_bwd (pallas_call in classic_train_grads_pallas),
// which keeps the chain in VMEM and runs the per-ray sums as shift
// ladders.
//
// Bound: operations.  Forward + dh + dW = 3 x 630,784 multiply-adds per
// point at the full-width model (no recompute: the forward stores its
// chain), 14.8 ms at 4096 x 64 points at 67 TFLOP/s; the bytes (the
// encodings, 384 per point, and 2.55 MB of gradients) take well under
// 1 ms.
//
// Design: the MLP passes of classic_mlp_train.cuh, with one compositing
// pass between forward and backward: one warp per ray, each lane a run of
// consecutive samples; the exclusive prefix of log(alpha + 1e-10) and the
// exclusive suffix of the transmittance cotangent are warp scans in fp32.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "classic_mlp_train.cuh"

namespace {

using namespace nerf_mlp;

// Forward and backward of the compositing and the loss (composite_ray),
// one ray per warp.  out [R*S][1 + c] is the MLP output; gout receives its
// cotangent.  ray_loss[ray] = loss_scale * mean_c(err^2).  Scratch: 3 S
// floats per warp.
__global__ void __launch_bounds__(kThreads)
    composite_kernel(const float* __restrict__ out, const float* __restrict__ dists,
                     const float* __restrict__ noise, const float* __restrict__ pix, int R,
                     int S, int c, int white, float g_scale, float loss_scale,
                     float* __restrict__ gout, float* __restrict__ ray_loss,
                     float* __restrict__ weights_out) {
  extern __shared__ float scratch[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  const int ld = 1 + c;
  const size_t base = static_cast<size_t>(ray) * S;
  const float* o = out + base * ld;
  float* g = gout + base * ld;
  const float loss = composite_ray(
      S, c, white ? 1.f : 0.f, pix + static_cast<size_t>(ray) * c, g_scale, loss_scale,
      scratch + warp * 3 * S,
      [&](int p) { return o[p * ld] + noise[base + p]; },
      [&](int p, int ch) { return o[p * ld + 1 + ch]; },
      [&](int p) { return dists[base + p]; },
      [&](int p, float wgt) {
        if (weights_out != nullptr) weights_out[base + p] = wgt;
      },
      [&](int p, int ch, float gl) { g[p * ld + 1 + ch] = gl; },
      [&](int p, float gs) { g[p * ld] = gs; });
  if (lane == 0) ray_loss[ray] = loss;
}

template <int H>
cudaError_t run(const Weights& w, const float* x, const float* d, const float* dists,
                const float* noise, const float* pix, int R, int S, int white, float g_scale,
                float loss_scale, float* weights_out, float* out, float* gout,
                float* ray_loss, float* loss, float* grads, const Scratch& s,
                cudaStream_t stream) {
  const int P = R * S;
  cudaError_t err = launch_fwd_store<H>(w, x, d, 1, out, P, s, stream);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(kWarps) * 3 * S * sizeof(float);
  err = cudaFuncSetAttribute(composite_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  composite_kernel<<<(R + kWarps - 1) / kWarps, kThreads, smem, stream>>>(
      out, dists, noise, pix, R, S, w.c, white, g_scale, loss_scale, gout, ray_loss,
      weights_out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum(ray_loss, R, 1, loss, s.tmp, stream)) != cudaSuccess) return err;
  return launch_mlp_backward<H>(w, x, d, 1, gout, P, s, nullptr, nullptr, grads, stream);
}

}  // namespace

extern "C" int train_grads(const float* x, const float* d, const float* dists,
                           const float* noise, const float* pix, float* loss, float* grads,
                           float* weights_out, int R, int S, int xe, int de, int hidden, int c,
                           int white, float loss_weight, const float* w0, const float* wx,
                           const float* wd, const float* whh, const float* b, const float* g,
                           const float* beta, const float* w_dens, const float* b_dens,
                           const float* w_col, const float* b_col, float* xhat, float* stats,
                           float* dpre, float* wpart, float* tpart, float* tmp, float* wt,
                           float* out, float* gout, float* ray_loss, int splits,
                           void* stream) {
  if (c > kMaxColors || c < 1) return cudaErrorInvalidValue;
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  const Scratch s{xhat, stats, dpre, wpart, tpart, tmp, wt, splits};
  const float g_scale = loss_weight * 2.f / (static_cast<float>(c) * R);
  const float loss_scale = loss_weight / R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                     \
  static_cast<int>(run<H>(w, x, d, dists, noise, pix, R, S, white, g_scale, loss_scale,  \
                          weights_out, out, gout, ray_loss, loss, grads, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
