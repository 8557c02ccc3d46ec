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
// recompute), 14.808 ms at 2048 x 128 fine samples at the float32 SIMT
// rate (67 TFLOP/s), 6.013 ms as three TF32 products at 495 TFLOP/s; the
// compositing is O(Sc + Sf) per ray.
//
// Design: the MLP passes of classic_mlp_train.cuh on the fine rows (the
// per-ray view encoding is read once per ray, d_div = Sf, also by wgrad's
// row function) with the tensor-core product policy of tc_mlp.cuh
// (TcProducts: fwd_store, bwd_rows and wgrad as 3xTF32 wgmma on the
// operand images the wrapper builds once per call, at every encoding
// width: tc_mlp.cuh note 9), with one compositing pass between forward and
// backward: one warp per ray merges
// the two sorted t lists by rank and scans them in fp32, then scatters the
// cotangents back to the coarse slots and the fine rows
// (union_train.cuh, shared with K9), its scratch a ray's 5 (Sc + Sf)
// floats of ray_scratch in device memory, so every sample count runs.
//
// fine_stage_train_bf16 is the same in compute_dtype bfloat16 (tc_mlp.cuh,
// note 10: TcProductsBf16, bf16 fine and per-ray view encodings read from
// device memory, the union pass, loss, gradients and coarse cotangents
// float32).  Its bound at 2048 x 128: 1.003 ms of bf16 tensor-core
// operations (FLOP / 989 TFLOP/s) against 3.2 ms of bytes, the float32
// chain (xhat and dpre, 10,240 bytes a row written once and read once) at
// 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"
#include "union_train.cuh"

namespace {

using namespace nerf_mlp;

template <int H, bool kBf16>
cudaError_t run(const Weights& w, const void* xf, const void* d, const float* t_c,
                const float* t_f, const float* dens_c, const float* col_c, const float* dnorm,
                const float* noise_f, const float* pix, int R, int Sc, int Sf, int white,
                float g_scale, float loss_scale, float* out, float* gout, float* ray_loss,
                float* loss, float* grads, float* g_dens_c, float* g_col_c, float* ray_scratch,
                const Scratch& s, cudaStream_t stream) {
  using T = enc_t<kBf16>;
  using Products = TcProductsT<kBf16>;
  const int P = R * Sf;
  cudaError_t err = launch_fwd_store_with<H, Products>(
      w, TileLoadT<T>{static_cast<const T*>(xf), static_cast<const T*>(d), Sf}, out, P, s,
      stream, static_cast<size_t>(P), 0);
  if (err != cudaSuccess) return err;
  union_composite_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      out, noise_f, t_c, t_f, UnionCoarse{dens_c, nullptr, col_c, g_dens_c, g_col_c, 1, w.c, 0},
      dnorm, pix, R, Sc, Sf, w.c, white, g_scale, loss_scale, gout, ray_loss, ray_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum(ray_loss, R, 1, loss, s.tmp, stream)) != cudaSuccess) return err;
  return launch_mlp_backward<H, Products>(w, xf, d, Sf, gout, P, s, nullptr, nullptr, grads,
                                         stream);
}

template <bool kBf16>
int entry(const void* xf, const void* d, const float* t_c, const float* t_f,
          const float* dens_c, const float* col_c, const float* dnorm, const float* noise_f,
          const float* pix, float* loss, float* grads, float* g_dens_c, float* g_col_c, int R,
          int Sc, int Sf, int xe, int de, int hidden, int c, int white, float loss_weight,
          const float* w0, const float* wx, const float* wd, const float* whh, const float* b,
          const float* g, const float* beta, const float* w_dens, const float* b_dens,
          const float* w_col, const float* b_col, float* xhat, float* stats, float* dpre,
          float* wpart, float* tpart, float* tmp, float* out, float* gout,
          float* ray_loss, float* ray_scratch, int splits, const void* tc_fwd,
          const void* tc_bwd, void* stream) {
  if (c < 1 || ray_scratch == nullptr) return cudaErrorInvalidValue;
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  const float g_scale = loss_weight * 2.f / (static_cast<float>(c) * R);
  const float loss_scale = loss_weight / R;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                    \
  static_cast<int>(run<H, kBf16>(w, xf, d, t_c, t_f, dens_c, col_c, dnorm, noise_f, pix, R, \
                                 Sc, Sf, white, g_scale, loss_scale, out, gout, ray_loss,  \
                                 loss, grads, g_dens_c, g_col_c, ray_scratch, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
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
                                float* tpart, float* tmp, float* out, float* gout,
                                float* ray_loss, float* ray_scratch, int splits,
                                const float* tc_fwd,
                                const float* tc_bwd, void* stream) {
  return entry<false>(xf, d, t_c, t_f, dens_c, col_c, dnorm, noise_f, pix, loss, grads,
                      g_dens_c, g_col_c, R, Sc, Sf, xe, de, hidden, c, white, loss_weight, w0,
                      wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat, stats, dpre,
                      wpart, tpart, tmp, out, gout, ray_loss, ray_scratch, splits, tc_fwd, tc_bwd,
                      stream);
}

// The same in compute_dtype bfloat16: xf, d and both images are bfloat16.
extern "C" int fine_stage_train_bf16(
    const void* xf, const void* d, const float* t_c, const float* t_f, const float* dens_c,
    const float* col_c, const float* dnorm, const float* noise_f, const float* pix, float* loss,
    float* grads, float* g_dens_c, float* g_col_c, int R, int Sc, int Sf, int xe, int de,
    int hidden, int c, int white, float loss_weight, const float* w0, const float* wx,
    const float* wd, const float* whh, const float* b, const float* g, const float* beta,
    const float* w_dens, const float* b_dens, const float* w_col, const float* b_col,
    float* xhat, float* stats, float* dpre, float* wpart, float* tpart, float* tmp,
    float* out, float* gout, float* ray_loss, float* ray_scratch, int splits, const void* tc_fwd,
    const void* tc_bwd, void* stream) {
  return entry<true>(xf, d, t_c, t_f, dens_c, col_c, dnorm, noise_f, pix, loss, grads,
                     g_dens_c, g_col_c, R, Sc, Sf, xe, de, hidden, c, white, loss_weight, w0, wx,
                     wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat, stats, dpre, wpart,
                     tpart, tmp, out, gout, ray_loss, ray_scratch, splits, tc_fwd, tc_bwd, stream);
}
