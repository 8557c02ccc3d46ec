// K1-bwd: the backward of the classic NeRF point MLP.  Given the encoded
// inputs x [P, xe] (+ d [P, de]) and the output cotangents g_out
// [P, 1 + c], returns dx, dd and the gradient of every packed weight,
// summed over the points.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mlp.py::_bwd_kernel
// (pallas_call in _fused_bwd_rule, the custom-VJP backward of
// classic_mlp_pallas), which recomputes the forward per tile in VMEM and
// accumulates the weight gradients across its sequential grid.
//
// Bound: operations.  The forward ran in another kernel (K1-fwd), so this
// one recomputes it: forward + dh + dW = 3 x 630,784 multiply-adds per
// point at the full-width model (H = 256, xe = 60, de = 36), against 384
// bytes of input, 400 of output per point and 2.55 MB of gradients: far
// above the card's fp32 ridge.  At 131,072 points the operations bound is
// 7.4 ms at 67 TFLOP/s.  Plain fp32 FMA, no TF32.
//
// Design (classic_mlp_train.cuh): the recomputed forward stores the chain
// (xhat and LayerNorm statistics) to global scratch, a per-tile backward
// writes every layer's dpre and the tile's column sums, a hand-written
// product over the points gives dW in split chunks, and fixed-order sums
// of the partials make the gradients repeatable.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "classic_mlp_train.cuh"

namespace {

using namespace nerf_mlp;

template <int H>
cudaError_t run(const Weights& w, const float* x, const float* d, const float* gout,
                float* dx, float* dd, float* grads, float* out, int P, const Scratch& s,
                cudaStream_t stream) {
  cudaError_t err = launch_fwd_store<H>(w, x, d, 1, out, P, s, stream);
  if (err != cudaSuccess) return err;
  return launch_mlp_backward<H>(w, x, d, 1, gout, P, s, dx, dd, grads, stream);
}

}  // namespace

extern "C" int classic_mlp_bwd(const float* x, const float* d, const float* gout, float* dx,
                               float* dd, float* grads, int P, int xe, int de, int hidden,
                               int c, const float* w0, const float* wx, const float* wd,
                               const float* whh, const float* b, const float* g,
                               const float* beta, const float* w_dens, const float* b_dens,
                               const float* w_col, const float* b_col, float* xhat,
                               float* stats, float* dpre, float* wpart, float* tpart,
                               float* tmp, float* wt, float* out, int splits, void* stream) {
  if (c > kMaxColors) return cudaErrorInvalidValue;
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  const Scratch s{xhat, stats, dpre, wpart, tpart, tmp, wt, splits};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(run<H>(w, x, d, gout, dx, dd, grads, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
