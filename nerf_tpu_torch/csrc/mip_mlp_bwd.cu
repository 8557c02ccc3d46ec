// K5-bwd: the backward of the HEAD (mip) NeRF point MLP.  Given the IPE
// features x [P, F] and the output cotangents g_out [P, O], returns dx
// (optional) and the gradient of every packed weight, summed over the
// points.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mip_mlp.py::_bwd_kernel
// (pallas_call in _bwd_rule, the custom-VJP backward of mip_mlp_pallas),
// which recomputes the forward per tile in VMEM and accumulates the weight
// gradients across its sequential grid.
//
// Bound: operations.  The forward ran in another kernel (K5-fwd), so this
// one recomputes it, as the TPU kernel does: forward + dh + dW = 3 x
// 300,544 multiply-adds per point at the full-width model (F = 96; 256 F +
// 275,968 each at hidden 256, 5 layers and 54 outputs), against 384 bytes
// of input, 216 of cotangents and 384 of dx per point and 1.2 MB of
// gradients.  At 258,048 points the operations bound is 6.945 ms at the
// float32 SIMT rate (67 TFLOP/s), 2.820 ms as three TF32 products on the
// tensor cores (FLOP / 165 TFLOP/s); the stored chain (xhat and dpre, 2 x
// 5 x 256 x 4 bytes per row written and read) adds about 2.6 GB, 0.8 ms at
// 3.35 TB/s.
//
// Design (mip_mlp.cuh on classic_mlp_train.cuh and tc_mlp.cuh): K6's
// tensor-core passes (MipTc: 3xTF32 wgmma on the operand images the wrapper
// builds).  The recomputed forward (mip_fwd_store_tc_kernel, the features
// streamed through the tile at every width) stores the chain to global
// scratch; a per-tile backward (mip_bwd_rows_tc_kernel) writes every
// layer's dpre and the tile's column sums and, where asked, the features'
// cotangent dx = dpre_0 w_in^T from the stored dpre (tc_input_grad); a
// product over the points gives dW in split chunks (wgrad_tc_kernel, in
// groups of kMaxProds products at any layer count); fixed-order sums of
// the partials make the gradients repeatable (no atomics).
//
// mip_mlp_bwd_bf16 is the same in compute_dtype bfloat16 (MipTcBf16,
// tc_mlp.cuh note 10): bfloat16 features and images, every product and the
// head's on bf16 operands with float32 sums, the features' cotangent
// written as bfloat16 (their dtype).  Its bound at 258,048 rows: 0.470 ms
// of bf16 tensor-core operations (FLOP / 989 TFLOP/s); the float32 chain
// (xhat and dpre, 10,240 bytes a row, written once and read once) takes
// 1.58 ms at 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "mip_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <int H, class Products>
cudaError_t run(const MipWeights& w, const void* x, const float* gout, void* dx, float* grads,
                float* out, int P, const Scratch& s, cudaStream_t stream) {
  cudaError_t err =
      Products::template fwd<H, true>(w, x, out, P, s.xhat, s.stats, s.tc_fwd, s.dpre, stream);
  if (err != cudaSuccess) return err;
  return launch_mip_backward<H, Products>(w, x, gout, P, s, dx, grads, stream);
}

template <class Products>
int run_at(const void* x, const float* gout, void* dx, float* grads, int P, int F, int hidden,
           int L, int O, const float* w_in, const float* whh, const float* b, const float* g,
           const float* beta, const float* w_out, const float* b_out, float* xhat,
           float* stats, float* dpre, float* wpart, float* tpart, float* tmp,
           float* out, int splits, const void* tc_fwd, const void* tc_bwd, void* stream) {
  if (L < 2 || O < 1) return cudaErrorInvalidValue;
  const MipWeights w = sized(MipWeights{w_in, whh, b, g, beta, w_out, b_out, F, L, O}, hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(run<H, Products>(w, x, gout, dx, grads, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int mip_mlp_bwd(const float* x, const float* gout, float* dx, float* grads, int P,
                           int F, int hidden, int L, int O, const float* w_in, const float* whh,
                           const float* b, const float* g, const float* beta,
                           const float* w_out, const float* b_out, float* xhat, float* stats,
                           float* dpre, float* wpart, float* tpart, float* tmp,
                           float* out, int splits, const float* tc_fwd, const float* tc_bwd,
                           void* stream) {
  return run_at<MipTc>(x, gout, dx, grads, P, F, hidden, L, O, w_in, whh, b, g, beta, w_out,
                       b_out, xhat, stats, dpre, wpart, tpart, tmp, out, splits, tc_fwd,
                       tc_bwd, stream);
}

// The same in compute_dtype bfloat16: x, dx and both images are bfloat16.
extern "C" int mip_mlp_bwd_bf16(const void* x, const float* gout, void* dx, float* grads,
                                int P, int F, int hidden, int L, int O, const float* w_in,
                                const float* whh, const float* b, const float* g,
                                const float* beta, const float* w_out, const float* b_out,
                                float* xhat, float* stats, float* dpre, float* wpart,
                                float* tpart, float* tmp, float* out, int splits,
                                const void* tc_fwd, const void* tc_bwd, void* stream) {
  return run_at<MipTcBf16>(x, gout, dx, grads, P, F, hidden, L, O, w_in, whh, b, g, beta,
                           w_out, b_out, xhat, stats, dpre, wpart, tpart, tmp, out, splits,
                           tc_fwd, tc_bwd, stream);
}

