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
// above the card's ridge.  At 131,072 points the operations bound is
// 7.404 ms at the float32 SIMT rate (67 TFLOP/s), 3.006 ms as three TF32
// products on the tensor cores (FLOP / 165 TFLOP/s).
//
// Design (classic_mlp_train.cuh): the recomputed forward stores the chain
// (xhat and LayerNorm statistics) to global scratch, a per-tile backward
// writes every layer's dpre and the tile's column sums, a product over the
// points gives dW in split chunks, and fixed-order sums of the partials
// make the gradients repeatable.  The three passes are K2's tensor-core
// ones (tc_mlp.cuh's TcProducts: 3xTF32 wgmma on the operand images the
// wrapper builds, the encodings streamed through the forward tile at every
// width), whose bwd_rows also writes the encodings' cotangents dx and dd
// where they are asked for (tc_input_grad; dx and dd null where autograd
// asks for none, as on the reuse step).
//
// classic_mlp_bwd_bf16 is the same in compute_dtype bfloat16 (tc_mlp.cuh,
// note 10): bf16 encodings, the passes of TcProductsBf16, the encodings'
// cotangents written as bfloat16, the encodings' dtype.  Its bound at
// 131,072 rows: 0.501 ms of bf16 tensor-core operations (FLOP / 989
// TFLOP/s); the float32 chain (xhat and dpre, 10,240 bytes a row written
// and read) takes 0.80 ms at 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <int H>
cudaError_t run(const Weights& w, const float* x, const float* d, const float* gout,
                float* dx, float* dd, float* grads, float* out, int P, const Scratch& s,
                cudaStream_t stream) {
  cudaError_t err = launch_fwd_store_with<H, TcProducts>(
      w, TileLoad{x, d, 1}, out, P, s, stream, static_cast<size_t>(P), 0);
  if (err != cudaSuccess) return err;
  return launch_mlp_backward<H, TcProducts>(w, x, d, 1, gout, P, s, dx, dd, grads, stream);
}

// compute_dtype bfloat16: x, d, dx and dd bfloat16.
template <int H>
cudaError_t run_bf16(const Weights& w, const void* x, const void* d, const float* gout,
                     void* dx, void* dd, float* grads, float* out, int P, const Scratch& s,
                     cudaStream_t stream) {
  using T = __nv_bfloat16;
  cudaError_t err = launch_fwd_store_with<H, TcProductsBf16>(
      w, TileLoadT<T>{static_cast<const T*>(x), static_cast<const T*>(d), 1}, out, P, s, stream,
      static_cast<size_t>(P), 0);
  if (err != cudaSuccess) return err;
  return launch_mlp_backward<H, TcProductsBf16>(w, x, d, 1, gout, P, s, dx, dd, grads, stream);
}

}  // namespace

extern "C" int classic_mlp_bwd(const float* x, const float* d, const float* gout, float* dx,
                               float* dd, float* grads, int P, int xe, int de, int hidden,
                               int c, const float* w0, const float* wx, const float* wd,
                               const float* whh, const float* b, const float* g,
                               const float* beta, const float* w_dens, const float* b_dens,
                               const float* w_col, const float* b_col, float* xhat,
                               float* stats, float* dpre, float* wpart, float* tpart,
                               float* tmp, float* out, int splits,
                               const float* tc_fwd, const float* tc_bwd, void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat, stats, dpre, wpart, tpart, tmp, splits, tc_fwd, tc_bwd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(run<H>(w, x, d, gout, dx, dd, grads, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

// The same in compute_dtype bfloat16: x, d, dx, dd and both images are
// bfloat16.
extern "C" int classic_mlp_bwd_bf16(const void* x, const void* d, const float* gout, void* dx,
                                    void* dd, float* grads, int P, int xe, int de, int hidden,
                                    int c, const float* w0, const float* wx, const float* wd,
                                    const float* whh, const float* b, const float* g,
                                    const float* beta, const float* w_dens,
                                    const float* b_dens, const float* w_col,
                                    const float* b_col, float* xhat, float* stats, float* dpre,
                                    float* wpart, float* tpart, float* tmp,
                                    float* out, int splits, const void* tc_fwd,
                                    const void* tc_bwd, void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(run_bf16<H>(w, x, d, gout, dx, dd, grads, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
