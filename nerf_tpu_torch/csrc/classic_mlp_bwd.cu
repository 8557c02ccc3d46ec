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
// Bound: operations.  Under autograd the forward that stores the chain
// runs in the forward call (classic_mlp_fwd_store below, counted as K1-fwd:
// the same tile as fwd_store, its outputs the forward's), so this kernel
// starts from the stored xhat and statistics: dh + dW = 2 x 630,784
// multiply-adds per point at the full-width model (H = 256, xe = 60, de =
// 36), against 384 bytes of input, 400 of output per point and 2.55 MB of
// gradients: far above the card's ridge.  At 131,072 points the operations
// bound is 4.936 ms at the float32 SIMT rate (67 TFLOP/s), 1.962 ms as
// three TF32 products on the tensor cores (FLOP / 165 TFLOP/s); the
// float32 chain (xhat read, dpre written and read) adds its bytes, 0.80 ms
// at 3.35 TB/s.  A direct call without a stored chain (stored = 0) runs
// the forward first, as the JAX kernel recomputes it per tile in VMEM:
// 3 x 630,784 multiply-adds a point, 7.404 and 3.006 ms.
//
// Design (classic_mlp_train.cuh): the forward stores the chain (xhat and
// LayerNorm statistics) to global scratch, a per-tile backward writes
// every layer's dpre and the column sums, a product over the points gives
// dW in split chunks, and fixed-order sums of the partials make the
// gradients repeatable.  The three passes are K2's tensor-core ones
// (tc_mlp.cuh's TcProducts: 3xTF32 wgmma on the operand images the wrapper
// builds, the encodings streamed through the forward tile at every width),
// whose bwd_rows also writes the encodings' cotangents dx and dd where they
// are asked for (tc_input_grad; dx and dd null where autograd asks for
// none, as on the reuse step).  The stored chain and the recomputed one
// come from the same tile on the same inputs, so both routes give the same
// gradients bit for bit.
//
// classic_mlp_bwd_bf16 is the same in compute_dtype bfloat16 (tc_mlp.cuh,
// note 10): bf16 encodings, the passes of TcProductsBf16, the encodings'
// cotangents written as bfloat16, the encodings' dtype.  Its bound at
// 131,072 rows from a stored chain: 0.334 ms of bf16 tensor-core
// operations (FLOP / 989 TFLOP/s; 0.501 with the forward); the float32
// chain (xhat read, dpre written and read) takes 0.80 ms at 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

namespace {

using namespace nerf_mlp;

// The forward that stores the chain of the P rows into s (xhat, stats;
// past hidden 256 the tiles' rows in dpre) and the outputs to out.  kBf16:
// x and d bfloat16.
template <int H, bool kBf16>
cudaError_t store(const Weights& w, const void* x, const void* d, float* out, int P,
                  const Scratch& s, cudaStream_t stream) {
  using T = enc_t<kBf16>;
  return launch_fwd_store_with<H, TcProductsT<kBf16>>(
      w, TileLoadT<T>{static_cast<const T*>(x), static_cast<const T*>(d), 1}, out, P, s, stream,
      static_cast<size_t>(P), 0);
}

// The backward; with stored 0 the forward first.  kBf16: x, d, dx and dd
// bfloat16.
template <int H, bool kBf16>
cudaError_t run(const Weights& w, const void* x, const void* d, const float* gout, void* dx,
                void* dd, float* grads, float* out, int P, const Scratch& s, int stored,
                cudaStream_t stream) {
  if (!stored) {
    const cudaError_t err = store<H, kBf16>(w, x, d, out, P, s, stream);
    if (err != cudaSuccess) return err;
  }
  return launch_mlp_backward<H, TcProductsT<kBf16>>(w, x, d, 1, gout, P, s, dx, dd, grads,
                                                     stream);
}

}  // namespace

extern "C" int classic_mlp_bwd(const float* x, const float* d, const float* gout, float* dx,
                               float* dd, float* grads, int P, int xe, int de, int hidden,
                               int c, const float* w0, const float* wx, const float* wd,
                               const float* whh, const float* b, const float* g,
                               const float* beta, const float* w_dens, const float* b_dens,
                               const float* w_col, const float* b_col, float* xhat,
                               float* stats, float* dpre, float* wpart, float* tpart,
                               float* tmp, float* out, int splits, int stored,
                               const float* tc_fwd, const float* tc_bwd, void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat, stats, dpre, wpart, tpart, tmp, splits, tc_fwd, tc_bwd};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(run<H, false>(w, x, d, gout, dx, dd, grads, out, P, s, stored, st))
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
                                    float* out, int splits, int stored, const void* tc_fwd,
                                    const void* tc_bwd, void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(run<H, true>(w, x, d, gout, dx, dd, grads, out, P, s, stored, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

// The forward that keeps the chain for classic_mlp_bwd (stored = 1): out
// [P][1 + c], xhat [L][P][hp], stats [L][P][2] and, past hidden 256, the
// tiles' rows in dpre [L][P][hp] (layers 0 and 1, which bwd_rows overwrites
// later); tc_fwd the forward images.
extern "C" int classic_mlp_fwd_store(const float* x, const float* d, float* out, int P, int xe,
                                     int de, int hidden, int c, const float* w0,
                                     const float* wx, const float* wd, const float* whh,
                                     const float* b, const float* g, const float* beta,
                                     const float* w_dens, const float* b_dens,
                                     const float* w_col, const float* b_col, float* xhat,
                                     float* stats, float* dpre, const float* tc_fwd,
                                     void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat, stats, dpre, nullptr, nullptr, nullptr, 0, tc_fwd, nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(store<H, false>(w, x, d, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

// The same in compute_dtype bfloat16: x, d and tc_fwd bfloat16.
extern "C" int classic_mlp_fwd_store_bf16(const void* x, const void* d, float* out, int P,
                                          int xe, int de, int hidden, int c, const float* w0,
                                          const float* wx, const float* wd, const float* whh,
                                          const float* b, const float* g, const float* beta,
                                          const float* w_dens, const float* b_dens,
                                          const float* w_col, const float* b_col, float* xhat,
                                          float* stats, float* dpre, const void* tc_fwd,
                                          void* stream) {
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat,    stats,   dpre, nullptr, nullptr, nullptr, 0,
                  static_cast<const float*>(tc_fwd), nullptr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(store<H, true>(w, x, d, out, P, s, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
