// K1-fwd: the classic NeRF point MLP forward, [P, xe] (+ [P, de]) ->
// [P, 1 + c] = [density, color logits] per point.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mlp.py::_fwd_kernel
// (pallas_call in _fused_fwd_call, reached from classic_mlp_pallas), which
// keeps all weights and the whole activation chain in VMEM.
//
// Bound: operations.  630,784 multiply-adds per point at the full-width
// model (H = 256, xe = 60, de = 36) against 384 bytes of input and 16 of
// output: about 3,150 FLOP per byte, far above the card's ridge.  At
// 262,144 points 4.936 ms at the float32 SIMT rate (67 TFLOP/s), 2.004 ms
// as three TF32 products on the tensor cores (FLOP / 165 TFLOP/s).
//
// Design: one block of 8 warps per 64-row tile keeps every activation on
// chip.  fwd_tc_kernel runs every hidden and encoding product as 3xTF32
// wgmma on the forward operand images the wrapper builds (mlp_tile_tc,
// K4's tile; one block an SM, 219,136 bytes at H = 256), the encodings
// streamed from global memory one k-chunk at a time beside the weights'
// chunks, so every encoding width runs it (tc_mlp.cuh, note 9; a
// latent-conditioned model's wider encodings only take more chunks);
// LayerNorm, the heads and the epilogues stay float32.  tc_mlp.cuh's
// launch_fwd, which K8-fwd shares with its own loader.
//
// classic_mlp_fwd_bf16 is the same kernel in compute_dtype bfloat16
// (tc_mlp.cuh, note 10): bf16 encodings and weight images, every product
// and both heads on bf16 operands with float32 sums, float32 outputs; the
// same tile.  Its bound at 262,144 rows: 0.334 ms of bf16
// tensor-core operations (FLOP / 989 TFLOP/s), against 192 bytes of
// encodings and 16 of output a row (0.016 ms at 3.35 TB/s).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <bool kBf16>
int run(const void* x, const void* d, float* out, int P, int hidden, const Weights& w0,
        const void* tc_fwd, float* wide, void* stream) {
  const Weights w = sized(w0, hidden);
  using T = enc_t<kBf16>;
  const TileLoadT<T> load{static_cast<const T*>(x), static_cast<const T*>(d), 1};
  const float* img = static_cast<const float*>(tc_fwd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(launch_fwd<H, TileLoadT<T>, kBf16>(w, load, out, P, img, wide, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int classic_mlp_fwd(const float* x, const float* d, float* out, int P, int xe,
                               int de, int hidden, int c, const float* w0, const float* wx,
                               const float* wd, const float* whh, const float* b,
                               const float* g, const float* beta, const float* w_dens,
                               const float* b_dens, const float* w_col, const float* b_col,
                               const float* tc_fwd, float* wide, void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  return run<false>(x, d, out, P, hidden, w, tc_fwd, wide, stream);
}

// The same in compute_dtype bfloat16: x, d and tc_fwd are bfloat16.
extern "C" int classic_mlp_fwd_bf16(const void* x, const void* d, float* out, int P, int xe,
                                    int de, int hidden, int c, const float* w0, const float* wx,
                                    const float* wd, const float* whh, const float* b,
                                    const float* g, const float* beta, const float* w_dens,
                                    const float* b_dens, const float* w_col,
                                    const float* b_col, const void* tc_fwd, float* wide,
                                    void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  return run<true>(x, d, out, P, hidden, w, tc_fwd, wide, stream);
}
