// K5-fwd: the HEAD (mip) NeRF point MLP forward, IPE features [P, F] ->
// [P, O] = [density, colour logits, segmentation logits] per point.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mip_mlp.py::_fwd_kernel
// (pallas_call in _fwd_call, reached from mip_mlp_pallas), which keeps all
// weights and the whole activation chain in VMEM.
//
// Bound: operations.  256 F + 275,968 multiply-adds per point at hidden
// 256, 5 layers and 54 outputs (300,544 at the full-width model's F = 96)
// against 4 F bytes of input and 216 of output: about 1,000 FLOP per byte,
// far above the card's ridge.  At 258,048 rows and F = 96: 2.315 ms at
// the float32 SIMT rate (67 TFLOP/s), 0.940 ms as three TF32 products on
// the tensor cores (FLOP / 165 TFLOP/s).
//
// Design (mip_mlp.cuh): K7's tile, the MipTc policy's forward with nothing
// saved (mip_fwd_tc_kernel): one block of 8 warps per 64-row tile keeps
// every activation on chip, the features streamed through the tile's ring
// a k-chunk at a time (tc_mlp.cuh note 9), so one tile of 219,136 bytes at
// H = 256 serves every feature width; the feature and hidden products as
// 3xTF32 wgmma on the forward operand images the wrapper builds (one block
// an SM), LayerNorm as warp reductions in registers, the head float32
// (head_wide) at any width.
//
// mip_mlp_fwd_bf16 is the same kernel in compute_dtype bfloat16 (MipTcBf16,
// tc_mlp.cuh note 10): bfloat16 features and weight images, every product
// and the head on bf16 operands with float32 sums, float32 outputs.  Its
// bound at 258,048 rows and F = 96: 0.157 ms of bf16 tensor-core operations
// (FLOP / 989 TFLOP/s), against 192 bytes of features and 216 of output a
// row (0.031 ms at 3.35 TB/s).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "mip_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <class Products>
int run(const void* x, float* out, int P, int F, int hidden, int L, int O, const float* w_in,
        const float* whh, const float* b, const float* g, const float* beta,
        const float* w_out, const float* b_out, const void* tc_fwd, float* wide, void* stream) {
  if (L < 2 || O < 1) return cudaErrorInvalidValue;
  const MipWeights w = sized(MipWeights{w_in, whh, b, g, beta, w_out, b_out, F, L, O}, hidden);
  const float* img = static_cast<const float*>(tc_fwd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(Products::template fwd<H, false>(w, x, out, P, nullptr, nullptr, img, wide, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int mip_mlp_fwd(const float* x, float* out, int P, int F, int hidden, int L, int O,
                           const float* w_in, const float* whh, const float* b, const float* g,
                           const float* beta, const float* w_out, const float* b_out,
                           const float* tc_fwd, float* wide, void* stream) {
  return run<MipTc>(x, out, P, F, hidden, L, O, w_in, whh, b, g, beta, w_out, b_out, tc_fwd,
                    wide, stream);
}

// The same in compute_dtype bfloat16: x and tc_fwd are bfloat16.
extern "C" int mip_mlp_fwd_bf16(const void* x, float* out, int P, int F, int hidden, int L,
                                int O, const float* w_in, const float* whh, const float* b,
                                const float* g, const float* beta, const float* w_out,
                                const float* b_out, const void* tc_fwd, float* wide,
                                void* stream) {
  return run<MipTcBf16>(x, out, P, F, hidden, L, O, w_in, whh, b, g, beta, w_out, b_out,
                        tc_fwd, wide, stream);
}

