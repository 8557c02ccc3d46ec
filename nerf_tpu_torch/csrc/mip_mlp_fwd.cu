// K5-fwd: the HEAD (mip) NeRF point MLP forward, IPE features [P, F] ->
// [P, O] = [density, colour logits, segmentation logits] per point.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mip_mlp.py::_fwd_kernel
// (pallas_call in _fwd_call, reached from mip_mlp_pallas), which keeps all
// weights and the whole activation chain in VMEM.
//
// Bound: operations.  300,544 multiply-adds per point at the full-width
// model (H = 256, F = 96, 5 layers, O = 54) against 384 bytes of input and
// 216 of output: about 1,000 FLOP per byte, far above the card's fp32
// ridge (20 FLOP per byte).  Plain fp32 FMA, no TF32, so the bound is the
// fp32 FMA rate.  The design (mip_mlp.cuh on classic_mlp.cuh) keeps every
// activation on chip: one block of 8 warps per 64-row tile, activations in
// one shared-memory buffer, LayerNorm as warp reductions in registers,
// weights streamed from L2; two blocks fit on an SM (the MipSimt policy:
// K6 and K7 run the same chain on the tensor cores).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "mip_mlp.cuh"

extern "C" int mip_mlp_fwd(const float* x, float* out, int P, int F, int hidden, int L, int O,
                           const float* w_in, const float* whh, const float* b, const float* g,
                           const float* beta, const float* w_out, const float* b_out,
                           void* stream) {
  using namespace nerf_mlp;
  if (L < 2 || O < 1 || O > kThreads) return cudaErrorInvalidValue;
  const MipWeights w{w_in, whh, b, g, beta, w_out, b_out, F, L, O};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(launch_mip_fwd<H, false, MipSimt>(w, x, out, P, nullptr, nullptr, nullptr, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
