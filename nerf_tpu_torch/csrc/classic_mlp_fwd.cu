// K1-fwd: the classic NeRF point MLP forward, [P, xe] (+ [P, de]) ->
// [P, 1 + c] = [density, color logits] per point.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mlp.py::_fwd_kernel
// (pallas_call in _fused_fwd_call, reached from classic_mlp_pallas), which
// keeps all weights and the whole activation chain in VMEM.
//
// Bound: operations.  630,784 multiply-adds per point at the full-width
// model (H = 256, xe = 60, de = 36) against 384 bytes of input and 16 of
// output: about 3,150 FLOP per byte, far above the card's fp32 ridge.  The
// kernel runs plain fp32 FMAs (no TF32), so the bound is the fp32 FMA rate.
// The design (classic_mlp.cuh) keeps every activation on chip: one block of
// 8 warps per 64-row tile, activations in one shared-memory buffer,
// LayerNorm as warp reductions in registers, weights streamed from L2 in
// 16-row chunks; two blocks fit on an SM.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "classic_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    classic_mlp_fwd_kernel(Weights w, const float* __restrict__ x,
                           const float* __restrict__ d, float* __restrict__ out, int P) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* wbuf = act + kTileRows * H;
  float* xs = wbuf + kChunk * H;
  float* ds = xs + kTileRows * round_up4(w.xe);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  load_tile(xs, x, row0, nvalid, w.xe, 1);
  if (w.wd != nullptr) load_tile(ds, d, row0, nvalid, w.de, 1);
  __syncthreads();
  mlp_tile<H>(w, xs, ds, act, wbuf, out + row0 * (1 + w.c), 1 + w.c, nvalid);
}

template <int H>
cudaError_t launch(const Weights& w, const float* x, const float* d, float* out, int P,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kTileRows) * H + mlp_side_floats<H>(w.xe, w.wd ? w.de : 0)) *
      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      classic_mlp_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (P + kTileRows - 1) / kTileRows;
  classic_mlp_fwd_kernel<H><<<blocks, kThreads, smem, stream>>>(w, x, d, out, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int classic_mlp_fwd(const float* x, const float* d, float* out, int P, int xe,
                               int de, int hidden, int c, const float* w0, const float* wx,
                               const float* wd, const float* whh, const float* b,
                               const float* g, const float* beta, const float* w_dens,
                               const float* b_dens, const float* w_col, const float* b_col,
                               void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(launch<H>(w, x, d, out, P, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
