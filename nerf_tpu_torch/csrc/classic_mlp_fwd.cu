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
// chip.  Where the tile fits the device's shared memory (tc_mlp.cuh, note
// 9: xe' + de' <= 132 at H = 256, which the full-width model's 60 + 36
// does), fwd_tc_kernel runs every hidden and encoding product as 3xTF32
// wgmma on the forward operand images the wrapper builds (mlp_tile_tc,
// K4's tile; one block an SM, 223 KB); LayerNorm, the heads and the
// epilogues stay float32.  Wider encodings (a latent-conditioned model's)
// run classic_mlp_fwd_kernel, the float32 SIMT tile (classic_mlp.cuh:
// weights streamed from L2 in 16-row chunks, two blocks an SM).  The
// choice is made from the shapes before any launch.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

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
                   const float* tc_fwd, cudaStream_t stream) {
  TilePolicy policy;
  cudaError_t err = fwd_store_plan<H>(w.xe, w.de, &policy);
  if (err != cudaSuccess) return err;
  const int blocks = (P + kTileRows - 1) / kTileRows;
  if (policy == kTileTc) {
    if (tc_fwd == nullptr) return cudaErrorInvalidValue;
    const size_t smem = tc_tile_bytes<H>(w.xe, w.de);
    err = cudaFuncSetAttribute(fwd_tc_kernel<H, TileLoad>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    fwd_tc_kernel<H, TileLoad><<<blocks, kThreads, smem, stream>>>(
        w, TcImages::forward(w, tc_fwd, H), TileLoad{x, d, 1}, out, P);
    return cudaGetLastError();
  }
  if (policy != kTileSimt) return cudaErrorInvalidValue;
  const size_t smem = fwd_store_smem<H>(w.xe, w.de);
  err = cudaFuncSetAttribute(classic_mlp_fwd_kernel<H>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  classic_mlp_fwd_kernel<H><<<blocks, kThreads, smem, stream>>>(w, x, d, out, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int classic_mlp_fwd(const float* x, const float* d, float* out, int P, int xe,
                               int de, int hidden, int c, const float* w0, const float* wx,
                               const float* wd, const float* whh, const float* b,
                               const float* g, const float* beta, const float* w_dens,
                               const float* b_dens, const float* w_col, const float* b_col,
                               const float* tc_fwd, void* stream) {
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                  xe, wd ? de : 0, c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(launch<H>(w, x, d, out, P, tc_fwd, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

// The plan K1-fwd follows for these widths (de 0 without the view branch):
// its tiles take fwd_store's bytes.  out = [policy (0 tensor cores, 1
// float32 SIMT, 2 neither fits), tensor-core bytes, SIMT bytes, the
// device's limit].
extern "C" int classic_mlp_fwd_plan(int xe, int de, int hidden, long long* out) {
  return static_cast<int>(fwd_store_plan_at(xe, de, hidden, out));
}
