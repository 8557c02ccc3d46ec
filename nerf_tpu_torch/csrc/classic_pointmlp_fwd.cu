// K8-fwd: the classic NeRF point MLP on RAW points and view directions,
// the frequency encoding computed inside the kernel: points [P, 3], dirs
// [P, 3] -> [P, 1 + c] = [density, color logits] per point, the encodings
// sin(x S + phase) on the placements of ops/encoding.py::enc_consts.
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mlp.py::_fwd_kernel
// with fuse_encoding=True (_encode_in_kernel; pallas_call in
// _fused_fwd_call, reached from classic_pointmlp_pallas).
//
// Bound: operations, as K1-fwd's: 630,784 multiply-adds per point at the
// full-width model (H = 256, encodings 60 + 36); the 96 sines per point
// are negligible beside them, and the inputs shrink from 384 bytes a
// point to 24.  At 262,144 points the bound is 4.94 ms at 67 TFLOP/s.
//
// Design: K1-fwd's tile (classic_mlp.cuh::mlp_tile), whose load of the
// encoding tiles from global memory becomes encode.cuh's PointEncodeLoad:
// the block reads its 64 rows of points and directions and writes the
// sines straight into the shared xs / ds tiles.  No encoding goes through
// device memory.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "encode.cuh"

namespace {

using namespace nerf_mlp;

template <int H>
__global__ void __launch_bounds__(kThreads, 2)
    classic_pointmlp_fwd_kernel(Weights w, PointEncodeLoad load, float* __restrict__ out,
                                int P) {
  extern __shared__ float4 smem4[];
  float* act = reinterpret_cast<float*>(smem4);
  float* wbuf = act + kTileRows * H;
  float* xs = wbuf + kChunk * H;
  float* ds = xs + kTileRows * round_up4(w.xe);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  load(w, xs, ds, row0, nvalid);
  __syncthreads();
  mlp_tile<H>(w, xs, ds, act, wbuf, out + row0 * (1 + w.c), 1 + w.c, nvalid);
}

template <int H>
cudaError_t launch(const Weights& w, const PointEncodeLoad& load, float* out, int P,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(kTileRows) * H + mlp_side_floats<H>(w.xe, w.de)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(classic_pointmlp_fwd_kernel<H>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (P + kTileRows - 1) / kTileRows;
  classic_pointmlp_fwd_kernel<H><<<blocks, kThreads, smem, stream>>>(w, load, out, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" int classic_pointmlp_fwd(const float* pts, const float* dirs, float* out, int P,
                                    int xe, int de, int hidden, int c, const float* sx,
                                    const float* phx, const float* sd, const float* phd,
                                    const float* w0, const float* wx, const float* wd,
                                    const float* whh, const float* b, const float* g,
                                    const float* beta, const float* w_dens,
                                    const float* b_dens, const float* w_col,
                                    const float* b_col, void* stream) {
  if (wd == nullptr) return cudaErrorInvalidValue;  // the view branch is required
  const Weights w{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xe, de, c};
  const PointEncodeLoad load{pts, dirs, sx, phx, sd, phd, nullptr, nullptr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) static_cast<int>(launch<H>(w, load, out, P, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}
