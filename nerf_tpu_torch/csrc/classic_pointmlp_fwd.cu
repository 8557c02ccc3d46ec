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
// point to 24.  At 262,144 points 4.936 ms at the float32 SIMT rate (67
// TFLOP/s), 2.004 ms as three TF32 products on the tensor cores (FLOP /
// 165 TFLOP/s).
//
// Design: K1-fwd's tile, whose copy of each k-chunk of the encodings from
// global memory becomes encode.cuh's PointEncodeLoad: the block reads its
// 64 rows of points and directions and writes one chunk's sines straight
// into the encodings' ring, beside the weights' chunk of the same k (the
// skip layer's chunks are computed again).  No encoding goes through
// device memory.  fwd_tc_kernel runs every hidden and encoding product as
// 3xTF32 wgmma on the forward operand images the wrapper builds
// (mlp_tile_tc; one block an SM, 219,136 bytes at H = 256) at every
// encoding width (tc_mlp.cuh, note 9); LayerNorm, the heads and the
// epilogues stay float32.  tc_mlp.cuh's launch_fwd, K1-fwd's launcher,
// with this loader.
//
// classic_pointmlp_fwd_bf16 is the same kernel in compute_dtype bfloat16
// (tc_mlp.cuh, note 10), K1-fwd's bf16 tile with this loader: the points,
// directions and placements stay float32 (as classic_pointmlp_pallas
// takes them) and so are the sines, rounded to bf16 where they enter the
// ring (as the tile rounds the float32 operands it loads); every product
// and both heads take bf16 operands with float32 sums, from bf16 weight
// images; the same tile.  Its bound at 262,144
// points: 0.334 ms of bf16 tensor-core operations (FLOP / 989 TFLOP/s),
// against 24 bytes of input and 16 of output a point.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"
#include "encode.cuh"

namespace {

using namespace nerf_mlp;

template <bool kBf16>
int run(const float* pts, const float* dirs, float* out, int P, int xe, int de, int hidden,
        int c, const float* sx, const float* phx, const float* sd, const float* phd,
        const float* w0, const float* wx, const float* wd, const float* whh, const float* b,
        const float* g, const float* beta, const float* w_dens, const float* b_dens,
        const float* w_col, const float* b_col, const void* tc_fwd, float* wide, void* stream) {
  if (wd == nullptr) return cudaErrorInvalidValue;  // the view branch is required
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xe, de, c},
                          hidden);
  const PointEncodeLoad load{pts, dirs, sx, phx, sd, phd, nullptr, nullptr};
  const float* img = static_cast<const float*>(tc_fwd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H) \
  static_cast<int>(launch_fwd<H, PointEncodeLoad, kBf16>(w, load, out, P, img, wide, s))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int classic_pointmlp_fwd(const float* pts, const float* dirs, float* out, int P,
                                    int xe, int de, int hidden, int c, const float* sx,
                                    const float* phx, const float* sd, const float* phd,
                                    const float* w0, const float* wx, const float* wd,
                                    const float* whh, const float* b, const float* g,
                                    const float* beta, const float* w_dens,
                                    const float* b_dens, const float* w_col,
                                    const float* b_col, const float* tc_fwd, float* wide,
                                    void* stream) {
  return run<false>(pts, dirs, out, P, xe, de, hidden, c, sx, phx, sd, phd, w0, wx, wd, whh, b,
                    g, beta, w_dens, b_dens, w_col, b_col, tc_fwd, wide, stream);
}

// The same in compute_dtype bfloat16: tc_fwd is bfloat16.
extern "C" int classic_pointmlp_fwd_bf16(const float* pts, const float* dirs, float* out, int P,
                                         int xe, int de, int hidden, int c, const float* sx,
                                         const float* phx, const float* sd, const float* phd,
                                         const float* w0, const float* wx, const float* wd,
                                         const float* whh, const float* b, const float* g,
                                         const float* beta, const float* w_dens,
                                         const float* b_dens, const float* w_col,
                                         const float* b_col, const void* tc_fwd, float* wide,
                                         void* stream) {
  return run<true>(pts, dirs, out, P, xe, de, hidden, c, sx, phx, sd, phd, w0, wx, wd, whh, b,
                   g, beta, w_dens, b_dens, w_col, b_col, tc_fwd, wide, stream);
}
