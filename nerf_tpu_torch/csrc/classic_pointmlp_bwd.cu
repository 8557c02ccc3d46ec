// K8-bwd: the backward of K8-fwd.  Given raw points [P, 3], dirs [P, 3] and
// the output cotangents g_out [P, 1 + c], returns the gradient of every
// packed weight, summed over the points, and the raw inputs' cotangents
// dpoints, ddirs [P, 3].
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mlp.py::_bwd_kernel
// with fuse_encoding=True (pallas_call in _fused_bwd_rule, the custom-VJP
// backward of classic_pointmlp_pallas), whose chain rule to the raw inputs
// is dpoints = (dx_enc * cos(x S + phase)) S^T.
//
// Bound: operations, as K1-bwd's: the forward ran in another kernel
// (K8-fwd), so this one recomputes it: forward + dh + dW = 3 x 630,784
// multiply-adds per point at the full-width model, 14.808 ms at 262,144
// points at the float32 SIMT rate (67 TFLOP/s), 6.013 ms as three TF32
// products on the tensor cores (FLOP / 165 TFLOP/s).
//
// Design: K2's tensor-core passes (tc_mlp.cuh's TcProducts: 3xTF32 wgmma on
// the operand images the wrapper builds).  The stored-chain forward
// (fwd_store_tc_kernel) takes encode.cuh's PointEncodeLoad as its loader
// and writes the encodings it computes to scratch (384 bytes a point),
// which the weight-gradient product reads as its left operand; bwd_rows
// gives the encodings' cotangents dx = dpre_0 w0^T + dpre_4 wx^T and dd =
// dpre_8 wd^T on the tensor cores (tc_input_grad); one warp per point then
// reduces its 60 (36) encoding-lane cotangents, times cos(x S + phase), to
// its 3 raw-input cotangents (encode_bwd_kernel, a float32 reduction, not
// an MLP product).  Every pass runs at every encoding width (tc_mlp.cuh
// note 9).
//
// classic_pointmlp_bwd_bf16 is the same in compute_dtype bfloat16
// (tc_mlp.cuh, note 10): the passes of TcProductsT<true> on bf16 operand
// images, the encodings written to scratch as bfloat16 (the values the
// forward's products rounded, which wgrad reads as its raw rows), and the
// encodings' cotangents float32 (tc_input_grad's float32 output: JAX's
// fused kernel keeps _dot_t's float32 result and applies the chain rule to
// it), so encode_bwd_kernel runs unchanged and the raw inputs' cotangents
// are float32.  Its bound at 262,144 points: 1.003 ms of bf16 tensor-core
// operations (FLOP / 989 TFLOP/s); the float32 chain (xhat and dpre,
// 10,240 bytes a point each, written once and read once) takes 3.2 ms at
// 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"
#include "encode.cuh"

namespace {

using namespace nerf_mlp;

// out[r] = sum_k g[r][k] cos(src_r S_k + phase_k) S[:, k]: the chain rule
// from the encoding's cotangent g [P][width] to the raw input's [P][3],
// one warp per row.
__global__ void __launch_bounds__(kThreads)
    encode_bwd_kernel(const float* __restrict__ src, const float* __restrict__ S,
                      const float* __restrict__ phase, int width, const float* __restrict__ g,
                      float* __restrict__ out, int P) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= P) return;
  const float* q = src + static_cast<size_t>(row) * 3;
  const float p[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
  float a[3] = {0.f, 0.f, 0.f};
  for (int k = lane; k < width; k += 32) {
    const float gc = g[static_cast<size_t>(row) * width + k] *
                     cosf(__fadd_rn(enc_arg(p, S, width, k), __ldg(phase + k)));
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = fmaf(gc, __ldg(S + c * width + k), a[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v = warp_sum(a[c]);
    if (lane == 0) out[static_cast<size_t>(row) * 3 + c] = v;
  }
}

template <int H, bool kBf16>
cudaError_t run(const Weights& w, const PointEncodeLoadT<enc_t<kBf16>>& load, const float* gout,
                float* dpts, float* ddirs, float* grads, float* out, float* dx_enc,
                float* dd_enc, int P, const Scratch& s, cudaStream_t stream) {
  using Products = TcProductsT<kBf16, float>;
  cudaError_t err = launch_fwd_store_with<H, Products>(w, load, out, P, s, stream,
                                                       static_cast<size_t>(P), 0);
  if (err != cudaSuccess) return err;
  const bool input_grads = dpts != nullptr;
  err = launch_mlp_backward<H, Products>(w, load.x_out, load.d_out, 1, gout, P, s,
                                         input_grads ? dx_enc : nullptr,
                                         input_grads ? dd_enc : nullptr, grads, stream);
  if (err != cudaSuccess || !input_grads) return err;
  const int blocks = (P + kWarps - 1) / kWarps;
  encode_bwd_kernel<<<blocks, kThreads, 0, stream>>>(load.pts, load.sx, load.phx, w.xe, dx_enc,
                                                     dpts, P);
  encode_bwd_kernel<<<blocks, kThreads, 0, stream>>>(load.dirs, load.sd, load.phd, w.de,
                                                     dd_enc, ddirs, P);
  return cudaGetLastError();
}

template <bool kBf16>
int entry(const float* pts, const float* dirs, const float* gout, float* dpts, float* ddirs,
          float* grads, int P, int xe, int de, int hidden, int c, const float* sx,
          const float* phx, const float* sd, const float* phd, const float* w0, const float* wx,
          const float* wd, const float* whh, const float* b, const float* g, const float* beta,
          const float* w_dens, const float* b_dens, const float* w_col, const float* b_col,
          float* xhat, float* stats, float* dpre, float* wpart, float* tpart, float* tmp,
          float* out, void* x_enc, void* d_enc, float* dx_enc, float* dd_enc,
          int splits, const void* tc_fwd, const void* tc_bwd, void* stream) {
  using T = enc_t<kBf16>;
  if (wd == nullptr) return cudaErrorInvalidValue;
  if ((dpts == nullptr) != (ddirs == nullptr)) return cudaErrorInvalidValue;
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xe, de, c},
                          hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  const PointEncodeLoadT<T> load{pts, dirs, sx, phx, sd, phd, static_cast<T*>(x_enc),
                                 static_cast<T*>(d_enc)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                       \
  static_cast<int>(run<H, kBf16>(w, load, gout, dpts, ddirs, grads, out, dx_enc, dd_enc, P, s, \
                                 st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int classic_pointmlp_bwd(const float* pts, const float* dirs, const float* gout,
                                    float* dpts, float* ddirs, float* grads, int P, int xe,
                                    int de, int hidden, int c, const float* sx,
                                    const float* phx, const float* sd, const float* phd,
                                    const float* w0, const float* wx, const float* wd,
                                    const float* whh, const float* b, const float* g,
                                    const float* beta, const float* w_dens,
                                    const float* b_dens, const float* w_col,
                                    const float* b_col, float* xhat, float* stats, float* dpre,
                                    float* wpart, float* tpart, float* tmp,
                                    float* out, float* x_enc, float* d_enc, float* dx_enc,
                                    float* dd_enc, int splits, const float* tc_fwd,
                                    const float* tc_bwd, void* stream) {
  return entry<false>(pts, dirs, gout, dpts, ddirs, grads, P, xe, de, hidden, c, sx, phx, sd,
                      phd, w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat,
                      stats, dpre, wpart, tpart, tmp, out, x_enc, d_enc, dx_enc, dd_enc,
                      splits, tc_fwd, tc_bwd, stream);
}

// The same in compute_dtype bfloat16: x_enc, d_enc and both images are
// bfloat16; dx_enc, dd_enc and the raw inputs' cotangents float32.
extern "C" int classic_pointmlp_bwd_bf16(
    const float* pts, const float* dirs, const float* gout, float* dpts, float* ddirs,
    float* grads, int P, int xe, int de, int hidden, int c, const float* sx, const float* phx,
    const float* sd, const float* phd, const float* w0, const float* wx, const float* wd,
    const float* whh, const float* b, const float* g, const float* beta, const float* w_dens,
    const float* b_dens, const float* w_col, const float* b_col, float* xhat, float* stats,
    float* dpre, float* wpart, float* tpart, float* tmp, float* out, void* x_enc,
    void* d_enc, float* dx_enc, float* dd_enc, int splits, const void* tc_fwd,
    const void* tc_bwd, void* stream) {
  return entry<true>(pts, dirs, gout, dpts, ddirs, grads, P, xe, de, hidden, c, sx, phx, sd,
                     phd, w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat, stats,
                     dpre, wpart, tpart, tmp, out, x_enc, d_enc, dx_enc, dd_enc, splits,
                     tc_fwd, tc_bwd, stream);
}
