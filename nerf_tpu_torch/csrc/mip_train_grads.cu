// K6: the mip train objective with its gradients.  MLP forward on R rays x
// n interval rows of IPE features, density noise, alpha compositing,
// sigmoid colour (optional white background), the MSE against the ray's
// pixel, the log-space segmentation cross-entropy of the ray's label, and
// the backward through all of it -> (rgb_loss, seg_loss, gradient of every
// packed weight of rgb_loss + seg_weight * seg_loss).
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mip_train.py::
// _mip_train_kernel (pallas_call in mip_train_grads_pallas), which keeps
// the chain in VMEM and runs the per-ray sums, max and exp-sum as
// segmented shift ladders.
//
// Bound: operations.  Forward + dh + dW = 3 x 300,544 multiply-adds per
// row at the full-width model (F = 96; 256 F + 275,968 each at hidden 256,
// 5 layers and 54 outputs; no recompute: the forward stores its chain),
// 4.653e11 FLOP at 4096 x 63 rows: 6.945 ms at the float32 SIMT rate (67
// TFLOP/s), 2.820 ms as three TF32 products on the tensor cores (FLOP /
// 165 TFLOP/s).  The stored chain (xhat and dpre, 5 x 256 x 4 bytes each
// per row, written and read) is about 2.6 GB of traffic, 0.8 ms at 3.35
// TB/s.
//
// Design: the mip MLP passes of mip_mlp.cuh with the tensor-core policy
// MipTc (the stored-chain forward, the features streamed through its tile
// at every width; bwd_rows' dh = dpre W^T and wgrad's dW, the head's too,
// as 3xTF32 wgmma on the operand images the wrapper builds once a step, in
// groups of kMaxProds products at any layer count; LayerNorm, the head's
// forward and its input cotangent float32, at any head width), with one
// per-ray pass between forward and backward: one warp per ray, each lane a
// run of consecutive rows (two at 63 rows); composite_ray runs the
// compositing, the MSE and their backward (warp scans in fp32), and SegCE
// adds the cross-entropy: z_i = log(w_i + 1e-10) + log_softmax(seg_i)
// [label], its max and exp-sum over the ray as warp reductions, and in the
// backward the weight cotangent -gs p_i / (w_i + 1e-10) and the logits'
// cotangents g_z (onehot - softmax(seg_i)) over every class.  With
// seg_weight 0 the CE is skipped and the segmentation logits get zero
// cotangents.  A ray's 5 n floats of scratch sit in device memory
// (ray_scratch, from the wrapper), so a ray may hold any number of rows.
//
// mip_train_grads_bf16 is the same in compute_dtype bfloat16 (MipTcBf16,
// tc_mlp.cuh note 10): bfloat16 features and images, every product and the
// head's on bf16 operands with float32 sums; the compositing, the losses
// and their backward float32.  Its bound at 4096 x 63 rows: 0.470 ms of
// bf16 tensor-core operations (FLOP / 989 TFLOP/s); its float32 chain
// (xhat and dpre, 10,240 bytes a row, written once and read once) takes
// 1.58 ms at 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "mip_mlp.cuh"

namespace {

using namespace nerf_mlp;

// The segmentation cross-entropy's part of a ray's objective (a weight
// term of composite_ray, fused_mip_train.py:226-266): forward fills z_i,
// each row's log-sum-exp over the classes and seg_out = logsumexp_i z_i;
// the ray's CE is -seg_out.  grad(p, w) writes row p's class-logit
// cotangents and returns the CE's dL/dw_p = g_z / (w_p + 1e-10).
struct SegCE {
  const float* o;   // the ray's MLP output rows [n][ld]
  float* g;         // their cotangents
  int ld, c, K;     // row width, colours (at 1..c), classes (at 1 + c..)
  long long label;  // a label outside [0, K) matches no class
  float gs;         // seg_weight / R
  float* z;         // scratch [n]
  float* lse;       // scratch [n]
  float seg_out;

  __device__ void forward(int begin, int end, const float* al, const float* tr) {
    float m = -3.0e38f;
    for (int p = begin; p < end; ++p) {
      const float* s = o + p * ld + 1 + c;
      float mx = s[0];
      for (int k = 1; k < K; ++k) mx = fmaxf(mx, s[k]);
      float se = 0.f;
      for (int k = 0; k < K; ++k) se += expf(s[k] - mx);
      lse[p] = mx + logf(se);
      const float s_label = (label >= 0 && label < K ? s[label] : 0.f) - lse[p];
      z[p] = logf((1.f - al[p]) * tr[p] + 1e-10f) + s_label;
      m = fmaxf(m, z[p]);
    }
    m = warp_max(m);
    float se = 0.f;
    for (int p = begin; p < end; ++p) se += expf(z[p] - m);
    seg_out = m + logf(warp_sum(se));
  }

  __device__ float grad(int p, float wgt) {
    const float g_z = -gs * expf(z[p] - seg_out);
    const float* s = o + p * ld + 1 + c;
    float* gr = g + p * ld + 1 + c;
    for (int k = 0; k < K; ++k) gr[k] = g_z * ((k == label ? 1.f : 0.f) - expf(s[k] - lse[p]));
    return g_z / (wgt + 1e-10f);
  }
};

// Forward and backward of the compositing and the losses, one ray per
// warp.  out [R*n][ld] is the MLP output; gout receives its cotangent.
// ray_loss[ray] = (mse / R, ce / R).  Scratch: 5 n floats a ray, ray r's
// at scratch + 5 n r.
__global__ void __launch_bounds__(kThreads)
    mip_objective_kernel(const float* __restrict__ out, const float* __restrict__ dists,
                         const float* __restrict__ noise, const float* __restrict__ pix,
                         const long long* __restrict__ labels, int R, int n, int c, int ld,
                         int white, float g_scale, float loss_scale, float gs_seg,
                         float* __restrict__ gout, float* __restrict__ ray_loss,
                         float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  const size_t base = static_cast<size_t>(ray) * n;
  const float* o = out + base * ld;
  float* g = gout + base * ld;
  float* sc = scratch + 5 * base;
  auto sigma = [&](int p) { return o[p * ld] + noise[base + p]; };
  auto logit = [&](int p, int ch) { return o[p * ld + 1 + ch]; };
  auto dist = [&](int p) { return dists[base + p]; };
  auto on_weight = [](int, float) {};
  auto on_color_grad = [&](int p, int ch, float gl) { g[p * ld + 1 + ch] = gl; };
  auto on_sigma_grad = [&](int p, float gd) { g[p * ld] = gd; };
  const float off = white ? 1.f : 0.f;
  const float* px = pix + static_cast<size_t>(ray) * c;
  float mse, ce = 0.f;
  if (gs_seg != 0.f) {
    SegCE term{o, g, ld, c, ld - 1 - c, labels[ray], gs_seg, sc + 3 * n, sc + 4 * n, 0.f};
    mse = composite_ray(n, c, off, px, g_scale, loss_scale, sc, sigma, logit, dist, on_weight,
                        on_color_grad, on_sigma_grad, term);
    ce = -term.seg_out * loss_scale;
  } else {
    NoWeightTerm none;
    mse = composite_ray(n, c, off, px, g_scale, loss_scale, sc, sigma, logit, dist, on_weight,
                        on_color_grad, on_sigma_grad, none);
    for (int p = lane; p < n; p += 32)
      for (int k = 1 + c; k < ld; ++k) g[p * ld + k] = 0.f;
  }
  if (lane == 0) {
    ray_loss[2 * ray] = mse;
    ray_loss[2 * ray + 1] = ce;
  }
}

template <int H, class Products>
cudaError_t run(const MipWeights& w, const void* x, const float* dists, const float* noise,
                const float* pix, const long long* labels, int R, int n, int c, int white,
                float seg_weight, float* loss, float* grads, const Scratch& s, float* out,
                float* gout, float* ray_loss, float* ray_scratch, cudaStream_t stream) {
  const int P = R * n;
  cudaError_t err =
      Products::template fwd<H, true>(w, x, out, P, s.xhat, s.stats, s.tc_fwd, s.dpre, stream);
  if (err != cudaSuccess) return err;
  const float g_scale = 2.f / (static_cast<float>(c) * R);
  const float loss_scale = 1.f / R;
  const float gs_seg = seg_weight / R;
  mip_objective_kernel<<<(R + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      out, dists, noise, pix, labels, R, n, c, w.O, white, g_scale, loss_scale, gs_seg, gout,
      ray_loss, ray_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = colsum(ray_loss, R, 2, loss, s.tmp, stream)) != cudaSuccess) return err;
  return launch_mip_backward<H, Products>(w, x, gout, P, s, nullptr, grads, stream);
}

template <class Products>
int run_at(const void* x, const float* dists, const float* noise, const float* pix,
           const long long* labels, float* loss, float* grads, int R, int n, int F, int hidden,
           int L, int c, int O, int white, float seg_weight, const float* w_in,
           const float* whh, const float* b, const float* g, const float* beta,
           const float* w_out, const float* b_out, float* xhat, float* stats, float* dpre,
           float* wpart, float* tpart, float* tmp, float* out, float* gout,
           float* ray_loss, float* ray_scratch, int splits, const void* tc_fwd,
           const void* tc_bwd, void* stream) {
  if (L < 2 || c < 1 || O < c + 2 || (seg_weight != 0.f && labels == nullptr))
    return cudaErrorInvalidValue;
  const MipWeights w = sized(MipWeights{w_in, whh, b, g, beta, w_out, b_out, F, L, O}, hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                       \
  static_cast<int>(run<H, Products>(w, x, dists, noise, pix, labels, R, n, c, white,         \
                                    seg_weight, loss, grads, s, out, gout, ray_loss,           \
                                    ray_scratch, st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int mip_train_grads(const float* x, const float* dists, const float* noise,
                               const float* pix, const long long* labels, float* loss,
                               float* grads, int R, int n, int F, int hidden, int L, int c,
                               int O, int white, float seg_weight, const float* w_in,
                               const float* whh, const float* b, const float* g,
                               const float* beta, const float* w_out, const float* b_out,
                               float* xhat, float* stats, float* dpre, float* wpart,
                               float* tpart, float* tmp, float* out, float* gout,
                               float* ray_loss, float* ray_scratch, int splits,
                               const float* tc_fwd, const float* tc_bwd, void* stream) {
  return run_at<MipTc>(x, dists, noise, pix, labels, loss, grads, R, n, F, hidden, L, c, O,
                       white, seg_weight, w_in, whh, b, g, beta, w_out, b_out, xhat, stats,
                       dpre, wpart, tpart, tmp, out, gout, ray_loss, ray_scratch, splits,
                       tc_fwd, tc_bwd, stream);
}

// The same in compute_dtype bfloat16: x and both images are bfloat16.
extern "C" int mip_train_grads_bf16(const void* x, const float* dists, const float* noise,
                                    const float* pix, const long long* labels, float* loss,
                                    float* grads, int R, int n, int F, int hidden, int L, int c,
                                    int O, int white, float seg_weight, const float* w_in,
                                    const float* whh, const float* b, const float* g,
                                    const float* beta, const float* w_out, const float* b_out,
                                    float* xhat, float* stats, float* dpre, float* wpart,
                                    float* tpart, float* tmp, float* out,
                                    float* gout, float* ray_loss, float* ray_scratch,
                                    int splits, const void* tc_fwd, const void* tc_bwd,
                                    void* stream) {
  return run_at<MipTcBf16>(x, dists, noise, pix, labels, loss, grads, R, n, F, hidden, L, c,
                           O, white, seg_weight, w_in, whh, b, g, beta, w_out, b_out, xhat,
                           stats, dpre, wpart, tpart, tmp, out, gout, ray_loss, ray_scratch,
                           splits, tc_fwd, tc_bwd, stream);
}

