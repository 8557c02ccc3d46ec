// K9: ONE hierarchical-reuse train step in one call: the coarse MLP, the
// coarse compositing and its stage MSE, the inverse-CDF resample of the
// fine samples from the detached coarse weights, their frequency
// encoding, the fine MLP, the union compositing and the fine stage MSE,
// and both MLP backwards -> (loss_c, loss_f, the gradient of every packed
// weight, the fine t-values).
//
// Replaces the TPU kernel nerf_tpu/ops/pallas/fused_mega.py::_mega_kernel
// (pallas_call in mega_train_loss_and_grads; _resample_lane, _encode_fine),
// which holds both stages' activation chains in 126 MB of VMEM, one ray
// tile at a time.  What carries over is that no forward runs twice: the
// coarse chain is stored once and serves the coarse backward (the reuse
// route recomputes it in K1-bwd).
//
// Bound: operations.  Forward + dh + dW = 3 x 630,784 multiply-adds per
// row at the full-width model on R (Sc + Sf) rows: 393,216 rows at 2048 x
// (64 + 128), 1.488e12 FLOP, 22.212 ms at the float32 SIMT rate (67
// TFLOP/s; the reuse route's bound is 24.7 ms with its coarse recompute)
// and 9.019 ms as three TF32 products at 495 TFLOP/s.  The per-ray passes
// and the encodings are O(Sc + Sf) per ray.  The chain's traffic is a
// co-bound: xhat and dpre, about 4 GB each, move about 20 GB a step, some
// 6 ms at 3.35 TB/s.
//
// Design: an SM has 227 KB, so the chains go to global scratch (about 8 GB
// at that shape) and the step is the passes of classic_mlp_train.cuh with
// the tensor-core product policy of tc_mlp.cuh (TcProducts: fwd_store,
// bwd_rows and wgrad run every hidden and encoding product as 3xTF32
// wgmma on operand images of the weights the wrapper builds once per
// call, at every encoding width: tc_mlp.cuh note 9; the epilogues, heads, per-ray passes and
// colsums are unchanged),
// launched in order on the caller's stream:
//   0. the coarse encodings (computed by the caller) copied into the first
//      R Sc rows of a coarse-then-fine encoding buffer;
//   1. fwd_store on the R Sc coarse rows: the chain's first rows and the
//      coarse density and colour logits;
//   2. one warp per ray (coarse_resample_kernel, its scratch in device
//      memory, ray_scratch, so every sample count runs): the coarse compositing
//      with density noise, its MSE and the MSE's backward
//      (composite_ray), then the inverse-CDF resample from the weights
//      and the given uniforms by sampling.sample_pdf's rules: the interior
//      weights plus 1e-5, normalised, their running sum and running max
//      (one lane, in order), fenceposts 0 and 1 at the ends, the top bin
//      closed, a bin narrower than 1e-5 of mass read as 1;
//   3. fwd_store on the R Sf fine rows, whose loader encodes each fine
//      point o + d t inside the block (encode.cuh's RayEncodeLoad) and
//      writes the encodings after the coarse ones;
//   4. K3's union pass (union_train.cuh, on the same ray_scratch), its
//      coarse cotangents added to the coarse stage's own;
//   5. bwd_rows and wgrad over all R (Sc + Sf) rows at once: both stages
//      share the weights, and their chains, encodings and cotangents are
//      contiguous, coarse then fine (the view encodings are per ray in
//      both stages: WProd::split);
//   6. fixed-order colsums of the partials and of the per-ray losses.
//
// mega_train_bf16 is the same step in compute_dtype bfloat16 (tc_mlp.cuh,
// note 10), as fine_stage_train_bf16 runs K3: the coarse encodings and the
// per-ray view encodings arrive as bfloat16 (mega_inputs casts them, as
// the JAX function does), the encoding buffer holds bfloat16 rows (step 3
// writes the fine sines rounded to nearest even: the values the products
// round them to, which wgrad reads as its raw rows), and every pass runs
// TcProductsT<true>: bf16 images, products and heads with float32 sums.
// The per-ray passes (steps 2, 4 and 6), the chain, the losses and the
// gradients stay float32.  Its bound at 2048 x (64 + 128): 1.505 ms of
// bf16 tensor-core operations (FLOP / 989 TFLOP/s) against 4.8 ms of
// bytes, the float32 chain (xhat and dpre, 10,240 bytes a row each,
// written once and read once) at 3.35 TB/s.
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "encode.cuh"
#include "tc_mlp.cuh"
#include "union_train.cuh"

namespace {

using namespace nerf_mlp;

constexpr float kPdfEps = 1e-5f;  // sampling.sample_pdf's eps

// Shared memory of coarse_resample_kernel: 5 Sc floats per warp.

// Step 2 for one ray per warp.  out [R*Sc][1 + c] is the coarse MLP
// output, noise_c its density noise; gout receives the coarse stage's
// cotangent of it, ray_loss[ray] its loss, dnorm[ray] = ||d||, and t_fine
// [R][Sf] the fine t-values.
__global__ void __launch_bounds__(kThreads)
    coarse_resample_kernel(const float* __restrict__ out, const float* __restrict__ noise_c,
                           const float* __restrict__ t_c, const float* __restrict__ rays_d,
                           const float* __restrict__ u, const float* __restrict__ pix, int R,
                           int Sc, int Sf, int c, int white, float g_scale, float loss_scale,
                           float* __restrict__ gout, float* __restrict__ ray_loss,
                           float* __restrict__ dnorm, float* __restrict__ t_fine,
                           float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  float* comp = scratch + static_cast<size_t>(ray) * 5 * Sc;  // composite_ray's 3 Sc
  float* wts = comp + 3 * Sc;             // the compositing weights
  float* cpost = wts + Sc;                // the cdf at the Sc - 1 fenceposts
  const int ld = 1 + c;
  const size_t base = static_cast<size_t>(ray) * Sc;
  const float* o = out + base * ld;
  float* g = gout + base * ld;
  const float* tc = t_c + base;
  const float* d3 = rays_d + static_cast<size_t>(ray) * 3;
  const float dn = __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(d3[0], d3[0]), __fmul_rn(d3[1], d3[1])),
                                        __fmul_rn(d3[2], d3[2])));
  NoWeightTerm none;
  const float loss = composite_ray(
      Sc, c, white ? 1.f : 0.f, pix + static_cast<size_t>(ray) * c, g_scale, loss_scale, comp,
      [&](int p) { return o[p * ld] + noise_c[base + p]; },
      [&](int p, int ch) { return o[p * ld + 1 + ch]; },
      [&](int p) { return p + 1 < Sc ? __fmul_rn(__fsub_rn(tc[p + 1], tc[p]), dn) : 1e10f; },
      [&](int p, float wgt) { wts[p] = wgt; },
      [&](int p, int ch, float gl) { g[p * ld + 1 + ch] = gl; },
      [&](int p, float gs) { g[p * ld] = gs; }, none);
  if (lane == 0) {
    ray_loss[ray] = loss;
    dnorm[ray] = dn;
  }
  __syncwarp();

  // The resample: nb = Sc - 2 bins between the Sc - 1 midpoints of the
  // coarse t-values, bin b weighted wts[b + 1] + eps.
  const int nb = Sc - 2;
  float part = 0.f;
  for (int b = lane; b < nb; b += 32) part += __fadd_rn(wts[b + 1], kPdfEps);
  const float total = warp_sum(part);
  if (lane == 0) {
    float run = 0.f, top = 0.f;
    cpost[0] = 0.f;
    for (int b = 0; b + 1 < nb; ++b) {
      run = __fadd_rn(run, __fdiv_rn(__fadd_rn(wts[b + 1], kPdfEps), total));
      top = fmaxf(top, run);
      cpost[b + 1] = top;
    }
    cpost[nb] = 1.f;
  }
  __syncwarp();
  auto mid = [&](int i) { return __fmul_rn(0.5f, __fadd_rn(tc[i + 1], tc[i])); };
  for (int j = lane; j < Sf; j += 32) {
    const float uj = u[static_cast<size_t>(ray) * Sf + j];
    int lo = 0, hi = nb + 1;  // fenceposts at or below u
    while (lo < hi) {
      const int m = (lo + hi) >> 1;
      if (cpost[m] <= uj) lo = m + 1; else hi = m;
    }
    const int idx = min(max(lo - 1, 0), nb - 1);
    const float below = cpost[idx], above = cpost[idx + 1];
    const float t0 = mid(idx), t1 = mid(idx + 1);
    float denom = __fsub_rn(above, below);
    if (denom < kPdfEps) denom = 1.f;
    const float frac = __fdiv_rn(__fsub_rn(uj, below), denom);
    t_fine[static_cast<size_t>(ray) * Sf + j] = __fadd_rn(t0, __fmul_rn(frac, __fsub_rn(t1, t0)));
  }
}

// T: the encodings' type, float or __nv_bfloat16 (compute_dtype).
template <class T>
struct Inputs {
  const T* xc;           // [R*Sc][xe] coarse encodings
  const T* d_ray;        // [R][de] view encodings, or nullptr
  const float* t_c;      // [R][Sc]
  const float* noise_c;  // [R][Sc]
  const float* u;        // [R][Sf]
  const float* noise_f;  // [R][Sf]
  const float* rays_o;   // [R][3]
  const float* rays_d;   // [R][3]
  const float* pix;      // [R][c]
  const float* S;        // [3][xe] fine placement
  const float* is_cos;   // [xe]
};

template <class T>
struct Work {
  float* out;       // [R(Sc+Sf)][1 + c] MLP outputs, coarse then fine
  float* gout;      // their cotangents
  T* x_all;         // [R(Sc+Sf)][xe] encodings, coarse then fine
  float* dnorm;     // [R]
  float* ray_loss;  // [2][R]: coarse, fine
  float* ray_scratch;  // [R][5 (Sc + Sf)]: the per-ray passes' scratch
};

template <int H, bool kBf16>
cudaError_t run(const Weights& w, const Inputs<enc_t<kBf16>>& in, const Work<enc_t<kBf16>>& k,
                float* loss, float* grads, float* t_fine, int R, int Sc, int Sf, int white,
                int exact, const Scratch& s, cudaStream_t stream) {
  using T = enc_t<kBf16>;
  using Products = TcProductsT<kBf16>;
  const int Pc = R * Sc, Pf = R * Sf, P = Pc + Pf, ld = 1 + w.c;
  const float g_scale = 0.5f * 2.f / (static_cast<float>(w.c) * R);  // stage weight 0.5
  const float loss_scale = 0.5f / R;
  cudaError_t err = cudaMemcpyAsync(k.x_all, in.xc, static_cast<size_t>(Pc) * w.xe * sizeof(T),
                                    cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return err;
  err = launch_fwd_store_with<H, Products>(w, TileLoadT<T>{k.x_all, in.d_ray, Sc}, k.out, Pc, s,
                                           stream, static_cast<size_t>(P), 0);
  if (err != cudaSuccess) return err;

  const int ray_blocks = (R + kWarps - 1) / kWarps;
  coarse_resample_kernel<<<ray_blocks, kThreads, 0, stream>>>(
      k.out, in.noise_c, in.t_c, in.rays_d, in.u, in.pix, R, Sc, Sf, w.c, white, g_scale,
      loss_scale, k.gout, k.ray_loss, k.dnorm, t_fine, k.ray_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const RayEncodeLoadT<T> fine_load{in.rays_o, in.rays_d, t_fine,  Sf, in.S, in.is_cos,
                                    exact,     in.d_ray,  k.x_all + static_cast<size_t>(Pc) * w.xe};
  err = launch_fwd_store_with<H, Products>(w, fine_load, k.out + static_cast<size_t>(Pc) * ld, Pf,
                                           s, stream, static_cast<size_t>(P),
                                           static_cast<size_t>(Pc));
  if (err != cudaSuccess) return err;

  const UnionCoarse coarse{k.out, in.noise_c, k.out + 1, k.gout, k.gout + 1, ld, ld, 1};
  union_composite_kernel<<<ray_blocks, kThreads, 0, stream>>>(
      k.out + static_cast<size_t>(Pc) * ld, in.noise_f, in.t_c, t_fine, coarse, k.dnorm, in.pix,
      R, Sc, Sf, w.c, white, g_scale, loss_scale, k.gout + static_cast<size_t>(Pc) * ld,
      k.ray_loss + R, k.ray_scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = colsum(k.ray_loss, R, 1, loss, s.tmp, stream)) != cudaSuccess) return err;
  if ((err = colsum(k.ray_loss + R, R, 1, loss + 1, s.tmp, stream)) != cudaSuccess) return err;
  return launch_mlp_backward<H, Products>(w, k.x_all, in.d_ray, Sc, k.gout, P, s, nullptr,
                                          nullptr, grads, stream, Pc, Sf);
}

template <bool kBf16>
int entry(const void* xc, const void* d_ray, const float* t_c, const float* noise_c,
          const float* u, const float* noise_f, const float* rays_o, const float* rays_d,
          const float* pix, const float* S, const float* is_cos, float* loss, float* grads,
          float* t_fine, int R, int Sc, int Sf, int xe, int de, int hidden, int c, int white,
          int exact_trig, const float* w0, const float* wx, const float* wd, const float* whh,
          const float* b, const float* g, const float* beta, const float* w_dens,
          const float* b_dens, const float* w_col, const float* b_col, float* xhat,
          float* stats, float* dpre, float* wpart, float* tpart, float* tmp,
          float* out, float* gout, void* x_all, float* dnorm, float* ray_loss,
          float* ray_scratch, int splits, const void* tc_fwd, const void* tc_bwd, void* stream) {
  using T = enc_t<kBf16>;
  if (c < 1 || Sc < 3 || Sf < 1 || ray_scratch == nullptr) return cudaErrorInvalidValue;
  const Weights w = sized(Weights{w0, wx, wd, whh, b, g, beta, w_dens, b_dens, w_col, b_col,
                                  xe, wd ? de : 0, c},
                          hidden);
  const Scratch s{xhat,   stats, dpre, wpart, tpart, tmp, splits,
                  static_cast<const float*>(tc_fwd), static_cast<const float*>(tc_bwd)};
  const Inputs<T> in{static_cast<const T*>(xc), static_cast<const T*>(d_ray), t_c, noise_c, u,
                     noise_f, rays_o, rays_d, pix, S, is_cos};
  const Work<T> k{out, gout, static_cast<T*>(x_all), dnorm, ray_loss, ray_scratch};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NERF_LAUNCH(H)                                                                          \
  static_cast<int>(run<H, kBf16>(w, in, k, loss, grads, t_fine, R, Sc, Sf, white, exact_trig, s, \
                                 st))
  NERF_DISPATCH_HIDDEN(hidden, NERF_LAUNCH)
#undef NERF_LAUNCH
}

}  // namespace

extern "C" int mega_train(const float* xc, const float* d_ray, const float* t_c,
                          const float* noise_c, const float* u, const float* noise_f,
                          const float* rays_o, const float* rays_d, const float* pix,
                          const float* S, const float* is_cos, float* loss, float* grads,
                          float* t_fine, int R, int Sc, int Sf, int xe, int de, int hidden,
                          int c, int white, int exact_trig, const float* w0, const float* wx,
                          const float* wd, const float* whh, const float* b, const float* g,
                          const float* beta, const float* w_dens, const float* b_dens,
                          const float* w_col, const float* b_col, float* xhat, float* stats,
                          float* dpre, float* wpart, float* tpart, float* tmp,
                          float* out, float* gout, float* x_all, float* dnorm,
                          float* ray_loss, float* ray_scratch, int splits,
                          const float* tc_fwd, const float* tc_bwd, void* stream) {
  return entry<false>(xc, d_ray, t_c, noise_c, u, noise_f, rays_o, rays_d, pix, S, is_cos, loss,
                      grads, t_fine, R, Sc, Sf, xe, de, hidden, c, white, exact_trig, w0, wx, wd,
                      whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat, stats, dpre, wpart,
                      tpart, tmp, out, gout, x_all, dnorm, ray_loss, ray_scratch, splits, tc_fwd, tc_bwd,
                      stream);
}

// The same in compute_dtype bfloat16: xc, d_ray, x_all and both images are
// bfloat16.
extern "C" int mega_train_bf16(
    const void* xc, const void* d_ray, const float* t_c, const float* noise_c, const float* u,
    const float* noise_f, const float* rays_o, const float* rays_d, const float* pix,
    const float* S, const float* is_cos, float* loss, float* grads, float* t_fine, int R, int Sc,
    int Sf, int xe, int de, int hidden, int c, int white, int exact_trig, const float* w0,
    const float* wx, const float* wd, const float* whh, const float* b, const float* g,
    const float* beta, const float* w_dens, const float* b_dens, const float* w_col,
    const float* b_col, float* xhat, float* stats, float* dpre, float* wpart, float* tpart,
    float* tmp, float* out, float* gout, void* x_all, float* dnorm, float* ray_loss,
    float* ray_scratch, int splits, const void* tc_fwd, const void* tc_bwd, void* stream) {
  return entry<true>(xc, d_ray, t_c, noise_c, u, noise_f, rays_o, rays_d, pix, S, is_cos, loss,
                     grads, t_fine, R, Sc, Sf, xe, de, hidden, c, white, exact_trig, w0, wx, wd,
                     whh, b, g, beta, w_dens, b_dens, w_col, b_col, xhat, stats, dpre, wpart,
                     tpart, tmp, out, gout, x_all, dnorm, ray_loss, ray_scratch, splits, tc_fwd, tc_bwd,
                     stream);
}
