// The per-ray pass of the hierarchical-reuse fine stage with its backward,
// shared by K3 (fine_stage_train.cu) and K9 (mega_train.cu): the union of
// a ray's coarse and fine samples composited in t order, the fine-stage
// MSE and the backward of both, one ray per warp.
#pragma once

#include "classic_mlp_train.cuh"

namespace nerf_mlp {

// Where the union pass reads a ray's coarse samples and puts their
// cotangents.  Coarse slot q (= ray * Sc + i) has the density logit
// dens[q * dens_ld] (+ noise[q] when noise is not null) and the colour
// logits col[q * col_ld + ch]; its cotangents go to g_dens[q * dens_ld] and
// g_col[q * col_ld + ch], added to what is there when accumulate is set.
// K3: the noised densities and colours as separate arrays, cotangents
// written.  K9: the coarse rows of the MLP output and their noise, the
// cotangents added to the coarse stage's own.
struct UnionCoarse {
  const float* dens;
  const float* noise;
  const float* col;
  float* g_dens;
  float* g_col;
  int dens_ld, col_ld, accumulate;
};

// Floats of union_composite_kernel's scratch in device memory: 5 (Sc +
// Sf) a ray, so every sample count runs.
inline size_t union_composite_floats(int R, int Sc, int Sf) {
  return static_cast<size_t>(R) * 5 * (Sc + Sf);
}

// Per ray and warp:
//   1. merge the sorted coarse and fine lists by rank (a coarse sample
//      tied with a fine one comes first);
//   2. each merged sample's interval to its successor times ||d|| (1e10
//      on the last), alpha = exp(-relu(sigma) dist);
//   3. the exclusive prefix of log(alpha + 1e-10) as a warp scan, the
//      weights, rgb and the loss;
//   4. backward: dL/dw, the exclusive suffix of w dL/dw, dL/dsigma with
//      relu' = (sigma > 0), and the colour cotangents, scattered back to
//      the coarse slots (cs) and the fine rows (gout, the MLP output's
//      cotangent).
// The scan, loss and backward are composite_ray's.  fo [R*Sf][1 + c] is
// the fine MLP output, noise_f its density noise; scratch holds
// union_composite_floats (the ray's merged list and composite_ray's
// arrays, written and read by its warp).
__global__ void __launch_bounds__(kThreads)
    union_composite_kernel(const float* __restrict__ fo, const float* __restrict__ noise_f,
                           const float* __restrict__ t_c, const float* __restrict__ t_f,
                           UnionCoarse cs, const float* __restrict__ dnorm,
                           const float* __restrict__ pix, int R, int Sc, int Sf, int c,
                           int white, float g_scale, float loss_scale,
                           float* __restrict__ gout, float* __restrict__ ray_loss,
                           float* __restrict__ scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ray = blockIdx.x * kWarps + warp;
  if (ray >= R) return;
  const int n = Sc + Sf, ld = 1 + c;
  float* mt = scratch + static_cast<size_t>(ray) * 5 * n;  // merged t
  int* src = reinterpret_cast<int*>(mt + n);  // coarse i, or Sc + fine j
  const float* tc = t_c + static_cast<size_t>(ray) * Sc;
  const float* tf = t_f + static_cast<size_t>(ray) * Sf;
  const size_t cbase = static_cast<size_t>(ray) * Sc, fbase = static_cast<size_t>(ray) * Sf;
  const float dn = dnorm[ray];

  for (int i = lane; i < Sc; i += 32) {
    const float t = tc[i];
    int lo = 0, hi = Sf;  // fine samples strictly before t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tf[mid] < t) lo = mid + 1; else hi = mid;
    }
    mt[i + lo] = t;
    src[i + lo] = i;
  }
  for (int j = lane; j < Sf; j += 32) {
    const float t = tf[j];
    int lo = 0, hi = Sc;  // coarse samples at or before t
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (tc[mid] <= t) lo = mid + 1; else hi = mid;
    }
    mt[j + lo] = t;
    src[j + lo] = Sc + j;
  }
  __syncwarp();

  auto put = [&](float* g, size_t at, float v) {
    if (cs.accumulate) g[at] += v; else g[at] = v;
  };
  // Merged position p holds coarse sample s = src[p] < Sc, or fine sample
  // s - Sc.
  NoWeightTerm none;
  const float loss = composite_ray(
      n, c, white ? 1.f : 0.f, pix + static_cast<size_t>(ray) * c, g_scale, loss_scale,
      mt + 2 * n,
      [&](int p) {
        const int s = src[p];
        if (s >= Sc) return fo[(fbase + s - Sc) * ld] + noise_f[fbase + s - Sc];
        const size_t q = cbase + s;
        return cs.noise != nullptr ? cs.dens[q * cs.dens_ld] + cs.noise[q] : cs.dens[q * cs.dens_ld];
      },
      [&](int p, int ch) {
        const int s = src[p];
        return s < Sc ? cs.col[(cbase + s) * cs.col_ld + ch] : fo[(fbase + s - Sc) * ld + 1 + ch];
      },
      [&](int p) { return p + 1 < n ? (mt[p + 1] - mt[p]) * dn : 1e10f; },
      [](int, float) {},
      [&](int p, int ch, float gl) {
        const int s = src[p];
        if (s < Sc) put(cs.g_col, (cbase + s) * cs.col_ld + ch, gl);
        else gout[(fbase + s - Sc) * ld + 1 + ch] = gl;
      },
      [&](int p, float gs) {
        const int s = src[p];
        if (s < Sc) put(cs.g_dens, (cbase + s) * cs.dens_ld, gs);
        else gout[(fbase + s - Sc) * ld] = gs;
      },
      none);
  if (lane == 0) ray_loss[ray] = loss;
}

}  // namespace nerf_mlp
