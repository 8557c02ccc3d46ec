// The classic frequency encoding computed inside a kernel, shared by K8
// (classic_pointmlp_fwd.cu, classic_pointmlp_bwd.cu) and K9's fine stage
// (mega_train.cu).  Each is a loader for the MLP tile (fwd_store_kernel's
// Load): it fills the zero-padded shared encoding tiles that load_tile
// fills from global memory in K1, so no encoding has to come from device
// memory.
//
// Lane k of the encoding of a point p [3] on a placement S [3][width] is
// sin(sum_c p_c S[c][k] + phase_k): row c of S holds the frequencies in
// scalar c's sin and cos blocks, phase_k is pi/2 on the cos lanes
// (cos z = sin(z + pi/2)).  Two of the three entries of a column of S are
// 0, so the rounded sum is exactly the one product p_c f_j, as the plain
// version's per-scalar product.
//
// compute_dtype="bfloat16": the loaders are templates on the type T of the
// encodings they also write to device memory (float, or __nv_bfloat16
// rounded to nearest even).  The shared tiles keep the float32 sines in
// both: the bf16 products round them where they load their operands
// (tc_mlp.cuh note 10; the SIMT tile's operand<true>), the JAX package's
// cast at the matmul boundary, and the copy in device memory holds the
// same rounded values for the backward's weight-gradient product.
#pragma once

#include "classic_mlp.cuh"

namespace nerf_mlp {

constexpr float kHalfPi = 1.57079632679489662f;  // float32(pi / 2), the phase

// The sine argument of lane k, without the phase; no FMA contraction, so
// it is the plain version's value to the bit.
__device__ __forceinline__ float enc_arg(const float (&p)[3], const float* __restrict__ S,
                                         int width, int k) {
  const float a = __fadd_rn(__fmul_rn(p[0], __ldg(S + k)), __fmul_rn(p[1], __ldg(S + width + k)));
  return __fadd_rn(a, __fmul_rn(p[2], __ldg(S + 2 * width + k)));
}

// An encoding value as stored in device memory: float32, or bfloat16.
__device__ __forceinline__ void store_enc(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_enc(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// dst [64][round_up4(width)] = sin(src_r S + phase) for the tile's rows r
// below nvalid (src [P][3], rows from row0), zero elsewhere; the values
// also go to out [P][width] when out is not null.
template <class T>
__device__ inline void encode_tile(float* dst, const float* __restrict__ src,
                                   const float* __restrict__ S, const float* __restrict__ phase,
                                   int width, size_t row0, int nvalid, T* out) {
  const int ld = round_up4(width);
  for (int i = threadIdx.x; i < kTileRows * ld; i += kThreads) {
    const int r = i / ld, k = i % ld;
    float v = 0.f;
    if (r < nvalid && k < width) {
      const float* q = src + (row0 + r) * 3;
      const float p[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
      v = sinf(__fadd_rn(enc_arg(p, S, width, k), __ldg(phase + k)));
      if (out != nullptr) store_enc(out + (row0 + r) * width + k, v);
    }
    dst[i] = v;
  }
}

// K8: the encodings of raw points [P][3] and view directions [P][3] on
// their placements (sx [3][xe], phx [xe]; sd [3][de], phd [de]); with x_out
// and d_out not null they are also written there ([P][xe], [P][de] of T:
// the backward's weight-gradient product reads them).
template <class T>
struct PointEncodeLoadT {
  const float* pts;
  const float* dirs;
  const float* sx;
  const float* phx;
  const float* sd;
  const float* phd;
  T* x_out;
  T* d_out;
  __device__ void operator()(const Weights& w, float* xs, float* ds, size_t row0,
                             int nvalid) const {
    encode_tile(xs, pts, sx, phx, w.xe, row0, nvalid, x_out);
    encode_tile(ds, dirs, sd, phd, w.de, row0, nvalid, d_out);
  }
};
using PointEncodeLoad = PointEncodeLoadT<float>;

// K9's fine stage: row r is sample r % per_ray of ray r / per_ray, at the
// point o + d t[r] (each product and sum rounded alone, as the plain
// version forms it); lane k is sin(arg + is_cos_k pi/2), or with exact
// cos(arg) on the cos lanes and sin(arg) on the others.  The encodings are
// also written to x_out [P][xe]; the view encodings are the ray's row of
// d_ray [R][de]; both of T.
template <class T>
struct RayEncodeLoadT {
  const float* o;
  const float* dir;
  const float* t;
  int per_ray;
  const float* S;
  const float* is_cos;
  int exact;
  const T* d_ray;
  T* x_out;
  __device__ void operator()(const Weights& w, float* xs, float* ds, size_t row0,
                             int nvalid) const {
    const int ld = round_up4(w.xe);
    for (int i = threadIdx.x; i < kTileRows * ld; i += kThreads) {
      const int r = i / ld, k = i % ld;
      float v = 0.f;
      if (r < nvalid && k < w.xe) {
        const size_t row = row0 + r, ray = row / per_ray;
        const float tt = __ldg(t + row);
        float p[3];
#pragma unroll
        for (int c = 0; c < 3; ++c)
          p[c] = __fadd_rn(__ldg(o + ray * 3 + c), __fmul_rn(__ldg(dir + ray * 3 + c), tt));
        const float arg = enc_arg(p, S, w.xe, k);
        const float cs = __ldg(is_cos + k);
        v = exact ? (cs > 0.f ? cosf(arg) : sinf(arg)) : sinf(__fadd_rn(arg, cs * kHalfPi));
        store_enc(x_out + row * w.xe + k, v);
      }
      xs[i] = v;
    }
    if (w.wd != nullptr) load_tile(ds, d_ray, row0, nvalid, w.de, per_ray);
  }
};

}  // namespace nerf_mlp
