// The classic frequency encoding computed inside a kernel, shared by K8
// (classic_pointmlp_fwd.cu, classic_pointmlp_bwd.cu) and K9's fine stage
// (mega_train.cu).  Each is a loader for the tensor-core MLP tile
// (tc_mlp.cuh's EncA): it computes one k-chunk of the tile's encodings
// into the ring slab where TileLoad copies one from global memory in K1,
// and writes them to device memory where the backward's weight-gradient
// product reads them (K8-bwd, K9).  The tile's skip layer reads the x
// encodings a second time: from that copy where there is one (the block
// wrote it, and the barriers between the two products make it visible),
// else (K8-fwd) computed again.
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
// rounded to nearest even).  The slab holds what the products read: the
// float32 sines, or in bf16 the sines rounded to nearest even as the
// tensor-core tile rounds a float32 operand it loads (tc_mlp.cuh note 10),
// the JAX package's cast at the matmul boundary; the copy in device memory
// holds the same rounded values for the backward's weight-gradient
// product.
#pragma once

#include "tc_mlp.cuh"

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

// Chunk c of the encoding value(r, k) (row r of the tile, lane k < width,
// r < nvalid; zero elsewhere) into a ring slab (tc_mlp.cuh's stage_enc
// layout): float32 values, or with kBf16 pairs rounded to bfloat16.  The
// values also go to out [P][width] (of T, rows from row0) when out is not
// null.  Called by the whole block.
template <bool kBf16, class T, class Value>
__device__ __forceinline__ void encode_chunk(float* slab, int width, int c, size_t row0,
                                             int nvalid, T* out, Value value) {
  auto at = [&](int r, int k) {
    if (r >= nvalid || k >= width) return 0.f;
    const float v = value(r, k);
    if (out != nullptr) store_enc(out + (row0 + r) * width + k, v);
    return v;
  };
  for (int i = threadIdx.x; i < kTileRows * 16; i += kThreads) {
    const int r = i >> 4, j = i & 15;
    if constexpr (kBf16) {
      const int k = c * kTcKB + 2 * j;
      reinterpret_cast<uint32_t*>(slab)[r * kEncLd + j] = pack_bf16x2(at(r, k), at(r, k + 1));
    } else {
      slab[r * kEncLd + j] = at(r, c * kTcK + j);
    }
  }
}

// sin(src_r S + phase) of lane k for the tile's row r (src [P][3], rows
// from row0).
struct PlacedSine {
  const float* src;
  const float* S;
  const float* phase;
  int width;
  size_t row0;
  __device__ __forceinline__ float operator()(int r, int k) const {
    const float* q = src + (row0 + r) * 3;
    const float p[3] = {__ldg(q), __ldg(q + 1), __ldg(q + 2)};
    return sinf(__fadd_rn(enc_arg(p, S, width, k), __ldg(phase + k)));
  }
};

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
  template <bool kBf16>
  __device__ __forceinline__ void stage(const Weights& w, int which, int c, size_t row0,
                                        int nvalid, bool first, float* slab) const {
    if (which != 0) {
      encode_chunk<kBf16>(slab, w.de, c, row0, nvalid, d_out,
                          PlacedSine{dirs, sd, phd, w.de, row0});
      return;
    }
    // The skip layer: the copy the first product wrote (K8-bwd's, in the
    // compute dtype; K8-fwd writes none).
    if constexpr (std::is_same_v<T, enc_t<kBf16>>) {
      if (!first && x_out != nullptr) {
        stage_enc<kBf16>(slab, static_cast<const T*>(x_out), w.xe, 1, c, row0, nvalid);
        return;
      }
    }
    encode_chunk<kBf16>(slab, w.xe, c, row0, nvalid, x_out, PlacedSine{pts, sx, phx, w.xe, row0});
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
  template <bool kBf16>
  __device__ __forceinline__ void stage(const Weights& w, int which, int c, size_t row0,
                                        int nvalid, bool first, float* slab) const {
    if (which != 0) {
      stage_enc<kBf16>(slab, d_ray, w.de, per_ray, c, row0, nvalid);
      return;
    }
    if (!first) {  // the skip layer: the copy the first product wrote
      stage_enc<kBf16>(slab, static_cast<const T*>(x_out), w.xe, 1, c, row0, nvalid);
      return;
    }
    encode_chunk<kBf16>(slab, w.xe, c, row0, nvalid, x_out, [&](int r, int k) {
      const size_t row = row0 + r, ray = row / per_ray;
      const float tt = __ldg(t + row);
      float p[3];
#pragma unroll
      for (int e = 0; e < 3; ++e)
        p[e] = __fadd_rn(__ldg(o + ray * 3 + e), __fmul_rn(__ldg(dir + ray * 3 + e), tt));
      const float arg = enc_arg(p, S, w.xe, k);
      const float cs = __ldg(is_cos + k);
      return exact ? (cs > 0.f ? cosf(arg) : sinf(arg)) : sinf(__fadd_rn(arg, cs * kHalfPi));
    });
  }
};

template <class T>
inline constexpr bool kChunkedSums<RayEncodeLoadT<T>> = false;

}  // namespace nerf_mlp
