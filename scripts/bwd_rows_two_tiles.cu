// A prototype of the MLP backward's row pass with two row tiles in flight:
// each consumer warpgroup of the 384-thread block owns its own 64-row tile
// over all H = 256 columns (m64n256 products, the accumulators in the
// wgmma layout throughout), so that one tile's LayerNorm backward can run
// while the other tile's products run.  It runs the hidden layers of the
// classic order (LayerNorm after ReLU), without heads and without the
// inputs' cotangents: from a given cotangent dh0 of the last layer's
// output, for i = L - 1 .. 0,
//
//   dpre_i = mask_i * inv_sigma_i * (dh g_i - mean(dh g_i) - xhat_i mean(dh g_i xhat_i)),
//   dh     = dpre_i W_{i-1}^T  (i > 0),
//
// storing every dpre_i and each warpgroup's running column sums (db, dg,
// dbeta) in tile order.  Driven, checked and timed by
// scripts/torch_bwd_rows_two_tiles.py; not part of the package.
//
// In this layout a row's values sit in one quad of one warp: the two row
// means are quad shuffles, the column sums shuffles over a warp's eight
// row groups and a sum over the warpgroup's four warps in shared memory.
// dpre leaves the registers once, for the chain; the next product reads
// its A fragments back from there (the thread's own stores, L1 or L2),
// so no shared memory holds an A tile and the B chunks take the rest.
// TF32: A fragment slot q (q + 4) of each k-step of 8 holds the
// accumulator's column 2q (2q + 1), so the B image's k order is permuted
// to match (the script builds it); bf16: the accumulator's layout is the
// A fragments' own.
//
// kParts takes the pass apart: kAll, both; kProducts, the products with
// each epilogue replaced by a wait of `spin` clock cycles and the stores
// of the accumulator as dpre (how far a given epilogue time hides behind
// the other tile's products; the stores keep the products' results live,
// which ptxas would otherwise drop with the products); kEpilogues, the
// epilogues without the products.  kBatch: the
// chunks whose products go between two waits (1 or 2).  Each library
// holds one dtype and one kBatch (-DTT_BF16, -DTT_BATCH).
//
// kMode picks the schedule:
//   kLockstep: one ring of the B chunks, both warpgroups' products and
//     epilogues in step (a barrier of both before each), so no epilogue
//     overlaps a product: the layout's arithmetic without the overlap;
//   kShared: one ring, the warpgroups free; one can run ahead of the other
//     by at most the ring's slots (6 TF32 chunks of the 16 a layer at H =
//     256; 12 bf16 ones of 8);
//   kTwoRings: a ring each (half the slots), both fed with the same chunks
//     by two producer threads from L2, so the warpgroups drift freely.
#include "tc_mlp.cuh"

#ifndef TT_BF16
#define TT_BF16 0
#endif
#ifndef TT_BATCH
#define TT_BATCH 2
#endif

namespace nerf_mlp {
namespace two_tiles {

constexpr int kH = 256;
constexpr int kRingBytes = 6 * 32768;             // the B chunks' slots
constexpr int kRedFloats = 2 * 4 * 3 * kH;        // [warpgroup][warp][sum][column]
constexpr size_t kSmemBytes = kRingBytes + kRedFloats * sizeof(float) + kSmemAlign;
enum Mode { kLockstep = 0, kShared = 1, kTwoRings = 2 };
enum Parts { kAll = 0, kProducts = 1, kEpilogues = 2 };

// Waits `cycles` clock cycles (the loop inside the asm: no divergent path
// that ptxas sees beside the products).
__device__ __forceinline__ void spin(long long cycles) {
  asm volatile(
      "{\n.reg .u64 t0, t1;\n.reg .s64 d;\n.reg .pred p;\nmov.u64 t0, %%clock64;\nSPIN:\n"
      "mov.u64 t1, %%clock64;\nsub.s64 d, t1, t0;\nsetp.lt.s64 p, d, %0;\n@p bra SPIN;\n}\n" ::"l"(
          cycles)
      : "memory");
}

// m64n256 products with A from registers (tf32: k8; bf16: k16).
__device__ __forceinline__ void wgmma_rs_256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_bf16_256(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <bool kBf16>
__device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kBf16) wgmma_rs_bf16_256(d, a, b); else wgmma_rs_256(d, a, b);
}

template <bool kBf16, int kMode>
struct Cfg {
  static constexpr int kChunkBytes = kBf16 ? kH * 32 * 2 : 2 * kH * 16 * 4;  // 16 / 32 KB
  static constexpr int kChunks = kBf16 ? kH / 32 : kH / 16;                  // a layer's
  static constexpr int kSlots = kRingBytes / kChunkBytes;                    // 12 / 6
  static constexpr int kRings = kMode == kTwoRings ? 2 : 1;
  static constexpr int kRingSlots = kSlots / kRings;
};

struct Ring {
  char* buf;
  uint32_t full0, empty0;
  int n, slot = 0;
  uint32_t phase = 0;
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
  __device__ void advance() {
    if (++slot == n) {
      slot = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void bar_both() { asm volatile("bar.sync 2, 256;\n" ::: "memory"); }
__device__ __forceinline__ void bar_wg(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }

// dh (acc) -> dpre_i (acc, and stored), the tile's column sums added to
// this warpgroup's running sums (part [3][L][H]).
__device__ __forceinline__ void epilogue(float (&acc)[128], int wg, int i, int L, size_t P,
                                         size_t row0, const float* __restrict__ xhat,
                                         const float* __restrict__ stats,
                                         const float* __restrict__ g, float* dpre, float* part,
                                         float* red, bool first) {
  const int wt = threadIdx.x & 127, wq = wt >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, q = lane & 3;
  const size_t r0 = row0 + 16 * wq + gq, r1 = r0 + 8;
  const size_t a0 = (static_cast<size_t>(i) * P + r0) * kH, a1 = (static_cast<size_t>(i) * P + r1) * kH;
  const float2 st0 = __ldg(reinterpret_cast<const float2*>(stats) + i * P + r0);
  const float2 st1 = __ldg(reinterpret_cast<const float2*>(stats) + i * P + r1);
  const float* gi = g + i * kH;
  float* my = red + (wg * 4 + wq) * 3 * kH;  // this warp's [3][H] partials
  constexpr float inv_h = 1.f / kH;
  float m1a = 0.f, m2a = 0.f, m1b = 0.f, m2b = 0.f;
#pragma unroll
  for (int j = 0; j < kH / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 x0 = __ldg(reinterpret_cast<const float2*>(xhat + a0 + c));
    const float2 x1 = __ldg(reinterpret_cast<const float2*>(xhat + a1 + c));
    const float2 gg = __ldg(reinterpret_cast<const float2*>(gi + c));
    float* d = acc + 4 * j;
    float v[4] = {d[0] + d[2], d[1] + d[3], fmaf(d[0], x0.x, d[2] * x1.x),
                  fmaf(d[1], x0.y, d[3] * x1.y)};  // dbeta, dg of columns c, c + 1
    d[0] *= gg.x;
    d[1] *= gg.y;
    d[2] *= gg.x;
    d[3] *= gg.y;
    m1a += d[0] + d[1];
    m2a = fmaf(d[0], x0.x, fmaf(d[1], x0.y, m2a));
    m1b += d[2] + d[3];
    m2b = fmaf(d[2], x1.x, fmaf(d[3], x1.y, m2b));
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
    if (gq == 0) {
      *reinterpret_cast<float2*>(my + 2 * kH + c) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(my + kH + c) = make_float2(v[2], v[3]);
    }
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    m1a += __shfl_xor_sync(kFull, m1a, o);
    m2a += __shfl_xor_sync(kFull, m2a, o);
    m1b += __shfl_xor_sync(kFull, m1b, o);
    m2b += __shfl_xor_sync(kFull, m2b, o);
  }
  m1a *= inv_h;
  m2a *= inv_h;
  m1b *= inv_h;
  m2b *= inv_h;
#pragma unroll
  for (int j = 0; j < kH / 8; ++j) {
    const int c = 8 * j + 2 * q;
    const float2 x0 = __ldg(reinterpret_cast<const float2*>(xhat + a0 + c));
    const float2 x1 = __ldg(reinterpret_cast<const float2*>(xhat + a1 + c));
    float* d = acc + 4 * j;
    d[0] = x0.x > st0.y ? st0.x * (d[0] - m1a - x0.x * m2a) : 0.f;
    d[1] = x0.y > st0.y ? st0.x * (d[1] - m1a - x0.y * m2a) : 0.f;
    d[2] = x1.x > st1.y ? st1.x * (d[2] - m1b - x1.x * m2b) : 0.f;
    d[3] = x1.y > st1.y ? st1.x * (d[3] - m1b - x1.y * m2b) : 0.f;
    *reinterpret_cast<float2*>(dpre + a0 + c) = make_float2(d[0], d[1]);
    *reinterpret_cast<float2*>(dpre + a1 + c) = make_float2(d[2], d[3]);
    float v[2] = {d[0] + d[2], d[1] + d[3]};  // db
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < 2; ++k) v[k] += __shfl_xor_sync(kFull, v[k], o);
    if (gq == 0) *reinterpret_cast<float2*>(my + c) = make_float2(v[0], v[1]);
  }
  bar_wg(wg);
  // Thread wt: columns 2 wt, 2 wt + 1 of the three sums, the warps in order.
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    float2 t = make_float2(0.f, 0.f);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float2 u = ld2(red + ((wg * 4 + w) * 3 + s) * kH + 2 * wt);
      t.x += u.x;
      t.y += u.y;
    }
    float2* out = reinterpret_cast<float2*>(part + (static_cast<size_t>(s) * L + i) * kH + 2 * wt);
    if (!first) {
      const float2 o = *out;
      t.x += o.x;
      t.y += o.y;
    }
    *out = t;
  }
  bar_wg(wg);
}

// The accumulator's rows r0, r0 + 8 -> dp [P][H] (kProducts' epilogue).
__device__ __forceinline__ void store_rows(const float (&acc)[128], float* dp, size_t r0) {
  const int q = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < kH / 8; ++j) {
    const int c = 8 * j + 2 * q;
    *reinterpret_cast<float2*>(dp + r0 * kH + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(dp + (r0 + 8) * kH + c) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// acc = dpre_i W^T over the ring's chunks of the layer's image, A read
// back from dpre_i (the thread's own stores).
template <bool kBf16, int kMode, int kBatch>
__device__ __forceinline__ void product(Ring& ring, float (&acc)[128], const float* dp, size_t r0) {
  using C = Cfg<kBf16, kMode>;
  const int lane = threadIdx.x & 31, q = lane & 3;
  const float* p0 = dp + r0 * kH + 2 * q;
  const float* p1 = p0 + 8 * kH;
#pragma unroll
  for (int k = 0; k < 128; ++k) acc[k] = 0.f;
  constexpr int kSteps = 2 * kBatch;  // k-steps of a batch (of 16 bf16 or 8 TF32 values)
  for (int c = 0; c < C::kChunks; c += kBatch) {
    uint32_t ahi[kSteps][4], alo[kSteps][4];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if constexpr (kBf16) {
        const int k = 32 * c + 16 * s;
        const float2 u0 = ld2(p0 + k), u1 = ld2(p1 + k), w0 = ld2(p0 + k + 8), w1 = ld2(p1 + k + 8);
        ahi[s][0] = pack_bf16x2(u0.x, u0.y);
        ahi[s][1] = pack_bf16x2(u1.x, u1.y);
        ahi[s][2] = pack_bf16x2(w0.x, w0.y);
        ahi[s][3] = pack_bf16x2(w1.x, w1.y);
      } else {
        const int k = 16 * c + 8 * s;
        const float2 u0 = ld2(p0 + k), u1 = ld2(p1 + k);
        split_tf32(u0.x, ahi[s][0], alo[s][0]);
        split_tf32(u1.x, ahi[s][1], alo[s][1]);
        split_tf32(u0.y, ahi[s][2], alo[s][2]);
        split_tf32(u1.y, ahi[s][3], alo[s][3]);
      }
    }
    const int s0 = ring.slot;
    mbar_wait(ring.full(ring.slot), ring.phase);
    ring.advance();
    const int s1 = ring.slot;
    if constexpr (kBatch == 2) {
      mbar_wait(ring.full(ring.slot), ring.phase);
      ring.advance();
    }
    uint64_t bd[kSteps][2];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const float* base = reinterpret_cast<const float*>(
          ring.buf + static_cast<size_t>(s < 2 ? s0 : s1) * C::kChunkBytes);
      bd[s][0] = smem_desc_sw64(base + 8 * (s & 1));
      bd[s][1] = smem_desc_sw64(base + kH * kTcK + 8 * (s & 1));
    }
    fence_regs(bd);
    fence_regs(ahi);
    if constexpr (!kBf16) fence_regs(alo);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      mma<kBf16>(acc, ahi[s], bd[s][0]);
      if constexpr (!kBf16) {
        mma<kBf16>(acc, ahi[s], bd[s][1]);
        mma<kBf16>(acc, alo[s], bd[s][0]);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(acc);
    mbar_arrive_if_zero(ring.empty(s0), threadIdx.x & 127);
    if constexpr (kBatch == 2) mbar_arrive_if_zero(ring.empty(s1), threadIdx.x & 127);
  }
}

template <bool kBf16, int kMode, int kParts, int kBatch>
__global__ void __launch_bounds__(kTcThreads, 1)
    rows_kernel(const float* __restrict__ xhat, const float* __restrict__ stats,
                const float* __restrict__ g, const float* __restrict__ dh0,
                const char* __restrict__ img, float* dpre, float* part, int P, int L,
                long long spin_cycles) {
  using C = Cfg<kBf16, kMode>;
  extern __shared__ float4 smem4[];
  char* ring_buf = reinterpret_cast<char*>(tc_smem_base(smem4));
  float* red = reinterpret_cast<float*>(ring_buf + kRingBytes);
  __shared__ __align__(8) uint64_t bars[2 * C::kSlots];
  const uint32_t b0 = smem_u32(bars);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kSlots; ++s) {
      mbar_init(b0 + 8 * s, 1);
      mbar_init(b0 + 8 * (C::kSlots + s), 3 - C::kRings);  // empties: each reader warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int pairs = P / (2 * kTileRows);
  const size_t PP = static_cast<size_t>(P);
  const size_t slab = static_cast<size_t>(C::kChunks) * C::kChunkBytes;
  const int role = __shfl_sync(kFull, threadIdx.x >> 7, 0);  // warp-uniform
  if (role == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kTcProducerRegs));
    const int r = (threadIdx.x - kThreads) >> 5;  // ring of this producer warp
    if (r < C::kRings && (threadIdx.x & 31) == 0) {
      Ring ring{ring_buf + r * C::kRingSlots * C::kChunkBytes, b0 + 8 * r * C::kRingSlots,
                b0 + 8 * (C::kSlots + r * C::kRingSlots), C::kRingSlots};
      for (int p = blockIdx.x; p < pairs && kParts != kEpilogues; p += gridDim.x)
        for (int i = L - 1; i > 0; --i)
          for (int c = 0; c < C::kChunks; ++c) {
            mbar_wait(ring.empty(ring.slot), ring.phase ^ 1);
            mbar_expect_tx(ring.full(ring.slot), C::kChunkBytes);
            bulk_copy(smem_u32(ring.buf + static_cast<size_t>(ring.slot) * C::kChunkBytes),
                      img + (i - 1) * slab + static_cast<size_t>(c) * C::kChunkBytes,
                      C::kChunkBytes, ring.full(ring.slot));
            ring.advance();
          }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kTcConsumerRegs));
  const int wg = role;
  const int r = C::kRings == 2 ? wg : 0;
  Ring ring{ring_buf + r * C::kRingSlots * C::kChunkBytes, b0 + 8 * r * C::kRingSlots,
            b0 + 8 * (C::kSlots + r * C::kRingSlots), C::kRingSlots};
  float* my_part = part + (2 * static_cast<size_t>(blockIdx.x) + wg) * 3 * L * kH;
  const int lane = threadIdx.x & 31, wq = (threadIdx.x & 127) >> 5;
  float acc[128];
  for (int p = blockIdx.x; p < pairs; p += gridDim.x) {
    const bool first = p == static_cast<int>(blockIdx.x);
    const size_t row0 = (2 * static_cast<size_t>(p) + wg) * kTileRows;
    const size_t r0 = row0 + 16 * wq + (lane >> 2);
    // dh of the last layer: the accumulator layout's rows r0, r0 + 8.
#pragma unroll
    for (int j = 0; j < kH / 8; ++j) {
      const int c = 8 * j + 2 * (lane & 3);
      const float2 u = __ldg(reinterpret_cast<const float2*>(dh0 + r0 * kH + c));
      const float2 v = __ldg(reinterpret_cast<const float2*>(dh0 + (r0 + 8) * kH + c));
      acc[4 * j] = u.x;
      acc[4 * j + 1] = u.y;
      acc[4 * j + 2] = v.x;
      acc[4 * j + 3] = v.y;
    }
    for (int i = L - 1; i >= 0; --i) {
      if constexpr (kMode == kLockstep) bar_both();
      if constexpr (kParts == kProducts) {
        spin(spin_cycles);
        store_rows(acc, dpre + static_cast<size_t>(i) * PP * kH, r0);
      } else
        epilogue(acc, wg, i, L, PP, row0, xhat, stats, g, dpre, my_part, red, first);
      if (i == 0) break;
      if constexpr (kMode == kLockstep) bar_both();
      if constexpr (kParts != kEpilogues)
        product<kBf16, kMode, kBatch>(ring, acc, dpre + static_cast<size_t>(i) * PP * kH, r0);
    }
  }
}

template <int kMode, int kParts>
int launch(const float* xhat, const float* stats, const float* g, const float* dh0,
           const void* img, float* dpre, float* part, int P, int L, int blocks,
           long long spin_cycles) {
  auto k = rows_kernel<TT_BF16 != 0, kMode, kParts, TT_BATCH>;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(kSmemBytes)) != cudaSuccess)
    return 1;
  k<<<blocks, kTcThreads, kSmemBytes>>>(xhat, stats, g, dh0, static_cast<const char*>(img), dpre,
                                        part, P, L, spin_cycles);
  return cudaGetLastError() == cudaSuccess ? 0 : 2;
}

}  // namespace two_tiles
}  // namespace nerf_mlp

// mode: 0 lockstep, 1 shared ring, 2 two rings; parts: 0 all, 1 the
// products with a spin of spin_cycles for each epilogue, 2 the epilogues;
// P a multiple of 128.  The library's dtype and batch: TT_BF16, TT_BATCH.
extern "C" int two_tiles_rows(int mode, int parts, long long spin_cycles, const float* xhat,
                              const float* stats, const float* g, const float* dh0,
                              const void* img, float* dpre, float* part, int P, int L,
                              int blocks) {
  using namespace nerf_mlp::two_tiles;
  if (P % (2 * nerf_mlp::kTileRows) != 0) return 3;
#define TT_CASE(m, q)                                                                     \
  case m * 3 + q:                                                                         \
    return launch<m, q>(xhat, stats, g, dh0, img, dpre, part, P, L, blocks, spin_cycles);
  switch (mode * 3 + parts) {
    TT_CASE(0, 0) TT_CASE(0, 1) TT_CASE(0, 2)
    TT_CASE(1, 0) TT_CASE(1, 1) TT_CASE(1, 2)
    TT_CASE(2, 0) TT_CASE(2, 1) TT_CASE(2, 2)
  }
#undef TT_CASE
  return 4;
}
