// The tensor-core products of tc_mlp.cuh alone, for the card tests of the
// 3xTF32 arithmetic and the operand layouts (tests/test_torch_cuda.py):
// no TPU kernel corresponds to these entry points and no path of the port
// calls them.
//
//   tc_linear: out [P][H] = A [P][K] @ W [K][H] through tc_gemm, one
//     64-row tile a block, the accumulators through tc_to_rows (img is the
//     operand image of W^T, tc_mlp.py::operand_image).  A's tile sits in
//     the activation tile where it fits (K <= H), as a hidden layer's
//     input does, else beside it.
//   tc_wgrad: out [splits][M][N], split k's partial of a^T b over its points
//     (wgrad_k_chunk) for b [P][N] and a's rows as WProd reads them (row p
//     of a [P][M] with div 1; p / div, and (p - split) / div2 for p >=
//     split > 0: the per-ray rows), through wgrad_tc_kernel (one product).
//   tc_linear_bf16, tc_wgrad_bf16: the same as bf16 products (note 10 of
//     tc_mlp.cuh): a and b float32, rounded to bf16 as the kernels round
//     them; img a bf16 image (operand_image with dtype bfloat16).
//
// Plain C interface for ctypes: returns a cudaError_t (0 on success).
#include "tc_mlp.cuh"

namespace {

using namespace nerf_mlp;

template <int H, bool kBf16>
NERF_TC_KERNEL
    tc_linear_kernel(const float* __restrict__ a, int P, int K, const float* __restrict__ img,
                     float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  float* bbuf = tc_smem_base(smem4);
  float* act = bbuf + tc_bbuf_floats<H>();
  float* as = K <= H ? act : act + kTileRows * act_ld<H>();  // [64][round_up4(K)]
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  tc_block<H, kBf16>(bbuf, [&](auto& pipe) {
    constexpr bool kC = std::decay_t<decltype(pipe)>::kConsumer;
    if constexpr (kC) load_tile(as, a, row0, nvalid, K, 1);  // tc_gemm starts with a barrier
    float d[H / 4];
    float acc[kRowsPerWarp][H / 32];
    tc_zero<H>(d);
    tc_gemm<H, kBf16>(pipe, d, as, round_up4(K), K, img);
    if constexpr (kC) {
      tc_to_rows<H>(d, act, acc);
      const int lane = threadIdx.x & 31;
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = (threadIdx.x >> 5) * kRowsPerWarp + r;
        if (row >= nvalid) continue;
#pragma unroll
        for (int j = 0; j < H / 32; ++j) out[(row0 + row) * H + lane + 32 * j] = acc[r][j];
      }
    }
  });
}

template <int H, bool kBf16>
cudaError_t linear(const float* a, int P, int K, const float* img, float* out,
                   cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(tc_bbuf_floats<H>()) +
       static_cast<size_t>(kTileRows) * (act_ld<H>() + (K <= H ? 0 : round_up4(K)))) *
          sizeof(float) +
      kSmemAlign;
  cudaError_t err = cudaFuncSetAttribute(
      tc_linear_kernel<H, kBf16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  tc_linear_kernel<H, kBf16><<<(P + kTileRows - 1) / kTileRows, kTcThreads, smem, stream>>>(
      a, P, K, img, out);
  return cudaGetLastError();
}

template <bool kBf16>
int linear_at(const float* a, const float* img, float* out, int P, int K, int hidden,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // The product at one instantiated width exactly (no padding here).
  switch (hidden) {
    case 32: return static_cast<int>(linear<32, kBf16>(a, P, K, img, out, st));
    case 64: return static_cast<int>(linear<64, kBf16>(a, P, K, img, out, st));
    case 128: return static_cast<int>(linear<128, kBf16>(a, P, K, img, out, st));
    case 256: return static_cast<int>(linear<256, kBf16>(a, P, K, img, out, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBf16>
int wgrad_at(const float* a, const float* b, float* out, int P, int M, int N, int splits,
             int div, int split, int div2, void* stream) {
  if (splits < 1 || div < 1 || div2 < 1) return static_cast<int>(cudaErrorInvalidValue);
  WProds prods{};
  prods.p[0] = WProd{a, nullptr, nullptr, b, M, M, N, div, 0, 0, (M + kWT - 1) / kWT,
                     (N + kWT - 1) / kWT, split, div2};
  prods.n = 1;
  // a and b read through tensor maps where TMA can (as the MLP launchers
  // map the chain), by bulk copies or from device memory otherwise.
  WgMaps maps{};
  cudaError_t err = cudaSuccess;
  if (div == 1 && (err = wg_add_map(maps, a, P, M)) == cudaSuccess)
    err = wg_add_map(maps, b, P, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_wgrad<kBf16>(
      maps, prods, prods.p[0].tiles_m * prods.p[0].tiles_n, P, wgrad_k_chunk(P, splits), splits,
      out, static_cast<size_t>(M) * N, static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" int tc_linear(const float* a, const float* img, float* out, int P, int K, int hidden,
                         void* stream) {
  return linear_at<false>(a, img, out, P, K, hidden, stream);
}

extern "C" int tc_wgrad(const float* a, const float* b, float* out, int P, int M, int N,
                        int splits, int div, int split, int div2, void* stream) {
  return wgrad_at<false>(a, b, out, P, M, N, splits, div, split, div2, stream);
}

extern "C" int tc_linear_bf16(const float* a, const void* img, float* out, int P, int K,
                              int hidden, void* stream) {
  return linear_at<true>(a, static_cast<const float*>(img), out, P, K, hidden, stream);
}

extern "C" int tc_wgrad_bf16(const float* a, const float* b, float* out, int P, int M, int N,
                             int splits, int div, int split, int div2, void* stream) {
  return wgrad_at<true>(a, b, out, P, M, N, splits, div, split, div2, stream);
}
