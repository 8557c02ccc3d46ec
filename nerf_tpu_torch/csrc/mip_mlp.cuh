// Device code of the HEAD (mip) NeRF point MLP, shared by K5-fwd
// (mip_mlp_fwd.cu), K5-bwd (mip_mlp_bwd.cu), K6 (mip_train_grads.cu) and
// K7 (mip_eval.cu).
//
// The network (nerf_tpu_torch/models/mlp.py::MipMLP): L layers of
// Linear -> LayerNorm(eps 1e-5) -> ReLU, LayerNorm BEFORE ReLU (the reverse
// of the classic order), L0 F -> H and L1..L(L-1) H -> H, then one head
// Linear H -> O = 1 + colours + classes.  No skip, no view branch.
//
// The TPU kernels (fused_mip_mlp.py, fused_mip_train.py) keep all weights
// and a tile's whole chain in VMEM.  Here the passes are the classic MLP's
// (classic_mlp.cuh, classic_mlp_train.cuh, tc_mlp.cuh), instantiated for
// this chain, their products through the policy MipTc (3xTF32 wgmma on the
// tensor cores; K5-fwd, K5-bwd, K6 and K7):
//   * the forward tile: 64 rows per block of 8 warps, the classic tile
//     (tc_mlp.cuh) with the features as its one encoding, streamed through
//     the encodings' ring a k-chunk at a time (MipFeatLoadT) and read by
//     layer 0 only, so its bytes are tc_tile_bytes at every feature width
//     (note 9); the epilogue in registers with the LayerNorm first
//     (layer_epilogue<kLnFirst>), and the head as a register-tiled float32
//     product (head_wide) over 64-column blocks of any width; with kSave it
//     stores every layer's xhat and (1/sigma, -mu/sigma) for the backward;
//   * bwd_rows: the head's input cotangent on the tensor cores (a tc_gemm
//     on the image of w_out as it stands, [H][O], the output cotangents
//     staged through the activation tile H columns at a time, so any head
//     width takes the same bytes; past 256 head_dh_rows), then per layer the
//     mask on the rebuilt LayerNorm output xhat * g + beta > 0 and the
//     LayerNorm backward (layer_bwd<kLnFirst>), and dh = dpre @ W^T as
//     tc_gemm on the slabs' backward images (mip_bwd_rows_tc_kernel, which
//     also writes the features' cotangent where asked: tc_input_grad);
//   * wgrad: every dW as a product over the points, the head's too (its
//     left operand relu(xhat * g + beta) of the last layer, its right one
//     the output cotangents: N = O, not a multiple of 4), launched in
//     groups of kMaxProds products (any number of layers), then colsum of
//     the partials in a fixed order.
// The flat gradient: w_in, whh, w_out | b, g, beta, b_out.
//
// compute_dtype="bfloat16" (the template parameter kBf16 of the tiles, the
// kernels and MipTcT; tc_mlp.cuh note 10): the features arrive as bfloat16
// (staged as the pairs they are), the products are bf16 wgmma on bf16
// images (tc_gemm<N, true>), and the head rounds its operands as head<H,
// true> does: head_wide rounds h and W, the head's backward product the
// output cotangents and W (its b_out sums stay float32).  wgrad is TcProductsT<true>'s, on the
// bf16 raw features (WProd::a_bf16), and K5-bwd's features' cotangent is
// written as bfloat16, the features' dtype.
#pragma once

#include "tc_mlp.cuh"

namespace nerf_mlp {

struct MipWeights {
  const float* w_in;   // [F, H]
  const float* whh;    // [L-1, H, H]
  const float* b;      // [L, H] Linear biases
  const float* g;      // [L, H] LayerNorm scales
  const float* beta;   // [L, H] LayerNorm biases
  const float* w_out;  // [H, O]
  const float* b_out;  // [O]
  int F, L, O;
  int h = 0, hp = 0;   // the hidden width and its padded width (sized())
  float inv_h = 0.f, padded = 0.f;  // 1 / h and hp - h (sized())
};

// The forward operand images of a mip call (tc_mlp.py::tc_images): w_in as
// [H][round_up_chunk(F)], then the hidden slabs as [out][in], each 2 H H
// floats (kBf16: bf16 images, tc_image_floats<true> each).
struct MipImages {
  const float* w_in;
  const float* whh;
  template <bool kBf16 = false>
  __host__ static MipImages forward(const MipWeights& w, const float* base, int H) {
    return MipImages{base, base + tc_image_floats<kBf16>(H, w.F)};
  }
};

// Floats of the weight-slab part (w_in, whh, w_out) of the flat gradient.
__host__ inline size_t mip_wgrad_floats(const MipWeights& w, int H) {
  return static_cast<size_t>(w.F) * H + static_cast<size_t>(w.L - 1) * H * H +
         static_cast<size_t>(H) * w.O;
}

// Floats of one tile's partials: b, g, beta [L][H], b_out [O].
__host__ __device__ inline size_t mip_tile_floats(const MipWeights& w, int H) {
  return static_cast<size_t>(3 * w.L) * H + w.O;
}

// out[row * n + c] = h[row] . W[:, c] + bias[c] for c < n and the tile's
// valid rows: a head wider than the classic ones (W row-major [H, n]).  A
// dot product per output across the warp would cost five shuffles a row
// and output; instead h goes through act (each warp its own rows, row
// stride LD = act_ld<H>(), at which other warps may still be reading their
// rows of act) and each lane accumulates columns c0 + lane and c0 + 32 +
// lane of a 64-column block, W staged through wbuf (16 x H floats) in
// chunks of H / 4 rows x 64 columns, read once per block; any n takes
// ceil(n / 64) blocks.  kBf16: h and W rounded to bfloat16 as they are
// staged (the JAX package's _dot on the head).
template <int H, int LD, bool kBf16 = false>
__device__ void head_wide(const float (&h)[kRowsPerWarp][H / 32], float* act, float* wbuf,
                          const float* __restrict__ W, const float* __restrict__ bias, int n,
                          float* out, int nvalid) {
  constexpr int kRows = H / 4;  // W rows per staged chunk: kRows * 64 = 16 * H floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* a_rows = act + warp * kRowsPerWarp * LD;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int j = 0; j < H / 32; ++j) a_rows[r * LD + lane + 32 * j] = operand<kBf16>(h[r][j]);
  for (int c0 = 0; c0 < n; c0 += 64) {
    float acc[kRowsPerWarp][2];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int k0 = 0; k0 < H; k0 += kRows) {
      // The chunk before is consumed, and this warp's rows of act written.
      tile_sync();
      for (int i = threadIdx.x; i < kRows * 64; i += kThreads) {
        const int c = c0 + i % 64;
        wbuf[i] = c < n ? operand<kBf16>(__ldg(W + static_cast<size_t>(k0 + i / 64) * n + c))
                        : 0.f;
      }
      tile_sync();
      for (int kk = 0; kk < kRows; kk += 4) {
        float4 a[kRowsPerWarp];
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r)
          a[r] = *reinterpret_cast<const float4*>(a_rows + r * LD + k0 + kk);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wa = wbuf[(kk + q) * 64 + lane], wb = wbuf[(kk + q) * 64 + 32 + lane];
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            const float av = q == 0 ? a[r].x : q == 1 ? a[r].y : q == 2 ? a[r].z : a[r].w;
            acc[r][0] = fmaf(av, wa, acc[r][0]);
            acc[r][1] = fmaf(av, wb, acc[r][1]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = warp * kRowsPerWarp + r;
      if (row >= nvalid) continue;
      if (c0 + lane < n) out[row * n + c0 + lane] = acc[r][0] + __ldg(bias + c0 + lane);
      if (c0 + 32 + lane < n)
        out[row * n + c0 + 32 + lane] = acc[r][1] + __ldg(bias + c0 + 32 + lane);
    }
  }
}

// The features x [P][F] of a mip call as the tile's one encoding (an EncA
// loader, tc_mlp.cuh note 9): chunk c of the tile's rows through stage_enc,
// float32 values or the bfloat16 pairs as stored (T, the compute dtype's).
template <class T>
struct MipFeatLoadT {
  const T* x;
  template <bool kBf16>
  __device__ __forceinline__ void stage(const MipWeights& w, int, int c, size_t row0, int nvalid,
                                        bool, float* slab) const {
    stage_enc<kBf16>(slab, x, w.F, 1, c, row0, nvalid);
  }
};

// The mip features' product sums its bf16 chunks in one pipelined
// accumulator at every width (tc_gemm's kChunkedSums): at 96 features
// (three chunks) that is the arithmetic the kernels had with the features
// resident, and at 600 (19 chunks) the kernels stay well inside the
// card's bf16 bounds either way.  On an H100, 16,128 rows: K5-bwd's
// gradients with dfeat 5.1e-3 from the plain bf16 version pipelined, 4.1e-3
// chunked, the plain version's own float64-sum distance 4.2e-3, against
// 2e-2; K7 2.2e-4 and 1.2e-4 against 1e-2
// (scripts/torch_bf16_sensitivity.py --family mip-widths).
template <class T>
inline constexpr bool kChunkedSums<MipFeatLoadT<T>> = false;

// The whole network on one 64-row tile on the tensor cores (mlp_tile_tc's
// order, tc_mlp.cuh): layer 0 is tc_gemm on the features that `load`
// streams through the ring (EncA), layers 1..L-1 on the activation tile act
// ([64][act_ld<H>()]) with the hidden slabs' forward images; each product's
// accumulators go through act into the row-per-warp layout, where
// layer_epilogue<kLnFirst> runs.  The head stays on the SIMT cores
// (head_wide), its weights staged through the B chunk buffers, lent by the
// pipe once the last product has retired.  Writes the O outputs of the
// tile's valid rows to out (row stride O); with kSave every layer's xhat
// and statistics go to save.  kBf16: bf16 images and products, the head's
// operands rounded (note 10).  In the producer's role only the products'
// copies (tc_mlp.cuh's tc_block).
template <int H, bool kSave, bool kBf16, class Pipe, class Load>
__device__ void mip_tile_tc(Pipe& pipe, const MipWeights& w, const MipImages& im, const Load& load,
                            size_t row0, int nvalid, float* act, float* ring, float* out,
                            const Save* save) {
  constexpr bool kC = Pipe::kConsumer;
  constexpr int ald = act_ld<H>();
  const size_t slab = tc_image_floats<kBf16>(H, H);
  float d[H / 4];
  float acc[kRowsPerWarp][H / 32];
  tc_zero<H>(d);
  tc_gemm<H, kBf16>(pipe, d, EncA<Load, MipWeights>{load, w, 0, row0, nvalid, true, ring}, w.F,
                    im.w_in);
  if constexpr (kC) {
    tc_to_rows<H>(d, act, acc);
    layer_epilogue<H, kSave, true>(acc, w.b, w.g, w.beta, w.inv_h, w.padded, save, 0);
  }
  for (int i = 1; i < w.L; ++i) {
    if constexpr (kC) tc_store_rows<H>(acc, act);
    tc_zero<H>(d);
    tc_gemm<H, kBf16>(pipe, d, act, ald, H, im.whh + (i - 1) * slab);
    if constexpr (kC) {
      tc_to_rows<H>(d, act, acc);
      layer_epilogue<H, kSave, true>(acc, w.b + i * H, w.g + i * H, w.beta + i * H, w.inv_h,
                                     w.padded, save, i);
    }
  }
  pipe.lend([&] { head_wide<H, ald, kBf16>(acc, act, pipe.buf, w.w_out, w.b_out, w.O, out, nvalid); });
}

// mip_tile_tc past 256 (tc_mlp.cuh note 11): the layers in column blocks,
// the tile's rows in device memory (pre, nrm), LayerNorm first (wide_norm
// <kLnFirst>), the head over nrm (head_rows).
template <bool kSave, bool kBf16, class Pipe, class Load>
__device__ void mip_tile_wide(Pipe& pipe, const MipWeights& w, const MipImages& im,
                              const Load& load, size_t row0, int nvalid, float* act, float* ring,
                              float* out, const Save* save, float* pre, float* nrm_f) {
  constexpr bool kC = Pipe::kConsumer;
  using T = enc_t<kBf16>;
  constexpr int B = kColBlock;
  T* nrm = reinterpret_cast<T*>(nrm_f);
  const int hp = w.hp, nb = hp / B;
  const size_t blk_f = tc_image_floats<kBf16>(B, w.F), blk_h = tc_image_floats<kBf16>(B, hp);
  const size_t slab = tc_image_floats<kBf16>(hp, hp);
  const RowsLoadT<T> rows{nrm, hp};
  const EncA<RowsLoadT<T>, MipWeights> prev{rows, w, 0, 0, nvalid, false, ring};
  float d[B / 4];
  for (int i = 0; i < w.L; ++i) {
    for (int cb = 0; cb < nb; ++cb) {
      tc_zero<B>(d);
      if (i == 0)
        tc_gemm<B, kBf16>(pipe, d, EncA<Load, MipWeights>{load, w, 0, row0, nvalid, true, ring},
                          w.F, im.w_in + cb * blk_f);
      else
        tc_gemm<B, kBf16>(pipe, d, prev, hp, im.whh + (i - 1) * slab + cb * blk_h);
      if constexpr (kC) wide_store_block<false>(d, act, pre, hp, cb, w.b + i * hp, nvalid);
    }
    if constexpr (kC)
      wide_norm<kSave, true>(pre, nrm, hp, w.h, w.inv_h, nvalid, w.g + i * hp, w.beta + i * hp,
                             save, i);
  }
  auto head = [&] {
    head_rows<kBf16>(nrm, hp, act, pipe.buf, w.w_out, w.b_out, w.O, out, w.O, 0, nvalid);
  };
  if (w.O > kFewOutputs)
    pipe.lend(head);
  else if constexpr (kC)
    head();
}

// The forward tile of a block: the B chunks, the activation tile and the
// features' ring, in tc_tile_bytes<col_width<H>()>() (fwd_store's layout)
// at every feature width.  kBf16: bfloat16 features and images.  wide:
// the tiles' rows past hidden 256 (note 11).
template <int H, bool kSave, bool kBf16>
__device__ __forceinline__ void mip_fwd_tc_block(const MipWeights& w, const MipImages& im,
                                                 const enc_t<kBf16>* x, float* out, int P,
                                                 float* xhat, float* stats, const WideRows& wide) {
  constexpr int HT = col_width<H>();
  extern __shared__ float4 smem4[];
  float* bbuf = tc_smem_base(smem4);
  float* act = bbuf + tc_bbuf_floats<HT>();
  float* ring = act + kTileRows * act_ld<HT>();
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  const Save save{xhat, stats, static_cast<size_t>(P), row0, nvalid};
  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    if constexpr (H > kColBlock)
      mip_tile_wide<kSave, kBf16>(pipe, w, im, MipFeatLoadT<enc_t<kBf16>>{x}, row0, nvalid, act,
                                  ring, out + row0 * w.O, &save,
                                  wide.pre + blockIdx.x * wide.stride,
                                  wide.nrm + blockIdx.x * wide.stride);
    else
      mip_tile_tc<H, kSave, kBf16>(pipe, w, im, MipFeatLoadT<enc_t<kBf16>>{x}, row0, nvalid, act,
                                   ring, out + row0 * w.O, &save);
  });
}

// K6's and K5-bwd's stored-chain forward over features x [P][F] -> out
// [P][O], every layer's xhat [L][P][H] and statistics [L][P][2] stored for
// the backward passes.  One block an SM.
template <int H, bool kBf16 = false>
NERF_TC_KERNEL
    mip_fwd_store_tc_kernel(MipWeights w, MipImages im, const enc_t<kBf16>* __restrict__ x,
                            float* __restrict__ out, int P, float* xhat, float* stats,
                            WideRows wide) {
  mip_fwd_tc_block<H, true, kBf16>(w, im, x, out, P, xhat, stats, wide);
}

// K7's and K5-fwd's forward, nothing saved.  One block an SM.
template <int H, bool kBf16 = false>
NERF_TC_KERNEL
    mip_fwd_tc_kernel(MipWeights w, MipImages im, const enc_t<kBf16>* __restrict__ x,
                      float* __restrict__ out, int P, WideRows wide) {
  mip_fwd_tc_block<H, false, kBf16>(w, im, x, out, P, nullptr, nullptr, wide);
}

// The k-values of each product of the head's input cotangent: a constant
// (a K known only at run time puts the batches' guards on a divergent path
// beside the wgmma, and ptxas then serializes every product of the kernel,
// C7520), which both image chunks (16 and 32 values) divide; w_out's image
// pads its K = O to a multiple of it (tc_mlp.py::HEAD_K).
constexpr int kHeadK = 32;

// Bytes of shared memory of mip_bwd_rows_tc_kernel: the B chunks, the
// activation tile (which also stages the head's output cotangents, H
// columns at a time), the colsum scratch (kWarps x H floats) and the
// alignment slack, at every head width.
template <int H>
__host__ constexpr size_t mip_bwd_rows_tc_smem() {
  constexpr int HT = col_width<H>();
  return (static_cast<size_t>(tc_bbuf_floats<HT>()) + static_cast<size_t>(kTileRows) * act_ld<HT>() +
          (H > kColBlock ? kEncRingFloats : static_cast<size_t>(kWarps) * H)) *
             sizeof(float) +
         kSmemAlign;
}

// The head's input cotangent past hidden 256, over rows in device memory
// (tc_mlp.cuh note 11), SIMT: dh [64][hp] =
// gout[tile rows, 0:O] @ W^T for the tile's valid rows (kBf16 rounds gout
// and W), and the tile's column sums of gout to p_bout.  A thread a
// column, its 64 rows' sums in registers; the output cotangents staged
// through gs ([64][64], zero past the valid rows and past O) 64 outputs at
// a time, so each weight is read once.  Ends with a barrier of the tile's threads.
template <bool kBf16>
__device__ void head_dh_rows(const float* __restrict__ gout, int O, size_t row0, int nvalid,
                             const float* __restrict__ W, int hp, float* dh, float* gs,
                             float* p_bout) {
  for (int q = threadIdx.x; q < O; q += kThreads) {
    float s = 0.f;
    for (int r = 0; r < nvalid; ++r) s += gout[(row0 + r) * O + q];
    p_bout[q] = s;
  }
  for (int k0 = 0; k0 < hp; k0 += kThreads) {  // hp is a multiple of 256
    const int k = k0 + threadIdx.x;
    float v[kTileRows];
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) v[r] = 0.f;
    for (int q0 = 0; q0 < O; q0 += 64) {
      tile_sync();  // gs's last readers are done
      for (int i = threadIdx.x; i < kTileRows * 64; i += kThreads) {
        const int r = i >> 6, q = q0 + (i & 63);
        gs[i] = r < nvalid && q < O ? operand<kBf16>(gout[(row0 + r) * O + q]) : 0.f;
      }
      tile_sync();
      for (int qq = 0; qq < min(64, O - q0); ++qq) {
        const float wq = operand<kBf16>(__ldg(W + static_cast<size_t>(k) * O + q0 + qq));
#pragma unroll
        for (int r = 0; r < kTileRows; ++r) v[r] = fmaf(gs[r * 64 + qq], wq, v[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kTileRows; ++r)
      if (r < nvalid) dh[static_cast<size_t>(r) * hp + k] = v[r];
  }
  tile_sync();
}

// mip_bwd_rows_tc_kernel past 256 (note 11): each layer's dh goes to the
// tile's rows of its dpre, where layer_bwd_wide<kLnFirst> turns it into
// dpre.
template <bool kBf16, class Pipe>
__device__ void mip_bwd_rows_wide(Pipe& pipe, const MipWeights& w, const float* __restrict__ gout,
                                  int P, const float* xhat, const float* stats,
                                  const float* __restrict__ bwd, float* dpre, float* tpart,
                                  void* dx, float* act, float* ring) {
  constexpr bool kC = Pipe::kConsumer;
  const int L = w.L, hp = w.hp;
  const size_t slab = tc_image_floats<kBf16>(hp, hp), PP = static_cast<size_t>(P);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  float* p_b = tpart + blockIdx.x * mip_tile_floats(w, hp);
  float* p_g = p_b + L * hp;
  float* p_beta = p_g + L * hp;
  auto rows = [&](int layer) { return dpre_rows(dpre, layer, PP, row0, hp); };
  pipe.lend([&] {
    head_dh_rows<kBf16>(gout, w.O, row0, nvalid, w.w_out, hp, rows(L - 1), pipe.buf,
                        p_beta + L * hp);
  });
  for (int i = L - 1; i >= 0; --i) {
    if constexpr (kC)
      layer_bwd_wide<true>(rows(i), i, w.g + i * hp, w.beta + i * hp, w.h, w.inv_h, hp, PP,
                           row0, nvalid, xhat, stats, p_b, p_g, p_beta);
    if (i == 0) break;
    wide_dh<kBf16>(pipe, w, rows(i), rows(i - 1), hp, nvalid, bwd + (i - 1) * slab, act, ring);
  }
  if (dx != nullptr)
    tc_input_grad_wide<kBf16, enc_t<kBf16>>(pipe, w, act, ring, dpre, PP, row0, nvalid, hp, 0,
                                            tc_input_images<kBf16>(bwd, L - 1, hp), -1, nullptr,
                                            w.F, dx);
}

// From the output cotangents gout [P][O] down through the layers, storing
// every layer's dpre and the tile's column sums (b, g, beta, b_out) to its
// row of tpart, with the hidden products dh = dpre W^T on the tensor
// cores (bwd_rows_tc_kernel's order, tc_mlp.cuh): bwd is the
// backward images, the hidden slabs' (the packed [in][out] slabs, 2 H H
// floats each), then w_in's, from which the features' cotangent dx [P][F]
// is written when not null (K5-bwd; K6 asks for none), then w_out's (the
// head's [H][O] as it stands, K = O zero-padded to a multiple of
// kHeadK).  The head's input cotangent dh = gout W_out^T is a tc_gemm too:
// the tile's output cotangents staged into the activation tile H columns
// at a time (zero past the valid rows and past O), one product a kHeadK
// of them, their b_out sums taken from there.  One block a tile.
// kBf16: bf16 images and products (the head's operands rounded as the
// JAX package's _dot_t rounds them), dx bfloat16 (note 10).
template <int H, bool kBf16 = false>
NERF_TC_KERNEL
    mip_bwd_rows_tc_kernel(MipWeights w, const float* __restrict__ gout, int P,
                           const float* xhat, const float* stats, const float* __restrict__ bwd,
                           float* dpre, float* tpart, void* dx) {
  extern __shared__ float4 smem4[];
  constexpr int HT = col_width<H>();
  float* bbuf = tc_smem_base(smem4);         // the B chunks' ring
  float* act = bbuf + tc_bbuf_floats<HT>();  // dpre of the current layer
  if constexpr (H > kColBlock) {
    tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
      mip_bwd_rows_wide<kBf16>(pipe, w, gout, P, xhat, stats, bwd, dpre, tpart, dx, act,
                               act + kTileRows * act_ld<kColBlock>());
    });
  } else {
  float* red = act + kTileRows * act_ld<H>();  // [kWarps][H] colsum scratch
  constexpr int ld = act_ld<H>();
  const int L = w.L, O = w.O;
  const size_t slab = tc_image_floats<kBf16>(H, H), PP = static_cast<size_t>(P);
  const size_t row0 = static_cast<size_t>(blockIdx.x) * kTileRows;
  const int nvalid = min(kTileRows, P - static_cast<int>(row0));
  float* p_b = tpart + blockIdx.x * mip_tile_floats(w, H);
  float* p_g = p_b + L * H;
  float* p_beta = p_g + L * H;
  float* p_bout = p_beta + L * H;
  const float* img_win = tc_input_images<kBf16>(bwd, L - 1, H);
  const float* img_wout = img_win + tc_input_image_floats<kBf16>(w.F, H);

  tc_block<HT, kBf16>(bbuf, [&](auto& pipe) {
    constexpr bool kC = std::decay_t<decltype(pipe)>::kConsumer;
    float acc[kRowsPerWarp][H / 32];
    float d[H / 4];
    // The head: dh = gout[tile rows, 0:O] @ W_out^T, H output columns
    // staged at a time (zero past O up to a multiple of kHeadK), each
    // kHeadK of them one product.
    tc_zero<H>(d);
    for (int q0 = 0; q0 < O; q0 += H) {
      const int kq = min(H, O - q0), kpad = (kq + kHeadK - 1) / kHeadK * kHeadK;
      if constexpr (kC) {
        tile_sync();  // act's last readers are done
        for (int i = threadIdx.x; i < kTileRows * kpad; i += kThreads) {
          const int r = i / kpad, q = i - r * kpad;
          act[r * ld + q] = r < nvalid && q < kq ? gout[(row0 + r) * O + q0 + q] : 0.f;
        }
      }
      // Each starts with a barrier of the consumers (act written) and ends
      // with one.
      for (int k0 = 0; k0 < kq; k0 += kHeadK)
        tc_gemm<H, kBf16>(pipe, d, act + k0, ld, kHeadK,
                          img_wout + tc_image_floats<kBf16>(H, q0 + k0));
      if constexpr (kC) {
        if (static_cast<int>(threadIdx.x) < kq) {
          float s = 0.f;
          for (int r = 0; r < kTileRows; ++r) s += act[r * ld + threadIdx.x];
          p_bout[q0 + threadIdx.x] = s;
        }
      }
    }
    if constexpr (kC) {
      tile_sync();  // the b_out sums' reads of act are done
      tc_to_rows<H>(d, act, acc);
    }
    for (int i = L - 1; i >= 0; --i) {
      if constexpr (kC)
        layer_bwd<H, true>(acc, i, w.g + i * H, w.beta + i * H, w.h, w.inv_h, PP, row0, nvalid,
                           xhat, stats, dpre, p_b, p_g, p_beta, red);
      if (i == 0) break;
      if constexpr (kC) tc_store_rows<H>(acc, act);
      tc_zero<H>(d);
      tc_gemm<H, kBf16>(pipe, d, act, act_ld<H>(), H, bwd + (i - 1) * slab);
      if constexpr (kC) tc_to_rows<H>(d, act, acc);
    }
    // The features' cotangent dx = dpre_0 @ w_in^T, from the stored dpre.
    if (dx != nullptr)
      tc_input_grad<H, kBf16>(pipe, act, dpre, PP, row0, nvalid, 0, img_win, -1, nullptr, w.F,
                              dx);
  });
  }
}

// ---------------------------------------------------------------------------
// The policies (TcProducts' counterparts for this chain).
// ---------------------------------------------------------------------------

// The 3xTF32 passes (K5-fwd, K5-bwd, K6, K7) on the call's operand images:
// tc_fwd, the forward images (MipImages), and the Scratch's tc_bwd, the
// backward images (the hidden slabs', then w_in's for the features'
// cotangent).  fwd is the forward over features x [P][F] -> out [P][O],
// with kSave also the chain for the backward (xhat, stats), on the one
// tile of tc_tile_bytes at every feature width (tc_mlp.cuh note 9): the
// launcher opts in to those bytes and returns the runtime's error on a
// device that allows fewer.  kBf16: compute_dtype bfloat16 (note 10):
// bfloat16 features and images, bf16 products and head,
// TcProductsT<true>'s wgrad, and the features' cotangent bfloat16.
template <bool kBf16_ = false>
struct MipTcT {
  static constexpr bool kBf16 = kBf16_;
  using Feat = enc_t<kBf16>;

  // wide: past hidden 256 (note 11), with kSave the dpre scratch (its
  // layers 0 and 1 hold the tiles' rows until bwd_rows), else the
  // wrapper's 2 x 64 x hp floats a tile; unused below.
  template <int H, bool kSave>
  static cudaError_t fwd(const MipWeights& w, const void* xv, float* out, int P, float* xhat,
                         float* stats, const float* tc_fwd, float* wide, cudaStream_t stream) {
    if (tc_fwd == nullptr || (H > kColBlock && wide == nullptr)) return cudaErrorInvalidValue;
    const Feat* x = static_cast<const Feat*>(xv);
    constexpr size_t smem = tc_tile_bytes<col_width<H>()>();
    const MipImages im = MipImages::forward<kBf16>(w, tc_fwd, w.hp);
    const int tiles = (P + kTileRows - 1) / kTileRows;
    const size_t hp = w.hp, rows = kTileRows * hp;
    cudaError_t err;
    if constexpr (kSave) {
      const WideRows rs{wide, wide == nullptr ? nullptr : wide + P * hp, rows};
      err = cudaFuncSetAttribute(mip_fwd_store_tc_kernel<H, kBf16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      mip_fwd_store_tc_kernel<H, kBf16><<<tiles, kTcThreads, smem, stream>>>(w, im, x, out, P, xhat,
                                                                           stats, rs);
    } else {
      err = cudaFuncSetAttribute(mip_fwd_tc_kernel<H, kBf16>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return err;
      mip_fwd_tc_kernel<H, kBf16><<<tiles, kTcThreads, smem, stream>>>(w, im, x, out, P,
                                                                     wide_rows(wide, w.hp));
    }
    return cudaGetLastError();
  }

  template <int H>
  static cudaError_t bwd_rows(const MipWeights& w, const float* gout, int P, const Scratch& s,
                              void* dx, cudaStream_t stream) {
    if (s.tc_bwd == nullptr) return cudaErrorInvalidValue;
    constexpr size_t smem = mip_bwd_rows_tc_smem<H>();
    cudaError_t err = cudaFuncSetAttribute(mip_bwd_rows_tc_kernel<H, kBf16>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int tiles = (P + kTileRows - 1) / kTileRows;
    mip_bwd_rows_tc_kernel<H, kBf16><<<tiles, kTcThreads, smem, stream>>>(
        w, gout, P, s.xhat, s.stats, s.tc_bwd, s.dpre, s.tpart, dx);
    return cudaGetLastError();
  }

  static cudaError_t wgrad(const WProds& prods, int total_tiles, int P, int k_chunk,
                           const Scratch& s, size_t wfloats, cudaStream_t stream,
                           long long chain_rows, int chain_cols) {
    return TcProductsT<kBf16>::wgrad(prods, total_tiles, P, k_chunk, s, wfloats, stream,
                                     chain_rows, chain_cols);
  }
};
using MipTc = MipTcT<false>;
using MipTcBf16 = MipTcT<true>;

// The backward passes from the output cotangents gout [P][O] (the forward
// ran with kSave into s): grads (the flat gradient, mip_wgrad_floats +
// mip_tile_floats) and, when not null, dx.  x is the forward's features
// (bfloat16 where Products::kBf16, as dx then is).
template <int H, class Products>
cudaError_t launch_mip_backward(const MipWeights& w, const void* xv, const float* gout, int P,
                                const Scratch& s, void* dx, float* grads,
                                cudaStream_t stream) {
  // The raw features' pointer as WProd holds it (a_bf16 marks bfloat16).
  const float* x = static_cast<const float*>(xv);
  constexpr int feat_bf16 = Products::kBf16 ? 1 : 0;
  const int L = w.L, hp = w.hp;  // the slabs' padded width
  cudaError_t err = Products::template bwd_rows<H>(w, gout, P, s, dx, stream);
  if (err != cudaSuccess) return err;
  const int tiles = (P + kTileRows - 1) / kTileRows;

  const size_t PP = static_cast<size_t>(P);
  const int th = (hp + kWT - 1) / kWT;
  auto xhat = [&](int layer) { return s.xhat + layer * PP * hp; };
  auto dpre = [&](int layer) { return s.dpre + layer * PP * hp; };
  const size_t wf = mip_wgrad_floats(w, hp);
  const int k_chunk = wgrad_k_chunk(P, s.splits);
  // The L + 1 products go to wgrad in groups of kMaxProds, one launch each:
  // each product writes its own slab of every split's partials, so the
  // grouping moves no sum.
  WProds prods{};
  auto flush = [&]() {
    int total_tiles = 0;
    for (int i = 0; i < prods.n; ++i) total_tiles += prods.p[i].tiles_m * prods.p[i].tiles_n;
    const cudaError_t e =
        Products::wgrad(prods, total_tiles, P, k_chunk, s, wf, stream, L * PP, hp);
    prods.n = 0;
    return e;
  };
  auto add = [&](const WProd& p) {
    prods.p[prods.n++] = p;
    return prods.n == kMaxProds ? flush() : cudaSuccess;
  };
  size_t off = 0;
  err = add(WProd{x, nullptr, nullptr, dpre(0), w.F, w.F, hp, 1, 0, off, (w.F + kWT - 1) / kWT,
                  th, 0, 1, feat_bf16});
  off += static_cast<size_t>(w.F) * hp;
  for (int k = 0; k < L - 1 && err == cudaSuccess; ++k) {
    err = add(WProd{xhat(k), w.g + k * hp, w.beta + k * hp, dpre(k + 1), hp, hp, hp, 1, 1, off,
                    th, th});
    off += static_cast<size_t>(hp) * hp;
  }
  if (err == cudaSuccess)
    err = add(WProd{xhat(L - 1), w.g + (L - 1) * hp, w.beta + (L - 1) * hp, gout, hp, hp, w.O, 1,
                    1, off, th, (w.O + kWT - 1) / kWT});
  if (err == cudaSuccess && prods.n > 0) err = flush();
  if (err != cudaSuccess) return err;
  if ((err = colsum(s.wpart, s.splits, wf, grads, s.tmp, stream)) != cudaSuccess) return err;
  return colsum(s.tpart, tiles, mip_tile_floats(w, hp), grads + wf, s.tmp, stream);
}

}  // namespace nerf_mlp
