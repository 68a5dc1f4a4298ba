// The masked lasso gradient on Hopper (sm_90a), on wgmma: f32 data with
// every f32 product as bf16x6 limb products (L = 3 limbs an operand), and
// bf16 data, where each product is one bf16 pass (L = 1). One template,
// grad_packed<KT, L, W>: a 0/1 mask as packed bits (W = false), or a
// weighted mask as a dense tile of weights in the data's dtype (W = true).
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_lasso.py:159
// masked_grad_rows (pallas_call :176, body _grad_rows_kernel :144-156).
// Given my = mask * y (M, N), the mask as bits (M, W) int32 (bit j of word
// w in row r is mask[r, 32 w + j]; W = ceil(N / 32) rounded up to a
// multiple of 4, pad bits 0) or as weights (M, N) in my's dtype, x (M, F),
// 1 <= F <= 128, and a (F, N) as its L bf16 limbs, it returns
//   g = cdt(f32(mask) * (x a) - f32(my)) a^T                   (M, F)
// at the TPU kernel's quantisation points, cdt the data's dtype:
//   - f32: both products at the TPU's Precision.HIGHEST (bf16x6 there, and
//     here); the residual E = f32(mask) R - my formed in f32 with
//     round-to-nearest operations and not rounded further; g stored in f32;
//   - bf16: both products on bf16 operands summed in f32; E rounded to
//     bf16 (round to nearest) from the f32 f32(mask) R - f32(my), as the
//     TPU kernel's .astype(a.dtype) (:151); g stored in bf16, x's dtype.
//
// Products. At L = 3 each f32 operand v is split into round-to-nearest
// bf16 limbs v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1) (the
// residuals are exact in f32), and a product u v is the sum of the six limb
// products whose order is at most 2^-16 of u0 v0: u0 v0 (the "big" chain)
// and u2 v0, u1 v1, u0 v2, u1 v0, u0 v1 (the "small" one). At L = 1 the
// bf16 data is its own limb and u0 v0 is the product. The tensor cores' f32
// sums do not round to nearest and a long chain drifts
// (nmf_common.cuh:206-212), so each big chain is summed in its own
// registers over at most 64 deep (R's per 64-feature chunk, g's per stage)
// and added with round-to-nearest f32 adds, the small chain beside it
// (kl_masked_packed.cu's discipline). No TF32 anywhere.
//
// What bounds it on an H100, at 100,000 x 1,024, F = 128:
//   - f32: 12 bf16 passes of 2 MNF operations, 3.15e11 operations, 0.318
//     ms at 989 TFLOP/s, against 0.53 GB (my 409.6 MB, the bits 12.8 MB, x
//     and g 51.2 MB each, a's limbs 0.8 MB: 0.157 ms at 3.35 TB/s): bound
//     by operations; weighted, the weights' 409.6 MB for the bits make
//     0.92 GB (0.275 ms), still below the operations;
//   - bf16: 2 passes, 5.2e10 operations, 0.053 ms, against 269 MB (my
//     204.8 MB, the bits 12.8 MB, x and g 25.6 MB each, a 0.26 MB: 0.080
//     ms): bound by bytes; weighted, 461 MB with the 204.8 MB of bf16
//     weights (0.138 ms).
// The design keeps the tensor cores fed from shared memory and the bytes
// low:
//   - a persistent block per SM walks 128-row stripes; one producer thread
//     keeps a ring of SC-column stages full by TMA (cp.async.bulk.tensor.2d,
//     one full and one empty mbarrier per stage) across stripes: my (128 x
//     SC, 128-byte rows: SC = 32 f32 or 64 bf16 columns, 16 KB either way,
//     128-byte swizzle), the stage's mask words of each row (a box of 4
//     words) or, weighted, the weights' box at my's coordinates (128 x SC
//     in the data's dtype, 16 KB, the same swizzle), and a's limbs for the
//     stage's SC columns (a^T rows of 64 features, 128-byte swizzle; L x 2
//     boxes at F > 64). The bf16 ring holds 5 stages of 34 KB (7 of 26 KB
//     at F <= 64): the kernel is bound by bytes there, and the freed shared
//     memory keeps more in flight. The weights' box costs the ring stages
//     (Cfg::kStages): 2 of 56 KB at f32, F > 64 (beside x's 96 KB of
//     limbs), 4 at f32, F <= 64, 4 of 48 KB at bf16, F > 64, 5 at F <= 64;
//   - two consumer warpgroups own 64 rows each; the stripe's x is kept
//     resident as its L limbs (96 KB f32, 32 KB bf16 at F > 64), split by
//     the threads and written in the 128-byte-swizzled layout wgmma reads;
//   - R = x a_s (64 x SC per warpgroup) on wgmma from shared memory, both
//     operands K-major: x0 against a0 (the big chain, summed per 64-feature
//     chunk in its own registers and added with round-to-nearest adds); at
//     L = 3 beside it x0 against [a1 | a2] and x1 against [a0 | a1]
//     (m64n64) and x2 against a0 (m64n32): the three limb boxes of a stage
//     lie side by side, so two limbs are one 64-row operand;
//   - E = f32(mask) R - my in registers, from the stage's mask words or
//     its weights at my's (row, column), split into L limbs (at L = 1
//     rounded to bf16): the accumulator layout of R
//     is the register-A fragment of the next wgmma's 16-deep steps, so E
//     never touches shared memory;
//   - g += E a_s^T on wgmma with A from registers and B the same limb boxes
//     read transposed (MN-major), per 64-feature chunk (m64n64) with its own
//     stage temporaries, so registers hold the running g (64 per thread at
//     F > 64), the chunk's chains and E's limbs; setmaxnreg gives the
//     consumers 232 registers and the producer warpgroup 40.
// Each block owns its rows of g: no cross-block sum and no float atomics,
// so a rerun gives the same bits. Ragged M, N and F are masked: TMA
// zero-fills boxes outside the tensors (so R, my and the mask bits or
// weights are 0 there and E is 0), x's limbs are zero past M and F, and
// a's limbs are zero past F in the wrapper's array. F <= 64 takes a KT = 64
// instance.
//
// The wrapper (ops/cuda_lasso.py) gives a's limbs as one (N, L KT) bf16
// array, row n = [limb 0 of a[:, n] | limb 1 | limb 2] (L = 3) or a[:, n]
// (L = 1), each KT wide with zeros past F (cuda_lasso.grad_limbs, made once
// per solve), and my and the weights with 16-byte-aligned rows (a padded
// copy where N is not a multiple of 4 f32 or 8 bf16). The tensor maps are
// encoded with cuTensorMapEncodeTiled through the runtime's entry-point
// query (sm90_common.cuh), so the library needs no -lcuda.

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int BM = 128;                // rows per stripe, 64 per consumer
constexpr int kMy = BM * 128;          // my, 128 rows of 128 bytes (SW128)
constexpr int kMask = BM * 16;         // 4 mask words per row
constexpr int kXChunk = BM * 128;      // 128 rows x 64 bf16 of x's limbs

// Shared memory, from a 1024-aligned base: kStages slots of [my | a's
// limbs, box (c, l) of feature chunk c and limb l at (L c + l) kBox |
// mask words, or (W) the weights' box], then x's limbs (chunk (c, l) at (L
// c + l) kXChunk, the warpgroup's 64 rows at 64 cw) and 2 kStages
// mbarriers. T is the data's type (my, the weights, x and g).
// The two values at (row, col) and (row, col + 1) of a 128 x SC box of
// 128-byte swizzled rows (my's, or the weights'), col even, as f32.
template <typename T>
__device__ __forceinline__ void pair_at(const unsigned char* box, int row,
                                        int col, float (&v)[2]) {
  if constexpr (sizeof(T) == 4) {
    const SwzF<BM> z{reinterpret_cast<const float*>(box)};
    v[0] = z.at(row, col);
    v[1] = z.at(row, col + 1);
  } else {
    const __nv_bfloat162 p = *reinterpret_cast<const __nv_bfloat162*>(
        Swz<128, BM>{reinterpret_cast<const bf16*>(box)}.at(row, col));
    v[0] = __low2float(p);
    v[1] = __high2float(p);
  }
}

template <int KT, int L, bool W>
struct Cfg {
  static_assert(L == 1 || L == 3, "one limb (bf16) or three (f32)");
  using T = std::conditional_t<L == 3, float, bf16>;
  static constexpr int SC = 128 / (int)sizeof(T);   // columns per stage
  static constexpr int KC = KT / 64;
  static constexpr int kBox = SC * 128;   // SC rows x 64 bf16 of a's limbs
  static constexpr int kA = L * KC * kBox;
  static constexpr int kSlot = kMy + kA + (W ? kMy : kMask);
  static constexpr int kStages =
      W ? (L == 3 ? (KT == 64 ? 4 : 2) : (KT == 64 ? 5 : 4))
        : (L == 3 ? (KT == 64 ? 4 : 3) : (KT == 64 ? 7 : 5));
  static constexpr int kX = L * KC * kXChunk;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + kX + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

// tm_mask: the bits in boxes of 4 words x 128 rows, or (W) the weights in
// my's boxes.
template <int KT, int L, bool W>
__global__ void __launch_bounds__(kThreads, 1)
    grad_packed(const __grid_constant__ CUtensorMap tm_my,
                const __grid_constant__ CUtensorMap tm_mask,
                const __grid_constant__ CUtensorMap tm_a,
                const typename Cfg<KT, L, W>::T* __restrict__ x, int M, int N,
                int F, typename Cfg<KT, L, W>::T* __restrict__ g) {
  using C = Cfg<KT, L, W>;
  using T = typename C::T;
  constexpr int S = C::kStages, KC = C::KC, SC = C::SC, kBox = C::kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  unsigned char* xs = ring + S * C::kSlot;
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + C::kX);
  uint64_t* empty = full + S;
  const int n_stripes = (M + BM - 1) / BM, n_st = (N + SC - 1) / SC;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full, across stripes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int q = 0;
      for (int sp = blockIdx.x; sp < n_stripes; sp += gridDim.x)
        for (int s = 0; s < n_st; ++s, ++q) {
          const int slot = q % S;
          if (q >= S) mbar_wait(empty + slot, ((q / S) + 1) & 1);
          unsigned char* dst = ring + slot * C::kSlot;
          uint64_t* bar = full + slot;
          mbar_expect(bar, C::kSlot);
          tma_load(dst, tm_my, s * SC, sp * BM, bar);
#pragma unroll
          for (int c = 0; c < KC; ++c)
#pragma unroll
            for (int l = 0; l < L; ++l)
              tma_load(dst + kMy + (L * c + l) * kBox, tm_a, l * KT + 64 * c,
                       s * SC, bar);
          // The 4-word group that holds the stage's SC / 32 words, or the
          // weights of my's box.
          if constexpr (W)
            tma_load(dst + kMy + C::kA, tm_mask, s * SC, sp * BM, bar);
          else
            tma_load(dst + kMy + C::kA, tm_mask, (s * SC / 32) & ~3, sp * BM,
                     bar);
        }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + gq;   // this thread's first row
  unsigned char* xw = xs + cw * (64 * 128);  // the warpgroup's x rows
  int q = 0;
  for (int sp = blockIdx.x; sp < n_stripes; sp += gridDim.x) {
    // The warpgroup's 64 rows of x, split into limbs, 8 features a store;
    // all of a thread's loads are issued first, so that their latencies
    // overlap (and the wait for the warpgroup's last products).
    constexpr int NE = KT / 16;   // groups of 8 features per thread
    const long long row0 = (long long)sp * BM + 64 * cw;
    T v[NE][8];
#pragma unroll
    for (int qe = 0; qe < NE; ++qe) {
      const int e = tid + 128 * qe, r = e / (KT / 8), c0 = e % (KT / 8) * 8;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[qe][u] = row0 + r < M && c0 + u < F ? x[(row0 + r) * F + c0 + u]
                                              : from_f32<T>(0.f);
    }
    bar_sync(1 + cw);   // the last stripe's products are done with x
#pragma unroll
    for (int qe = 0; qe < NE; ++qe) {
      const int e = tid + 128 * qe, r = e / (KT / 8), c0 = e % (KT / 8) * 8;
      uint32_t w[L][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        if constexpr (L == 3) {
          uint32_t f[3];
          split_pair(v[qe][2 * p], v[qe][2 * p + 1], f);
#pragma unroll
          for (int l = 0; l < 3; ++l) w[l][p] = f[l];
        } else {
          w[0][p] = pack(v[qe][2 * p], v[qe][2 * p + 1]);
        }
      }
      const uint32_t off = r * 128 + ((((c0 % 64) / 8) ^ (r & 7)) << 4);
#pragma unroll
      for (int l = 0; l < L; ++l)
        *reinterpret_cast<uint4*>(xw + (L * (c0 / 64) + l) * kXChunk + off) =
            make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
    }
    // Thread writes to shared memory, then wgmma's reads of them.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bar_sync(1 + cw);

    float acc[KC][32];
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;

    for (int s = 0; s < n_st; ++s, ++q) {
      const int slot = q % S;
      const unsigned char* base = ring + slot * C::kSlot;
      mbar_wait(full + slot, (q / S) & 1);

      // R = x a_s: the big chain x0 a0 per 64-feature chunk c (rb[c],
      // m64n32 at L = 3, m64n64 at L = 1); at L = 3 the small one as x0
      // [a1 | a2], x1 [a0 | a1] and x2 a0.
      float rb[KC][SC / 2], r0[32], r1[32], r2[16];
#pragma unroll
      for (int c = 0; c < KC; ++c) fence_operand(rb[c]);
      if constexpr (L == 3) {
        fence_operand(r0);
        fence_operand(r1);
        fence_operand(r2);
      }
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const int c = kk / 4, k32 = (kk % 4) * 32;
        const unsigned char* ab = base + kMy + L * c * kBox + k32;
        const uint64_t da0 = smem_desc(ab, 16, 1024);
        const unsigned char* xa = xw + L * c * kXChunk + k32;
        const uint64_t dx0 = smem_desc(xa, 16, 1024);
        wgmma_ss(rb[c], dx0, da0, kk % 4);
        if constexpr (L == 3) {
          const uint64_t da1 = smem_desc(ab + kBox, 16, 1024);
          wgmma_ss(r0, dx0, da1, kk);
          wgmma_ss(r1, smem_desc(xa + kXChunk, 16, 1024), da0, kk);
          wgmma_ss(r2, smem_desc(xa + 2 * kXChunk, 16, 1024), da0, kk);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < KC; ++c) fence_operand(rb[c]);
      if constexpr (L == 3) {
        fence_operand(r0);
        fence_operand(r1);
        fence_operand(r2);
      }

      // E = f32(mask) R - my, split into limbs: register i of R sits at row
      // rr + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2; the A
      // fragment of depth step ks takes 8-column blocks 2 ks and 2 ks + 1.
      // Column col = 8 j + 2 t of the stage is bit 8 (j % 4) + 2 t of word
      // (s SC / 32 + j / 4) % 4 of the row's 4-word group; W: the weights
      // at (row, col) and (row, col + 1) of their box, read as my is.
      const uint32_t* mw =
          reinterpret_cast<const uint32_t*>(base + kMy + C::kA);
      uint32_t ea[SC / 16][L][4];
#pragma unroll
      for (int j = 0; j < SC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rr + 8 * h, col = 8 * j + 2 * t;
          // my (and W's weights) at (row, col) and (row, col + 1), side by
          // side.
          float my[2], wt[2];
          pair_at<T>(base, row, col, my);
          if constexpr (W) {
            pair_at<T>(base + kMy + C::kA, row, col, wt);
          } else {
            const uint32_t word =
                mw[row * 4 + ((s * SC / 32 + j / 4) & 3)] >>
                (8 * (j % 4) + 2 * t);
            wt[0] = (float)(word & 1u);
            wt[1] = (float)((word >> 1) & 1u);
          }
          float e[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 4 * j + 2 * h + u;
            float r = rb[0][i];
#pragma unroll
            for (int c = 1; c < KC; ++c) r = __fadd_rn(r, rb[c][i]);
            if constexpr (L == 3)
              r = __fadd_rn(r, (r0[i] + r0[16 + i]) + (r1[i] + r1[16 + i]) +
                                   r2[i]);
            e[u] = __fsub_rn(__fmul_rn(wt[u], r), my[u]);
          }
          if constexpr (L == 3) {
            uint32_t f[3];
            split_pair(e[0], e[1], f);
#pragma unroll
            for (int l = 0; l < 3; ++l) ea[j / 2][l][2 * (j % 2) + h] = f[l];
          } else {
            const __nv_bfloat162 v = __floats2bfloat162_rn(e[0], e[1]);
            ea[j / 2][0][2 * (j % 2) + h] =
                *reinterpret_cast<const uint32_t*>(&v);
          }
        }

      // g += E a_s^T per 64-feature chunk: the big chain (e0 a0) and, at
      // L = 3, the small one in their own registers, then added to g.
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float tb[32], ts[32];
        fence_operand(tb);
        if constexpr (L == 3) fence_operand(ts);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < SC / 16; ++ks) {
          const unsigned char* bb = base + kMy + L * c * kBox + ks * 2048;
          const uint64_t b0 = smem_desc(bb, kBox, 1024);
          wgmma_rs(tb, ea[ks][0], b0, ks);
          if constexpr (L == 3) {
            const uint64_t b1 = smem_desc(bb + kBox, kBox, 1024);
            const uint64_t b2 = smem_desc(bb + 2 * kBox, kBox, 1024);
            wgmma_rs(ts, ea[ks][2], b0, ks);
            wgmma_rs(ts, ea[ks][1], b1, 1);
            wgmma_rs(ts, ea[ks][0], b2, 1);
            wgmma_rs(ts, ea[ks][1], b0, 1);
            wgmma_rs(ts, ea[ks][0], b1, 1);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operand(tb);
        if constexpr (L == 3) {
          fence_operand(ts);
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] += tb[i] + ts[i];
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[c][i] += tb[i];
        }
      }
      // This warp's products and reads of the slot are done.
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    // g: register i of chunk c at row rr + 8 ((i / 2) % 2), feature
    // 64 c + 8 (i / 4) + 2 t + i % 2; bf16 rounded to nearest.
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long gr = (long long)sp * BM + rr + 8 * ((i / 2) % 2);
        const int col = 64 * c + 8 * (i / 4) + 2 * t + i % 2;
        if (gr < M && col < F) g[gr * F + col] = from_f32<T>(acc[c][i]);
      }
  }
}

// mask: the bits (words per row) or, W, the weights (row stride words).
struct Args {
  const void *my, *mask, *x, *al;
  int ld_my, words, M, N, F;
  void* g;
  cudaStream_t stream;
};

template <int KT, int L, bool W>
int launch(const Args& a) {
  using C = Cfg<KT, L, W>;
  using T = typename C::T;
  constexpr CUtensorMapDataType TT = L == 3
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap my, mask, al;
  const bool ok =
      make_map(&my, TT, (int)sizeof(T), a.my, a.N, a.M, a.ld_my, C::SC, BM,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      (W ? make_map(&mask, TT, (int)sizeof(T), a.mask, a.N, a.M, a.words,
                    C::SC, BM, CU_TENSOR_MAP_SWIZZLE_128B)
         : make_map(&mask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.mask, a.words,
                    a.M, a.words, 4, BM, CU_TENSOR_MAP_SWIZZLE_NONE)) &&
      make_map(&al, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.al, L * KT, a.N,
               L * KT, 64, C::SC, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_packed<KT, L, W>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int stripes = (a.M + BM - 1) / BM;
  grad_packed<KT, L, W><<<stripes < sms ? stripes : sms, kThreads,
                          C::kSmem, a.stream>>>(my, mask, al,
                                                static_cast<const T*>(a.x),
                                                a.M, a.N, a.F,
                                                static_cast<T*>(a.g));
  return (int)cudaGetLastError();
}

// Both C entries: the checks they share, the mask's own (W: the weights'
// row stride in a.words, 16-byte aligned as my's; else the bits' words a
// row), then the instance.
template <bool W>
int entry(int limbs, int kt, const Args& a) {
  const int per = limbs == 3 ? 4 : 8;   // elements in 16 bytes
  const bool mask_ok = W ? a.words >= a.N && a.words % per == 0
                         : a.words % 4 == 0 && a.words * 32 >= a.N;
  if (a.M < 1 || a.N < 1 || a.F < 1 || a.F > kt || (kt != 64 && kt != 128) ||
      (limbs != 1 && limbs != 3) || a.ld_my < a.N || a.ld_my % per != 0 ||
      !mask_ok)
    return (int)cudaErrorInvalidValue;
  if (limbs == 3)
    return kt == 64 ? launch<64, 3, W>(a) : launch<128, 3, W>(a);
  return kt == 64 ? launch<64, 1, W>(a) : launch<128, 1, W>(a);
}

}  // namespace

// The C interface, loaded with ctypes. limbs 3 (f32 data: my, x and g f32)
// or 1 (bf16 data: my, x and g bf16); my (M x N, row stride ld_my, 16-byte
// aligned rows: a multiple of 4 f32 or 8 bf16); mask the packed bits (M x
// words int32, words % 4 == 0); x (M x F); al a's limbs (N x limbs kt
// bf16: row n = [limb 0 | limb 1 | limb 2] of a[:, n], or a[:, n] at one
// limb, each kt wide, zero past F); kt the feature tile, 64 (F <= 64) or
// 128 (F <= 128); g (M x F). Returns 0 or the first non-zero cudaError_t.
extern "C" int lasso_grad_packed_launch(int limbs, int kt, const void* my,
                                        int ld_my, const void* mask,
                                        int words, const void* x,
                                        const void* al, int M, int N, int F,
                                        void* g, void* stream) {
  return entry<false>(limbs, kt, Args{my, mask, x, al, ld_my, words, M, N,
                                      F, g,
                                      static_cast<cudaStream_t>(stream)});
}

// The weighted mask: as lasso_grad_packed_launch with the weights w (M x N
// in my's dtype, row stride ld_w, 16-byte aligned rows as my's) for the
// bits.
extern "C" int lasso_grad_weighted_launch(int limbs, int kt, const void* my,
                                          int ld_my, const void* w, int ld_w,
                                          const void* x, const void* al,
                                          int M, int N, int F, void* g,
                                          void* stream) {
  return entry<true>(limbs, kt, Args{my, w, x, al, ld_my, ld_w, M, N, F, g,
                                     static_cast<cudaStream_t>(stream)});
}
