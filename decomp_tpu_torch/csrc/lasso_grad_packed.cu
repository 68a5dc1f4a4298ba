// The masked lasso gradient on f32 data with a bit-packed 0/1 mask, on
// Hopper (sm_90a): every f32 product as bf16x6 limb products on wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_lasso.py:159
// masked_grad_rows (pallas_call :176, body _grad_rows_kernel :144-156) for
// f32 data and a 0/1 mask. Given my = mask * y (M, N) f32, the mask as bits
// (M, W) int32 (bit j of word w in row r is mask[r, 32 w + j]; W =
// ceil(N / 32) rounded up to a multiple of 4, pad bits 0), x (M, F) f32,
// 1 <= F <= 128, and a (F, N) as its three bf16 limbs, it returns
//   g = (mask * (x a) - my) a^T                                 (M, F) f32
// at the TPU kernel's f32 quantisation points: both products at the TPU's
// Precision.HIGHEST (bf16x6 there, and here); the residual E = f32(mask) *
// R - my formed in f32 with round-to-nearest operations and not rounded
// further; g stored in f32.
//
// Products. Each f32 operand v is split into round-to-nearest bf16 limbs
// v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1) (the residuals
// are exact in f32), and a product u v is the sum of the six limb products
// whose order is at most 2^-16 of u0 v0: u0 v0 (the "big" chain) and u2 v0,
// u1 v1, u0 v2, u1 v0, u0 v1 (the "small" one). The tensor cores' f32 sums
// do not round to nearest and a long chain drifts (nmf_common.cuh:206-212),
// so each big chain is summed in its own registers over at most 64 deep
// (R's per 64-feature chunk, g's per 32-column stage) and added with
// round-to-nearest f32 adds, the small chain beside it
// (kl_masked_packed.cu's discipline). No TF32 anywhere.
//
// What bounds it on an H100. 12 bf16 passes of 2 MNF operations: at
// 100,000 x 1,024, F = 128, 3.15e11 operations, 0.318 ms at 989 TFLOP/s,
// against 0.53 GB (my 409.6 MB, the bits 12.8 MB, x and g 51.2 MB each,
// a's limbs 0.8 MB: 0.157 ms at 3.35 TB/s): bound by operations. The
// design keeps the tensor cores fed from shared memory and the bytes low:
//   - a persistent block per SM walks 128-row stripes; one producer thread
//     keeps a ring of 32-column stages full by TMA (cp.async.bulk.tensor.2d,
//     one full and one empty mbarrier per stage) across stripes: my (128 x
//     32 f32, 128-byte swizzle), the stage's mask word of each row (a box
//     of 4 words), and a's limbs for the stage's 32 columns (a^T rows of
//     64 features, 128-byte swizzle; 3 x 2 boxes at F > 64);
//   - two consumer warpgroups own 64 rows each; the stripe's x is split
//     once into three limbs and kept resident (96 KB at F > 64), written by
//     the threads in the 128-byte-swizzled layout wgmma reads;
//   - R = x a_s (64 x 32 per warpgroup) on wgmma from shared memory, both
//     operands K-major: x0 against a0 (m64n32, the big chain, summed per
//     64-feature chunk in its own registers and added with round-to-nearest
//     adds), x0 against [a1 | a2] and x1 against [a0 | a1] (m64n64) and x2
//     against a0 (m64n32): the three limb boxes of a stage lie side by
//     side, so two limbs are one 64-row operand;
//   - E = f32(mask) R - my in registers, from the stage's mask word, split
//     into three limbs: the accumulator layout of R is the register-A
//     fragment of the next wgmma's two 16-deep steps, so E never touches
//     shared memory;
//   - g += E a_s^T on wgmma with A from registers and B the same limb boxes
//     read transposed (MN-major), per 64-feature chunk (m64n64) with its own
//     stage temporaries, so registers hold the running g (64 per thread at
//     F > 64), the chunk's two chains and E's limbs; setmaxnreg gives the
//     consumers 232 registers and the producer warpgroup 40.
// Each block owns its rows of g: no cross-block sum and no float atomics,
// so a rerun gives the same bits. Ragged M, N and F are masked: TMA
// zero-fills boxes outside the tensors (so R, my and the mask bits are 0
// there and E is 0), x's limbs are zero past M and F, and a's limbs are
// zero past F in the wrapper's array. F <= 64 takes a KT = 64
// instance.
//
// The wrapper (ops/cuda_lasso.py) gives a's limbs as one (N, 3 KT) bf16
// array, row n = [limb 0 of a[:, n] | limb 1 | limb 2], each KT wide with
// zeros past F (cuda_lasso.grad_limbs, made once per solve), and my with
// 16-byte-aligned rows (a padded copy where N % 4 != 0). The tensor maps
// are encoded with cuTensorMapEncodeTiled through the runtime's entry-point
// query (sm90_common.cuh), so the library needs no -lcuda.

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int BM = 128;                // rows per stripe, 64 per consumer
constexpr int SC = 32;                 // columns per stage: one mask word
constexpr int kMy = BM * SC * 4;       // my, 128 x 32 f32 (SW128)
constexpr int kBox = SC * 128;         // 32 rows x 64 bf16 of a's limbs
constexpr int kMask = BM * 16;         // 4 mask words per row
constexpr int kXChunk = BM * 128;      // 128 rows x 64 bf16 of x's limbs

// Shared memory, from a 1024-aligned base: kStages slots of [my | a's
// limbs, box (c, l) of feature chunk c and limb l at (3 c + l) kBox |
// mask words], then x's limbs (chunk (c, l) at (3 c + l) kXChunk, the
// warpgroup's 64 rows at 64 cw) and 2 kStages mbarriers.
template <int KT>
struct Cfg {
  static constexpr int KC = KT / 64;
  static constexpr int kA = 3 * KC * kBox;
  static constexpr int kSlot = kMy + kA + kMask;
  static constexpr int kStages = KT == 64 ? 4 : 3;
  static constexpr int kX = 3 * KC * kXChunk;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + kX + 16 * kStages;
};

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    grad_packed(const __grid_constant__ CUtensorMap tm_my,
                const __grid_constant__ CUtensorMap tm_mask,
                const __grid_constant__ CUtensorMap tm_a,
                const float* __restrict__ x, int M, int N, int F,
                float* __restrict__ g) {
  using C = Cfg<KT>;
  constexpr int S = C::kStages, KC = C::KC;
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
            for (int l = 0; l < 3; ++l)
              tma_load(dst + kMy + (3 * c + l) * kBox, tm_a, l * KT + 64 * c,
                       s * SC, bar);
          tma_load(dst + kMy + C::kA, tm_mask, s & ~3, sp * BM, bar);
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
    // The warpgroup's 64 rows of x, split into limbs, 8 features a store.
    const long long row0 = (long long)sp * BM + 64 * cw;
    bar_sync(1 + cw);   // the last stripe's products are done with x
    for (int e = tid; e < 64 * (KT / 8); e += 128) {
      const int r = e / (KT / 8), c0 = e % (KT / 8) * 8;
      uint32_t w[3][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = c0 + 2 * p + u;
          v[u] = row0 + r < M && c < F ? x[(row0 + r) * F + c] : 0.f;
        }
        uint32_t f[3];
        split_pair(v[0], v[1], f);
#pragma unroll
        for (int l = 0; l < 3; ++l) w[l][p] = f[l];
      }
      const uint32_t off = r * 128 + ((((c0 % 64) / 8) ^ (r & 7)) << 4);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        *reinterpret_cast<uint4*>(xw + (3 * (c0 / 64) + l) * kXChunk + off) =
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

      // R = x a_s: the big chain x0 a0 per 64-feature chunk c (rb[c]);
      // the small one as x0 [a1 | a2], x1 [a0 | a1] and x2 a0.
      float rb[KC][16], r0[32], r1[32], r2[16];
#pragma unroll
      for (int c = 0; c < KC; ++c) fence_operand(rb[c]);
      fence_operand(r0);
      fence_operand(r1);
      fence_operand(r2);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const int c = kk / 4, k32 = (kk % 4) * 32;
        const unsigned char* ab = base + kMy + 3 * c * kBox + k32;
        const uint64_t da0 = smem_desc(ab, 16, 1024);
        const uint64_t da1 = smem_desc(ab + kBox, 16, 1024);
        const unsigned char* xa = xw + 3 * c * kXChunk + k32;
        const uint64_t dx0 = smem_desc(xa, 16, 1024);
        wgmma_ss(rb[c], dx0, da0, kk % 4);
        wgmma_ss(r0, dx0, da1, kk);
        wgmma_ss(r1, smem_desc(xa + kXChunk, 16, 1024), da0, kk);
        wgmma_ss(r2, smem_desc(xa + 2 * kXChunk, 16, 1024), da0, kk);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < KC; ++c) fence_operand(rb[c]);
      fence_operand(r0);
      fence_operand(r1);
      fence_operand(r2);

      // E = f32(mask) R - my, split into limbs: register i of R sits at row
      // rr + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2; the A
      // fragment of depth step ks takes 8-column blocks 2 ks and 2 ks + 1.
      const SwzF<BM> ms{reinterpret_cast<const float*>(base)};
      const uint32_t* mw =
          reinterpret_cast<const uint32_t*>(base + kMy + C::kA);
      uint32_t ea[2][3][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rr + 8 * h, col = 8 * j + 2 * t;
          const uint32_t word = mw[row * 4 + (s & 3)];
          float e[2];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int i = 4 * j + 2 * h + u;
            float big = rb[0][i];
#pragma unroll
            for (int c = 1; c < KC; ++c) big = __fadd_rn(big, rb[c][i]);
            const float small = (r0[i] + r0[16 + i]) +
                                (r1[i] + r1[16 + i]) + r2[i];
            const float m = (float)((word >> (col + u)) & 1u);
            e[u] = __fsub_rn(__fmul_rn(m, __fadd_rn(big, small)),
                             ms.at(row, col + u));
          }
          uint32_t f[3];
          split_pair(e[0], e[1], f);
#pragma unroll
          for (int l = 0; l < 3; ++l) ea[j / 2][l][2 * (j % 2) + h] = f[l];
        }

      // g += E a_s^T per 64-feature chunk: the big chain (e0 a0) and the
      // small one in their own registers, then added to g.
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float tb[32], ts[32];
        fence_operand(tb);
        fence_operand(ts);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const unsigned char* bb = base + kMy + 3 * c * kBox + ks * 2048;
          const uint64_t b0 = smem_desc(bb, kBox, 1024);
          const uint64_t b1 = smem_desc(bb + kBox, kBox, 1024);
          const uint64_t b2 = smem_desc(bb + 2 * kBox, kBox, 1024);
          wgmma_rs(tb, ea[ks][0], b0, ks);
          wgmma_rs(ts, ea[ks][2], b0, ks);
          wgmma_rs(ts, ea[ks][1], b1, 1);
          wgmma_rs(ts, ea[ks][0], b2, 1);
          wgmma_rs(ts, ea[ks][1], b0, 1);
          wgmma_rs(ts, ea[ks][0], b1, 1);
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operand(tb);
        fence_operand(ts);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[c][i] += tb[i] + ts[i];
      }
      // This warp's products and reads of the slot are done.
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }

    // g: register i of chunk c at row rr + 8 ((i / 2) % 2), feature
    // 64 c + 8 (i / 4) + 2 t + i % 2.
#pragma unroll
    for (int c = 0; c < KC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long gr = (long long)sp * BM + rr + 8 * ((i / 2) % 2);
        const int col = 64 * c + 8 * (i / 4) + 2 * t + i % 2;
        if (gr < M && col < F) g[gr * F + col] = acc[c][i];
      }
  }
}

struct Args {
  const void *my, *mask, *x, *al;
  int ld_my, words, M, N, F;
  void* g;
  cudaStream_t stream;
};

template <int KT>
int launch(const Args& a) {
  using C = Cfg<KT>;
  CUtensorMap my, mask, al;
  const bool ok =
      make_map(&my, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.my, a.N, a.M,
               a.ld_my, SC, BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&mask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.mask, a.words, a.M,
               a.words, 4, BM, CU_TENSOR_MAP_SWIZZLE_NONE) &&
      make_map(&al, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.al, 3 * KT, a.N,
               3 * KT, 64, SC, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grad_packed<KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int stripes = (a.M + BM - 1) / BM;
  grad_packed<KT><<<stripes < sms ? stripes : sms, kThreads, C::kSmem,
                    a.stream>>>(my, mask, al, static_cast<const float*>(a.x),
                                a.M, a.N, a.F, static_cast<float*>(a.g));
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N f32, row stride ld_my, a
// multiple of 4); mask the packed bits (M x words int32, words % 4 == 0);
// x (M x F) f32; al a's limbs (N x 3 kt bf16: row n = [limb 0 | limb 1 |
// limb 2] of a[:, n], each kt wide, zero past F); kt the feature tile, 64
// (F <= 64) or 128 (F <= 128); g (M x F) f32. Returns 0 or the first
// non-zero cudaError_t.
extern "C" int lasso_grad_packed_launch(int kt, const void* my, int ld_my,
                                        const void* mask, int words,
                                        const void* x, const void* al, int M,
                                        int N, int F, void* g, void* stream) {
  const Args a{my, mask, x, al, ld_my, words, M, N, F, g,
               static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || F < 1 || F > kt || (kt != 64 && kt != 128) ||
      words % 4 != 0 || words * 32 < N || ld_my < N || ld_my % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}
