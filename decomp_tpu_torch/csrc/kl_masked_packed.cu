// Masked KL-divergence NMF statistics on f32 data with a bit-packed mask,
// on Hopper (sm_90a): every f32 product as bf16x6 limb products on the
// tensor cores.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:678
// kl_stats_masked (body _kl_masked_kernel :325) for f32 data and a 0/1
// mask. Given my = mask * y (M, N) f32, the mask as bits (M, W) int32 (bit j
// of word w in row r is mask[r, 32 w + j]; W = ceil(N / 32) rounded up to a
// multiple of 4, pad bits 0), x (M, K) f32 and d (K, N) as its three bf16
// limbs, it returns
//   E1 = my / (x d + eps)
//   x_new = x * (E1 d^T) / (mask d^T + eps)                      (M, K) f32
//   E2 = my / (x_new d + eps)
//   numd = x_new^T E2, dend = x_new^T mask                       (K, N) f32
// the function of KL_MASKED in mu_kl_stats.cu at its f32 quantisation
// points (cdt = f32: E is not rounded).
//
// Products. The TPU kernel runs f32 operands at Precision.HIGHEST, which on
// the TPU is bf16x6; so does this kernel, on mma.sync m16n8k16 with f32
// accumulation. Each f32 operand a is split into round-to-nearest bf16 limbs
// a0 = bf16(a), a1 = bf16(a - a0), a2 = bf16(a - a0 - a1) (the residuals
// are exact in f32), and a product a b is the sum of the six limb products
// whose order is at most 2^-16 of a0 b0: a2 b0, a1 b1, a0 b2, a1 b0, a0 b1
// (the "small" chain, summed first) and a0 b0 (the "big" chain). The 0/1
// mask is exact in bf16, so mask d^T and x_new^T mask take three products
// (mask against each limb). The tensor cores' f32 sums do not round to
// nearest, and a long chain drifts (nmf_common.cuh:206-212); here the big
// chain of every streamed product is summed per 32-deep sub-stage in its own
// registers and added to the running sum with round-to-nearest f32 adds,
// the small chain beside it (its drift is 2^-8 smaller). No TF32 anywhere.
//
// What bounds it on an H100. 30 passes of 2 MNK bf16 operations (r1, num_x,
// r2, numd: 6 each; den_x, dend: 3 each): at 100,000 x 1,024, K = 128,
// 7.9e11 operations, 0.795 ms at 989 TFLOP/s, against 0.53 GB (my read once,
// the mask bits, x read and x_new written, d and the statistics; 0.157 ms
// at 3.35 TB/s). Bound by operations, 3x under the full-f32-FMA bound of
// the dense-mask kernel (2.348 ms at 67 TFLOP/s). The design keeps the
// tensor cores fed and the bytes low:
//   - the mask is read as bits (1/32 of the f32 mask the dense-mask kernel
//     reads); a lane builds its 0/1 bf16 fragments from the words;
//   - each warp owns whole rows (x update) or whole columns (statistics),
//     so a ratio E formed from the reconstruction's accumulators is already
//     the next product's fragment (the accumulator layout of a 16 x 16
//     reconstruction tile is the A fragment of x update's num, and the B
//     fragment of the statistics' numd when the statistics form R^T): E
//     never touches shared memory and takes no extra barrier;
//   - the stages arrive by TMA (cp.async.bulk.tensor.2d) into a two-stage
//     ring, one mbarrier per stage, issued by one thread; f32 my in boxes of
//     128-byte rows, swizzled (128B), read at fragment positions without
//     bank conflicts; the limbs of d (x update) and of x_new (statistics)
//     land swizzled for ldmatrix;
//   - the x update keeps the three limbs of its 128-row x stripe resident in
//     shared memory (split once per stripe: 102 KB at K = 128); the
//     statistics pass keeps the three limbs of its 128-column d tile (96
//     KB); one block per SM.
// Schedule, as mu_masked_packed.cu: three launches.
//   1. x update: one block per 128-row stripe loops over N in 32-column
//      stages (my, the stage's mask word, d's limbs). It writes x_new (f32)
//      and its three limbs xc (M x 3 KT bf16: [limb 0 | limb 1 | limb 2]).
//   2. statistics: a grid of (128-column N tile) x (row chunk) walks its
//      chunk in 32-row stages and writes per-chunk partials [numd | dend].
//   3. the fixed-order reduction of nmf_common.cuh.
// No float atomics: a rerun gives the same bits. The ragged M, N and K edges
// are masked: TMA zero-fills boxes outside the tensors, E is 0 outside the
// matrix and outside the block's row chunk (so eps = 0 gives no NaN there),
// and the mask bits of rows past the chunk are taken as 0.
//
// The wrapper (ops/cuda_mu.py) gives d's limbs as one (3 KT, ld_d) bf16
// array, limb l in rows [l KT, l KT + K) and zero rows after, and my with
// 16-byte-aligned rows (a padded copy where N % 4 != 0). The tensor maps
// are encoded with cuTensorMapEncodeTiled through the runtime's entry-point
// query (sm90_common.cuh), so the library needs no -lcuda.

#include "sm90_common.cuh"

namespace {

constexpr int BMX = 128;   // rows per block of the x update (16 per warp)
constexpr int SC = 32;     // columns per x-update stage: one mask word
constexpr int BNS = 128;   // columns per block of the statistics pass
constexpr int SR = 32;     // rows per statistics stage
constexpr int kStages = 2;

// Two 0/1 bits as a bf16 pair (1.0 = 0x3F80), lo in the lower half.
__device__ __forceinline__ uint32_t bit_pair(uint32_t lo, uint32_t hi) {
  return (lo & 1u) * 0x3F80u | (hi & 1u) * 0x3F800000u;
}

// acc += a b for one 16 x 8 tile of an f32 product, b given as its limbs
// (b0, b1) fragments per limb and a as its limb fragments: the small chain
// into s, the big one into g.
__device__ __forceinline__ void six(float (&s)[4], float (&g)[4],
                                    const uint32_t (&a)[3][4],
                                    const uint32_t (&b)[3][2]) {
  mma_bf16(s, a[2], b[0][0], b[0][1]);
  mma_bf16(s, a[1], b[1][0], b[1][1]);
  mma_bf16(s, a[0], b[2][0], b[2][1]);
  mma_bf16(s, a[1], b[0][0], b[0][1]);
  mma_bf16(s, a[0], b[1][0], b[1][1]);
  mma_bf16(g, a[0], b[0][0], b[0][1]);
}

// Launch 1 shared memory, from a 1024-aligned base: kStages slots of
// [my (128 rows x 32 f32, SW128) | d's limbs (3 boxes of KT rows x 32 bf16,
// SW64) | mask words (128 rows x 4 int32)], then the stripe's x limbs
// (3 x 128 x (KT + 8) bf16) and the slots' mbarriers.
template <int KT> constexpr int kXMy = BMX * SC * 4;
template <int KT> constexpr int kXD = KT * SC * 2;   // one limb
template <int KT> constexpr int kXMask = BMX * 16;
template <int KT>
constexpr int kXSlot = kXMy<KT> + 3 * kXD<KT> + kXMask<KT>;
template <int KT> constexpr int kLdx = KT + 8;
template <int KT>
constexpr size_t x_smem() {
  return 1024 + (size_t)kStages * kXSlot<KT> + 3 * BMX * kLdx<KT> * 2 +
         8 * kStages;
}

// Launch 1: the x update of one 128-row stripe. Warp w owns rows
// [16 w, 16 w + 16) of the stripe: per stage it forms R = x d_s (16 x 32),
// E1 = my / (R + eps) in registers, and adds E1 d_s^T to num and mask d_s^T
// to den (16 x KT each).
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
    kl_x_update(const __grid_constant__ CUtensorMap tm_my,
                const __grid_constant__ CUtensorMap tm_mask,
                const __grid_constant__ CUtensorMap tm_d,
                const float* __restrict__ x, float eps, int M, int N, int K,
                float* __restrict__ x_new, bf16* __restrict__ xc) {
  constexpr int NT = KT / 8, KS = KT / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  bf16* Xs = reinterpret_cast<bf16*>(ring + kStages * kXSlot<KT>);
  uint64_t* full = reinterpret_cast<uint64_t*>(Xs + 3 * BMX * kLdx<KT>);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;
  const int row0 = blockIdx.x * BMX;
  const int n_st = (N + SC - 1) / SC;

  // Stage s: columns [32 s, 32 s + 32); its mask word s sits at s % 4 in a
  // box of 4 words that starts 16-byte aligned.
  auto issue = [&](int s) {
    unsigned char* slot = ring + (s % kStages) * kXSlot<KT>;
    uint64_t* bar = full + s % kStages;
    mbar_expect(bar, kXSlot<KT>);
    tma_load(slot, tm_my, s * SC, row0, bar);
#pragma unroll
    for (int l = 0; l < 3; ++l)
      tma_load(slot + kXMy<KT> + l * kXD<KT>, tm_d, s * SC, l * KT, bar);
    tma_load(slot + kXMy<KT> + 3 * kXD<KT>, tm_mask, s & ~3, row0, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages && s < n_st; ++s) issue(s);
  }
  // The stripe's x, split once into its three limbs (zero outside x).
  for (int e = threadIdx.x; e < BMX * KT; e += THREADS) {
    const int r = e / KT, c = e % KT;
    const float v = (row0 + r < M && c < K)
                        ? x[(long long)(row0 + r) * K + c] : 0.f;
    bf16 l[3];
    split3(v, l);
#pragma unroll
    for (int q = 0; q < 3; ++q) Xs[(q * BMX + r) * kLdx<KT> + c] = l[q];
  }
  float num[1][NT][4], den[1][NT][4];
  zero(num);
  zero(den);
  __syncthreads();

  const auto xs0 = op<false>(Pad{Xs, kLdx<KT>});
  const auto xs1 = op<false>(Pad{Xs + BMX * kLdx<KT>, kLdx<KT>});
  const auto xs2 = op<false>(Pad{Xs + 2 * BMX * kLdx<KT>, kLdx<KT>});
  for (int s = 0; s < n_st; ++s) {
    const unsigned char* slot = ring + (s % kStages) * kXSlot<KT>;
    const SwzF<BMX> ms{reinterpret_cast<const float*>(slot)};
    const bf16* dl = reinterpret_cast<const bf16*>(slot + kXMy<KT>);
    const Swz<64, KT> d0{dl}, d1{dl + KT * SC}, d2{dl + 2 * KT * SC};
    const uint32_t* mw =
        reinterpret_cast<const uint32_t*>(slot + kXMy<KT> + 3 * kXD<KT>);
    mbar_wait(full + s % kStages, (uint32_t)(s / kStages) & 1u);

    // R = x d_s: 4 tiles of 16 x 8 (columns 8 j .. 8 j + 7).
    float rs[4][4] = {}, rb[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t xa[3][4];
      xs0.a(xa[0], wr, 16 * kk, lane);
      xs1.a(xa[1], wr, 16 * kk, lane);
      xs2.a(xa[2], wr, 16 * kk, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t db[3][4];
        op<true>(d0).b2(db[0], 16 * h, 16 * kk, lane);
        op<true>(d1).b2(db[1], 16 * h, 16 * kk, lane);
        op<true>(d2).b2(db[2], 16 * h, 16 * kk, lane);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t b[3][2] = {{db[0][2 * q], db[0][2 * q + 1]},
                                    {db[1][2 * q], db[1][2 * q + 1]},
                                    {db[2][2 * q], db[2][2 * q + 1]}};
          six(rs[2 * h + q], rb[2 * h + q], xa, b);
        }
      }
    }
    // E1 = my / (R + eps), 0 outside the matrix, as the A fragments of the
    // 32-deep product with d_s^T (depth steps ks = 0, 1); the mask's 0/1
    // fragments from the stage's word of rows g and g + 8.
    uint32_t ea[2][3][4], ma[2][4];
    const uint32_t w_lo = mw[(wr + g) * 4 + (s & 3)];
    const uint32_t w_hi = mw[(wr + g + 8) * 4 + (s & 3)];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = wr + g + 8 * h2, col = 8 * j + 2 * t;
        const bool rin = row0 + row < M;
        const int c = s * SC + col;
        const float r0 = rb[j][2 * h2] + rs[j][2 * h2];
        const float r1 = rb[j][2 * h2 + 1] + rs[j][2 * h2 + 1];
        const float e0 = rin && c < N ? ms.at(row, col) / (r0 + eps) : 0.f;
        const float e1 =
            rin && c + 1 < N ? ms.at(row, col + 1) / (r1 + eps) : 0.f;
        uint32_t f[3];
        split_pair(e0, e1, f);
        const int reg = 2 * (j & 1) + h2;
#pragma unroll
        for (int l = 0; l < 3; ++l) ea[j >> 1][l][reg] = f[l];
        const uint32_t w = h2 ? w_hi : w_lo;
        ma[j >> 1][reg] = bit_pair(w >> col, w >> (col + 1));
      }
    // num += E1 d_s^T, den += mask d_s^T, per pair of 8-rank tiles.
#pragma unroll
    for (int np = 0; np < KT / 16; ++np) {
      float ss[2][4] = {}, sb[2][4] = {}, qs[2][4] = {}, qb[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t db[3][4];
        op<false>(d0).b2(db[0], 16 * np, 16 * ks, lane);
        op<false>(d1).b2(db[1], 16 * np, 16 * ks, lane);
        op<false>(d2).b2(db[2], 16 * np, 16 * ks, lane);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t b[3][2] = {{db[0][2 * q], db[0][2 * q + 1]},
                                    {db[1][2 * q], db[1][2 * q + 1]},
                                    {db[2][2 * q], db[2][2 * q + 1]}};
          six(ss[q], sb[q], ea[ks], b);
          mma_bf16(qs[q], ma[ks], b[2][0], b[2][1]);
          mma_bf16(qs[q], ma[ks], b[1][0], b[1][1]);
          mma_bf16(qb[q], ma[ks], b[0][0], b[0][1]);
        }
      }
#pragma unroll
      for (int q = 0; q < 2; ++q)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          num[0][2 * np + q][i] += sb[q][i] + ss[q][i];
          den[0][2 * np + q][i] += qb[q][i] + qs[q][i];
        }
    }
    __syncthreads();
    // Every warp is done with stage s: its slot takes stage s + kStages.
    if (threadIdx.x == 0 && s + kStages < n_st) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + kStages);
    }
  }

  // x_new = x * num / (den + eps); xc = its three limbs, zero past K.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const long long gr = row0 + wr + g + 8 * h2;
      const int c = 8 * nt + 2 * t;
      if (gr >= M) continue;
      float xf[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        xf[u] = 0.f;
        if (c + u < K) {
          xf[u] = x[gr * K + c + u] * num[0][nt][2 * h2 + u] /
                  (den[0][nt][2 * h2 + u] + eps);
          x_new[gr * K + c + u] = xf[u];
        }
      }
      uint32_t f[3];
      split_pair(xf[0], xf[1], f);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        *reinterpret_cast<uint32_t*>(xc + gr * (3 * KT) + l * KT + c) = f[l];
    }
}

// Launch 2 shared memory, from a 1024-aligned base: kStages slots of
// [xc (32 rows x 3 KT bf16, boxes of 64 columns, SW128) | my (32 rows x
// 128 f32, 4 boxes of 32 columns, SW128) | mask words (32 rows x 4 int32),
// padded to 1 KB], the resident d tile (3 limbs x 2 boxes of KT rows x 64
// bf16, SW128) and kStages + 1 mbarriers.
template <int KT> constexpr int kSX = SR * 3 * KT * 2;
template <int KT> constexpr int kSMy = SR * BNS * 4;
template <int KT> constexpr int kSMask = SR * 16;
template <int KT> constexpr int kSSlot = kSX<KT> + kSMy<KT> + 1024;
template <int KT> constexpr int kSD = KT * BNS * 2;   // one limb
template <int KT>
constexpr size_t s_smem() {
  return 1024 + (size_t)kStages * kSSlot<KT> + 3 * kSD<KT> +
         8 * (kStages + 1);
}

// Launch 2: block (j, c) covers columns [128 j, 128 j + 128) of row chunk
// c and writes partial c = [numd (K x N) | dend (K x N)]. Warp w owns the
// columns [16 w, 16 w + 16) of the tile: per stage it forms R^T = d^T x_new^T
// (16 columns x 32 rows), E2^T = (my / (R + eps))^T in registers (the B
// fragments of x_new^T E2), and adds x_new^T E2 to numd and x_new^T mask to
// dend (KT x 16 each).
template <int KT>
__global__ void __launch_bounds__(THREADS, 1)
    kl_stats(const __grid_constant__ CUtensorMap tm_xc,
             const __grid_constant__ CUtensorMap tm_my,
             const __grid_constant__ CUtensorMap tm_mask,
             const __grid_constant__ CUtensorMap tm_d, float eps, int M,
             int N, int K, int chunk_rows, float* __restrict__ part) {
  constexpr int MT = KT / 16, KS = KT / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const bf16* Dt = reinterpret_cast<const bf16*>(ring + kStages * kSSlot<KT>);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + kStages * kSSlot<KT> + 3 * kSD<KT>);
  uint64_t* dbar = full + kStages;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wc = 16 * warp;
  const int n0 = blockIdx.x * BNS;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, M);
  const int n_st = (r_end - r_begin + SR - 1) / SR;

  auto issue = [&](int s) {
    unsigned char* slot = ring + (s % kStages) * kSSlot<KT>;
    uint64_t* bar = full + s % kStages;
    const int r = r_begin + s * SR;
    mbar_expect(bar, kSX<KT> + kSMy<KT> + kSMask<KT>);
#pragma unroll
    for (int b = 0; b < 3 * KT / 64; ++b)
      tma_load(slot + b * (SR * 128), tm_xc, 64 * b, r, bar);
#pragma unroll
    for (int b = 0; b < BNS / 32; ++b)
      tma_load(slot + kSX<KT> + b * (SR * 128), tm_my, n0 + 32 * b, r, bar);
    tma_load(slot + kSX<KT> + kSMy<KT>, tm_mask, n0 / 32, r, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(dbar, 3 * kSD<KT>);
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int b = 0; b < 2; ++b)
        tma_load(const_cast<bf16*>(Dt) + l * KT * BNS + b * KT * 64, tm_d,
                 n0 + 64 * b, l * KT, dbar);
    for (int s = 0; s < kStages && s < n_st; ++s) issue(s);
  }
  float numd[MT][2][4], dend[MT][2][4];
  zero(numd);
  zero(dend);
  __syncthreads();
  mbar_wait(dbar, 0);

  const Swz<128, KT> dt0{Dt}, dt1{Dt + KT * BNS}, dt2{Dt + 2 * KT * BNS};
  for (int s = 0; s < n_st; ++s) {
    const unsigned char* slot = ring + (s % kStages) * kSSlot<KT>;
    const bf16* xb = reinterpret_cast<const bf16*>(slot);
    const Swz<128, SR> x0{xb}, x1{xb + KT * SR}, x2{xb + 2 * KT * SR};
    const SwzF<SR> ms{reinterpret_cast<const float*>(slot + kSX<KT>)};
    const uint32_t* mw =
        reinterpret_cast<const uint32_t*>(slot + kSX<KT> + kSMy<KT>);
    const int valid = r_end - (r_begin + s * SR);   // rows of this chunk
    mbar_wait(full + s % kStages, (uint32_t)(s / kStages) & 1u);

    // R^T = d^T x_new^T: 4 tiles of 16 columns x 8 rows (rows 8 j ..).
    float rs[4][4] = {}, rb[4][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t da[3][4];
      op<true>(dt0).a(da[0], wc, 16 * kk, lane);
      op<true>(dt1).a(da[1], wc, 16 * kk, lane);
      op<true>(dt2).a(da[2], wc, 16 * kk, lane);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t xr[3][4];
        op<false>(x0).b2(xr[0], 16 * h, 16 * kk, lane);
        op<false>(x1).b2(xr[1], 16 * h, 16 * kk, lane);
        op<false>(x2).b2(xr[2], 16 * h, 16 * kk, lane);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const uint32_t b[3][2] = {{xr[0][2 * q], xr[0][2 * q + 1]},
                                    {xr[1][2 * q], xr[1][2 * q + 1]},
                                    {xr[2][2 * q], xr[2][2 * q + 1]}};
          six(rs[2 * h + q], rb[2 * h + q], da, b);
        }
      }
    }
    // E2 = my / (R + eps), 0 outside the matrix and the chunk, as the B
    // fragments of x_new^T E2 (depth steps ks over rows, 8-column blocks
    // cb); the mask's from the words of rows 2t, 2t + 1 (+ 8).
    uint32_t eb[2][2][3][2], mb[2][2][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = 8 * j + 2 * t;
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        const int col = wc + 8 * cb + g;
        const bool cin = n0 + col < N;
        float e[2];
        uint32_t bits[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool in = cin && row + u < valid;
          const float r = rb[j][2 * cb + u] + rs[j][2 * cb + u];
          e[u] = in ? ms.at(row + u, col) / (r + eps) : 0.f;
          bits[u] = row + u < valid
                        ? mw[(row + u) * 4 + (col >> 5)] >> (col & 31) : 0u;
        }
        uint32_t f[3];
        split_pair(e[0], e[1], f);
#pragma unroll
        for (int l = 0; l < 3; ++l) eb[j >> 1][cb][l][j & 1] = f[l];
        mb[j >> 1][cb][j & 1] = bit_pair(bits[0], bits[1]);
      }
    }
    // numd += x_new^T E2, dend += x_new^T mask, per 16-rank tile.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float ss[2][4] = {}, sb[2][4] = {}, qs[2][4] = {}, qb[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        uint32_t xa[3][4];
        op<true>(x0).a(xa[0], 16 * mt, 16 * ks, lane);
        op<true>(x1).a(xa[1], 16 * mt, 16 * ks, lane);
        op<true>(x2).a(xa[2], 16 * mt, 16 * ks, lane);
#pragma unroll
        for (int cb = 0; cb < 2; ++cb) {
          six(ss[cb], sb[cb], xa, eb[ks][cb]);
          mma_bf16(qs[cb], xa[2], mb[ks][cb][0], mb[ks][cb][1]);
          mma_bf16(qs[cb], xa[1], mb[ks][cb][0], mb[ks][cb][1]);
          mma_bf16(qb[cb], xa[0], mb[ks][cb][0], mb[ks][cb][1]);
        }
      }
#pragma unroll
      for (int cb = 0; cb < 2; ++cb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          numd[mt][cb][i] += sb[cb][i] + ss[cb][i];
          dend[mt][cb][i] += qb[cb][i] + qs[cb][i];
        }
    }
    __syncthreads();
    if (threadIdx.x == 0 && s + kStages < n_st) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(s + kStages);
    }
  }

  const long long KN = (long long)K * N;
  float* out = part + (long long)blockIdx.y * 2 * KN;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = 16 * mt + g + (i >= 2 ? 8 : 0);
        const long long c = n0 + wc + 8 * cb + 2 * t + (i & 1);
        if (kr >= K || c >= N) continue;
        out[kr * (long long)N + c] = numd[mt][cb][i];
        out[KN + kr * (long long)N + c] = dend[mt][cb][i];
      }
}

struct Args {
  const void *my, *mask, *x, *dl;
  int ld_my, words, ld_d;
  float eps;
  int M, N, K, chunk_rows;
  void *x_new, *xc, *part, *out;
  cudaStream_t stream;
};

template <int KT>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapDataType I32 = CU_TENSOR_MAP_DATA_TYPE_INT32;
  CUtensorMap my1, mask1, d1, xc2, my2, mask2, d2;
  const bool ok =
      make_map(&my1, F32, 4, a.my, a.N, a.M, a.ld_my, SC, BMX,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&mask1, I32, 4, a.mask, a.words, a.M, a.words, 4, BMX,
               CU_TENSOR_MAP_SWIZZLE_NONE) &&
      make_map(&d1, BF, 2, a.dl, a.N, 3 * KT, a.ld_d, SC, KT,
               CU_TENSOR_MAP_SWIZZLE_64B) &&
      make_map(&xc2, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, SR,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&my2, F32, 4, a.my, a.N, a.M, a.ld_my, 32, SR,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&mask2, I32, 4, a.mask, a.words, a.M, a.words, 4, SR,
               CU_TENSOR_MAP_SWIZZLE_NONE) &&
      make_map(&d2, BF, 2, a.dl, a.N, 3 * KT, a.ld_d, 64, KT,
               CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;

  constexpr size_t smem1 = x_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      kl_x_update<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  kl_x_update<KT><<<(a.M + BMX - 1) / BMX, THREADS, smem1, a.stream>>>(
      my1, mask1, d1, static_cast<const float*>(a.x), a.eps, a.M, a.N, a.K,
      static_cast<float*>(a.x_new), static_cast<bf16*>(a.xc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  constexpr size_t smem2 = s_smem<KT>();
  err = cudaFuncSetAttribute(kl_stats<KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  kl_stats<KT><<<dim3((a.N + BNS - 1) / BNS, chunks), THREADS, smem2,
                 a.stream>>>(xc2, my2, mask2, d2, a.eps, a.M, a.N, a.K,
                             a.chunk_rows, static_cast<float*>(a.part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part), 2LL * a.K * a.N,
                       chunks, static_cast<float*>(a.out), a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N f32, row stride ld_my, a
// multiple of 4); mask the packed bits (M x words int32, words % 4 == 0);
// x and x_new (M x K) f32; dl d's limbs (3 kt x ld_d bf16, ld_d a multiple
// of 8: limb l in rows [l kt, l kt + K), zero rows after); kt the rank
// tile, 64 (K <= 64) or 128 (K <= 128); xc (M x 3 kt) bf16 scratch; part
// chunks x 2 K N f32 scratch with chunks = ceil(M / chunk_rows); out 2 K N
// f32 = [numd | dend]. Returns 0 or the first non-zero cudaError_t.
extern "C" int kl_masked_packed_launch(int kt, const void* my, int ld_my,
                                       const void* mask, int words,
                                       const void* x, const void* dl,
                                       int ld_d, float eps, int M, int N,
                                       int K, int chunk_rows, void* x_new,
                                       void* xc, void* part, void* out,
                                       void* stream) {
  const Args a{my, mask, x, dl, ld_my, words, ld_d, eps, M, N, K, chunk_rows,
               x_new, xc, part, out, static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      chunk_rows < 1 || words % 4 != 0 || words * 32 < N || ld_my < N ||
      ld_d < N || ld_my % 4 != 0 || ld_d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}
