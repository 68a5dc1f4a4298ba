// Masked multiplicative-update NMF statistics on bf16 data with a
// bit-packed mask, on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:522
// mu_stats_masked (body _masked_kernel :222) for bf16 data, with f32 or
// bf16 x. Given my = mask * y (M, N) bf16, the mask as bits (M, W) int32
// (bit j of word w in row r is mask[r, 32 w + j]; W = ceil(N / 32) rounded
// up to a multiple of 4, pad bits 0), x (M, K) and d (K, N) bf16, it forms
//   E = cdt(mask * cdt(x) d)
//   x_new = x * (my d^T) / (E d^T + eps)
//   numd = cdt(x_new)^T my, dend = cdt(x_new)^T E(x_new)      (K, N) f32
// with the TPU kernel's quantisation points, as MU_MASKED of
// mu_kl_stats.cu: products take bf16 operands and sum in f32 (mma.sync),
// E is formed in f32 and cast to bf16, x_new is formed in f32 and stored in
// x's dtype, the statistics use bf16(x_new_f32).
//
// What bounds it on an H100. Its products are 12 MNK operations; per entry
// it must read 2 bytes of my and 1 bit of mask. At config 4 (100,000 x
// 1,000, K = 50) that is 6.0e10 operations (0.061 ms at 989 TFLOP/s)
// against 200 MB of my, 12.8 MB of mask words and 40 MB of x and x_new
// (0.076 ms at 3.35 TB/s): bound by bytes. The design therefore cuts the
// bytes it moves and keeps enough of them in flight:
//   - the mask is streamed as bits, one 32-bit word per row per 32
//     columns, 1/16 of the bf16 mask the dense-mask kernel reads; a lane
//     expands two bits at a time where E is formed;
//   - the rank tile KT is a template parameter, 64 for K <= 64 and 128 up
//     to 128, so K = 50 runs half the R-product MMAs and half the shared
//     memory of a 128-rank tile;
//   - tiles arrive by TMA (cp.async.bulk.tensor.2d) into a ring of stages
//     in shared memory, one mbarrier per stage, issued by one thread: no
//     register staging, and with two blocks per SM >= 32 KB of my in
//     flight per SM (Little's law at 3.35 TB/s and ~1.3 us wants ~33 KB);
//   - a stage is 64 columns (x update) or 64 rows (statistics), so every
//     box row is 128 bytes, and a block forms E of stage s + 1 between the
//     same two barriers as it adds stage s to its sums;
//   - TMA boxes land unpadded with the 128-byte swizzle, and the fragment
//     loads (ldmatrix, .trans for the transposed operands) apply the same
//     XOR (Swz below), so they do not conflict on banks; TMA zero-fills
//     boxes outside the tensor, which masks the ragged M, N and K edges; a
//     box's first column must start 16 bytes into a row, so the mask boxes
//     start at a multiple of 4 words;
//   - the statistics pass writes one partial per row chunk, with chunks
//     chosen by the wrapper so that chunks x N tiles make two waves of the
//     resident blocks (33 chunks, 13 MB of partials at config 4, against
//     125 chunks and 50 MB with the dense-mask kernel's default).
// What is left is the work per stage on mma.sync: the two passes run at
// about 1.2 TB/s of the bytes they move, each well under its bytes (see
// PERF.md), while the fragment loads, the MMAs and the formation of E keep
// the SM busy; wgmma, or a single pass, is the next step.
// It keeps mu_kl_stats.cu's structure: an x-update pass (one block per
// 64-row stripe, looping over N), a statistics pass (a grid of 64-column N
// tiles x row chunks, d tile resident) and the fixed-order reduction of
// nmf_common.cuh. So the data are still read twice per iteration; a single
// pass (a thread-block cluster that splits N and reduces num / den through
// distributed shared memory) is later work. No float atomics: a rerun
// gives the same bits. The x-update pass also writes xc = bf16(x_new), (M,
// KT) with zero pad columns, which the statistics pass reads by TMA.
//
// TMA needs 16-byte-aligned rows: my and d with N % 8 != 0 are given here
// as padded copies by the wrapper (ops/cuda_mu.py), whose row stride
// (ld_my, ld_d) may exceed N. The tensor maps are encoded on the host with
// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime's
// entry-point query, so the library needs no -lcuda.

#include "sm90_common.cuh"

namespace {

constexpr int BMX = 64;          // rows per block of the x update
constexpr int BNS = 64;          // columns per block of the statistics pass

// The A fragments of one BK-deep stage (two 16-deep steps, depth k0 ..
// k0 + 31) for the rows i0 .. i0 + 16 MT - 1 of operand a.
template <int MT, typename OA>
__device__ __forceinline__ void stage_a(uint32_t (&f)[2][MT][4], const OA& a,
                                        int i0, int k0, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      a.a(f[ks][mt], i0 + 16 * mt, k0 + 16 * ks, lane);
}

// One BK-deep stage (depth k0 .. k0 + 31) of acc[mt][nt] += A B (rows of
// B: n = wc + 8 nt), and,
// when A2 is given, acc2 += A2 B with the same B fragments. Each 16 x 16
// output tile sums its stage in its own registers and is then added to
// acc with a round-to-nearest f32 add (stage_mma of nmf_common.cuh: a long
// mma.sync chain drifts). NT is even.
template <int MT, int NT, typename OB>
__device__ __forceinline__ void stage_acc(float (&acc)[MT][NT][4],
                                          const uint32_t (&af)[2][MT][4],
                                          float (*acc2)[NT][4],
                                          const uint32_t (*af2)[MT][4],
                                          const OB& b, int wc, int k0,
                                          int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; nt += 2) {
    float st[MT][2][4] = {}, st2[MT][2][4] = {};
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t bf[4];
      b.b2(bf, wc + 8 * nt, k0 + 16 * ks, lane);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(st[mt][0], af[ks][mt], bf[0], bf[1]);
        mma_bf16(st[mt][1], af[ks][mt], bf[2], bf[3]);
        if (acc2 != nullptr) {
          mma_bf16(st2[mt][0], af2[ks][mt], bf[0], bf[1]);
          mma_bf16(st2[mt][1], af2[ks][mt], bf[2], bf[3]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[mt][nt][i] += st[mt][0][i];
        acc[mt][nt + 1][i] += st[mt][1][i];
        if (acc2 != nullptr) {
          acc2[mt][nt][i] += st2[mt][0][i];
          acc2[mt][nt + 1][i] += st2[mt][1][i];
        }
      }
  }
}

// A stage is 64 columns of the stripe (launch 1) or 64 rows of the chunk
// (launch 2), so every TMA box row is 128 bytes; its products run as two
// BK-deep sub-stages. Ring depth by rank tile, two blocks per SM: >= 32 KB
// of my in flight per SM (2 blocks x 2-3 stages x 8 KB).
constexpr int SW = 64;
template <int KT> constexpr int kStages = KT == 64 ? 4 : 3;
constexpr int kBlocks = 2;

// Launch 1 shared memory, from a 1024-aligned base: S stages of
// [my (64 x 64, SW128) | d (KT x 64, SW128) | mask words (64 x 4 int32)],
// then Xs (64 x KT + 8, bf16 x), two E tiles (64 x LDE) and S mbarriers.
constexpr int LDE = SW + 8;   // leading dim of the E tiles
template <int KT> constexpr int kXMy = BMX * SW * 2;
template <int KT> constexpr int kXD = KT * SW * 2;
template <int KT> constexpr int kXMask = BMX * 16;
template <int KT> constexpr int kXSlot = kXMy<KT> + kXD<KT> + kXMask<KT>;
template <int KT>
constexpr size_t x_smem() {
  return 1024 + (size_t)kStages<KT> * kXSlot<KT> +
         (size_t)BMX * (KT + 8) * 2 + 2 * BMX * LDE * 2 + 8 * kStages<KT>;
}

// E = cdt(mask * r) for a warp's 16 x 32 tile of R at (row0, col0) of the
// stage's E tile: r as mma.sync accumulators (4 tiles of 16 x 8), the mask
// bits of row r, columns c .. c + 31 of the stage, in word w(r, c / 32).
// Columns 2t and 2t + 1 go as one bf16 pair.
template <typename W>
__device__ __forceinline__ void store_e(bf16* E, const float (&r)[4][4],
                                        int row0, int col0, int lane,
                                        W word) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // rows g and g + 8
      const int row = row0 + frag_row(0, 2 * h, lane);
      const int col = col0 + frag_col(nt, 0, lane);
      const uint32_t bits = (word(row, col >> 5) >> (col & 31)) & 3u;
      *reinterpret_cast<__nv_bfloat162*>(E + row * LDE + col) =
          __floats2bfloat162_rn((float)(bits & 1u) * r[nt][2 * h],
                                (float)(bits >> 1) * r[nt][2 * h + 1]);
    }
}

// Launch 1: the x update of one 64-row stripe. Warps: 4 (rows of 16) x 2
// (columns of 32) for the R product, 4 (rows of 16) x 2 (ranks of KT / 2)
// for num and den, which share their d fragments.
template <int KT, typename X>
__global__ void __launch_bounds__(THREADS, kBlocks)
    x_update_packed(const __grid_constant__ CUtensorMap tm_my,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const __grid_constant__ CUtensorMap tm_d,
                    const X* __restrict__ x, float eps, int M, int N, int K,
                    X* __restrict__ x_new, bf16* __restrict__ xc) {
  constexpr int S = kStages<KT>, NT = KT / 16, KS = KT / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  bf16* Xs = reinterpret_cast<bf16*>(ring + S * kXSlot<KT>);
  bf16* Es = Xs + BMX * (KT + 8);
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + 2 * BMX * LDE);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 16, wc_r = (warp >> 2) * 32;
  const int wc = (warp >> 2) * (KT / 2);
  const int row0 = blockIdx.x * BMX;
  const int n_st = (N + SW - 1) / SW;

  // Stage s: columns [64 s, 64 s + 64); its mask words 2 s and 2 s + 1
  // sit at 2 s % 4 and on in a box that starts 16-byte aligned.
  auto issue = [&](int s) {
    unsigned char* slot = ring + (s % S) * kXSlot<KT>;
    uint64_t* bar = full + s % S;
    mbar_expect(bar, kXSlot<KT>);
    tma_load(slot, tm_my, s * SW, row0, bar);
    tma_load(slot + kXMy<KT>, tm_d, s * SW, 0, bar);
    tma_load(slot + kXMy<KT> + kXD<KT>, tm_mask, (2 * s) & ~3, row0, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < S && s < n_st; ++s) issue(s);
  }
  load_tile<bf16, X, BMX, KT>(Xs, KT + 8, x + (long long)row0 * K, K,
                              M - row0, K);
  float num[1][NT][4], den[1][NT][4];
  zero(num);
  zero(den);
  __syncthreads();

  const auto xs = op<false>(Pad{Xs, KT + 8});
  // Stage s: R = cdt(x) d_s (64 x 64), E = cdt(mask * R) into E tile s & 1.
  auto form_e = [&](int s) {
    const unsigned char* slot = ring + (s % S) * kXSlot<KT>;
    const auto ds = op<true>(
        Swz<128, KT>{reinterpret_cast<const bf16*>(slot + kXMy<KT>)});
    const uint32_t* mw =
        reinterpret_cast<const uint32_t*>(slot + kXMy<KT> + kXD<KT>);
    const int w0 = (2 * s) & 3;
    mbar_wait(full + s % S, (uint32_t)(s / S) & 1u);
    float r[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4], bf[4], bf2[4];
      xs.a(af, wr, 16 * kk, lane);
      ds.b2(bf, wc_r, 16 * kk, lane);
      ds.b2(bf2, wc_r + 16, 16 * kk, lane);
      mma_bf16(r[0], af, bf[0], bf[1]);
      mma_bf16(r[1], af, bf[2], bf[3]);
      mma_bf16(r[2], af, bf2[0], bf2[1]);
      mma_bf16(r[3], af, bf2[2], bf2[3]);
    }
    store_e(Es + (s & 1) * BMX * LDE, r, wr, wc_r, lane,
            [&](int row, int w) { return mw[row * 4 + w0 + w]; });
  };
  // Between two barriers a warp forms E of stage s + 1 and adds stage s to
  // num and den (my_s d_s^T, E_s d_s^T) in two BK-deep sub-stages.
  form_e(0);
  __syncthreads();
  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) form_e(s + 1);
    const unsigned char* slot = ring + (s % S) * kXSlot<KT>;
    const Swz<128, BMX> ys{reinterpret_cast<const bf16*>(slot)};
    const Swz<128, KT> ds{reinterpret_cast<const bf16*>(slot + kXMy<KT>)};
    const Pad es{Es + (s & 1) * BMX * LDE, LDE};
#pragma unroll
    for (int kb = 0; kb < SW; kb += BK) {
      uint32_t fy[2][1][4], fe[2][1][4];
      stage_a(fy, op<false>(ys), wr, kb, lane);
      stage_a(fe, op<false>(es), wr, kb, lane);
      stage_acc<1, NT>(num, fy, den, fe, op<false>(ds), wc, kb, lane);
    }
    __syncthreads();
    // Every thread is done with stage s: its slot takes stage s + S.
    if (threadIdx.x == 0 && s + S < n_st) issue(s + S);
  }

  // x_new = x * num / (den + eps) in x's dtype; xc = bf16(x_new_f32) with
  // zero pad columns, for the statistics pass.
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long gr = row0 + wr + frag_row(0, i, lane);
      const int c = wc + frag_col(nt, i, lane);
      if (gr >= M) continue;
      float xf = 0.f;
      if (c < K) {
        xf = to_f32(x[gr * K + c]) * num[0][nt][i] / (den[0][nt][i] + eps);
        x_new[gr * K + c] = cvt<X>(xf);
      }
      xc[gr * KT + c] = from_f32<bf16>(xf);
    }
}

// Launch 2 shared memory, from a 1024-aligned base: S stages of
// [xc (64 x KT, boxes of 64 columns, SW128) | my (64 x 64, SW128) | mask
// words (64 x 4 int32)], the resident d tile (KT x 64, SW128), two E tiles
// (64 x LDE) and S + 1 mbarriers.
template <int KT> constexpr int kSX = SW * KT * 2;
template <int KT> constexpr int kSMy = SW * BNS * 2;
template <int KT> constexpr int kSMask = SW * 16;
template <int KT> constexpr int kSSlot = kSX<KT> + kSMy<KT> + kSMask<KT>;
template <int KT> constexpr int kSD = KT * BNS * 2;
template <int KT>
constexpr size_t s_smem() {
  return 1024 + (size_t)kStages<KT> * kSSlot<KT> + kSD<KT> +
         2 * SW * LDE * 2 + 8 * (kStages<KT> + 1);
}

// Launch 2: block (j, c) covers columns [64 j, 64 j + 64) of row chunk c
// and writes partial c = [numd (K x N) | dend (K x N)]. Warps: 4 (rows of
// 16) x 2 (columns of 32) for the R product; KT / 32 (ranks of 32) x
// 256 / KT (columns of KT / 4) for numd and dend, which share their x_new
// fragments.
template <int KT>
__global__ void __launch_bounds__(THREADS, kBlocks)
    stats_packed(const __grid_constant__ CUtensorMap tm_xc,
                 const __grid_constant__ CUtensorMap tm_my,
                 const __grid_constant__ CUtensorMap tm_mask,
                 const __grid_constant__ CUtensorMap tm_d, int M, int N,
                 int K, int chunk_rows, float* __restrict__ part) {
  constexpr int S = kStages<KT>, NT = KT / 32, WR = KT / 32, KS = KT / 16;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  const bf16* Dt = reinterpret_cast<const bf16*>(ring + S * kSSlot<KT>);
  bf16* Es = reinterpret_cast<bf16*>(ring + S * kSSlot<KT> + kSD<KT>);
  uint64_t* full = reinterpret_cast<uint64_t*>(Es + 2 * SW * LDE);
  uint64_t* dbar = full + S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr_r = (warp & 3) * 16, wc_r = (warp >> 2) * 32;
  const int wr = (warp % WR) * 32, wc = (warp / WR) * (KT / 4);
  const int n0 = blockIdx.x * BNS;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, M);
  const int n_st = (r_end - r_begin + SW - 1) / SW;
  const int w0 = (n0 / 32) & 3;   // the tile's first word in a mask box

  auto issue = [&](int s) {
    unsigned char* slot = ring + (s % S) * kSSlot<KT>;
    uint64_t* bar = full + s % S;
    const int r = r_begin + s * SW;
    mbar_expect(bar, kSSlot<KT>);
#pragma unroll
    for (int b = 0; b < KT / 64; ++b)
      tma_load(slot + b * (SW * 128), tm_xc, 64 * b, r, bar);
    tma_load(slot + kSX<KT>, tm_my, n0, r, bar);
    tma_load(slot + kSX<KT> + kSMy<KT>, tm_mask, (n0 / 32) & ~3, r, bar);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(dbar, kSD<KT>);
    tma_load(const_cast<bf16*>(Dt), tm_d, n0, 0, dbar);
    for (int s = 0; s < S && s < n_st; ++s) issue(s);
  }
  float numd[2][NT][4], dend[2][NT][4];
  zero(numd);
  zero(dend);
  __syncthreads();
  mbar_wait(dbar, 0);

  const auto dt = op<true>(Swz<128, KT>{Dt});
  // Stage s: R = cdt(x_new) d_tile (64 x 64), E = cdt(mask * R) into E
  // tile s & 1.
  auto form_e = [&](int s) {
    unsigned char* slot = ring + (s % S) * kSSlot<KT>;
    const Swz<128, SW> xt{reinterpret_cast<const bf16*>(slot)};
    const uint32_t* mw =
        reinterpret_cast<const uint32_t*>(slot + kSX<KT> + kSMy<KT>);
    mbar_wait(full + s % S, (uint32_t)(s / S) & 1u);
    const int valid = r_end - (r_begin + s * SW);
    if (valid < SW) {
      // The last stage of a chunk whose rows are not a multiple of 64: the
      // box holds the next chunk's rows, which must not count here. This
      // slot is never refilled, so generic writes may follow the TMA's.
      for (int e = threadIdx.x; e < (SW - valid) * KT / 8; e += THREADS) {
        const int row = valid + e / (KT / 8), c8 = (e % (KT / 8)) * 8;
        *reinterpret_cast<uint4*>(
            slot + (c8 / 64) * (SW * 128) + row * 128 + (c8 % 64) * 2) =
            make_uint4(0, 0, 0, 0);
      }
      __syncthreads();
    }
    float r[4][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4], bf[4], bf2[4];
      op<false>(xt).a(af, wr_r, 16 * kk, lane);
      dt.b2(bf, wc_r, 16 * kk, lane);
      dt.b2(bf2, wc_r + 16, 16 * kk, lane);
      mma_bf16(r[0], af, bf[0], bf[1]);
      mma_bf16(r[1], af, bf[2], bf[3]);
      mma_bf16(r[2], af, bf2[0], bf2[1]);
      mma_bf16(r[3], af, bf2[2], bf2[3]);
    }
    store_e(Es + (s & 1) * SW * LDE, r, wr_r, wc_r, lane,
            [&](int row, int w) { return mw[row * 4 + w0 + w]; });
  };
  // As in launch 1: E of stage s + 1 beside the statistics of stage s.
  form_e(0);
  __syncthreads();
  for (int s = 0; s < n_st; ++s) {
    if (s + 1 < n_st) form_e(s + 1);
    const unsigned char* slot = ring + (s % S) * kSSlot<KT>;
    const Swz<128, SW> xt{reinterpret_cast<const bf16*>(slot)};
    const Swz<128, SW> yt{reinterpret_cast<const bf16*>(slot + kSX<KT>)};
    const Pad es{Es + (s & 1) * SW * LDE, LDE};
#pragma unroll
    for (int kb = 0; kb < SW; kb += BK) {
      uint32_t fx[2][2][4];
      stage_a(fx, op<true>(xt), wr, kb, lane);
      stage_acc<2, NT>(numd, fx, nullptr, nullptr, op<true>(yt), wc, kb,
                       lane);
      stage_acc<2, NT>(dend, fx, nullptr, nullptr, op<true>(es), wc, kb,
                       lane);
    }
    __syncthreads();
    if (threadIdx.x == 0 && s + S < n_st) issue(s + S);
  }

  const long long KN = (long long)K * N;
  float* out = part + (long long)blockIdx.y * 2 * KN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = wr + frag_row(mt, i, lane);
        const long long c = n0 + wc + frag_col(nt, i, lane);
        if (kr >= K || c >= N) continue;
        out[kr * (long long)N + c] = numd[mt][nt][i];
        out[KN + kr * (long long)N + c] = dend[mt][nt][i];
      }
}

struct Args {
  const void *my, *mask, *x, *d;
  int ld_my, words, ld_d;
  float eps;
  int M, N, K, chunk_rows;
  void *x_new, *xc, *part, *out;
  cudaStream_t stream;
};

template <int KT, typename X>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType I32 = CU_TENSOR_MAP_DATA_TYPE_INT32;
  CUtensorMap my1, mask1, d1, xc2, my2, mask2, d2;
  const bool ok =
      make_map(&my1, BF, 2, a.my, a.N, a.M, a.ld_my, SW, BMX,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&mask1, I32, 4, a.mask, a.words, a.M, a.words, 4, BMX,
               CU_TENSOR_MAP_SWIZZLE_NONE) &&
      make_map(&d1, BF, 2, a.d, a.N, a.K, a.ld_d, SW, KT,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&xc2, BF, 2, a.xc, KT, a.M, KT, 64, SW,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&my2, BF, 2, a.my, a.N, a.M, a.ld_my, BNS, SW,
               CU_TENSOR_MAP_SWIZZLE_128B) &&
      make_map(&mask2, I32, 4, a.mask, a.words, a.M, a.words, 4, SW,
               CU_TENSOR_MAP_SWIZZLE_NONE) &&
      make_map(&d2, BF, 2, a.d, a.N, a.K, a.ld_d, BNS, KT,
               CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;

  constexpr size_t smem1 = x_smem<KT>();
  cudaError_t err = cudaFuncSetAttribute(
      x_update_packed<KT, X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  x_update_packed<KT, X><<<(a.M + BMX - 1) / BMX, THREADS, smem1, a.stream>>>(
      my1, mask1, d1, static_cast<const X*>(a.x), a.eps, a.M, a.N, a.K,
      static_cast<X*>(a.x_new), static_cast<bf16*>(a.xc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  constexpr size_t smem2 = s_smem<KT>();
  err = cudaFuncSetAttribute(stats_packed<KT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  stats_packed<KT><<<dim3((a.N + BNS - 1) / BNS, chunks), THREADS, smem2,
                     a.stream>>>(xc2, my2, mask2, d2, a.M, a.N, a.K,
                                 a.chunk_rows, static_cast<float*>(a.part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       2LL * a.K * a.N, chunks, static_cast<float*>(a.out),
                       a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N, row stride ld_my) and d
// (K x N, row stride ld_d) bf16 with 16-byte-aligned rows; mask the packed
// bits (M x words int32, words % 4 == 0); x and x_new (M x K) f32 or bf16
// (x_bf16); kt the rank tile, 64 (K <= 64) or 128 (K <= 128); xc (M x kt)
// bf16 scratch; part chunks x 2 K N f32 scratch with chunks = ceil(M /
// chunk_rows); out 2 K N f32 = [numd | dend]. Returns 0 or the first
// non-zero cudaError_t.
extern "C" int mu_masked_packed_launch(int x_bf16, int kt, const void* my,
                                       int ld_my, const void* mask, int words,
                                       const void* x, const void* d, int ld_d,
                                       float eps, int M, int N, int K,
                                       int chunk_rows, void* x_new, void* xc,
                                       void* part, void* out, void* stream) {
  const Args a{my, mask, x, d, ld_my, words, ld_d, eps, M, N, K, chunk_rows,
               x_new, xc, part, out, static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      chunk_rows < 1 || words % 4 != 0 || words * 32 < N || ld_my < N ||
      ld_d < N || ld_my % 8 != 0 || ld_d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  if (kt == 64)
    return x_bf16 ? launch<64, bf16>(a) : launch<64, float>(a);
  return x_bf16 ? launch<128, bf16>(a) : launch<128, float>(a);
}
