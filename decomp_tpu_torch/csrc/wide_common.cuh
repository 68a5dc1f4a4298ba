// The three products of the wide routes on Hopper (sm_90a), shared by
// grad_wide.cu (the masked gradients above 128 features) and mu_wide.cu
// (masked and dense MU and KL-MU above rank 128): f32 data with every f32
// product as bf16x6 limb products (L = 3 limbs an operand), bf16 data with
// each product one bf16 pass (L = 1), on wgmma.
//
//   wide_resid: R = x b, a persistent 128 x 128-tile kernel; x's limbs (M x
//       L kp) and b's (N x L kp: row n = the limbs of column n of b, each
//       kp wide, zero past the depth K) in 64-deep TMA stages; an epilogue
//       functor (Epi) consumes each tile's two 64-column halves of R;
//   wide_rows:  out = E b^T, E (M x N) in the data's dtype, b's limbs read
//       MN-major; a persistent block walks (128-row stripe) x (128-column
//       chunk) items and hands each item's accumulators to an epilogue
//       functor;
//   wide_dict:  the row chunks' partials of G = x^T E (K x N f32), summed
//       in chunk order by nmf_common.cuh's reduction.
//
// Products. At L = 3 each f32 operand v is split into round-to-nearest bf16
// limbs v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1), and a
// product u v is the sum of the six limb products whose order is at most
// 2^-16 of u0 v0: u0 v0 (the "big" chain) and u2 v0, u1 v1, u0 v2, u1 v0,
// u0 v1 (the "small" one). The tensor cores' f32 sums do not round to
// nearest and a long chain drifts (nmf_common.cuh:206-212), so each 64-deep
// big chain, and the small chain beside it, is summed in its own registers
// and added with round-to-nearest f32 adds (lasso_grad_packed.cu's
// discipline): over a depth of 10,624 the chain of R is 166 such adds. No
// TF32. No float atomics: a rerun gives the same bits. Ragged M, N and K
// are masked: TMA zero-fills boxes outside the tensors, and the limbs are
// zero past K.
//
// wide_resid's stages come from L2: a 64-deep f32 stage of a 128 x 64 tile
// is 72 KB for 1,536 clocks of products an SM (some 11 TB/s over 132 SMs
// at 1.83 GHz), and a 128 x 128 tile takes 1.5 times fewer bytes a product
// (on an H100 the f32 weighted residual of grad_wide.cu went from 0.77 to
// 0.69 ms at 100,000 x 1,024, K = 256: tools/grad_wide_turns.py). Two
// consumer warpgroups own 64 rows each, and each takes the tile's two
// 64-column halves in turn: per stage and half the big chain x0 b0 and the
// small chain x0 b1 + x0 b2 + x1 b0 + x1 b1 + x2 b0 (m64n64k16, both
// operands from shared memory) in their own registers, added to R with
// round-to-nearest adds.
//
// wide_rows' ring stages carry E's box (128 rows x 128 bytes: 32 f32 or 64
// bf16 columns) and b's limbs for those columns and the item's 128 output
// columns (read MN-major). E is split into limbs in registers (R's
// accumulator layout is wgmma's register-A fragment), as
// lasso_grad_packed.cu splits its E, and the item sums per stage in its
// own registers. Each block owns its piece of the output: no cross-block
// sum.
//
// wide_dict runs a grid of (128-column N tile) x (row chunk) x (128-row K
// chunk); 32-row stages of E (read at transposed positions, as
// wgmma_chain.cuh's GradDict reads my) and x's limbs for the chunk's rows
// of G; each block writes its partial G as (K, N).

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int BM = 128;                // rows per tile, 64 per consumer
constexpr int BN = 128;                // R's columns per tile (wide_resid)
constexpr int kXBox = BM * 128;        // 128 rows x 64 bf16 of x's limbs
constexpr int kBBox = BN * 128;        // 128 rows x 64 bf16 of b's limbs
constexpr int DR = 32;                 // rows per stage of wide_dict

template <int L>
using Elt = std::conditional_t<L == 3, float, bf16>;

// Shared memory of each kernel, from a 1024-aligned base: kStages slots
// (each a multiple of 1024 bytes), then 2 kStages mbarriers.
//   wide_resid: [x's L boxes | b's L boxes]: 96 KB at L = 3, 32 KB at 1;
//   wide_rows:  [E's box (128 rows x 128 bytes) | b's limbs, box (c, l) of
//               output chunk c and limb l at (L c + l) kBox]: SC = 32 f32
//               or 64 bf16 columns, 40 KB at L = 3, 32 KB at L = 1;
//   wide_dict:  [E's boxes (32 rows x 128 columns, 32- or 64-column boxes
//               side by side) | x's limbs, box (c, l) at (L c + l) kBox]:
//               40 KB at L = 3, 16 KB at L = 1.
template <int L>
struct ResidCfg {
  static constexpr int kA = L * kXBox;
  static constexpr int kSlot = kA + L * kBBox;
  static constexpr int kStages = L == 3 ? 2 : 7;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

template <int L>
struct RowsCfg {
  static constexpr int SC = 128 / (int)sizeof(Elt<L>);   // columns a stage
  static constexpr int kE = BM * 128;
  static constexpr int kBox = SC * 128;
  static constexpr int kSlot = kE + 2 * L * kBox;
  static constexpr int kStages = L == 3 ? 5 : 7;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

template <int L>
struct DictCfg {
  static constexpr int MC = 128 / (int)sizeof(Elt<L>);   // E's box columns
  static constexpr int kE = DR * 128 * (int)sizeof(Elt<L>);
  static constexpr int kBox = DR * 128;
  static constexpr int kSlot = kE + 2 * L * kBox;
  static constexpr int kStages = L == 3 ? 5 : 13;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty,
                                          int stages) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + i);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer's wait for a free slot of stage q of an S-deep ring.
__device__ __forceinline__ uint64_t* claim(uint64_t* full, uint64_t* empty,
                                           int q, int S, uint32_t bytes) {
  const int slot = q % S;
  if (q >= S) mbar_wait(empty + slot, ((q / S) + 1) & 1);
  mbar_expect(full + slot, bytes);
  return full + slot;
}

// A consumer warp is done with its slot.
__device__ __forceinline__ void release(uint64_t* empty, int slot, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty + slot);
}

// E's value at (row, col) of a box of 128-byte swizzled rows (32 f32 or 64
// bf16 columns) with ROWS rows, boxes side by side along the columns.
template <int L, int ROWS>
__device__ __forceinline__ float e_at(const unsigned char* box, int row,
                                      int col) {
  if constexpr (L == 3)
    return SwzF<ROWS>{reinterpret_cast<const float*>(box)}.at(row, col);
  else
    return to_f32(
        *Swz<128, ROWS>{reinterpret_cast<const bf16*>(box)}.at(row, col));
}

// The A fragment words of the pair (v0, v1) at slot ``slot`` of a depth
// step: its L limbs (L = 3), or the bf16 pair (L = 1: E is bf16 there, so
// the pair is exact).
template <int L>
__device__ __forceinline__ void put_pair(uint32_t (&ea)[L][4], int slot,
                                         float v0, float v1) {
  if constexpr (L == 3) {
    uint32_t f[3];
    split_pair(v0, v1, f);
#pragma unroll
    for (int l = 0; l < 3; ++l) ea[l][slot] = f[l];
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(v0, v1);
    ea[0][slot] = *reinterpret_cast<const uint32_t*>(&v);
  }
}

// acc (64 x 128 per warpgroup, two 64-wide chunks) += E_s B_s over one
// stage of KS 16-deep steps: A = E's limbs from registers (ea[ks][l]), B
// the stage's limb boxes read MN-major (box (c, l) at (L c + l) kBox, its
// 16-row step at ks 2048). Per chunk the big chain (e0 b0) and the small
// one in their own registers, then added to acc.
template <int L, int KS, int kBox>
__device__ __forceinline__ void product_rs(float (&acc)[2][32],
                                           const uint32_t (&ea)[KS][L][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    float tb[32], ts[32];
    fence_operand(tb);
    if constexpr (L == 3) fence_operand(ts);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const unsigned char* bb = b + L * c * kBox + ks * 2048;
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
}

// The pair at p and p + 1 (p 8- or 4-byte aligned) as f32, or zeros
// where not ``in``.
__device__ __forceinline__ void load_pair(const float* p, bool in,
                                          float (&v)[2]) {
  const float2 q = in ? __ldg(reinterpret_cast<const float2*>(p))
                      : make_float2(0.f, 0.f);
  v[0] = q.x;
  v[1] = q.y;
}
__device__ __forceinline__ void load_pair(const bf16* p, bool in,
                                          float (&v)[2]) {
  const __nv_bfloat162 q =
      in ? __ldg(reinterpret_cast<const __nv_bfloat162*>(p))
         : __floats2bfloat162_rn(0.f, 0.f);
  v[0] = __low2float(q);
  v[1] = __high2float(q);
}

// v (rounded to nearest in T) at p and p + 1.
__device__ __forceinline__ void store_pair(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_pair(bf16* p, const float (&v)[2]) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
}

// 1. R = x b for every 128 x 128 tile; epi(half, m0, nh, rr, t, M, N) takes
// each 64-column half of a tile, register i of the half at row m0 + rr +
// 8 ((i / 2) % 2), column nh + 8 (i / 4) + 2 t + i % 2. tm_x: x's limbs (M x
// L kp, limb l at column l kp) in boxes of 64 x 128 rows; tm_b: b's limbs
// (N x L kp) in boxes of 64 x 128 rows; K the depth.
template <int L, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    wide_resid(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_b, int M, int N, int K,
               int kp, const __grid_constant__ Epi epi) {
  using C = ResidCfg<L>;
  constexpr int S = C::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kSlot);
  uint64_t* empty = full + S;
  const int tiles_n = (N + BN - 1) / BN;
  const long long tiles = (long long)((M + BM - 1) / BM) * tiles_n;
  const int n_st = (K + 63) / 64;
  init_ring(full, empty, S);

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full, across tiles.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int q = 0;
      for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
        const int n0 = (int)(tl % tiles_n) * BN, m0 = (int)(tl / tiles_n) * BM;
        for (int s = 0; s < n_st; ++s, ++q) {
          uint64_t* bar = claim(full, empty, q, S, C::kSlot);
          unsigned char* dst = ring + (q % S) * C::kSlot;
#pragma unroll
          for (int l = 0; l < L; ++l) {
            tma_load(dst + l * kXBox, tm_x, l * kp + 64 * s, m0, bar);
            tma_load(dst + C::kA + l * kBBox, tm_b, l * kp + 64 * s, n0, bar);
          }
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + lane / 4;   // this thread's first row
  int q = 0;
  for (long long tl = blockIdx.x; tl < tiles; tl += gridDim.x) {
    const int n0 = (int)(tl % tiles_n) * BN, m0 = (int)(tl / tiles_n) * BM;
    float acc[2][32];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;
    for (int s = 0; s < n_st; ++s, ++q) {
      const int slot = q % S;
      const unsigned char* base = ring + slot * C::kSlot;
      mbar_wait(full + slot, (q / S) & 1);
      // Each 64-column half hh of the tile in turn: the stage's 64-deep
      // chains, the big one x0 b0, at L = 3 the small one x0 b1 + x0 b2 +
      // x1 b0 + x1 b1 + x2 b0, each in its own registers.
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float bc[32], sc[32];
        fence_operand(bc);
        if constexpr (L == 3) fence_operand(sc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const unsigned char* xa = base + cw * (64 * 128) + kk * 32;
          const unsigned char* ba = base + C::kA + hh * (64 * 128) + kk * 32;
          const uint64_t x0 = smem_desc(xa, 16, 1024);
          const uint64_t b0 = smem_desc(ba, 16, 1024);
          wgmma_ss(bc, x0, b0, kk);
          if constexpr (L == 3) {
            const uint64_t x1 = smem_desc(xa + kXBox, 16, 1024);
            const uint64_t x2 = smem_desc(xa + 2 * kXBox, 16, 1024);
            const uint64_t b1 = smem_desc(ba + kBBox, 16, 1024);
            const uint64_t b2 = smem_desc(ba + 2 * kBBox, 16, 1024);
            wgmma_ss(sc, x0, b1, kk);
            wgmma_ss(sc, x0, b2, 1);
            wgmma_ss(sc, x1, b0, 1);
            wgmma_ss(sc, x1, b1, 1);
            wgmma_ss(sc, x2, b0, 1);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_operand(bc);
        if constexpr (L == 3) fence_operand(sc);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          if constexpr (L == 3)
            acc[hh][i] = __fadd_rn(acc[hh][i], __fadd_rn(bc[i], sc[i]));
          else
            acc[hh][i] = __fadd_rn(acc[hh][i], bc[i]);
        }
      }
      release(empty, slot, lane);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) epi(acc[hh], m0, n0 + 64 * hh, rr, t, M, N);
  }
}

// 2. out = E b^T for every (128-row stripe) x (128-column chunk) item;
// epi(acc, m0, f0, rr, t, M, F) takes an item's accumulators, register i
// of chunk c at row m0 + rr + 8 ((i / 2) % 2), column f0 + 64 c + 8 (i /
// 4) + 2 t + i % 2. tm_e: E (M x N) in boxes of SC x 128 rows; tm_b: b's
// limbs (N x L kp) in boxes of 64 x SC rows; F the output's columns.
template <int L, class Epi>
__global__ void __launch_bounds__(kThreads, 1)
    wide_rows(const __grid_constant__ CUtensorMap tm_e,
              const __grid_constant__ CUtensorMap tm_b, int M, int N, int F,
              int kp, const __grid_constant__ Epi epi) {
  using C = RowsCfg<L>;
  constexpr int S = C::kStages, SC = C::SC, kBox = C::kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kSlot);
  uint64_t* empty = full + S;
  const int chunks = kp / 128, n_st = (N + SC - 1) / SC;
  const long long items = (long long)((M + BM - 1) / BM) * chunks;
  init_ring(full, empty, S);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int q = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const int f0 = (int)(it % chunks) * 128, m0 = (int)(it / chunks) * BM;
        for (int s = 0; s < n_st; ++s, ++q) {
          uint64_t* bar = claim(full, empty, q, S, C::kSlot);
          unsigned char* dst = ring + (q % S) * C::kSlot;
          tma_load(dst, tm_e, s * SC, m0, bar);
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int l = 0; l < L; ++l)
              tma_load(dst + C::kE + (L * c + l) * kBox, tm_b,
                       l * kp + f0 + 64 * c, s * SC, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + lane / 4;
  int q = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int f0 = (int)(it % chunks) * 128, m0 = (int)(it / chunks) * BM;
    float acc[2][32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    for (int s = 0; s < n_st; ++s, ++q) {
      const int slot = q % S;
      const unsigned char* base = ring + slot * C::kSlot;
      mbar_wait(full + slot, (q / S) & 1);
      // E's A fragments: 8-column block j of rows rr and rr + 8; depth
      // step ks takes blocks 2 ks and 2 ks + 1. TMA zero-filled E past M
      // and N, and b's limbs past N.
      uint32_t ea[SC / 16][L][4];
#pragma unroll
      for (int j = 0; j < SC / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = rr + 8 * h, col = 8 * j + 2 * t;
          put_pair<L>(ea[j / 2], 2 * (j % 2) + h,
                      e_at<L, BM>(base, row, col),
                      e_at<L, BM>(base, row, col + 1));
        }
      product_rs<L, SC / 16, kBox>(acc, ea, base + C::kE);
      release(empty, slot, lane);
    }
    epi(acc, m0, f0, rr, t, M, F);
  }
}

// 3. the row chunk blockIdx.y's partial of G = x^T E for the N tile
// blockIdx.x and G's rows 128 blockIdx.z ... + 127, as (K, N). tm_e: E in
// boxes of MC x 32 rows; tm_x: x's limbs in boxes of 64 x 32 rows.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
    wide_dict(const __grid_constant__ CUtensorMap tm_e,
              const __grid_constant__ CUtensorMap tm_x, int M, int N, int K,
              int kp, int chunk_rows, float* __restrict__ part) {
  using C = DictCfg<L>;
  constexpr int S = C::kStages, kBox = C::kBox, MC = C::MC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kSlot);
  uint64_t* empty = full + S;
  const int n0 = blockIdx.x * 128, k0 = blockIdx.z * 128;
  const int r_begin = blockIdx.y * chunk_rows;
  const int r_end = min(r_begin + chunk_rows, M);
  const int n_st = (r_end - r_begin + DR - 1) / DR;
  init_ring(full, empty, S);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int s = 0; s < n_st; ++s) {
        uint64_t* bar = claim(full, empty, s, S, C::kSlot);
        unsigned char* dst = ring + (s % S) * C::kSlot;
        const int r0 = r_begin + s * DR;
#pragma unroll
        for (int b = 0; b < 128 / MC; ++b)
          tma_load(dst + b * (DR * 128), tm_e, n0 + MC * b, r0, bar);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int l = 0; l < L; ++l)
            tma_load(dst + C::kE + (L * c + l) * kBox, tm_x,
                     l * kp + k0 + 64 * c, r0, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + lane / 4;   // this thread's first column
  const int n_lim = N - n0;
  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  for (int s = 0; s < n_st; ++s) {
    const int slot = s % S;
    const unsigned char* base = ring + slot * C::kSlot;
    mbar_wait(full + slot, (s / S) & 1);
    // E^T's A fragments: column n = rr (+ 8) of the tile, stage rows 8 j
    // + 2 t (+ 1); 0 past N and past the chunk's rows.
    const int s_lim = r_end - r_begin - s * DR;
    uint32_t ea[2][L][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rr + 8 * h, col = 8 * j + 2 * t;
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u)
          v[u] = row < n_lim && col + u < s_lim
                     ? e_at<L, DR>(base, col + u, row) : 0.f;
        put_pair<L>(ea[j / 2], 2 * (j % 2) + h, v[0], v[1]);
      }
    product_rs<L, 2, kBox>(acc, ea, base + C::kE);
    release(empty, slot, lane);
  }
  // acc^T's rows are the tile's columns n: register i of chunk c at n =
  // n0 + rr + 8 ((i / 2) % 2), row k0 + 64 c + 8 (i / 4) + 2 t + i % 2.
  float* out = part + (long long)blockIdx.y * K * N;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = n0 + rr + 8 * ((i / 2) % 2);
      const int k = k0 + 64 * c + 8 * (i / 4) + 2 * t + i % 2;
      if (n < N && k < K) out[(long long)k * N + n] = acc[c][i];
    }
}

// The masked residual's epilogue, of each 64-column half of an R tile: E
// = cdt(f32(mask) R - f32(my)) (MY: the gradients' residual) or cdt(f32(mask)
// R) (masked MU's reconstruction), in the data's dtype T. mask: the bits
// (ld_mask words a row; bit j of word w in row r is mask[r, 32 w + j]) or
// (W) the weights (row stride ld_mask). All of a half's loads come first
// (my and the weights in pairs, or the two mask words of each of the
// thread's rows that hold the half's 64 columns), so that their latencies
// overlap; then E, stored in pairs. Rows hold at least one more column
// than N rounded down to even (their strides are multiples of 4 or 8), so
// a pair at col < N is read in bounds.
template <int L, bool W, bool MY>
struct MaskedResid {
  using T = Elt<L>;
  const T* my;
  int ld_my;
  const void* mask;
  int ld_mask;
  T* e;
  int ld_e;

  __device__ __forceinline__ void operator()(const float (&acc)[32], int m0,
                                             int nh, int rr, int t, int M,
                                             int N) const {
    float mv[16][2], wv[16][2];
    uint32_t words[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long gr = (long long)m0 + rr + 8 * h;
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        if constexpr (!W) {
          const int word = nh / 32 + w;
          words[h][w] = gr < M && word < ld_mask
                            ? __ldg(static_cast<const uint32_t*>(mask) +
                                    gr * ld_mask + word)
                            : 0u;
        }
      }
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const long long gr = (long long)m0 + rr + 8 * (p % 2);
      const int col = nh + 8 * (p / 2) + 2 * t;
      const bool in = gr < M && col < N;
      if constexpr (MY) load_pair(my + gr * ld_my + col, in, mv[p]);
      if constexpr (W)
        load_pair(static_cast<const T*>(mask) + gr * ld_mask + col, in,
                  wv[p]);
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const long long gr = (long long)m0 + rr + 8 * (p % 2);
      const int col = nh + 8 * (p / 2) + 2 * t;
      if (gr >= M || col >= N) continue;
      float ev[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = 4 * (p / 2) + 2 * (p % 2) + u;
        float wt;
        // Column col + u of the half is bit 8 ((p / 2) % 4) + 2 t + u
        // of its word (p / 2) / 4: indices known at compile time, so
        // the words stay in registers.
        if constexpr (W)
          wt = wv[p][u];
        else
          wt = (float)((words[p % 2][p / 8] >>
                        (8 * ((p / 2) % 4) + 2 * t + u)) & 1u);
        if constexpr (MY)
          ev[u] = __fsub_rn(__fmul_rn(wt, acc[i]), mv[p][u]);
        else
          ev[u] = __fmul_rn(wt, acc[i]);
      }
      T* out = e + gr * ld_e + col;
      if (col + 1 < N) {
        store_pair(out, ev);
      } else {
        out[0] = from_f32<T>(ev[0]);
      }
    }
  }
};

// wide_rows' plain epilogue: the item's output in T, row stride ld.
template <typename T>
struct RowsStore {
  T* out;
  int ld;

  __device__ __forceinline__ void operator()(const float (&acc)[2][32],
                                             int m0, int f0, int rr, int t,
                                             int M, int F) const {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long gr = (long long)m0 + rr + 8 * ((i / 2) % 2);
        const int col = f0 + 64 * c + 8 * (i / 4) + 2 * t + i % 2;
        if (gr < M && col < F) out[gr * ld + col] = from_f32<T>(acc[c][i]);
      }
  }
};

// ---- host side ----

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// A bf16 limb array (rows x cols, row stride ld) in 128-byte swizzled boxes
// of 64 x box_rows: x's limbs, b's, or bf16 data read as its one limb.
bool limb_map(CUtensorMap* map, const void* p, long long cols,
              long long rows, long long ld, int box_rows) {
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p, cols, rows, ld,
                  64, box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// E (rows x cols in the data's dtype, row stride ld) in boxes of 128 bytes
// x box_rows.
template <int L>
bool e_map(CUtensorMap* map, const void* p, long long cols, long long rows,
           long long ld, int box_rows) {
  return make_map(map,
                  L == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  (int)sizeof(Elt<L>), p, cols, rows, ld,
                  128 / (int)sizeof(Elt<L>), box_rows,
                  CU_TENSOR_MAP_SWIZZLE_128B);
}

// wide_resid over M x N (depth K, limbs kp wide), one block per SM at most.
// tx: x's limbs in boxes of 64 x BM rows; tb: b's limbs in boxes of 64 x
// BN rows.
template <int L, class Epi>
int launch_resid(const CUtensorMap& tx, const CUtensorMap& tb, int M, int N,
                 int K, int kp, const Epi& epi, cudaStream_t stream) {
  using C = ResidCfg<L>;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      wide_resid<L, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  wide_resid<L, Epi><<<(unsigned)(tiles < sms ? tiles : sms), kThreads,
                       C::kSmem, stream>>>(tx, tb, M, N, K, kp, epi);
  return (int)cudaGetLastError();
}

// wide_rows: out (M x F) = E (M x N) b^T. te: E in boxes of 128 bytes x BM
// rows; tb: b's limbs in boxes of 64 x SC rows.
template <int L, class Epi>
int launch_rows(const CUtensorMap& te, const CUtensorMap& tb, int M, int N,
                int F, int kp, const Epi& epi, cudaStream_t stream) {
  using C = RowsCfg<L>;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      wide_rows<L, Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((M + BM - 1) / BM) * (kp / 128);
  wide_rows<L, Epi><<<(unsigned)(items < sms ? items : sms), kThreads,
                      C::kSmem, stream>>>(te, tb, M, N, F, kp, epi);
  return (int)cudaGetLastError();
}

// wide_dict's partials of G = x^T E (K x N) over row chunks of chunk_rows,
// then their sum in chunk order into out. te: E in boxes of 128 bytes x DR
// rows; tx: x's limbs in boxes of 64 x DR rows; part: chunks x K N f32.
template <int L>
int launch_dict(const CUtensorMap& te, const CUtensorMap& tx, int M, int N,
                int K, int kp, int chunk_rows, float* part, float* out,
                cudaStream_t stream) {
  using C = DictCfg<L>;
  cudaError_t err = cudaFuncSetAttribute(
      wide_dict<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (M + chunk_rows - 1) / chunk_rows;
  wide_dict<L><<<dim3((N + 127) / 128, chunks, kp / 128), kThreads, C::kSmem,
                 stream>>>(te, tx, M, N, K, kp, chunk_rows, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(part, (long long)K * N, chunks, out, stream);
}

}  // namespace
