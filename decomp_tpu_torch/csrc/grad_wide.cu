// The masked lasso and dictionary gradients above 128 features on Hopper
// (sm_90a), on wgmma: f32 data with every f32 product as bf16x6 limb
// products (L = 3 limbs an operand), and bf16 data with each product one
// bf16 pass (L = 1); a 0/1 mask as packed bits, or a weighted mask as
// weights in the data's dtype. Every F (rows) and K (dictionary) that the
// TPU kernels' gate takes (ops/cuda_lasso.py grad_fits: up to 1,152 f32 or
// 2,432 bf16 features at N = 1,024, 10,112 or 20,352 at N <= 128).
//
// Replaces, above 128 features, the Pallas TPU kernels
// decomp_tpu/ops/pallas_lasso.py:159 masked_grad_rows (pallas_call :176)
// and :225 masked_grad_dict (pallas_call :243). Given my = mask * y (M, N),
// the mask as bits (M, W) int32 (bit j of word w in row r is mask[r, 32 w
// + j]) or as weights (M, N) in my's dtype, x (M, K) and b (K, N) (a, or
// d) as its L bf16 limbs, they return
//   rows:       g = cdt(f32(mask) (x b) - f32(my)) b^T           (M, K)
//   dictionary: G = x^T cdt(f32(mask) (x b) - f32(my))          (K, N) f32
// at the TPU kernels' quantisation points, cdt the data's dtype: at f32
// both products at the TPU's Precision.HIGHEST (bf16x6 there, and here)
// and the residual E = f32(mask) R - my formed in f32 with round-to-nearest
// operations and not rounded further; at bf16 both products on bf16
// operands summed in f32 and E rounded to bf16 (round to nearest).
//
// Products. At L = 3 each f32 operand v is split into round-to-nearest bf16
// limbs v0 = bf16(v), v1 = bf16(v - v0), v2 = bf16(v - v0 - v1), and a
// product u v is the sum of the six limb products whose order is at most
// 2^-16 of u0 v0: u0 v0 (the "big" chain) and u2 v0, u1 v1, u0 v2, u1 v0,
// u0 v1 (the "small" one). The tensor cores' f32 sums do not round to
// nearest and a long chain drifts (nmf_common.cuh:206-212), so each 64-deep
// big chain, and the small chain beside it, is summed in its own registers
// and added with round-to-nearest f32 adds (lasso_grad_packed.cu's
// discipline): over K = 10,112 the chain of R is 158 such adds. No TF32.
//
// Why not the fused kernels widened: lasso_grad_packed.cu keeps a stripe's
// x resident as its limbs (96 KB at F = 128, f32) and g in registers (64 a
// thread); grad_dict_packed.cu keeps a tile's d limbs (96 KB) and G^T (128
// x KT). Both double at 256 features, past shared memory and the register
// file. So R = x b, which the two gradients share, is its own product here,
// and E goes to device memory once:
//   0. (f32 only) split_rows of sm90_common.cuh (grad_dict_packed.cu's
//      too): x's limbs xl (M x 3 Kp bf16, row m = [limb 0 of x[m] | limb 1
//      | limb 2], each Kp wide, zero past K; Kp = K rounded up to 128), one
//      thread per 8 features; bf16 x is its own limb and is read as it is;
//   1. wide_resid: E = cdt(f32(mask) (x b) - f32(my)) (M x N in cdt). A
//      persistent block per SM walks 128 x 128 tiles of E (the N tiles of
//      a stripe one after another, so that x's limbs come from L2); a
//      producer thread keeps a ring of 64-deep stages full by TMA: x's L
//      limb boxes (128 rows x 64) and b's (128 rows x 64, from b's limbs
//      (N x L Kp)), both K-major with the 128-byte swizzle. The stages
//      come from L2: a 64-deep f32 stage of a 128 x 64 tile is 72 KB for
//      1,536 clocks of products an SM (some 11 TB/s over 132 SMs at 1.83
//      GHz), and a 128 x 128 tile takes 1.5 times fewer bytes a product
//      (on an H100 the f32 weighted residual went from 0.77 to 0.69 ms at
//      100,000 x 1,024, K = 256: tools/grad_wide_turns.py). Two consumer
//      warpgroups own 64 rows each, and each takes the tile's two
//      64-column halves in turn: per stage and half the big chain x0 b0
//      and the small chain x0 b1 + x0 b2 + x1 b0 + x1 b1 + x2 b0
//      (m64n64k16, both operands from shared memory) in their own
//      registers, added to R with round-to-nearest adds; the epilogue reads
//      my and the mask words or weights at R's positions and writes E;
//   2. rows, wide_rows: g = E b^T. A persistent block walks (128-row
//      stripe) x (128-feature chunk) items, the chunks of a stripe one
//      after another; its ring stages carry E's box (128 rows x 128 bytes:
//      32 f32 or 64 bf16 columns) and b's limbs for those columns and the
//      chunk's 128 features (read MN-major). E is split into limbs in
//      registers (R's accumulator layout is wgmma's register-A fragment), as
//      lasso_grad_packed.cu splits its E, and g's chunk sums per stage in
//      its own registers. Each block owns its piece of g: no cross-block
//      sum;
//   3. dictionary, wide_dict: G = x^T E. A grid of (128-column N tile) x
//      (row chunk) x (128-atom K chunk); 32-row stages of E (read at
//      transposed positions, as wgmma_chain.cuh's GradDict reads my) and
//      x's limbs for the chunk's atoms; each block writes its partial G as
//      (K, N), and nmf_common.cuh's fixed-order reduction sums the chunks.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, and E is 0 outside the matrix and the row chunk.
//
// What bounds it on an H100, at 100,000 x 1,024, F = K = 256 (the TPU
// kernel's own work: my, the mask, x, b read once, g or G written once, no
// E):
//   - f32: 12 bf16 passes of 2 MNF operations (two f32 products, six limb
//     products each), 6.29e11 operations, 0.636 ms at 989 TFLOP/s, against
//     ~0.63 GB (my 409.6 MB, x and g 102.4 MB each, the bits 12.8 MB: 0.19
//     ms at 3.35 TB/s): bound by operations;
//   - bf16: 2 passes, 1.05e11 operations, 0.106 ms, against 320 MB (0.096
//     ms): bound by operations, nearly by bytes.
// E's round trip is this route's own cost, beside that bound: 0.82 GB at
// f32 (0.245 ms of bytes, which can hide under the products) and 0.41 GB
// at bf16 (0.122 ms, about doubling the floor); x's limbs (f32) add 154 MB
// written and read again.
//
// The wrappers (ops/cuda_lasso.py, ops/cuda_dl.py) give b's limbs as one
// (N, L Kp) bf16 array (cuda_mu.column_limbs(b, Kp, L): a's once per solve,
// d's once per call), my, the weights and E with 16-byte-aligned rows (a
// multiple of 4 f32 or 8 bf16), bf16 x likewise, the scratch (xl, E, the
// partials), and the row chunks from the shape alone
// (cuda_dl.grad_wide_dict_rows).

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int BM = 128;                // rows per tile, 64 per consumer
constexpr int BN = 128;                // E's columns per tile (wide_resid)
constexpr int kXBox = BM * 128;        // 128 rows x 64 bf16 of x's limbs
constexpr int kBBox = BN * 128;        // 128 rows x 64 bf16 of b's limbs
constexpr int DR = 32;                 // rows per stage of wide_dict

template <int L>
using Elt = std::conditional_t<L == 3, float, bf16>;

// Shared memory of each kernel, from a 1024-aligned base: kStages slots
// (each a multiple of 1024 bytes), then 2 kStages mbarriers.
//   wide_resid: [x's L boxes | b's L boxes]: 96 KB at L = 3, 32 KB at 1;
//   wide_rows:  [E's box (128 rows x 128 bytes) | b's limbs, box (c, l) of
//               feature chunk c and limb l at (L c + l) kBox]: SC = 32 f32
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

// 1. E = cdt(f32(mask) (x b) - f32(my)). tm_x: x's limbs (L = 3: xl, limb
// l at column l kp) or x (L = 1) in boxes of 64 x 128 rows; tm_b: b's limbs
// (N x L kp) in boxes of 64 x 64 rows. mask: the bits (ld_mask words a row)
// or (W) the weights (row stride ld_mask).
template <int L, bool W>
__global__ void __launch_bounds__(kThreads, 1)
    wide_resid(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_b,
               const Elt<L>* __restrict__ my, int ld_my,
               const void* __restrict__ mask, int ld_mask,
               Elt<L>* __restrict__ e, int ld_e, int M, int N, int K,
               int kp) {
  using C = ResidCfg<L>;
  using T = Elt<L>;
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
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + gq;   // this thread's first row
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
    // E at R's positions, half hh: register i at row rr + 8 ((i / 2) %
    // 2), column n0 + 64 hh + 8 (i / 4) + 2 t + i % 2. All of a half's
    // loads come first (my and the weights in pairs, or the two mask words
    // of each of the thread's rows that hold the half's 64 columns), so
    // that their latencies overlap; then E, stored in pairs. Rows hold at
    // least one more column than N rounded down to even (their strides
    // are multiples of 4 or 8), so a pair at col < N is read in bounds.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nh = n0 + 64 * hh;
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
        load_pair(my + gr * ld_my + col, in, mv[p]);
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
          ev[u] = __fsub_rn(__fmul_rn(wt, acc[hh][i]), mv[p][u]);
        }
        T* out = e + gr * ld_e + col;
        if (col + 1 < N) {
          store_pair(out, ev);
        } else {
          out[0] = from_f32<T>(ev[0]);
        }
      }
    }
  }
}

// 2. rows: g = E b^T. tm_e: E in boxes of SC x 128 rows; tm_b: b's limbs
// (N x L kp) in boxes of 64 x SC rows.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
    wide_rows(const __grid_constant__ CUtensorMap tm_e,
              const __grid_constant__ CUtensorMap tm_b, int M, int N, int F,
              int kp, Elt<L>* __restrict__ g) {
  using C = RowsCfg<L>;
  using T = Elt<L>;
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
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + gq;
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
    // g: register i of chunk c at row rr + 8 ((i / 2) % 2), feature f0 +
    // 64 c + 8 (i / 4) + 2 t + i % 2.
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const long long gr = (long long)m0 + rr + 8 * ((i / 2) % 2);
        const int col = f0 + 64 * c + 8 * (i / 4) + 2 * t + i % 2;
        if (gr < M && col < F) g[gr * F + col] = from_f32<T>(acc[c][i]);
      }
  }
}

// 3. dictionary: the row chunk blockIdx.y's partial of G = x^T E for the N
// tile blockIdx.x and the atoms 128 blockIdx.z ... + 127, as (K, N). tm_e:
// E in boxes of MC x 32 rows; tm_x: x's limbs (or x) in boxes of 64 x 32
// rows.
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
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t = lane % 4;
  const int rr = 64 * cw + 16 * warp + gq;   // this thread's first column
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
  // n0 + rr + 8 ((i / 2) % 2), atom k0 + 64 c + 8 (i / 4) + 2 t + i % 2.
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

// mask: the bits (ld_mask words a row) or, W, the weights (row stride
// ld_mask). K is F for the rows gradient.
struct Args {
  const void *my, *mask, *x, *bl;
  int ld_my, ld_mask, ld_x, M, N, K, kp;
  void *xl, *e;
  int ld_e;
  void* out;           // g (rows) or G (dictionary)
  int chunk_rows;      // dictionary
  void* part;          // dictionary: chunks x K N f32
  cudaStream_t stream;
};

int sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

// The x operand's map: L = 3 x's limbs (M x 3 kp), L = 1 x itself (M x K,
// row stride ld_x), in boxes of 64 x rows.
template <int L>
bool x_map(CUtensorMap* map, const Args& a, int rows) {
  return L == 3 ? make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.xl,
                           3LL * a.kp, a.M, 3LL * a.kp, 64, rows,
                           CU_TENSOR_MAP_SWIZZLE_128B)
                : make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.x, a.K,
                           a.M, a.ld_x, 64, rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// E's map, in boxes of 128 bytes x rows.
template <int L>
bool e_map(CUtensorMap* map, const Args& a, int rows) {
  return make_map(map,
                  L == 3 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  (int)sizeof(Elt<L>), a.e, a.N, a.M, a.ld_e,
                  128 / (int)sizeof(Elt<L>), rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int L, bool W>
int resid(const Args& a) {
  using C = ResidCfg<L>;
  CUtensorMap tx, tb;
  if (!x_map<L>(&tx, a, BM) ||
      !make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.bl,
                (long long)L * a.kp, a.N, (long long)L * a.kp, 64, BN,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      wide_resid<L, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles =
      (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  wide_resid<L, W><<<(unsigned)(tiles < sms ? tiles : sms), kThreads,
                     C::kSmem, a.stream>>>(
      tx, tb, static_cast<const Elt<L>*>(a.my), a.ld_my, a.mask, a.ld_mask,
      static_cast<Elt<L>*>(a.e), a.ld_e, a.M, a.N, a.K, a.kp);
  return (int)cudaGetLastError();
}

template <int L>
int rows(const Args& a) {
  using C = RowsCfg<L>;
  CUtensorMap te, tb;
  if (!e_map<L>(&te, a, BM) ||
      !make_map(&tb, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.bl,
                (long long)L * a.kp, a.N, (long long)L * a.kp, 64, C::SC,
                CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      wide_rows<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((a.M + BM - 1) / BM) * (a.kp / 128);
  wide_rows<L><<<(unsigned)(items < sms ? items : sms), kThreads, C::kSmem,
                 a.stream>>>(te, tb, a.M, a.N, a.K, a.kp,
                             static_cast<Elt<L>*>(a.out));
  return (int)cudaGetLastError();
}

template <int L>
int dict(const Args& a) {
  using C = DictCfg<L>;
  CUtensorMap te, tx;
  if (!e_map<L>(&te, a, DR) || !x_map<L>(&tx, a, DR))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wide_dict<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  wide_dict<L><<<dim3((a.N + 127) / 128, chunks, a.kp / 128), kThreads,
                 C::kSmem, a.stream>>>(te, tx, a.M, a.N, a.K, a.kp,
                                       a.chunk_rows,
                                       static_cast<float*>(a.part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part), (long long)a.K * a.N,
                       chunks, static_cast<float*>(a.out), a.stream);
}

// The checks both entries share: shapes, strides (16-byte aligned rows of
// my, the weights, E and bf16 x; f32 x contiguous), the mask's own.
bool args_ok(int limbs, bool w, const Args& a) {
  const int per = limbs == 3 ? 4 : 8;   // elements in 16 bytes
  const bool mask_ok = w ? a.ld_mask >= a.N && a.ld_mask % per == 0
                         : a.ld_mask % 4 == 0 && a.ld_mask * 32LL >= a.N;
  return a.M >= 1 && a.N >= 1 && a.K >= 1 && a.K <= a.kp &&
         a.kp % 128 == 0 && (limbs == 1 || limbs == 3) && a.ld_my >= a.N &&
         a.ld_my % per == 0 && a.ld_e >= a.N && a.ld_e % per == 0 &&
         mask_ok &&
         (limbs == 3 ? a.ld_x == a.K : a.ld_x >= a.K && a.ld_x % 8 == 0);
}

// x's limbs (f32), then E.
template <int L>
int split_resid(bool w, const Args& a) {
  if constexpr (L == 3) {
    const int rc = launch_split_rows(static_cast<const float*>(a.x), a.M,
                                     a.K, a.kp, static_cast<bf16*>(a.xl),
                                     a.stream);
    if (rc != 0) return rc;
  }
  return w ? resid<L, true>(a) : resid<L, false>(a);
}

}  // namespace

// The C interface, loaded with ctypes. limbs 3 (f32 data: my, x, g and the
// weights f32) or 1 (bf16 data: all bf16); weighted 0 (mask: the packed
// bits, M x ld_mask int32, ld_mask % 4 == 0) or 1 (mask: the weights, M x
// N, row stride ld_mask); my (M x N, row stride ld_my), E (M x N scratch in
// the data's dtype, row stride ld_e), each with 16-byte-aligned rows; x (M
// x F: f32 contiguous, ld_x == F; bf16 row stride ld_x, a multiple of 8);
// al a's limbs (N x limbs fp bf16: row n = [limb 0 | limb 1 | limb 2] of
// a[:, n], or a[:, n] at one limb, each fp wide, zero past F); fp F rounded
// up to 128; xl (M x 3 fp bf16 scratch at f32, unused at bf16); g (M x F).
// Runs split_rows (f32), wide_resid, wide_rows. Returns 0 or the first
// non-zero cudaError_t.
extern "C" int grad_wide_rows_launch(int limbs, int weighted, const void* my,
                                     int ld_my, const void* mask, int ld_mask,
                                     const void* x, int ld_x, const void* al,
                                     int M, int N, int F, int fp, void* xl,
                                     void* e, int ld_e, void* g,
                                     void* stream) {
  const Args a{my, mask, x, al, ld_my, ld_mask, ld_x, M, N, F, fp, xl, e,
               ld_e, g, 0, nullptr, static_cast<cudaStream_t>(stream)};
  if (!args_ok(limbs, weighted != 0, a)) return (int)cudaErrorInvalidValue;
  const int rc = limbs == 3 ? split_resid<3>(weighted != 0, a)
                            : split_resid<1>(weighted != 0, a);
  if (rc != 0) return rc;
  return limbs == 3 ? rows<3>(a) : rows<1>(a);
}

// The dictionary gradient: as grad_wide_rows_launch with x (M x K), dl d's
// limbs (N x limbs kp, the layout of al), chunk_rows a multiple of 32, part
// (chunks x K N f32 scratch, chunks = ceil(M / chunk_rows)) and out (K N
// f32 = G). Runs split_rows (f32), wide_resid, wide_dict and the
// reduction.
extern "C" int grad_wide_dict_launch(int limbs, int weighted, const void* my,
                                     int ld_my, const void* mask, int ld_mask,
                                     const void* x, int ld_x, const void* dl,
                                     int M, int N, int K, int kp,
                                     int chunk_rows, void* xl, void* e,
                                     int ld_e, void* part, void* out,
                                     void* stream) {
  const Args a{my, mask, x, dl, ld_my, ld_mask, ld_x, M, N, K, kp, xl, e,
               ld_e, out, chunk_rows, part, static_cast<cudaStream_t>(stream)};
  if (!args_ok(limbs, weighted != 0, a) || chunk_rows < 1 ||
      chunk_rows % DR != 0)
    return (int)cudaErrorInvalidValue;
  const int rc = limbs == 3 ? split_resid<3>(weighted != 0, a)
                            : split_resid<1>(weighted != 0, a);
  if (rc != 0) return rc;
  return limbs == 3 ? dict<3>(a) : dict<1>(a);
}
