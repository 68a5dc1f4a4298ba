// Dense and masked multiplicative-update NMF, MU and KL-MU, above rank 128
// on Hopper (sm_90a), on the wide route's products (wide_common.cuh): f32
// data with every f32 product as bf16x6 limb products (L = 3 limbs an
// operand), bf16 data with each product one bf16 pass (L = 1); the mask as
// packed bits (a 0/1 mask) or as weights in the data's dtype; x in the
// data's dtype or (MU) in f32. Every rank K above 128 that the TPU
// kernels' gate takes (ops/cuda_mu.py rank_fits: MU at N <= 128 up to
// 10,624 dense and 6,272 masked in f32, 12,800 and 7,040 in bf16, at N =
// 1,024 up to 1,280 and 640 in f32; KL at N <= 128 up to 4,480 dense and
// 3,456 masked in f32, at N = 1,024 up to 512 and 384).
//
// Replaces, above rank 128, the Pallas TPU kernels
// decomp_tpu/ops/pallas_mu.py:438 mu_stats_dense (pallas_call :459), :522
// mu_stats_masked (pallas_call :540), :603 kl_stats_dense (pallas_call
// :621) and :678 kl_stats_masked (pallas_call :696):
//   MU dense:  x_new = x (y d^T) / (cdt(x) G + eps), inner_iter times with
//              G = cdt(d d^T) formed outside (pallas_mu.py:453); numd =
//              x_new^T y, gram = x_new^T x_new;
//   MU masked: x_new = x (my d^T) / (cdt(f32(mask) (cdt(x) d)) d^T + eps);
//              numd = x_new^T my, dend = x_new^T cdt(f32(mask) (x_new d));
//   KL dense:  E1 = cdt(my / (cdt(x) d + eps)), x_new = x (E1 d^T) /
//              (dsum + eps) with dsum = d's row sums formed outside
//              (pallas_mu.py:618); E2 = cdt(my / (x_new d + eps)), numd =
//              x_new^T E2, xsum = the column sums of the f32 x_new;
//   KL masked: E1 as dense, x_new = x (E1 d^T) / (mask d^T + eps); E2 as
//              dense, numd = x_new^T E2, dend = x_new^T mask,
// at the TPU kernels' quantisation points (cdt the data's dtype; the
// products take cdt operands and sum in f32; x_new formed in f32, kept in
// f32 between inner iterations, stored in x's dtype; the statistics on
// cdt(x_new); every division round-to-nearest).
//
// Why not the fused kernels widened: mu_dense_packed.cu, mu_masked_f32.cu,
// kl_dense_packed.cu and kl_masked_packed.cu keep d's limbs or a 128-rank
// tile of x resident, which past 128 outgrows shared memory and the
// register file (the same reason as grad_wide.cu's). So the products run
// as wide_common.cuh's kernels and, masked MU, as two merged passes of
// this file, with the intermediates in device memory:
//   prep:      cdt(x)'s limbs (xl, M x L kp, zero past K) and, except for
//              masked MU, x in f32 (xf, M x kp), one thread per 8 ranks;
//              kp = K rounded up to 128;
//   MU dense:  num = y d^T (wide_rows, E := y, num M x kp f32); per inner
//              iteration wide_resid with b := G's limbs over K x K and the
//              MuXResid epilogue (x_new = x num / (R + eps) written to xf,
//              and on the last to x_new in x's dtype, cdt(x_new)'s limbs to
//              the other of two limb buffers); numd and gram by wide_dict
//              (E := y, then E := cdt(x_new): xf at f32, its one limb at
//              bf16) and the fixed-order reduction;
//   MU masked: E1 = cdt(f32(mask) R) (wide_resid, MaskedResid without my);
//              the x update (mask_xupd: num = my d^T and den = E1 d^T
//              against one stream of d's limbs, x_new = x num / (den +
//              eps) in its epilogue, cdt(x_new)'s limbs written over x's);
//              E2 = cdt(f32(mask) (x_new d)) (wide_resid); the statistics
//              (mask_stats: numd = x_new^T my and dend = x_new^T E2 against
//              one stream of x_new's limbs, 2 K N partials a row chunk) and
//              one fixed-order reduction;
//   KL dense:  E1 (wide_resid, the KlRatio epilogue), num = E1 d^T with the
//              x update in wide_rows' KlX epilogue (xf, x_new, its limbs),
//              E2 over E1's buffer, numd by wide_dict, xsum by fixed-order
//              row-chunk partials of xf (col_partials) and the reduction;
//   KL masked: E1, num = E1 d^T (wide_rows into num), the mask as E (the
//              weights as they are; the bits expanded to 0/1 in cdt over
//              E1's buffer by expand_bits), den = mask d^T with the x update
//              (MuXRows), dend by wide_dict (E := the mask), then E2 over
//              the same buffer and numd.
// The wrappers (ops/cuda_mu.py _dense_wide_launch, _masked_wide_launch,
// _kl_dense_wide_launch, _kl_masked_wide_launch) launch them in that order
// on one stream: MU 6 + inner_iter launches dense and 6 masked, KL 8 dense,
// 9 masked on weights and 10 on bits (the reductions included). No float
// atomics: a rerun gives the same bits; the row chunks of the statistics
// and of xsum come from the shape alone (cuda_mu.wide_dict_rows,
// wide_mstats_rows, wide_sum_rows).
//
// Why masked MU's E1 and E2 stay in device memory at f32: forming E1 inside
// the x update would need a stripe's x limbs over all of kp resident (128
// rows x 3 x 256 x 2 bytes = 196 KB at K = 256, more than the ring leaves
// of 227 KB), and forming E2 inside the statistics would compute x_new d
// again for every 128-rank chunk of their grid.
//
// What bounds it on an H100, at 100,000 x 1,024, K = 256 (the TPU kernel's
// own work: y or my and the mask read once, x read, x_new written, the
// statistics written):
//   - MU dense f32: 4MNK + 4MK^2 = 1.31e11 operations as 6 bf16 passes,
//     7.86e11, 0.795 ms at 989 TFLOP/s, against ~0.63 GB of bytes (0.19
//     ms): bound by operations; bf16 0.133 ms;
//   - MU masked f32: 12MNK = 3.15e11 as 6 passes, 1.91 ms; bf16 0.318 ms;
//   - KL dense f32: 8MNK as 6 passes, 1.272 ms; bf16 0.212 ms;
//   - KL masked f32: 12MNK, the two mask products at 3 passes, 1.590 ms;
//     bf16 0.318 ms.
// This route's own traffic beside that bound: E1 and E2 out and back (1.64
// GB at f32, 0.49 ms of bytes; half at bf16), the bits' expansion (1.23 GB
// at f32), num and xf (M x kp f32 each; not in masked MU) and x's limbs.

#include "wide_common.cuh"

namespace {

// x_new = x num / (den + eps) at (gr, col) and (gr, col + 1), col even and
// < K, each operation rounded to nearest (the TPU's (x * num) / (den +
// eps) in f32): x read from xf (M x kp f32), num (M x kp f32); x_new
// written by ``store``: to xf where wxf, to xout in x's dtype (M x K,
// contiguous) where not null, and cdt(x_new)'s limbs to xl (M x L kp).
// Past K the pair's second value is 0, so the pads of xf and xl stay zero.
template <int L>
struct MuX {
  float* xf;
  const float* num;
  void* xout;
  bf16* xl;
  int kp, xout_bf16, wxf;
  float eps;

  __device__ __forceinline__ void pair(long long gr, int col, int K,
                                       float d0, float d1) const {
    const long long o = gr * kp + col;
    const float2 xv = *reinterpret_cast<const float2*>(xf + o);
    const float2 nv = __ldg(reinterpret_cast<const float2*>(num + o));
    float v[2] = {__fdiv_rn(__fmul_rn(xv.x, nv.x), __fadd_rn(d0, eps)),
                  __fdiv_rn(__fmul_rn(xv.y, nv.y), __fadd_rn(d1, eps))};
    store(gr, col, K, v);
  }

  __device__ __forceinline__ void store(long long gr, int col, int K,
                                        float (&v)[2]) const {
    const long long o = gr * kp + col;
    const bool two = col + 1 < K;
    if (!two) v[1] = 0.f;
    if (wxf) store_pair(xf + o, v);
    if (xout != nullptr) {
      const long long ox = gr * K + col;
      if (xout_bf16) {
        bf16* p = static_cast<bf16*>(xout) + ox;
        p[0] = __float2bfloat16_rn(v[0]);
        if (two) p[1] = __float2bfloat16_rn(v[1]);
      } else {
        float* p = static_cast<float*>(xout) + ox;
        p[0] = v[0];
        if (two) p[1] = v[1];
      }
    }
    if constexpr (L == 3) {
      uint32_t f[3];
      split_pair(v[0], v[1], f);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        *reinterpret_cast<uint32_t*>(xl + gr * (3LL * kp) + (long long)l * kp +
                                     col) = f[l];
    } else {
      store_pair(xl + o, v);
    }
  }
};

// Dense MU's x update as wide_resid's epilogue (R = cdt(x) G, N := K).
template <int L>
struct MuXResid {
  MuX<L> x;

  __device__ __forceinline__ void operator()(const float (&acc)[32], int m0,
                                             int nh, int rr, int t, int M,
                                             int N) const {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const long long gr = (long long)m0 + rr + 8 * (p % 2);
      const int col = nh + 8 * (p / 2) + 2 * t;
      const int i = 4 * (p / 2) + 2 * (p % 2);
      if (gr < M && col < N) x.pair(gr, col, N, acc[i], acc[i + 1]);
    }
  }
};

// Masked MU's x update as wide_rows' epilogue (den = E1 d^T, F := K).
template <int L>
struct MuXRows {
  MuX<L> x;

  __device__ __forceinline__ void operator()(const float (&acc)[2][32],
                                             int m0, int f0, int rr, int t,
                                             int M, int F) const {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long gr = (long long)m0 + rr + 8 * (j % 2);
        const int col = f0 + 64 * c + 8 * (j / 2) + 2 * t;
        if (gr < M && col < F)
          x.pair(gr, col, F, acc[c][2 * j], acc[c][2 * j + 1]);
      }
  }
};

// KL's ratio as wide_resid's epilogue, of each 64-column half of an R
// tile: E = cdt(f32(my) / (R + eps)), each step rounded to nearest (the
// TPU's (my / (x d + eps)).astype(cdt)), in the data's dtype T. my's pairs
// are all loaded first, so that their latencies overlap; rows of my hold
// at least one more column than N rounded down to even (MaskedResid's
// rule), so a pair at col < N is read in bounds. A zero my over a positive
// R + eps is the quotient +0 without the division: __fdiv_rn sends a zero
// dividend to its slow path, and a masked my is zero wherever the mask is
// (on an H100 at 100,000 x 1,024, K = 256, 30% missing, the two ratio
// launches took 2.13 ms with every zero divided, 1.34 ms dense, where no
// my is zero: tools/kl_wide_turns.py). Any other zero (R + eps zero,
// negative or NaN) is divided, so eps = 0 gives the twin's NaNs.
template <int L>
struct KlRatio {
  using T = Elt<L>;
  const T* my;
  int ld_my;
  T* e;
  int ld_e;
  float eps;

  __device__ __forceinline__ void operator()(const float (&acc)[32], int m0,
                                             int nh, int rr, int t, int M,
                                             int N) const {
    float mv[16][2];
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      const long long gr = (long long)m0 + rr + 8 * (p % 2);
      const int col = nh + 8 * (p / 2) + 2 * t;
      load_pair(my + gr * ld_my + col, gr < M && col < N, mv[p]);
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
        const float r = __fadd_rn(acc[i], eps);
        ev[u] = 0.f;
        if (mv[p][u] != 0.f || !(r > 0.f)) ev[u] = __fdiv_rn(mv[p][u], r);
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

// Dense KL's x update as wide_rows' epilogue (num = E1 d^T, F := K): x_new
// = (x num) / (dsum + eps), dsum (K f32) the row sums of d, each operation
// rounded to nearest; written as MuX::store writes it, xf included (xsum
// sums the f32 x_new).
template <int L>
struct KlX {
  MuX<L> x;
  const float* dsum;

  __device__ __forceinline__ void operator()(const float (&acc)[2][32],
                                             int m0, int f0, int rr, int t,
                                             int M, int F) const {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long gr = (long long)m0 + rr + 8 * (j % 2);
        const int col = f0 + 64 * c + 8 * (j / 2) + 2 * t;
        if (gr >= M || col >= F) continue;
        const float2 xv =
            *reinterpret_cast<const float2*>(x.xf + gr * x.kp + col);
        const float d0 = __ldg(dsum + col);
        const float d1 = col + 1 < F ? __ldg(dsum + col + 1) : 0.f;
        float v[2] = {
            __fdiv_rn(__fmul_rn(xv.x, acc[c][2 * j]), __fadd_rn(d0, x.eps)),
            __fdiv_rn(__fmul_rn(xv.y, acc[c][2 * j + 1]),
                      __fadd_rn(d1, x.eps))};
        x.store(gr, col, F, v);
      }
  }
};

// xf = f32(x) (where not null: the masked MU route reads x itself) and xl
// = cdt(x)'s L limbs, each zero past K, one thread per 8 ranks of a row
// (x: M x K, f32 or bf16 by x_bf16); xl2, where not null,
// gets zeros in every 8-rank group that reaches past K (the pads of the
// dense x update's second limb buffer, whose epilogue writes only below
// K).
template <int L>
__global__ void __launch_bounds__(THREADS)
    prep_x(const void* __restrict__ x, int x_bf16, int M, int K, int kp,
           float* __restrict__ xf, bf16* __restrict__ xl,
           bf16* __restrict__ xl2) {
  const int G = kp / 8;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)M * G) return;
  const long long r = e / G;
  const int c0 = (int)(e % G) * 8;
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const long long o = r * K + c0 + u;
    v[u] = c0 + u >= K ? 0.f
           : x_bf16    ? __bfloat162float(static_cast<const bf16*>(x)[o])
                       : static_cast<const float*>(x)[o];
  }
  if (xf != nullptr) {
    float4* pf = reinterpret_cast<float4*>(xf + r * kp + c0);
    pf[0] = make_float4(v[0], v[1], v[2], v[3]);
    pf[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  uint32_t w[L][4];
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    if constexpr (L == 3) {
      uint32_t f[3];
      split_pair(v[2 * pp], v[2 * pp + 1], f);
#pragma unroll
      for (int l = 0; l < 3; ++l) w[l][pp] = f[l];
    } else {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * pp], v[2 * pp + 1]);
      w[0][pp] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const long long o = r * ((long long)L * kp) + (long long)l * kp + c0;
    *reinterpret_cast<uint4*>(xl + o) =
        make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
    if (xl2 != nullptr && c0 + 8 > K)
      *reinterpret_cast<uint4*>(xl2 + o) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The 0/1 mask of the bits (M x ld_mask int32 words) in the data's dtype
// T: e[r, c] for c < N (row stride ld_e, 16-byte aligned rows), one thread
// per 8 columns of a row, stored as one 16- or 32-byte vector where all 8
// lie below N.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    expand_bits(const uint32_t* __restrict__ mask, int ld_mask, int M, int N,
                T* __restrict__ e, int ld_e) {
  const int G = (N + 7) / 8;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)M * G) return;
  const long long r = i / G;
  const int c0 = (int)(i % G) * 8;
  const uint32_t byte = (__ldg(mask + r * ld_mask + c0 / 32) >> (c0 % 32)) &
                        0xffu;
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) v[u] = (float)((byte >> u) & 1u);
  T* out = e + r * ld_e + c0;
  if (c0 + 8 <= N) {
    if constexpr (sizeof(T) == 4) {
      float4* p = reinterpret_cast<float4*>(out);
      p[0] = make_float4(v[0], v[1], v[2], v[3]);
      p[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
        w[q] = *reinterpret_cast<const uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(out) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + u < N) out[u] = from_f32<T>(v[u]);
  }
}

// The row chunk blockIdx.y's column sums of xf (M x kp f32; the chunk's
// rows chunk_rows blockIdx.y ... in row order), one thread per column:
// part[blockIdx.y K + col] for col < K. Summed in chunk order by
// launch_reduce, so the column sums of x_new (dense KL's xsum) do not
// depend on scheduling.
__global__ void __launch_bounds__(128)
    col_partials(const float* __restrict__ xf, int M, int K, int kp,
                 int chunk_rows, float* __restrict__ part) {
  const int col = blockIdx.x * 128 + threadIdx.x;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min(r0 + chunk_rows, (long long)M);
  float s = 0.f;
  for (long long r = r0; r < r1; ++r) s += __ldg(xf + r * kp + col);
  if (col < K) part[(long long)blockIdx.y * K + col] = s;
}

// ---- Masked MU's two merged passes ----
//
// The x update: a persistent block walks (64-row stripe) x (128-column
// chunk) items. Its ring stages carry my's box and E1's box (64 rows x 128
// bytes: 32 f32 or 64 bf16 columns n) and d's limbs for those n and the
// item's 128 columns k (read MN-major), so one stream of d serves both
// products. Consumer warpgroup 0 sums num = my d^T, warpgroup 1 den = E1
// d^T, each over the item's two 64-column chunks (64 accumulators a
// thread). At the item's end each hands the other one chunk through shared
// memory (num's chunk 1, den's chunk 0), and each forms x_new = x num /
// (den + eps) on the chunk it kept: x read as it is, x_new written in x's
// dtype and cdt(x_new)'s limbs over x's.
//
// The statistics: a grid of (64-column N tile) x (row chunk) x (128-row K
// chunk) blocks; 64-row stages of my's and E2's columns of the tile and
// x_new's limbs for the K chunk, so one stream of x_new's limbs serves
// both; warpgroup 0 sums numd^T = my^T x_new, warpgroup 1 dend^T = E2^T
// x_new, each into the row chunk's partial (2 K N f32 a chunk: numd, then
// dend), summed in chunk order by one reduction.
//
// The tensor cores are kept fed. A group's sums are read only after
// wait_group 0 (ptxas serializes every wgmma of a kernel that reads one
// group's accumulators while another is in flight, C7514), so the
// overlap comes from the two consumers, one a product, which run the same
// stages. At L = 1 both operands are read by wgmma from shared memory as
// TMA left them (the x update's A = my or E1 K-major; the statistics' A =
// my^T or E2^T and B = x_new's limbs MN-major), both chunks of a stage one
// group of eight steps: no fragment is formed. At L = 3 the A operand is
// split into its limbs in registers (mma.sync's A fragment layout), and
// the consumers take turns at the tensor cores, ping-pong, so that while
// one waits for its group, adds its sums and forms fragments, the other's
// group runs. The x update hands the turn over after each chunk's group
// and forms the next 32-deep stage's fragments while its first chunk
// runs; the statistics, a turn a unit (32 rows, half a stage: both
// chunks), form each unit's fragments after the one before completes (a
// second set beside 64 sums and 64 chain registers spilled). The sum
// order is wide_rows' and wide_dict's: per unit (L = 1: stage) and chunk
// the big and the small chain in their own registers, added to the item's
// sums with round-to-nearest f32 adds.

constexpr int XR = 64;   // rows per x-update item
constexpr int SR = 64;   // rows per statistics stage

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the fragment registers that a group in flight reads from being
// reused before the wait that precedes this.
__device__ __forceinline__ void keep(const uint32_t (&f)[2][3][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" ::"r"(f[ks][l][i]));
}

__device__ __forceinline__ void copy_frags(uint32_t (&to)[2][3][4],
                                           const uint32_t (&from)[2][3][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int l = 0; l < 3; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) to[ks][l][i] = from[ks][l][i];
}

// Issues one 64-column chunk's bf16x6 chains over two 16-deep steps as one
// group: A from registers (ea), B the chunk's three limb boxes at b (limb l
// at l kBox, step ks at ks 2048 bytes) read MN-major; the big chain into
// tb, the small one into ts.
template <int kBox>
__device__ __forceinline__ void issue_rs(float (&tb)[32], float (&ts)[32],
                                         const uint32_t (&ea)[2][3][4],
                                         const unsigned char* b) {
  fence_operand(tb);
  fence_operand(ts);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const unsigned char* bb = b + ks * 2048;
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
}

// Issues a stage's chains of both 64-column chunks over four 16-deep steps
// as one group into t0 and t1, both operands in shared memory: A at a, B at
// b0 and b1 (descriptors advanced a step by a_step and b_step 16-byte
// units), B MN-major, A MN-major where TA.
template <int TA>
__device__ __forceinline__ void issue_ss(float (&t0)[32], float (&t1)[32],
                                         uint64_t a, uint64_t b0, uint64_t b1,
                                         int a_step, int b_step) {
  fence_operand(t0);
  fence_operand(t1);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<TA, 1>(t0, a + ks * a_step, b0 + ks * b_step, ks);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss<TA, 1>(t1, a + ks * a_step, b1 + ks * b_step, ks);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += a completed group's chain, each add rounded to nearest.
__device__ __forceinline__ void add_chain(float (&acc)[32], float (&tb)[32]) {
  fence_operand(tb);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tb[i];
}
__device__ __forceinline__ void add_chains(float (&acc)[32], float (&tb)[32],
                                           float (&ts)[32]) {
  fence_operand(tb);
  fence_operand(ts);
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += tb[i] + ts[i];
}

// The A fragments at L = 3 of a 32-column stage of a 64-row f32 box (the x
// update's my or E1): rows rr and rr + 8, columns 8 j + 2 t (+ 1), each
// pair one 8-byte load (the swizzle keeps 16-byte chunks whole); step ks
// takes blocks 2 ks and 2 ks + 1.
__device__ __forceinline__ void frag_rows(uint32_t (&ea)[2][3][4],
                                          const unsigned char* box, int rr,
                                          int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = rr + 8 * h, col = 8 * j + 2 * t;
      const float2 v = *reinterpret_cast<const float2*>(
          box + ((row * 128 + col * 4) ^ ((row & 7) << 4)));
      put_pair<3>(ea[j / 2], 2 * (j % 2) + h, v.x, v.y);
    }
}

// The A fragments at L = 3 of E^T over the 32 stage rows from r0 of two
// 32-column f32 boxes side by side (the statistics' my or E2 on the tile's
// 64 columns): A's rows are the columns rr and rr + 8, its depth the stage
// rows r0 + 8 j + 2 t (+ 1). TMA zero-filled past M and N. The swizzle
// XORs a row's 16-byte chunk index with the row's low 3 bits, 2 t + u
// here for every j, so each of the thread's four (h, u) columns has one
// byte offset and the loads differ by constants.
__device__ __forceinline__ void frag_cols(uint32_t (&ea)[2][3][4],
                                          const unsigned char* box, int r0,
                                          int rr, int t) {
  const unsigned char* p = box + (r0 + 2 * t) * 128;
  int off[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int n = rr + 8 * h;
      off[h][u] = (n / 32) * (SR * 128) + u * 128 +
                  (((n % 32) * 4) ^ (((2 * t + u) & 7) << 4));
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* q = p + j * 1024;
      put_pair<3>(ea[j / 2], 2 * (j % 2) + h,
                  *reinterpret_cast<const float*>(q + off[h][0]),
                  *reinterpret_cast<const float*>(q + off[h][1]));
    }
}

// Named barrier 1 over the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The consumers' turns at the tensor cores, ping-pong: consumer warpgroup
// cw issues groups only in its turn (named barrier 2 + cw) and hands the
// turn over once it has issued them (barrier 3 - cw), so the two
// consumers' groups alternate. Consumer 1 hands consumer 0 the first turn
// (turns_begin); consumer 0 takes the last one handed back (turns_end).
__device__ __forceinline__ void turn_take(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(2 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(3 - cw) : "memory");
}
__device__ __forceinline__ void turns_begin(int cw) {
  if (cw == 1) turn_pass(1);
}
__device__ __forceinline__ void turns_end(int cw) {
  if (cw == 0) turn_take(0);
}

// The masked x update's operands: x (M x K in x's dtype, bf16 where
// x_bf16), x_new (xout, x's dtype), x_new's limbs xl (M x L kp).
struct MaskX {
  const void* x;
  void* xout;
  bf16* xl;
  int x_bf16, kp;
  float eps;
};

// x_new = x num / (den + eps) on one 64-column chunk from c0 of a 64-row
// item at m0, each operation rounded to nearest (the TPU's (x * num) /
// (den + eps) in f32): registers 2 j and 2 j + 1 at row m0 + rr + 8 (j %
// 2), columns c0 + 8 (j / 2) + 2 t (+ 1). Past K a pair's second value is
// 0, so the pads of xl stay zero.
template <int L>
__device__ __forceinline__ void x_epi(const MaskX& xo, const float (&num)[32],
                                      const float (&den)[32], int m0, int c0,
                                      int rr, int t, int M, int K) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const long long gr = (long long)m0 + rr + 8 * (j % 2);
    const int col = c0 + 8 * (j / 2) + 2 * t;
    if (gr >= M || col >= K) continue;
    const bool two = col + 1 < K;
    const long long o = gr * K + col;
    float xv[2] = {0.f, 0.f};
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (u == 0 || two)
        xv[u] = xo.x_bf16 ? __bfloat162float(
                                static_cast<const bf16*>(xo.x)[o + u])
                          : static_cast<const float*>(xo.x)[o + u];
    float v[2] = {
        __fdiv_rn(__fmul_rn(xv[0], num[2 * j]), __fadd_rn(den[2 * j], xo.eps)),
        __fdiv_rn(__fmul_rn(xv[1], num[2 * j + 1]),
                  __fadd_rn(den[2 * j + 1], xo.eps))};
    if (!two) v[1] = 0.f;
    if (xo.x_bf16) {
      bf16* p = static_cast<bf16*>(xo.xout) + o;
      p[0] = __float2bfloat16_rn(v[0]);
      if (two) p[1] = __float2bfloat16_rn(v[1]);
    } else {
      float* p = static_cast<float*>(xo.xout) + o;
      p[0] = v[0];
      if (two) p[1] = v[1];
    }
    bf16* pl = xo.xl + gr * ((long long)L * xo.kp) + col;
    if constexpr (L == 3) {
      uint32_t f[3];
      split_pair(v[0], v[1], f);
#pragma unroll
      for (int l = 0; l < 3; ++l)
        *reinterpret_cast<uint32_t*>(pl + (long long)l * xo.kp) = f[l];
    } else {
      store_pair(pl, v);
    }
  }
}

// Shared memory of mask_xupd, from a 1024-aligned base: kStages slots of
// [my's box | E1's box | d's limbs, box (c, l) of chunk c and limb l at
// (L c + l) kBox], the exchange (two 64 x 64 f32 chunks), 2 kStages
// mbarriers: 40 KB slots, 4 stages at L = 3; 32 KB, 6 stages at L = 1.
template <int L>
struct XupdCfg {
  static constexpr int SC = 128 / (int)sizeof(Elt<L>);   // n a stage
  static constexpr int kA = XR * 128;
  static constexpr int kBox = SC * 128;
  static constexpr int kSlot = 2 * kA + 2 * L * kBox;
  static constexpr int kStages = L == 3 ? 4 : 6;
  static constexpr int kX = 2 * 64 * 64 * 4;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + kX + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

// 1. num = my d^T and den = E1 d^T for every (64-row stripe) x (128-column
// chunk) item, and x_new from them. tm_my, tm_e: my and E1 (M x N) in
// boxes of 128 bytes x 64 rows; tm_b: d's limbs (N x L kp) in boxes of 64 x
// SC rows.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
    mask_xupd(const __grid_constant__ CUtensorMap tm_my,
              const __grid_constant__ CUtensorMap tm_e,
              const __grid_constant__ CUtensorMap tm_b, int M, int N, int K,
              int kp, const __grid_constant__ MaskX xo) {
  using C = XupdCfg<L>;
  constexpr int S = C::kStages, SC = C::SC, kBox = C::kBox;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  float* xbuf = reinterpret_cast<float*>(ring + S * C::kSlot);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kSlot + C::kX);
  uint64_t* empty = full + S;
  const int chunks = kp / 128, n_st = (N + SC - 1) / SC;
  const long long items = (long long)((M + XR - 1) / XR) * chunks;
  init_ring(full, empty, S);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int q = 0;
      for (long long it = blockIdx.x; it < items; it += gridDim.x) {
        const int f0 = (int)(it % chunks) * 128, m0 = (int)(it / chunks) * XR;
        for (int s = 0; s < n_st; ++s, ++q) {
          uint64_t* bar = claim(full, empty, q, S, C::kSlot);
          unsigned char* dst = ring + (q % S) * C::kSlot;
          tma_load(dst, tm_my, s * SC, m0, bar);
          tma_load(dst + C::kA, tm_e, s * SC, m0, bar);
#pragma unroll
          for (int c = 0; c < 2; ++c)
#pragma unroll
            for (int l = 0; l < L; ++l)
              tma_load(dst + 2 * C::kA + (L * c + l) * kBox, tm_b,
                       l * kp + f0 + 64 * c, s * SC, bar);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // Warpgroup cw sums num (0: A = my) or den (1: A = E1) over the same 64
  // rows: thread tid of either holds the same (row, column) entries.
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rr = 16 * warp + lane / 4;
  int q = 0;
  if constexpr (L == 3) turns_begin(cw);
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int f0 = (int)(it % chunks) * 128, m0 = (int)(it / chunks) * XR;
    float acc[2][32];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
    if constexpr (L == 3) {
      uint32_t fa[2][3][4], fb[2][3][4];
      mbar_wait(full + q % S, (q / S) & 1);
      frag_rows(fa, ring + (q % S) * C::kSlot + cw * C::kA, rr, t);
      for (int s = 0; s < n_st; ++s, ++q) {
        const int slot = q % S;
        const unsigned char* b = ring + slot * C::kSlot + 2 * C::kA;
        float tb[32], ts[32];
        turn_take(cw);
        issue_rs<kBox>(tb, ts, fa, b);
        turn_pass(cw);
        const bool more = s + 1 < n_st;
        if (more) {
          const int nq = q + 1;
          mbar_wait(full + nq % S, (nq / S) & 1);
          frag_rows(fb, ring + (nq % S) * C::kSlot + cw * C::kA, rr, t);
        }
        wg_wait<0>();
        add_chains(acc[0], tb, ts);
        turn_take(cw);
        issue_rs<kBox>(tb, ts, fa, b + 3 * kBox);
        turn_pass(cw);
        wg_wait<0>();
        keep(fa);
        add_chains(acc[1], tb, ts);
        release(empty, slot, lane);
        if (more) copy_frags(fa, fb);
      }
    } else {
      float t0[32], t1[32];
      for (int s = 0; s < n_st; ++s, ++q) {
        const int slot = q % S;
        mbar_wait(full + slot, (q / S) & 1);
        const unsigned char* base = ring + slot * C::kSlot;
        const unsigned char* b = base + 2 * C::kA;
        issue_ss<0>(t0, t1, smem_desc(base + cw * C::kA, 16, 1024),
                    smem_desc(b, kBox, 1024), smem_desc(b + kBox, kBox, 1024),
                    2, 128);
        wg_wait<0>();
        add_chain(acc[0], t0);
        add_chain(acc[1], t1);
        release(empty, slot, lane);
      }
    }
    // Warpgroup 0 keeps num's chunk 0 and hands over chunk 1; warpgroup 1
    // keeps den's chunk 1 and hands over chunk 0.
    float* mine = xbuf + cw * 4096;
    if (cw == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) mine[i * 128 + tid] = acc[1][i];
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) mine[i * 128 + tid] = acc[0][i];
    }
    consumers_sync();
    float other[32];
    const float* theirs = xbuf + (1 - cw) * 4096;
#pragma unroll
    for (int i = 0; i < 32; ++i) other[i] = theirs[i * 128 + tid];
    consumers_sync();
    if (cw == 0)
      x_epi<L>(xo, acc[0], other, m0, f0, rr, t, M, K);
    else
      x_epi<L>(xo, other, acc[1], m0, f0 + 64, rr, t, M, K);
  }
  if constexpr (L == 3) turns_end(cw);
}

// Shared memory of mask_stats, from a 1024-aligned base: kStages slots of
// [my's 64 columns of 64 rows (two 32-column f32 boxes or one bf16 box) |
// E2's | x_new's limbs, box (c, l) at (L c + l) kBox], 2 kStages
// mbarriers: 80 KB slots, 2 stages at L = 3; 32 KB, 7 stages at L = 1.
template <int L>
struct MStatsCfg {
  static constexpr int MC = 128 / (int)sizeof(Elt<L>);   // columns a box
  static constexpr int kA = SR * 64 * (int)sizeof(Elt<L>);
  static constexpr int kBox = SR * 128;
  static constexpr int kSlot = 2 * kA + 2 * L * kBox;
  static constexpr int kStages = L == 3 ? 2 : 7;
  static constexpr size_t kSmem =
      1024 + (size_t)kStages * kSlot + 16 * kStages;
  static_assert(kSmem <= 232448, "more than a block's shared memory");
};

// 2. The row chunk blockIdx.y's partials of numd = x_new^T my and dend =
// x_new^T E2 for the N tile blockIdx.x (64 columns) and the statistics'
// rows 128 blockIdx.z ... + 127, as (2, K, N) at part + 2 K N blockIdx.y.
// tm_my, tm_e: my and E2 (M x N) in boxes of 128 bytes x 64 rows; tm_x:
// x_new's limbs (M x L kp) in boxes of 64 x 64 rows. chunk_rows is a
// multiple of SR, so no stage crosses a chunk.
template <int L>
__global__ void __launch_bounds__(kThreads, 1)
    mask_stats(const __grid_constant__ CUtensorMap tm_my,
               const __grid_constant__ CUtensorMap tm_e,
               const __grid_constant__ CUtensorMap tm_x, int M, int N, int K,
               int kp, int chunk_rows, float* __restrict__ part) {
  using C = MStatsCfg<L>;
  constexpr int S = C::kStages, kBox = C::kBox, MC = C::MC;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::kSlot);
  uint64_t* empty = full + S;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.z * 128;
  const int r_begin = blockIdx.y * chunk_rows;
  const int n_st = (min(r_begin + chunk_rows, M) - r_begin + SR - 1) / SR;
  init_ring(full, empty, S);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      for (int s = 0; s < n_st; ++s) {
        uint64_t* bar = claim(full, empty, s, S, C::kSlot);
        unsigned char* dst = ring + (s % S) * C::kSlot;
        const int r0 = r_begin + s * SR;
#pragma unroll
        for (int b = 0; b < 64 / MC; ++b) {
          tma_load(dst + b * (SR * 128), tm_my, n0 + MC * b, r0, bar);
          tma_load(dst + C::kA + b * (SR * 128), tm_e, n0 + MC * b, r0, bar);
        }
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int l = 0; l < L; ++l)
            tma_load(dst + 2 * C::kA + (L * c + l) * kBox, tm_x,
                     l * kp + k0 + 64 * c, r0, bar);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // Warpgroup cw sums numd^T (0: A = my^T) or dend^T (1: A = E2^T).
  const int cw = threadIdx.x / 128 - 1, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int rr = 16 * warp + lane / 4;   // this thread's first column n
  float acc[2][32];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  if constexpr (L == 3) {
    // Units of 32 stage rows, two a stage; the loop over them stays rolled,
    // so that the next unit's fragment loads wait for this one's groups.
    turns_begin(cw);
    for (int s = 0; s < n_st; ++s) {
      const int slot = s % S;
      mbar_wait(full + slot, (s / S) & 1);
      const unsigned char* base = ring + slot * C::kSlot;
#pragma unroll 1
      for (int h = 0; h < 2; ++h) {
        uint32_t fa[2][3][4];
        frag_cols(fa, base + cw * C::kA, 32 * h, rr, t);
        const unsigned char* b = base + 2 * C::kA + h * 4096;
        float tb[32], ts[32];
        turn_take(cw);
        issue_rs<kBox>(tb, ts, fa, b);
        wg_wait<0>();
        add_chains(acc[0], tb, ts);
        issue_rs<kBox>(tb, ts, fa, b + 3 * kBox);
        turn_pass(cw);
        wg_wait<0>();
        keep(fa);
        add_chains(acc[1], tb, ts);
      }
      release(empty, slot, lane);
    }
    turns_end(cw);
  } else {
    float t0[32], t1[32];
    for (int s = 0; s < n_st; ++s) {
      const int slot = s % S;
      mbar_wait(full + slot, (s / S) & 1);
      const unsigned char* base = ring + slot * C::kSlot;
      const unsigned char* b = base + 2 * C::kA;
      issue_ss<1>(t0, t1, smem_desc(base + cw * C::kA, C::kA, 1024),
                  smem_desc(b, kBox, 1024), smem_desc(b + kBox, kBox, 1024),
                  128, 128);
      wg_wait<0>();
      add_chain(acc[0], t0);
      add_chain(acc[1], t1);
      release(empty, slot, lane);
    }
  }
  // acc^T's rows are the tile's columns n: register i of chunk c at n = n0
  // + rr + 8 ((i / 2) % 2), row k0 + 64 c + 8 (i / 4) + 2 t + i % 2.
  const long long KN = (long long)K * N;
  float* out = part + (long long)blockIdx.y * 2 * KN + cw * KN;
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int n = n0 + rr + 8 * ((i / 2) % 2);
      const int k = k0 + 64 * c + 8 * (i / 4) + 2 * t + i % 2;
      if (n < N && k < K) out[(long long)k * N + n] = acc[c][i];
    }
}

bool dims_ok(int limbs, int M, int N, int K, int kp) {
  return (limbs == 1 || limbs == 3) && M >= 1 && N >= 1 && K >= 1 &&
         K <= kp && kp % 128 == 0;
}

// The rows of E in the data's dtype start 16-byte aligned.
bool ld_ok(int limbs, int ld, int cols) {
  return ld >= cols && ld % (limbs == 3 ? 4 : 8) == 0;
}

// x's limbs or b's (rows x L kp) in boxes of 64 x box_rows.
bool limbs_map(CUtensorMap* map, const void* p, int limbs, long long rows,
               int kp, int box_rows) {
  return limb_map(map, p, (long long)limbs * kp, rows, (long long)limbs * kp,
                  box_rows);
}

template <int L>
int prep(const void* x, int x_bf16, int M, int K, int kp, void* xf, void* xl,
         void* xl2, cudaStream_t stream) {
  const long long n = (long long)M * (kp / 8);
  prep_x<L><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      x, x_bf16, M, K, kp, static_cast<float*>(xf), static_cast<bf16*>(xl),
      static_cast<bf16*>(xl2));
  return (int)cudaGetLastError();
}

template <int L, class Epi>
int rows(const void* e, int ld_e, const void* bl, int M, int N, int F, int kp,
         const Epi& epi, cudaStream_t stream) {
  CUtensorMap te, tb;
  if (!e_map<L>(&te, e, N, M, ld_e, BM) ||
      !limbs_map(&tb, bl, L, N, kp, RowsCfg<L>::SC))
    return (int)cudaErrorInvalidValue;
  return launch_rows<L>(te, tb, M, N, F, kp, epi, stream);
}

// wide_resid over M x N at depth K with the epilogue epi: x's limbs xl,
// b's bl.
template <int L, class Epi>
int resid(const void* xl, const void* bl, int M, int N, int K, int kp,
          const Epi& epi, cudaStream_t stream) {
  CUtensorMap tx, tb;
  if (!limbs_map(&tx, xl, L, M, kp, BM) || !limbs_map(&tb, bl, L, N, kp, BN))
    return (int)cudaErrorInvalidValue;
  return launch_resid<L>(tx, tb, M, N, K, kp, epi, stream);
}

template <int L, bool W>
int masked_resid(const void* xl, const void* bl, const void* mask,
                 int ld_mask, int M, int N, int K, int kp, void* e, int ld_e,
                 cudaStream_t stream) {
  const MaskedResid<L, W, false> epi{nullptr, 0, mask, ld_mask,
                                     static_cast<Elt<L>*>(e), ld_e};
  return resid<L>(xl, bl, M, N, K, kp, epi, stream);
}

template <int L>
int kl_resid(const void* xl, const void* bl, const void* my, int ld_my,
             int M, int N, int K, int kp, float eps, void* e, int ld_e,
             cudaStream_t stream) {
  using T = Elt<L>;
  const KlRatio<L> epi{static_cast<const T*>(my), ld_my, static_cast<T*>(e),
                       ld_e, eps};
  return resid<L>(xl, bl, M, N, K, kp, epi, stream);
}

template <int L>
int dict(const void* e, int ld_e, const void* xl, int M, int N, int K, int kp,
         int chunk_rows, void* part, void* out, cudaStream_t stream) {
  CUtensorMap te, tx;
  if (!e_map<L>(&te, e, N, M, ld_e, DR) || !limbs_map(&tx, xl, L, M, kp, DR))
    return (int)cudaErrorInvalidValue;
  return launch_dict<L>(te, tx, M, N, K, kp, chunk_rows,
                        static_cast<float*>(part), static_cast<float*>(out),
                        stream);
}

// mask_xupd over M x N (d's limbs bl, kp wide), one block per SM at most.
template <int L>
int mask_xupd_run(const void* my, int ld_my, const void* e, int ld_e,
                  const void* bl, int M, int N, int K, int kp, const MaskX& xo,
                  cudaStream_t stream) {
  using C = XupdCfg<L>;
  CUtensorMap tmy, te, tb;
  if (!e_map<L>(&tmy, my, N, M, ld_my, XR) ||
      !e_map<L>(&te, e, N, M, ld_e, XR) ||
      !limbs_map(&tb, bl, L, N, kp, C::SC))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      mask_xupd<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const long long items = (long long)((M + XR - 1) / XR) * (kp / 128);
  mask_xupd<L><<<(unsigned)(items < sms ? items : sms), kThreads, C::kSmem,
                 stream>>>(tmy, te, tb, M, N, K, kp, xo);
  return (int)cudaGetLastError();
}

// mask_stats' partials over row chunks of chunk_rows: part (chunks x 2 K N
// f32).
template <int L>
int mask_stats_run(const void* my, int ld_my, const void* e, int ld_e,
                   const void* xl, int M, int N, int K, int kp, int chunk_rows,
                   void* part, cudaStream_t stream) {
  using C = MStatsCfg<L>;
  CUtensorMap tmy, te, tx;
  if (!e_map<L>(&tmy, my, N, M, ld_my, SR) ||
      !e_map<L>(&te, e, N, M, ld_e, SR) || !limbs_map(&tx, xl, L, M, kp, SR))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mask_stats<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (M + chunk_rows - 1) / chunk_rows;
  mask_stats<L><<<dim3((N + 63) / 64, chunks, kp / 128), kThreads, C::kSmem,
                  stream>>>(tmy, te, tx, M, N, K, kp, chunk_rows,
                            static_cast<float*>(part));
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes; each returns 0 or the first non-zero
// cudaError_t. limbs: 3 (f32 data) or 1 (bf16 data); kp: K rounded up to
// 128; limb arrays (x's xl: M x limbs kp; b's bl: N x limbs kp, row n the
// limbs of column n of b, cuda_mu.column_limbs) bf16 with zeros past K.

// xf (M x kp f32) = x, xl = cdt(x)'s limbs; x (M x K contiguous) f32 or
// (x_bf16) bf16; xl2 (or null) the second limb buffer, whose pads it
// zeroes.
extern "C" int mu_wide_prep_launch(int limbs, const void* x, int x_bf16,
                                   int M, int K, int kp, void* xf, void* xl,
                                   void* xl2, void* stream) {
  if (!dims_ok(limbs, M, 1, K, kp)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return limbs == 3 ? prep<3>(x, x_bf16, M, K, kp, xf, xl, xl2, s)
                    : prep<1>(x, x_bf16, M, K, kp, xf, xl, xl2, s);
}

// out (M x F f32, row stride ld_out) = E b^T; E (M x N in the data's
// dtype, row stride ld_e), bl b's limbs (N x limbs kp, F <= kp).
extern "C" int mu_wide_rows_launch(int limbs, const void* e, int ld_e,
                                   const void* bl, int M, int N, int F,
                                   int kp, void* out, int ld_out,
                                   void* stream) {
  if (!dims_ok(limbs, M, N, F, kp) || !ld_ok(limbs, ld_e, N) || ld_out < F)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const RowsStore<float> epi{static_cast<float*>(out), ld_out};
  return limbs == 3 ? rows<3>(e, ld_e, bl, M, N, F, kp, epi, s)
                    : rows<1>(e, ld_e, bl, M, N, F, kp, epi, s);
}

// den = E b^T (E, bl as mu_wide_rows_launch, F = K) and in its epilogue
// the x update: x_new = xf num / (den + eps) (xf, num: M x kp f32), written
// to xout (M x K in x's dtype: bf16 where xout_bf16) and its cdt limbs to
// xl (M x limbs kp).
extern "C" int mu_wide_xrows_launch(int limbs, const void* e, int ld_e,
                                    const void* bl, int M, int N, int K,
                                    int kp, void* xf, const void* num,
                                    float eps, void* xout, int xout_bf16,
                                    void* xl, void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_e, N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limbs == 3) {
    const MuX<3> x{static_cast<float*>(xf), static_cast<const float*>(num),
                   xout, static_cast<bf16*>(xl), kp, xout_bf16, 0, eps};
    return rows<3>(e, ld_e, bl, M, N, K, kp, MuXRows<3>{x}, s);
  }
  const MuX<1> x{static_cast<float*>(xf), static_cast<const float*>(num),
                 xout, static_cast<bf16*>(xl), kp, xout_bf16, 0, eps};
  return rows<1>(e, ld_e, bl, M, N, K, kp, MuXRows<1>{x}, s);
}

// E (M x N in the data's dtype, row stride ld_e) = cdt(f32(mask) (x b)),
// x's limbs xl, b's bl, depth K; mask the bits (M x ld_mask int32, ld_mask
// % 4 == 0, ld_mask 32 >= N) or (weighted) the weights (M x N in the
// data's dtype, row stride ld_mask).
extern "C" int mu_wide_resid_launch(int limbs, int weighted, const void* xl,
                                    const void* bl, const void* mask,
                                    int ld_mask, int M, int N, int K, int kp,
                                    void* e, int ld_e, void* stream) {
  const bool mask_ok = weighted ? ld_ok(limbs, ld_mask, N)
                                : ld_mask % 4 == 0 && ld_mask * 32LL >= N;
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_e, N) || !mask_ok)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limbs == 3)
    return weighted
               ? masked_resid<3, true>(xl, bl, mask, ld_mask, M, N, K, kp, e,
                                       ld_e, s)
               : masked_resid<3, false>(xl, bl, mask, ld_mask, M, N, K, kp, e,
                                        ld_e, s);
  return weighted
             ? masked_resid<1, true>(xl, bl, mask, ld_mask, M, N, K, kp, e,
                                     ld_e, s)
             : masked_resid<1, false>(xl, bl, mask, ld_mask, M, N, K, kp, e,
                                      ld_e, s);
}

// Dense MU's x update: den = cdt(x) G from x's limbs xl_in and G's limbs
// gl (K x limbs kp), and x_new = xf num / (den + eps) written to xf (in
// place), to xout where not null (the last inner iteration) and as its cdt
// limbs to xl_out (not xl_in).
extern "C" int mu_wide_xresid_launch(int limbs, const void* xl_in,
                                     const void* gl, int M, int K, int kp,
                                     void* xf, const void* num, float eps,
                                     void* xout, int xout_bf16, void* xl_out,
                                     void* stream) {
  if (!dims_ok(limbs, M, K, K, kp) || xl_in == xl_out)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (limbs == 3) {
    const MuX<3> x{static_cast<float*>(xf), static_cast<const float*>(num),
                   xout, static_cast<bf16*>(xl_out), kp, xout_bf16, 1, eps};
    return resid<3>(xl_in, gl, M, K, K, kp, MuXResid<3>{x}, s);
  }
  const MuX<1> x{static_cast<float*>(xf), static_cast<const float*>(num),
                 xout, static_cast<bf16*>(xl_out), kp, xout_bf16, 1, eps};
  return resid<1>(xl_in, gl, M, K, K, kp, MuXResid<1>{x}, s);
}

// out (K x N f32) = x^T E: E (M x N in the data's dtype, row stride ld_e),
// x's limbs xl; the partials of row chunks of chunk_rows (a multiple of
// 32) in part (chunks x K N f32), summed in chunk order.
extern "C" int mu_wide_dict_launch(int limbs, const void* e, int ld_e,
                                   const void* xl, int M, int N, int K,
                                   int kp, int chunk_rows, void* part,
                                   void* out, void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_e, N) ||
      chunk_rows < 1 || chunk_rows % DR != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return limbs == 3 ? dict<3>(e, ld_e, xl, M, N, K, kp, chunk_rows, part, out,
                              s)
                    : dict<1>(e, ld_e, xl, M, N, K, kp, chunk_rows, part, out,
                              s);
}

// E (M x N in the data's dtype, row stride ld_e) = cdt(f32(my) / (x b +
// eps)), KL's ratio: x's limbs xl, b's bl, depth K; my (M x N in the
// data's dtype, row stride ld_my).
extern "C" int mu_wide_kl_resid_launch(int limbs, const void* xl,
                                       const void* bl, const void* my,
                                       int ld_my, int M, int N, int K, int kp,
                                       float eps, void* e, int ld_e,
                                       void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_e, N) ||
      !ld_ok(limbs, ld_my, N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return limbs == 3
             ? kl_resid<3>(xl, bl, my, ld_my, M, N, K, kp, eps, e, ld_e, s)
             : kl_resid<1>(xl, bl, my, ld_my, M, N, K, kp, eps, e, ld_e, s);
}

// Dense KL's num = E b^T (E, bl as mu_wide_rows_launch, F = K) and in its
// epilogue the x update: x_new = (xf num) / (dsum + eps) (xf: M x kp f32,
// dsum: K f32), written to xf, to xout (M x K in x's dtype: bf16 where
// xout_bf16) and as its cdt limbs to xl (M x limbs kp).
extern "C" int mu_wide_kl_xrows_launch(int limbs, const void* e, int ld_e,
                                       const void* bl, int M, int N, int K,
                                       int kp, void* xf, const void* dsum,
                                       float eps, void* xout, int xout_bf16,
                                       void* xl, void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_e, N))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ds = static_cast<const float*>(dsum);
  if (limbs == 3) {
    const MuX<3> x{static_cast<float*>(xf), nullptr, xout,
                   static_cast<bf16*>(xl), kp, xout_bf16, 1, eps};
    return rows<3>(e, ld_e, bl, M, N, K, kp, KlX<3>{x, ds}, s);
  }
  const MuX<1> x{static_cast<float*>(xf), nullptr, xout,
                 static_cast<bf16*>(xl), kp, xout_bf16, 1, eps};
  return rows<1>(e, ld_e, bl, M, N, K, kp, KlX<1>{x, ds}, s);
}

// E (M x N in the data's dtype, row stride ld_e) = the 0/1 mask of the
// bits (M x ld_mask int32, ld_mask % 4 == 0, ld_mask 32 >= N).
extern "C" int mu_wide_expand_launch(int limbs, const void* mask, int ld_mask,
                                     int M, int N, void* e, int ld_e,
                                     void* stream) {
  if (!dims_ok(limbs, M, N, 1, 128) || !ld_ok(limbs, ld_e, N) ||
      ld_mask % 4 != 0 || ld_mask * 32LL < N)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n = (long long)M * ((N + 7) / 8);
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  const uint32_t* words = static_cast<const uint32_t*>(mask);
  if (limbs == 3)
    expand_bits<float><<<blocks, THREADS, 0, s>>>(
        words, ld_mask, M, N, static_cast<float*>(e), ld_e);
  else
    expand_bits<bf16><<<blocks, THREADS, 0, s>>>(
        words, ld_mask, M, N, static_cast<bf16*>(e), ld_e);
  return (int)cudaGetLastError();
}

// out (K f32) = the column sums of xf (M x kp f32): the partials of row
// chunks of chunk_rows in part (chunks x K f32), summed in chunk order.
extern "C" int mu_wide_colsum_launch(const void* xf, int M, int K, int kp,
                                     int chunk_rows, void* part, void* out,
                                     void* stream) {
  if (!dims_ok(1, M, 1, K, kp) || chunk_rows < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + chunk_rows - 1) / chunk_rows;
  col_partials<<<dim3(kp / 128, chunks), 128, 0, s>>>(
      static_cast<const float*>(xf), M, K, kp, chunk_rows,
      static_cast<float*>(part));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(part), K, chunks,
                       static_cast<float*>(out), s);
}

// Masked MU's x update in one pass: num = my d^T and den = E d^T against
// one stream of d's limbs bl (N x limbs kp), and x_new = x num / (den +
// eps) in its epilogue; my and E (M x N in the data's dtype, row strides
// ld_my, ld_e); x (M x K contiguous, bf16 where x_bf16, else f32), x_new to
// xout (x's dtype) and cdt(x_new)'s limbs over xl (M x limbs kp).
extern "C" int mu_wide_mxupd_launch(int limbs, const void* my, int ld_my,
                                    const void* e, int ld_e, const void* bl,
                                    int M, int N, int K, int kp,
                                    const void* x, int x_bf16, float eps,
                                    void* xout, void* xl, void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_my, N) ||
      !ld_ok(limbs, ld_e, N) || (limbs == 3 && x_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const MaskX xo{x, xout, static_cast<bf16*>(xl), x_bf16, kp, eps};
  return limbs == 3
             ? mask_xupd_run<3>(my, ld_my, e, ld_e, bl, M, N, K, kp, xo, s)
             : mask_xupd_run<1>(my, ld_my, e, ld_e, bl, M, N, K, kp, xo, s);
}

// Masked MU's statistics in one pass: the row chunks' partials of numd =
// x^T my and dend = x^T E (my, E as mu_wide_mxupd_launch; x's limbs xl, M x
// limbs kp) against one stream of xl, chunks of chunk_rows (a multiple of
// 64) rows, into part (chunks x 2 K N f32: numd's K x N, then dend's).
extern "C" int mu_wide_mstats_launch(int limbs, const void* my, int ld_my,
                                     const void* e, int ld_e, const void* xl,
                                     int M, int N, int K, int kp,
                                     int chunk_rows, void* part,
                                     void* stream) {
  if (!dims_ok(limbs, M, N, K, kp) || !ld_ok(limbs, ld_my, N) ||
      !ld_ok(limbs, ld_e, N) || chunk_rows < 1 || chunk_rows % SR != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return limbs == 3 ? mask_stats_run<3>(my, ld_my, e, ld_e, xl, M, N, K, kp,
                                        chunk_rows, part, s)
                    : mask_stats_run<1>(my, ld_my, e, ld_e, xl, M, N, K, kp,
                                        chunk_rows, part, s);
}

// out (S f32) = the sum over chunks, in chunk order, of part (chunks x S).
extern "C" int mu_wide_reduce_launch(const void* part, long long S,
                                     int chunks, void* out, void* stream) {
  if (S < 1 || chunks < 1) return (int)cudaErrorInvalidValue;
  return launch_reduce(static_cast<const float*>(part), S, chunks,
                       static_cast<float*>(out),
                       static_cast<cudaStream_t>(stream));
}
