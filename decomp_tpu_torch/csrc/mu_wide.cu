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
// register file (the same reason as grad_wide.cu's). So each product is
// its own launch of a wide_common.cuh kernel, with the intermediates in
// device memory:
//   prep:      x in f32 (xf, M x kp) and cdt(x)'s limbs (xl, M x L kp,
//              zero past K), one thread per 8 ranks; kp = K rounded up to
//              128;
//   MU dense:  num = y d^T (wide_rows, E := y, num M x kp f32); per inner
//              iteration wide_resid with b := G's limbs over K x K and the
//              MuXResid epilogue (x_new = x num / (R + eps) written to xf,
//              and on the last to x_new in x's dtype, cdt(x_new)'s limbs to
//              the other of two limb buffers); numd and gram by wide_dict
//              (E := y, then E := cdt(x_new): xf at f32, its one limb at
//              bf16) and the fixed-order reduction;
//   MU masked: E1 = cdt(f32(mask) R) (wide_resid, MaskedResid without my),
//              num = my d^T (wide_rows), den = E1 d^T (wide_rows with the
//              MuXRows epilogue: the x update, cdt(x_new)'s limbs written
//              over x's), E2 = cdt(f32(mask) (x_new d)) (wide_resid), and
//              numd, dend by wide_dict (E := my, then E := E2);
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
// on one stream: MU 6 + inner_iter launches dense and 9 masked, KL 8 dense,
// 9 masked on weights and 10 on bits (the reductions included). No float
// atomics: a rerun gives the same bits; the row chunks of the statistics
// and of xsum come from the shape alone (cuda_mu.wide_dict_rows,
// wide_sum_rows).
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
// at f32), num and xf (M x kp f32 each) and x's limbs.

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

// xf = f32(x) and xl = cdt(x)'s L limbs, each zero past K, one thread per
// 8 ranks of a row (x: M x K, f32 or bf16 by x_bf16); xl2, where not null,
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
  float4* pf = reinterpret_cast<float4*>(xf + r * kp + c0);
  pf[0] = make_float4(v[0], v[1], v[2], v[3]);
  pf[1] = make_float4(v[4], v[5], v[6], v[7]);
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
