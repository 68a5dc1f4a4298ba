// Dense and masked multiplicative-update NMF above rank 128 on Hopper
// (sm_90a), on the wide route's products (wide_common.cuh): f32 data with
// every f32 product as bf16x6 limb products (L = 3 limbs an operand), bf16
// data with each product one bf16 pass (L = 1); the mask as packed bits
// (a 0/1 mask) or as weights in the data's dtype; x in the data's dtype or
// in f32. Every rank K above 128 that the TPU kernels' gate takes
// (ops/cuda_mu.py rank_fits: at N <= 128 up to 10,624 dense and 6,272
// masked in f32, 12,800 and 7,040 in bf16; at N = 1,024 up to 1,280 and
// 640 in f32).
//
// Replaces, above rank 128, the Pallas TPU kernels
// decomp_tpu/ops/pallas_mu.py:438 mu_stats_dense (pallas_call :459) and
// :522 mu_stats_masked (pallas_call :540):
//   dense:  x_new = x (y d^T) / (cdt(x) G + eps), inner_iter times with
//           G = cdt(d d^T) formed outside (pallas_mu.py:453); numd =
//           x_new^T y, gram = x_new^T x_new;
//   masked: x_new = x (my d^T) / (cdt(f32(mask) (cdt(x) d)) d^T + eps);
//           numd = x_new^T my, dend = x_new^T cdt(f32(mask) (x_new d)),
// at the TPU kernels' quantisation points (cdt the data's dtype; the
// products take cdt operands and sum in f32; x_new formed in f32, kept in
// f32 between inner iterations, stored in x's dtype; the statistics on
// cdt(x_new)).
//
// Why not the fused kernels widened: mu_dense_packed.cu and
// mu_masked_f32.cu keep d's limbs or a 128-rank tile of x resident, which
// past 128 outgrows shared memory and the register file (the same reason
// as grad_wide.cu's). So each product is its own launch of a wide_common.cuh
// kernel, with the intermediates in device memory:
//   prep:     x in f32 (xf, M x kp) and cdt(x)'s limbs (xl, M x L kp,
//             zero past K), one thread per 8 ranks; kp = K rounded up to
//             128;
//   dense:    num = y d^T (wide_rows, E := y, num M x kp f32); per inner
//             iteration wide_resid with b := G's limbs over K x K and the
//             MuXResid epilogue (x_new = x num / (R + eps) written to xf,
//             and on the last to x_new in x's dtype, cdt(x_new)'s limbs to
//             the other of two limb buffers); numd and gram by wide_dict
//             (E := y, then E := cdt(x_new): xf at f32, its one limb at
//             bf16) and the fixed-order reduction;
//   masked:   E1 = cdt(f32(mask) R) (wide_resid, MaskedResid without my),
//             num = my d^T (wide_rows), den = E1 d^T (wide_rows with the
//             MuXRows epilogue: the x update, cdt(x_new)'s limbs written
//             over x's), E2 = cdt(f32(mask) (x_new d)) (wide_resid), and
//             numd, dend by wide_dict (E := my, then E := E2).
// The wrappers (ops/cuda_mu.py _dense_wide_launch, _masked_wide_launch)
// launch them in that order on one stream: 6 + inner_iter launches dense,
// 9 masked (the reductions included). No float atomics: a rerun gives the
// same bits; the row chunks of the statistics come from the shape alone
// (cuda_mu.wide_dict_rows).
//
// What bounds it on an H100, at 100,000 x 1,024, K = 256 (the TPU kernel's
// own work: y or my and the mask read once, x read, x_new written, the
// statistics written):
//   - dense f32: 4MNK + 4MK^2 = 1.31e11 operations as 6 bf16 passes, 7.86e11,
//     0.795 ms at 989 TFLOP/s, against ~0.63 GB of bytes (0.19 ms): bound
//     by operations;
//   - dense bf16: 1.31e11 operations in one pass, 0.133 ms, against ~0.41 GB
//     (0.122 ms): bound by operations, nearly by bytes;
//   - masked f32: 12MNK = 3.15e11 as 6 passes, 1.91 ms; bf16 0.318 ms.
// This route's own traffic beside that bound: E1 and E2 out and back (1.64
// GB at f32, 0.49 ms of bytes; half at bf16), num and xf (M x kp f32 each)
// and x's limbs.

#include "wide_common.cuh"

namespace {

// x_new = x num / (den + eps) at (gr, col) and (gr, col + 1), col even and
// < K, each operation rounded to nearest (the TPU's (x * num) / (den +
// eps) in f32): x read from xf (M x kp f32), num (M x kp f32); x_new
// written to xf where wxf, to xout in x's dtype (M x K, contiguous) where
// not null, and cdt(x_new)'s limbs to xl (M x L kp). Past K the pair's
// second value is 0, so the pads of xf and xl stay zero.
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

template <int L, bool W>
int resid(const void* xl, const void* bl, const void* mask, int ld_mask,
          int M, int N, int K, int kp, void* e, int ld_e,
          cudaStream_t stream) {
  CUtensorMap tx, tb;
  if (!limbs_map(&tx, xl, L, M, kp, BM) || !limbs_map(&tb, bl, L, N, kp, BN))
    return (int)cudaErrorInvalidValue;
  const MaskedResid<L, W, false> epi{nullptr, 0, mask, ld_mask,
                                     static_cast<Elt<L>*>(e), ld_e};
  return launch_resid<L>(tx, tb, M, N, K, kp, epi, stream);
}

template <int L>
int xresid(const void* xl_in, const void* gl, int M, int K, int kp,
           const MuX<L>& x, cudaStream_t stream) {
  CUtensorMap tx, tb;
  if (!limbs_map(&tx, xl_in, L, M, kp, BM) ||
      !limbs_map(&tb, gl, L, K, kp, BN))
    return (int)cudaErrorInvalidValue;
  return launch_resid<L>(tx, tb, M, K, K, kp, MuXResid<L>{x}, stream);
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
               ? resid<3, true>(xl, bl, mask, ld_mask, M, N, K, kp, e, ld_e, s)
               : resid<3, false>(xl, bl, mask, ld_mask, M, N, K, kp, e, ld_e,
                                 s);
  return weighted
             ? resid<1, true>(xl, bl, mask, ld_mask, M, N, K, kp, e, ld_e, s)
             : resid<1, false>(xl, bl, mask, ld_mask, M, N, K, kp, e, ld_e, s);
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
    return xresid<3>(xl_in, gl, M, K, kp, x, s);
  }
  const MuX<1> x{static_cast<float*>(xf), static_cast<const float*>(num),
                 xout, static_cast<bf16*>(xl_out), kp, xout_bf16, 1, eps};
  return xresid<1>(xl_in, gl, M, K, kp, x, s);
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
