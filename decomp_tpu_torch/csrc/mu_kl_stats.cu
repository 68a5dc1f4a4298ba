// Masked multiplicative-update and KL-divergence NMF statistics, and the
// masked dictionary gradient, on Hopper (sm_90a): one templated source,
// four variants.
//
// Replaces three Pallas TPU kernels of decomp_tpu/ops/pallas_mu.py:
//   MU_MASKED  mu_stats_masked (:522, body _masked_kernel :222)
//   KL_DENSE   kl_stats_dense  (:603, body _kl_dense_kernel :276)
//   KL_MASKED  kl_stats_masked (:678, body _kl_masked_kernel :325)
// and one of decomp_tpu/ops/pallas_lasso.py:
//   GRAD_DICT  masked_grad_dict (:225, body _grad_dict_kernel :201)
// The masked variants serve a dense mask: MU_MASKED weighted masks only (a
// 0/1 mask goes as bits to mu_masked_f32.cu with f32 data, bf16x6 on
// wgmma, and to mu_masked_packed.cu with bf16 data), KL_MASKED bf16 data
// and weighted masks (f32 data with a 0/1 mask go to kl_masked_packed.cu,
// bf16x6 on the tensor cores); ops/cuda_mu.py routes by the data's dtype
// and the mask's form.
// Given my = mask * y (M, N), mask (M, N) (masked variants), x (M, K) and
// d (K, N) in my's dtype (cdt), each forms a reconstruction R = cdt(x) d
// on chip, applies the variant's elementwise step E(R), and returns
//   MU_MASKED  E = cdt(mask * R)
//              x_new = x * (my d^T) / (E d^T + eps)
//              numd = x_new^T my, dend = x_new^T E(x_new)        (K, N) f32
//   KL_DENSE   E = cdt(my / (R + eps))
//              x_new = x * (E d^T) / (dsum + eps), dsum = sum_n d (1, K)
//              numd = x_new^T E(x_new) (K, N) f32, xsum = sum_m x_new (1, K)
//   KL_MASKED  E as KL_DENSE
//              x_new = x * (E d^T) / (mask d^T + eps)
//              numd = x_new^T E(x_new), dend = x_new^T mask       (K, N) f32
//   GRAD_DICT  E = cdt(mask * R - my), no x update
//              g = x^T E(x)                                       (K, N) f32
// with the TPU kernels' quantisation points: products take cdt operands and
// sum in f32; E is formed in f32 and cast to cdt; x_new is formed in f32
// and stored in x's dtype; the statistics use cdt(x_new_f32); xsum sums the
// f32 x_new, not the stored one. x is f32 or cdt for MU_MASKED (f32 with
// bf16 data is the mixed-precision mode) and cdt for the KL variants. bf16
// products run on the tensor cores (mma.sync, f32 accumulation), f32
// products as full-f32 FMAs (never TF32), as in mu_stats_dense.cu.
//
// What bounds it on an H100. Per data pass the variants do 4-6 MNK FLOP
// against 2-4 bytes per entry (my, and mask for the masked variants), so at
// K = 128 they sit at or below the ~295 FLOP/byte ridge: memory bound once
// the products run near the tensor-core rate. Nothing M x N is ever written:
// R and E live in registers and shared memory only.
//
// Schedule: as mu_stats_dense.cu, three launches that together are the port
// of one TPU kernel, so the data are read twice per iteration.
//   1. x update: one block per 64-row stripe loops over N in 32-wide stages
//      of (my, mask, d). Per stage it forms R (64 x 32) from the stripe's x,
//      resident in shared memory, writes E to shared memory, and adds the
//      stage's products with d^T to num and den (64 x K each, f32 in
//      registers, stage-wise summed). It then writes x_new and, for
//      KL_DENSE, the stripe's f32 column sums of x_new.
//   2. statistics: a grid of (64-wide N tile) x (row chunk). The block keeps
//      its d tile in shared memory, walks its chunk in 32-row stages, forms
//      R = cdt(x_new) d_tile and E, and adds per-chunk partials of numd
//      (and dend).
//   3. reduction: the partials are summed chunk by chunk in a fixed order
//      (KL_DENSE also sums the stripes' column sums in a fixed tree).
// No float atomics, so two runs on the same inputs give the same bits. The
// ragged M, N and K edges are masked in the kernels (E is zero outside the
// matrix, so eps = 0 gives no NaN there); nothing is padded or copied.
//
// HBM bytes per iteration at 262,144 x 10,112, K = 128, bf16 my and mask,
// f32 x (MU_MASKED, mixed):
//   my and mask read twice   2 x (5.3 + 5.3) GB = 21.2 GB
//   x read, x_new written    2 x 0.13 GB
//   x_new read (stats)       >= 0.13 GB (per N tile when L2 misses)
//   partials                 128 chunks x 10.4 MB, written and read: 2.7 GB
//   total                    ~24 GB, ~7.2 ms at 3.35 TB/s
// against ~10.6 GB for one fused pass. KL_DENSE reads no mask (half the
// data bytes, partials 1.3 GB). The packed kernels read the mask as bits.
// d (2.6 MB) is re-read from L2 by every stripe of launch 1.
//
// GRAD_DICT runs launches 2 and 3 only, on x itself: one pass over my and
// mask, 4 MNK FLOP (R and x^T E). It is the first design of the dense-mask
// dictionary gradient and on no route: grad_dict_packed.cu's weighted
// instance took its masks, and ops/cuda_dl.py reaches it only through the
// private _grad_dict_dense_mma_launch, to time it beside that instance. At 100,000 x 1,024, K = 128: 52 GFLOP
// against 0.87 GB in f32 (0.78 ms of f32 FMA at 67 TFLOP/s bounds it), 0.44
// GB in bf16 (0.13 ms of HBM). Its row chunks are chosen by the wrapper to
// fill the 132 SMs a few times over (ops/cuda_dl.py), since each chunk's
// K x N partial (0.5 MB at K = 128, N = 1,024) is written and read again.

#include "nmf_common.cuh"

namespace {

enum Variant { MU_MASKED = 0, KL_DENSE = 1, KL_MASKED = 2, GRAD_DICT = 3 };

constexpr int BM1 = 64;         // rows per block of the x update
constexpr int BN2 = 64;         // columns per block of the statistics pass
constexpr int LDN = BN2 + 8;    // leading dim of BN2-wide tiles
constexpr int LDF = KP + 4;     // leading dim of the f32 x_new tile

template <int V> constexpr bool kMasked = V != KL_DENSE;
// K x N statistics per partial: [numd | dend], or [numd] (the gradient).
template <int V> constexpr int kParts = V == MU_MASKED || V == KL_MASKED
                                            ? 2 : 1;

// The variant's elementwise step on one entry: r is the f32 reconstruction,
// y and m the entry's data and mask values.
template <int V, typename T>
__device__ __forceinline__ T elementwise(float r, float y, float m,
                                         float eps) {
  if constexpr (V == MU_MASKED) return from_f32<T>(m * r);
  else if constexpr (V == GRAD_DICT)
    return from_f32<T>(__fsub_rn(__fmul_rn(m, r), y));
  else return from_f32<T>(y / (r + eps));
}

template <typename T>
constexpr size_t x_update_smem() {
  return (size_t)(BM1 * LDR + BM1 * LDT + 2 * (2 * BM1 + KP) * LDT) *
         sizeof(T);
}
template <typename T>
constexpr size_t stats_smem() {
  return (size_t)(KP * LDN + BK * LDN + 2 * (BK * LDR + 2 * BK * LDN)) *
         sizeof(T);
}

// Launch 1: the x update of one 64-row stripe. Warps: the R product as
// 2 (rows of 32) x 4 (cols of 8); num/den as 2 (rows of 32) x 4 (cols of
// 32). Shared memory: Xs (BM1 x LDR, cdt x) | Es (BM1 x LDT) | two stages
// of [my (BM1 x LDT) | mask (BM1 x LDT) | d (KP x LDT)].
template <int V, typename T, typename X>
__global__ void __launch_bounds__(THREADS)
    x_update_kernel(const T* __restrict__ my, const T* __restrict__ mask,
                    const X* __restrict__ x, const T* __restrict__ d,
                    const float* __restrict__ dsum, float eps, int M, int N,
                    int K, X* __restrict__ x_new, float* __restrict__ xpart,
                    bool y_vec, bool d_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Es = Xs + BM1 * LDR;
  T* stage0 = Es + BM1 * LDT;
  constexpr int STAGE = (2 * BM1 + KP) * LDT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr_r = (warp & 1) * 32, wc_r = (warp >> 1) * 8;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 32;
  const long long row0 = (long long)blockIdx.x * BM1;

  load_tile<T, X, BM1, KP>(Xs, LDR, x + row0 * K, K, M - row0, K);
  float num[2][4][4], den[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) num[mt][nt][i] = den[mt][nt][i] = 0.f;

  Stage<T, BM1, BK> ys, ms;
  Stage<T, KP, BK> ds;
  ys.load(my, N, row0, M, 0, N, y_vec);
  if (kMasked<V>) ms.load(mask, N, row0, M, 0, N, y_vec);
  ds.load(d, N, 0, K, 0, N, d_vec);
  ys.store(stage0, LDT);
  if (kMasked<V>) ms.store(stage0 + BM1 * LDT, LDT);
  ds.store(stage0 + 2 * BM1 * LDT, LDT);
  __syncthreads();
  const int n_stages = (N + BK - 1) / BK;
  for (int s = 0; s < n_stages; ++s) {
    const T* Ys = stage0 + (s & 1) * STAGE;
    const T* Ms = Ys + BM1 * LDT;
    const T* Ds = Ys + 2 * BM1 * LDT;
    const bool more = s + 1 < n_stages;
    if (more) {
      const long long c_next = (long long)(s + 1) * BK;
      ys.load(my, N, row0, M, c_next, N, y_vec);
      if (kMasked<V>) ms.load(mask, N, row0, M, c_next, N, y_vec);
      ds.load(d, N, 0, K, c_next, N, d_vec);
    }
    // R = cdt(x) d_tile (BM1 x BK), then E into shared memory.
    float r[2][1][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KP; k0 += 16)
      WarpMma<T, false, true>::template run<1>(r, Xs, LDR, Ds, LDT, k0, wr_r,
                                               wc_r, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr_r + frag_row(mt, i, lane);
        const int col = wc_r + frag_col(0, i, lane);
        const bool in = row0 + row < M && (long long)s * BK + col < N;
        Es[row * LDT + col] =
            in ? elementwise<V, T>(r[mt][0][i], to_f32(Ys[row * LDT + col]),
                                   kMasked<V> ? to_f32(Ms[row * LDT + col])
                                               : 1.f,
                                   eps)
               : from_f32<T>(0.f);
      }
    __syncthreads();
    if constexpr (V == MU_MASKED) {
      stage_mma<T, false, false>(num, Ys, LDT, Ds, LDT, wr, wc, lane);
      stage_mma<T, false, false>(den, Es, LDT, Ds, LDT, wr, wc, lane);
    } else {
      stage_mma<T, false, false>(num, Es, LDT, Ds, LDT, wr, wc, lane);
      if constexpr (V == KL_MASKED)
        stage_mma<T, false, false>(den, Ms, LDT, Ds, LDT, wr, wc, lane);
    }
    if (more) {
      T* next = stage0 + ((s + 1) & 1) * STAGE;
      ys.store(next, LDT);
      if (kMasked<V>) ms.store(next + BM1 * LDT, LDT);
      ds.store(next + 2 * BM1 * LDT, LDT);
    }
    __syncthreads();
  }

  // x_new = x * num / (den + eps); KL_DENSE stages the f32 x_new in shared
  // memory (the loop above ended on a barrier) for its column sums.
  float* F = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr + frag_row(mt, i, lane);
        const int c = wc + frag_col(nt, i, lane);
        const long long gr = row0 + row;
        const bool in = gr < M && c < K;
        float xf = 0.f;
        if (in) {
          const float dn = V == KL_DENSE ? dsum[c] : den[mt][nt][i];
          xf = to_f32(x[gr * K + c]) * num[mt][nt][i] / (dn + eps);
          x_new[gr * K + c] = cvt<X>(xf);
        }
        if (V == KL_DENSE) F[row * LDF + c] = xf;
      }
  if constexpr (V == KL_DENSE) {
    __syncthreads();
    if (threadIdx.x < K) {
      float s = 0.f;
      for (int row = 0; row < BM1; ++row) s += F[row * LDF + threadIdx.x];
      xpart[(long long)blockIdx.x * K + threadIdx.x] = s;
    }
  }
}

// Launch 2: per-chunk partials. Block (j, c) covers columns [64 j, 64 j +
// 64) of row chunk c. Warps: the R product as 8 column strips of 8; the
// statistics as 4 (rank rows of 32) x 2 (cols of 32). Shared memory:
// Ds (KP x LDN, resident) | Es (BK x LDN) | two stages of
// [x_new (BK x LDR, cdt) | my (BK x LDN) | mask (BK x LDN)].
// Partial c holds [numd (K x N) | dend (K x N, MU_MASKED and KL_MASKED)];
// for GRAD_DICT x_new is x and numd is the gradient.
template <int V, typename T, typename X>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ my, const T* __restrict__ mask,
                 const X* __restrict__ x_new, const T* __restrict__ d,
                 float eps, int M, int N, int K, int chunk_rows,
                 float* __restrict__ part, bool y_vec, bool x_vec,
                 bool d_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ds = reinterpret_cast<T*>(smem_raw);
  T* Es = Ds + KP * LDN;
  T* stage0 = Es + BK * LDN;
  constexpr int STAGE = BK * LDR + 2 * BK * LDN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wc_r = warp * 8;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 32;
  const long long n0 = (long long)blockIdx.x * BN2;
  const long long r_begin = (long long)blockIdx.y * chunk_rows;
  const long long r_end = min(r_begin + chunk_rows, (long long)M);

  {
    Stage<T, KP, BN2> dt;
    dt.load(d, N, 0, K, n0, N, d_vec);
    dt.store(Ds, LDN);
  }
  float numd[2][4][4], dend[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) numd[mt][nt][i] = dend[mt][nt][i] = 0.f;

  Stage<X, BK, KP> xs;
  Stage<T, BK, BN2> ys, ms;
  xs.load(x_new, K, r_begin, r_end, 0, K, x_vec);
  ys.load(my, N, r_begin, r_end, n0, N, y_vec);
  if (kMasked<V>) ms.load(mask, N, r_begin, r_end, n0, N, y_vec);
  xs.store(stage0, LDR);
  ys.store(stage0 + BK * LDR, LDN);
  if (kMasked<V>) ms.store(stage0 + BK * LDR + BK * LDN, LDN);
  __syncthreads();
  const int n_stages = (int)((r_end - r_begin + BK - 1) / BK);
  for (int s = 0; s < n_stages; ++s) {
    const T* Xs = stage0 + (s & 1) * STAGE;
    const T* Ys = Xs + BK * LDR;
    const T* Ms = Ys + BK * LDN;
    const long long r_cur = r_begin + (long long)s * BK;
    const bool more = s + 1 < n_stages;
    if (more) {
      xs.load(x_new, K, r_cur + BK, r_end, 0, K, x_vec);
      ys.load(my, N, r_cur + BK, r_end, n0, N, y_vec);
      if (kMasked<V>) ms.load(mask, N, r_cur + BK, r_end, n0, N, y_vec);
    }
    // R = cdt(x_new) d_tile (BK x BN2), then E into shared memory.
    float r[2][1][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KP; k0 += 16)
      WarpMma<T, false, true>::template run<1>(r, Xs, LDR, Ds, LDN, k0, 0,
                                               wc_r, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = frag_row(mt, i, lane);
        const int col = wc_r + frag_col(0, i, lane);
        const bool in = r_cur + row < r_end && n0 + col < N;
        Es[row * LDN + col] =
            in ? elementwise<V, T>(r[mt][0][i], to_f32(Ys[row * LDN + col]),
                                   kMasked<V> ? to_f32(Ms[row * LDN + col])
                                               : 1.f,
                                   eps)
               : from_f32<T>(0.f);
      }
    __syncthreads();
    if constexpr (V == MU_MASKED) {
      stage_mma<T, true, true>(numd, Xs, LDR, Ys, LDN, wr, wc, lane);
      stage_mma<T, true, true>(dend, Xs, LDR, Es, LDN, wr, wc, lane);
    } else {
      stage_mma<T, true, true>(numd, Xs, LDR, Es, LDN, wr, wc, lane);
      if constexpr (V == KL_MASKED)
        stage_mma<T, true, true>(dend, Xs, LDR, Ms, LDN, wr, wc, lane);
    }
    if (more) {
      T* next = stage0 + ((s + 1) & 1) * STAGE;
      xs.store(next, LDR);
      ys.store(next + BK * LDR, LDN);
      if (kMasked<V>) ms.store(next + BK * LDR + BK * LDN, LDN);
    }
    __syncthreads();
  }

  const long long KN = (long long)K * N;
  float* out = part + (long long)blockIdx.y * kParts<V> * KN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = wr + frag_row(mt, i, lane);
        const long long c = n0 + wc + frag_col(nt, i, lane);
        if (kr >= K || c >= N) continue;
        out[kr * (long long)N + c] = numd[mt][nt][i];
        if (kParts<V> == 2)
          out[KN + kr * (long long)N + c] = dend[mt][nt][i];
      }
}

struct Args {
  const void *my, *mask, *x, *d, *dsum;
  float eps;
  int M, N, K, chunk_rows;
  void *x_new, *part, *out, *xpart, *xsum;
  cudaStream_t stream;
};

template <typename T>
bool data_vec(const Args& a, bool masked) {
  return rows_aligned<T>(a.my, a.N) &&
         (!masked || rows_aligned<T>(a.mask, a.N));
}

// Launches 2 and 3: the statistics of x_stats (x_new, or x for GRAD_DICT)
// in per-chunk partials, then their fixed-order sum into a.out.
template <int V, typename T, typename X>
int launch_stats(const Args& a, const void* x_stats) {
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  const dim3 grid2((a.N + BN2 - 1) / BN2, chunks);
  constexpr size_t smem2 = stats_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<V, T, X>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem2);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<V, T, X><<<grid2, THREADS, smem2, a.stream>>>(
      static_cast<const T*>(a.my), static_cast<const T*>(a.mask),
      static_cast<const X*>(x_stats), static_cast<const T*>(a.d), a.eps, a.M,
      a.N, a.K, a.chunk_rows, static_cast<float*>(a.part),
      data_vec<T>(a, kMasked<V>), rows_aligned<X>(x_stats, a.K),
      rows_aligned<T>(a.d, a.N));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       (long long)kParts<V> * a.K * a.N, chunks,
                       static_cast<float*>(a.out), a.stream);
}

template <int V, typename T, typename X>
int launch(const Args& a) {
  cudaError_t err;
  const T* my = static_cast<const T*>(a.my);
  const T* mask = static_cast<const T*>(a.mask);
  const T* d = static_cast<const T*>(a.d);
  const bool y_vec = data_vec<T>(a, kMasked<V>);
  const bool d_vec = rows_aligned<T>(a.d, a.N);
  const int blocks1 = (a.M + BM1 - 1) / BM1;

  constexpr size_t smem1 = x_update_smem<T>();
  static_assert(smem1 >= (size_t)BM1 * LDF * sizeof(float), "x_new tile");
  err = cudaFuncSetAttribute(x_update_kernel<V, T, X>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return (int)err;
  x_update_kernel<V, T, X><<<blocks1, THREADS, smem1, a.stream>>>(
      my, mask, static_cast<const X*>(a.x), d,
      static_cast<const float*>(a.dsum), a.eps, a.M, a.N, a.K,
      static_cast<X*>(a.x_new), static_cast<float*>(a.xpart), y_vec, d_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int rc = launch_stats<V, T, X>(a, a.x_new);
  if (rc != 0 || V != KL_DENSE) return rc;
  return launch_reduce_long(static_cast<const float*>(a.xpart), a.K, blocks1,
                            static_cast<float*>(a.xsum), a.stream);
}

bool bad_shape(const Args& a) {
  return a.M < 1 || a.N < 1 || a.K < 1 || a.K > KP || a.chunk_rows < 1;
}

}  // namespace

// The C interface, loaded with ctypes. t_bf16 selects the compute dtype
// (bf16 or f32) of my, mask and d; x_bf16 the storage dtype of x and x_new
// (MU_MASKED only: bf16 requires t_bf16; the KL variants take x in the
// compute dtype). part holds chunks x S f32 partials and out S f32, with
// S = 2 K N = [numd | dend] for the masked variants and K N = [numd] for
// KL_DENSE, whose dsum is (K) f32, xpart ceil(M / 64) x K f32 scratch and
// xsum (K) f32. masked_grad_dict_launch takes my, mask, x and d all in the
// compute dtype and writes the (K, N) f32 gradient to out, through chunks x
// K N f32 partials in part. Each returns 0 or the first non-zero
// cudaError_t.
extern "C" int mu_stats_masked_launch(int t_bf16, int x_bf16, const void* my,
                                      const void* mask, const void* x,
                                      const void* d, float eps, int M, int N,
                                      int K, int chunk_rows, void* x_new,
                                      void* part, void* out, void* stream) {
  const Args a{my, mask, x, d, nullptr, eps, M, N, K, chunk_rows,
               x_new, part, out, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  if (bad_shape(a) || (x_bf16 && !t_bf16)) return (int)cudaErrorInvalidValue;
  if (t_bf16 && x_bf16) return launch<MU_MASKED, bf16, bf16>(a);
  if (t_bf16) return launch<MU_MASKED, bf16, float>(a);
  return launch<MU_MASKED, float, float>(a);
}

extern "C" int kl_stats_dense_launch(int t_bf16, const void* my,
                                     const void* x, const void* d,
                                     const void* dsum, float eps, int M,
                                     int N, int K, int chunk_rows,
                                     void* x_new, void* part, void* out,
                                     void* xpart, void* xsum, void* stream) {
  const Args a{my, nullptr, x, d, dsum, eps, M, N, K, chunk_rows,
               x_new, part, out, xpart, xsum,
               static_cast<cudaStream_t>(stream)};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (t_bf16) return launch<KL_DENSE, bf16, bf16>(a);
  return launch<KL_DENSE, float, float>(a);
}

extern "C" int kl_stats_masked_launch(int t_bf16, const void* my,
                                      const void* mask, const void* x,
                                      const void* d, float eps, int M, int N,
                                      int K, int chunk_rows, void* x_new,
                                      void* part, void* out, void* stream) {
  const Args a{my, mask, x, d, nullptr, eps, M, N, K, chunk_rows,
               x_new, part, out, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (t_bf16) return launch<KL_MASKED, bf16, bf16>(a);
  return launch<KL_MASKED, float, float>(a);
}

extern "C" int masked_grad_dict_launch(int t_bf16, const void* my,
                                       const void* mask, const void* x,
                                       const void* d, int M, int N, int K,
                                       int chunk_rows, void* part, void* out,
                                       void* stream) {
  const Args a{my, mask, x, d, nullptr, 0.f, M, N, K, chunk_rows,
               nullptr, part, out, nullptr, nullptr,
               static_cast<cudaStream_t>(stream)};
  if (bad_shape(a)) return (int)cudaErrorInvalidValue;
  if (t_bf16) return launch_stats<GRAD_DICT, bf16, bf16>(a, x);
  return launch_stats<GRAD_DICT, float, float>(a, x);
}
