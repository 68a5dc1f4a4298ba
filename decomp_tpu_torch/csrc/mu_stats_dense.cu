// Dense multiplicative-update NMF statistics on Hopper (sm_90a), for f32
// data.
//
// The first port of the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:438
// mu_stats_dense (body _dense_kernel, pallas_mu.py:160), on no route now:
// bf16 y, the main path, goes to mu_dense_tma.cu (TMA ring, wgmma, a bf16
// copy of x_new, few statistics chunks) and f32 y to mu_dense_packed.cu
// (bf16x6 on wgmma); ops/cuda_mu.py routes by dtype. This kernel takes
// both, so that the designs can be timed on the same inputs
// (cuda_mu._dense_mma_launch); the bf16 notes below describe that path,
// and the byte count is its, at the main path's shape. Given data
// y (M, N), activations x (M, K), dictionary d (K, N) in y's dtype and
// ddt = d d^T (K, K, f32) it returns
//   x_new = x * (y d^T) / (x ddt + eps)   (inner_iter refinements that reuse
//                                          the numerator y d^T)
//   numd  = x_new^T y      (K, N) f32
//   gram  = x_new^T x_new  (K, K) f32
// with the TPU kernel's quantisation points: products take compute-dtype
// operands (cdt = y's dtype) and sum in f32; ddt is cast to cdt at use; the
// iterate stays f32 across refinements and is cast to cdt before each
// denominator product; x_new is stored in x's dtype; the statistics use
// x_new cast to cdt. bf16 products go through the tensor cores (mma.sync
// m16n8k16 with f32 accumulation: bf16 x bf16 products are exact in f32, as
// on the TPU's MXU; see stage_mma for how the long sums are kept at f32
// summation-order accuracy). f32 products are full-f32 FMAs on the CUDA
// cores, never TF32 (the TPU pins Precision.HIGHEST for f32).
//
// What bounds it on an H100. At K = 128 one pass over bf16 y does
// 2K = 256 FLOP per byte, below the card's ~295 FLOP/byte ridge (989 TFLOP/s
// bf16 over 3.35 TB/s), so even a fused single pass is near the memory bound.
// At 1,048,576 x 10,112 one iteration is ~5.5 TFLOP against 21.2 GB of y per
// pass.
//
// Schedule: three launches, which together are the port of the one TPU
// kernel. The TPU grid runs its row stripes in order and carries numd/gram
// in scratch from stripe to stripe; CUDA blocks run in no order, and d
// (2.6 MB at K = 128, N = 10,112 in bf16) is far beyond a block's 227 KB of
// shared memory, so N is tiled:
//   1. x update: one block per 128-row stripe loops over N in 32-wide tiles
//      of y and d to build num_x (128 x K, f32, in registers), then applies
//      the inner_iter refinements with ddt resident in shared memory.
//   2. statistics: a grid of (N tile + one gram tile) x (row chunk) forms
//      per-chunk partials of x_new^T y and x_new^T x_new.
//   3. reduction: the partials are summed chunk by chunk in a fixed order.
// No float atomics anywhere, so two runs on the same inputs give the same
// bits. The kernels mask the ragged M, N and K edges themselves: y is never
// padded or copied, and any 1 <= K <= 128 is taken.
//
// The streamed loops of launches 1 and 2 are software-pipelined: the next
// stage's tiles are read from global memory into registers (16-byte loads
// where rows are 16-byte aligned) while the tensor cores work on the current
// stage in one of two shared-memory buffers. Both kernels keep every tile in
// its natural row-major layout; launch 2 reads the transposed operands
// x_new^T and y by fragment, so no tile is transposed in shared memory.
//
// HBM bytes per iteration at 1,048,576 x 10,112, K = 128, bf16 y, f32 x:
//   y read twice          2 x 21.2 GB = 42.4 GB
//   x read, x_new written 2 x 0.54 GB
//   x_new read (stats)    >= 0.54 GB (once per N tile when L2 misses)
//   partials              128 chunks x 5.2 MB, written and read: 1.3 GB
//   total                 ~45 GB, ~13.5 ms at 3.35 TB/s
// against ~22 GB (~6.7 ms) for a fused single pass. d and ddt (2.6 MB,
// 32 KB) are re-read by every block but from L2. mu_dense_tma.cu moves
// ~44 GB for bf16 data (xc in bf16 and 8 chunks of partials).

#include "nmf_common.cuh"

namespace {

// Both launches arrange their 8 warps as 4 (rows) x 2 (cols) of 32 x 64.
constexpr int BM = 128;        // rows per block of the x update
constexpr int BN = 128;        // columns per block of the statistics pass

// Launch 1: the x update of one 128-row stripe.
template <typename T, typename X>
__global__ void __launch_bounds__(THREADS)
    x_update_kernel(const T* __restrict__ y, const X* __restrict__ x,
                    const T* __restrict__ d, const float* __restrict__ ddt,
                    float eps, int M, int N, int K, int inner,
                    X* __restrict__ x_new, bool y_vec, bool d_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;
  const long long row0 = (long long)blockIdx.x * BM;

  // num_x = y d^T over the whole width, in f32, through two buffers of
  // (y tile, d tile).
  float num[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) num[mt][nt][i] = 0.f;
  constexpr int STAGE = (BM + KP) * LDT;
  Stage<T, BM, BK> ys;
  Stage<T, KP, BK> ds;
  ys.load(y, N, row0, M, 0, N, y_vec);
  ds.load(d, N, 0, K, 0, N, d_vec);
  ys.store(smem, LDT);
  ds.store(smem + BM * LDT, LDT);
  __syncthreads();
  const int n_stages = (N + BK - 1) / BK;
  for (int s = 0; s < n_stages; ++s) {
    const T* As = smem + (s & 1) * STAGE;
    const bool more = s + 1 < n_stages;
    if (more) {
      ys.load(y, N, row0, M, (long long)(s + 1) * BK, N, y_vec);
      ds.load(d, N, 0, K, (long long)(s + 1) * BK, N, d_vec);
    }
    stage_mma<T, false, false>(num, As, LDT, As + BM * LDT, LDT, wr, wc,
                               lane);
    if (more) {
      T* next = smem + ((s + 1) & 1) * STAGE;
      ys.store(next, LDT);
      ds.store(next + BM * LDT, LDT);
    }
    __syncthreads();
  }

  // Refinements: x_f <- x_f * num / (cdt(x_f) cdt(ddt) + eps), with ddt
  // resident in shared memory.
  T* Xs = smem;
  T* Ds = smem + BM * LDR;
  load_tile<T, float, KP, KP>(Ds, LDR, ddt, K, K, K);
  float xf[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = row0 + wr + frag_row(mt, i, lane);
        const int c = wc + frag_col(nt, i, lane);
        xf[mt][nt][i] = (r < M && c < K) ? to_f32(x[r * K + c]) : 0.f;
      }
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          Xs[(wr + frag_row(mt, i, lane)) * LDR + wc + frag_col(nt, i, lane)] =
              from_f32<T>(xf[mt][nt][i]);
    __syncthreads();
    // One 8-column slab at a time keeps only 8 denominator registers live
    // beside num and xf.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float den[2][1][4] = {};
#pragma unroll
      for (int k0 = 0; k0 < KP; k0 += 16)
        WarpMma<T, false, true>::template run<1>(den, Xs, LDR, Ds, LDR, k0,
                                                 wr, wc + 8 * nt, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = wc + frag_col(nt, i, lane);
          // Columns past K stay exactly 0 (0/eps would be NaN at eps = 0).
          xf[mt][nt][i] = c < K ? xf[mt][nt][i] * num[mt][nt][i] /
                                      (den[mt][0][i] + eps)
                                : 0.f;
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long r = row0 + wr + frag_row(mt, i, lane);
        const int c = wc + frag_col(nt, i, lane);
        if (r < M && c < K) x_new[r * K + c] = cvt<X>(xf[mt][nt][i]);
      }
}

// Launch 2: per-chunk partials. Block (j, c) with j < n_tiles writes
// x_new[chunk c]^T y[chunk c, tile j]; block (n_tiles, c) writes
// x_new[chunk c]^T x_new[chunk c]. Partial c is laid out as
// [numd (K x N) | gram (K x K)], stride S = K N + K K.
template <typename T, typename X>
__global__ void __launch_bounds__(THREADS)
    stats_kernel(const T* __restrict__ y, const X* __restrict__ x_new,
                 int M, int N, int K, int chunk_rows,
                 float* __restrict__ part, bool y_vec, bool x_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr = (warp & 3) * 32, wc = (warp >> 2) * 64;
  const int n_tiles = (N + BN - 1) / BN;
  const bool gram = blockIdx.x == n_tiles;
  const long long n0 = (long long)blockIdx.x * BN;
  const long long r_begin = (long long)blockIdx.y * chunk_rows;
  const long long r_end = min(r_begin + chunk_rows, (long long)M);

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // Two buffers of (x_new rows, y rows), both row-major BK x 128: A is
  // read as x_new^T (A_KM) and B as the rows themselves (B_KN). The gram
  // block multiplies the x_new tile by itself.
  constexpr int STAGE = 2 * BK * LDR;
  Stage<X, BK, KP> xs;
  Stage<T, BK, BN> ys;
  xs.load(x_new, K, r_begin, r_end, 0, K, x_vec);
  if (!gram) ys.load(y, N, r_begin, r_end, n0, N, y_vec);
  xs.store(smem, LDR);
  if (!gram) ys.store(smem + BK * LDR, LDR);
  __syncthreads();
  const int n_stages = (int)((r_end - r_begin + BK - 1) / BK);
  for (int s = 0; s < n_stages; ++s) {
    const T* As = smem + (s & 1) * STAGE;
    const bool more = s + 1 < n_stages;
    const long long r_next = r_begin + (long long)(s + 1) * BK;
    if (more) {
      xs.load(x_new, K, r_next, r_end, 0, K, x_vec);
      if (!gram) ys.load(y, N, r_next, r_end, n0, N, y_vec);
    }
    stage_mma<T, true, true>(acc, As, LDR, gram ? As : As + BK * LDR, LDR,
                             wr, wc, lane);
    if (more) {
      T* next = smem + ((s + 1) & 1) * STAGE;
      xs.store(next, LDR);
      if (!gram) ys.store(next + BK * LDR, LDR);
    }
    __syncthreads();
  }

  const long long S = (long long)K * N + (long long)K * K;
  float* out = part + (long long)blockIdx.y * S;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = wr + frag_row(mt, i, lane);
        const int c = wc + frag_col(nt, i, lane);
        if (kr >= K) continue;
        if (gram) {
          if (c < K) out[(long long)K * N + kr * K + c] = acc[mt][nt][i];
        } else if (n0 + c < N) {
          out[(long long)kr * N + n0 + c] = acc[mt][nt][i];
        }
      }
}

template <typename T, typename X>
int launch(const void* y, const void* x, const void* d, const void* ddt,
           float eps, int M, int N, int K, int inner, int chunk_rows,
           void* x_new, void* part, void* out, cudaStream_t stream) {
  cudaError_t err;
  const size_t smem1 = 2 * (size_t)BM * LDR * sizeof(T);
  static_assert(2 * BM * LDR >= 2 * (BM + KP) * LDT, "launch 1 smem");
  err = cudaFuncSetAttribute(x_update_kernel<T, X>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return (int)err;
  x_update_kernel<T, X><<<(M + BM - 1) / BM, THREADS, smem1, stream>>>(
      static_cast<const T*>(y), static_cast<const X*>(x),
      static_cast<const T*>(d), static_cast<const float*>(ddt), eps, M, N, K,
      inner, static_cast<X*>(x_new), rows_aligned<T>(y, N),
      rows_aligned<T>(d, N));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunks = (M + chunk_rows - 1) / chunk_rows;
  const dim3 grid2((N + BN - 1) / BN + 1, chunks);
  const size_t smem2 = 2 * 2 * (size_t)BK * LDR * sizeof(T);
  err = cudaFuncSetAttribute(stats_kernel<T, X>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<T, X><<<grid2, THREADS, smem2, stream>>>(
      static_cast<const T*>(y), static_cast<const X*>(x_new), M, N, K,
      chunk_rows, static_cast<float*>(part), rows_aligned<T>(y, N),
      rows_aligned<X>(x_new, K));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long S = (long long)K * N + (long long)K * K;
  return launch_reduce(static_cast<const float*>(part), S, chunks,
                       static_cast<float*>(out), stream);
}

}  // namespace

// The C interface, loaded with ctypes. y_bf16 / x_bf16 select the compute
// dtype (bf16 or f32) and x's storage dtype (bf16 or f32; x_bf16 requires
// y_bf16). d has y's dtype; ddt is (K, K) f32. part holds chunks x S f32,
// out S f32 = [numd (K x N) | gram (K x K)], x_new (M, K) in x's dtype.
// Returns 0 or the first non-zero cudaError_t of the launches.
extern "C" int mu_stats_dense_launch(int y_bf16, int x_bf16, const void* y,
                                     const void* x, const void* d,
                                     const void* ddt, float eps, int M, int N,
                                     int K, int inner, int chunk_rows,
                                     void* x_new, void* part, void* out,
                                     void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > KP || inner < 1 || chunk_rows < 1 ||
      (x_bf16 && !y_bf16))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_bf16 && x_bf16)
    return launch<bf16, bf16>(y, x, d, ddt, eps, M, N, K, inner, chunk_rows,
                              x_new, part, out, s);
  if (y_bf16)
    return launch<bf16, float>(y, x, d, ddt, eps, M, N, K, inner, chunk_rows,
                               x_new, part, out, s);
  return launch<float, float>(y, x, d, ddt, eps, M, N, K, inner, chunk_rows,
                              x_new, part, out, s);
}
