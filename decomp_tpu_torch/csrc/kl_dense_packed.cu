// Dense KL-divergence NMF statistics on f32 data, on Hopper (sm_90a):
// every f32 product as bf16x6 limb products on wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:603
// kl_stats_dense (pallas_call :621, body _kl_dense_kernel :276) for f32
// data. Given my (M, N) f32, x (M, K) f32, 1 <= K <= 128, d (K, N) as its
// three bf16 limbs and dsum, d's f32 row sums (formed outside, as
// pallas_mu.py:618 forms them), it returns
//   E1 = my / (x d + eps)
//   x_new = x * (E1 d^T) / (dsum + eps)                          (M, K) f32
//   E2 = my / (x_new d + eps)
//   numd = x_new^T E2                                            (K, N) f32
//   xsum = the column sums of x_new                              (1, K) f32
// the function of KL_DENSE in mu_kl_stats.cu at its f32 quantisation
// points (cdt = f32: E is not rounded; x_new is formed from the f32 x).
//
// Products: each f32 product as the six bf16 limb products of the TPU's
// Precision.HIGHEST, the big chain summed per 64-deep chunk and added with
// round-to-nearest f32 adds, no TF32 (wgmma_chain.cuh).
//
// What bounds it on an H100. 24 bf16 passes of 2 MNK (four f32 products,
// six limb products each): at 100,000 x 1,024, K = 128, 6.3e11 operations,
// 0.636 ms at 989 TFLOP/s, against ~0.5 GB (my read twice, x, x_new and
// its limbs, the partials: ~0.16 ms at 3.35 TB/s): bound by operations.
// Both passes are lasso_grad_packed.cu's chain (R = A B, E from R and my
// in registers, acc += E B), the template chain_pass of wgmma_chain.cuh
// (a producer warpgroup's TMA ring, two consumer warpgroups on wgmma),
// with E = my / (R + eps) by div_rn there: IEEE-rounded wherever the
// quotient is normal, with no branch.
//
// Schedule: four launches.
//   1. x update: a persistent block per SM walks 128-row stripes. The
//      resident operand is the stripe's x, split by the threads; the
//      streamed one d's limbs, 32 columns a stage (my as one 128 x 32
//      box). The epilogue forms x_new from the f32 x read from global
//      memory (the limbs give x back only to 2^-24 |x|) and writes x_new,
//      its limbs xc (M x 3 KT bf16: written into the warpgroup's resident
//      rows, whose layout is xc's boxes, and stored by TMA) and the column
//      sums of x_new over each warp's 16 rows (no barrier between the
//      warps).
//   2. statistics: a grid of (128-column N tile) x (row chunk). The
//      resident operand is the tile's d limbs taken as d_tile^T (128 x KT,
//      by TMA); the streamed one xc, 32 rows a stage (my as four 32 x 32
//      boxes, read at transposed positions): R'^T = d_tile^T x_new_s^T,
//      E2^T, numd^T += E2^T x_new_s. Each chunk writes its partial as
//      (K, N).
//   3. the fixed-order reductions of nmf_common.cuh over the chunks'
//      partials, and over the 16-row column sums.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, E is 0 outside the matrix and the chunk. K <= 64 takes a KT = 64
// instance.
//
// The wrapper (ops/cuda_mu.py) gives d's limbs as one (N, 3 KT) bf16
// array, row n = [limb 0 of d[:, n] | limb 1 | limb 2], each KT wide with
// zeros past K (cuda_mu.column_limbs, the layout of
// cuda_lasso.grad_limbs), and my with 16-byte-aligned rows (a padded copy
// where N % 4 != 0). The tensor maps are encoded with
// cuTensorMapEncodeTiled through the runtime's entry-point query
// (sm90_common.cuh), so the library needs no -lcuda.

#include "wgmma_chain.cuh"

namespace {

// The two passes under names of their own (the profiler tells them apart).
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    dense_x_update(const __grid_constant__ CUtensorMap tm_my,
                   const __grid_constant__ CUtensorMap tm_d,
                   const __grid_constant__ CUtensorMap tm_xc,
                   const Params p) {
  chain_pass<KT, Pass::XUpdate>(tm_my, tm_d, tm_xc, p);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    dense_stats(const __grid_constant__ CUtensorMap tm_my,
                const __grid_constant__ CUtensorMap tm_xc,
                const __grid_constant__ CUtensorMap tm_d,
                const Params p) {
  chain_pass<KT, Pass::KlStats>(tm_my, tm_xc, tm_d, p);
}

struct Args {
  const void *my, *x, *dl, *dsum;
  int ld_my;
  float eps;
  int M, N, K, chunk_rows;
  void *x_new, *xc, *xpart, *xsum, *part, *out;
  cudaStream_t stream;
};

template <int KT, typename Kernel>
cudaError_t run_pass(Kernel kernel, const CUtensorMap& my,
                     const CUtensorMap& b, const CUtensorMap& r, dim3 grid,
                     const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Cfg<KT, Pass::XUpdate>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(my, b, r, p);
  return cudaGetLastError();
}

template <int KT>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap my1, dl1, xc1, my2, xc2, dl2;
  const bool ok =
      make_map(&my1, F32, 4, a.my, a.N, a.M, a.ld_my, SS, BR, SW) &&
      make_map(&dl1, BF, 2, a.dl, 3 * KT, a.N, 3 * KT, 64, SS, SW) &&
      make_map(&xc1, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, 64, SW) &&
      make_map(&my2, F32, 4, a.my, a.N, a.M, a.ld_my, 32, SS, SW) &&
      make_map(&xc2, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, SS, SW) &&
      make_map(&dl2, BF, 2, a.dl, 3 * KT, a.N, 3 * KT, 64, BR, SW);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  Params p{a.M, a.N, a.K, a.eps,
           static_cast<const float*>(a.x), static_cast<const float*>(a.dsum),
           static_cast<float*>(a.x_new), static_cast<float*>(a.xpart),
           a.chunk_rows,
           static_cast<float*>(a.part)};
  const int stripes = (a.M + BR - 1) / BR;
  err = run_pass<KT>(dense_x_update<KT>, my1, dl1, xc1,
                     stripes < sms ? stripes : sms, p, a.stream);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  err = run_pass<KT>(dense_stats<KT>, my2, xc2, dl2,
                     dim3((a.N + BR - 1) / BR, chunks), p, a.stream);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_reduce(static_cast<const float*>(a.part),
                               (long long)a.K * a.N, chunks,
                               static_cast<float*>(a.out), a.stream);
  if (rc != 0) return rc;
  return launch_reduce_long(static_cast<const float*>(a.xpart), a.K,
                            stripes * kConsumerWarps,
                            static_cast<float*>(a.xsum), a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N f32, row stride ld_my, a
// multiple of 4); x and x_new (M x K) f32; dl d's limbs (N x 3 kt bf16: row
// n = [limb 0 | limb 1 | limb 2] of d[:, n], each kt wide, zero past K);
// dsum d's row sums (K) f32; kt the rank tile, 64 (K <= 64) or 128 (K <=
// 128); chunk_rows a multiple of 32; xc (M x 3 kt) bf16 scratch; xpart
// 8 ceil(M / 128) x K f32 scratch; xsum (K) f32; part chunks x K N f32
// scratch with chunks = ceil(M / chunk_rows); out K N f32 = numd. Returns 0
// or the first non-zero cudaError_t.
extern "C" int kl_dense_packed_launch(int kt, const void* my, int ld_my,
                                      const void* x, const void* dl,
                                      const void* dsum, float eps, int M,
                                      int N, int K, int chunk_rows,
                                      void* x_new, void* xc, void* xpart,
                                      void* xsum, void* part, void* out,
                                      void* stream) {
  const Args a{my, x, dl, dsum, ld_my, eps, M, N, K, chunk_rows,
               x_new, xc, xpart, xsum, part, out,
               static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      chunk_rows < 1 || chunk_rows % SS != 0 || ld_my < N || ld_my % 4 != 0)
    return (int)cudaErrorInvalidValue;
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}
