// Dense multiplicative-update NMF statistics on f32 data, on Hopper
// (sm_90a): every f32 product as bf16x6 limb products on wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:438
// mu_stats_dense (pallas_call :459, body _dense_kernel :160) for f32 data,
// where that kernel runs its products at Precision.HIGHEST
// (pallas_mu.py:67-75); bf16 data run mu_dense_tma.cu. Given y (M, N) f32,
// x (M, K) f32, d (K, N) f32, 1 <= K <= 128, and ddt = d d^T (K, K, f32;
// formed outside, as pallas_mu.py:453 forms it), it returns
//   x_new = x * (y d^T) / (x ddt + eps)   (inner_iter refinements that
//                                          reuse the numerator y d^T)
//   numd  = x_new^T y                                   (K, N) f32
//   gram  = x_new^T x_new                               (K, K) f32
// the function of mu_stats_dense.cu at its f32 quantisation points (the
// iterate stays f32 across refinements; the statistics use x_new in f32).
//
// Products: y d^T, x_new^T y and x_new^T x_new as the six bf16 limb
// products of the TPU's Precision.HIGHEST, each stage's big chain summed
// in its own registers and added with round-to-nearest f32 adds, no TF32
// (wgmma_chain.cuh). x ddt (128 x K by K x K a stripe and a refinement)
// stays full-f32 FMAs in the x update's epilogue.
//
// What bounds it on an H100. 24 MNK + 12 MK^2 bf16 operations (y d^T and
// x_new^T y at six limb products of 2 MNK each, gram at six of 2 MK^2):
// at 262,144 x 10,112, K = 128, 8.2e12 operations, 8.29 ms at 989
// TFLOP/s, against 10.9 GB (y 10.6 GB read once, x, x_new, d, numd: 3.24
// ms at 3.35 TB/s): bound by operations. Full-f32 FMAs would take 20.5 ms
// (4 MNK + 4 MK^2 at 67 TFLOP/s); mu_stats_dense.cu runs them so.
//
// Schedule: four launches, the chain of wgmma_chain.cuh (a producer
// warpgroup's TMA ring, two consumer warpgroups on wgmma, setmaxnreg):
//   1. split_cols: d's limbs dl (N x 3 KT bf16, row n = [limb 0 of d[:, n]
//      | limb 1 | limb 2], each KT wide, zero past K: the layout of
//      ops/cuda_mu.py column_limbs), one thread per 8 features of a
//      column;
//   2. x update (Pass::MuXUpdate), dense KL's x update without its first
//      product: a persistent block per SM walks 128-row stripes; per
//      32-column stage, y (one 128 x 32 box) is split into limbs in
//      registers and acc += y_s dl_s^T, dl_s streamed beside it. The
//      epilogue forms x_new from the f32 x read from global memory with
//      ddt resident in shared memory, then writes x_new and its limbs xc
//      (M x 3 KT bf16);
//   3. statistics (Pass::MuStats): a grid of (128-column N tile + the gram
//      tile) x (row chunk); xc streamed 32 rows a stage, y as four 32 x 32
//      boxes read at transposed positions: numd^T += y_s^T x_new_s, and in
//      the gram tile gram^T += x_new_s^T x_new_s with x_new_s^T's limbs
//      read from the stage's xc. Each chunk writes its partial (K N + K K);
//   4. the fixed-order reduction of nmf_common.cuh over the chunks.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, E is 0 outside the matrix and the chunk, x_new is 0 past K. K <= 64
// takes a KT = 64 instance.
//
// The wrapper (ops/cuda_mu.py) gives y with 16-byte-aligned rows (a padded
// copy where N % 4 != 0), the chunks from the shape alone
// (cuda_mu.dense_packed_block_rows) and one workspace for d's limbs, xc
// and the partials (at config 1's 1,000 x 500, K = 10, the four launches
// take ~0.04 ms of the card, and a call is paced by the host).

#include "wgmma_chain.cuh"

namespace {

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    mu_x_update(const __grid_constant__ CUtensorMap tm_y,
                const __grid_constant__ CUtensorMap tm_d, const Params p) {
  chain_pass<KT, Pass::MuXUpdate>(tm_y, tm_d, tm_d, p);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    mu_stats(const __grid_constant__ CUtensorMap tm_y,
             const __grid_constant__ CUtensorMap tm_xc, const Params p) {
  chain_pass<KT, Pass::MuStats>(tm_y, tm_xc, tm_xc, p);
}

struct Args {
  const void *y, *x, *d, *ddt;
  int ld_y;
  float eps;
  int M, N, K, inner, chunk_rows;
  void *dl, *x_new, *xc, *part, *out;
  cudaStream_t stream;
};

// Bytes of a workspace section, in whole KB (TMA reads tensors whose
// rows start 16-byte aligned).
constexpr long long section(long long bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// The workspace: d's limbs (N x 3 kt bf16), xc (M x 3 kt bf16), then the
// partials (chunks x (K N + K K) f32), each section KB-aligned.
long long workspace_bytes(int kt, int M, int N, int K, int chunk_rows) {
  const long long chunks = (M + chunk_rows - 1) / chunk_rows;
  return section(2LL * N * 3 * kt) + section(2LL * M * 3 * kt) +
         section(4LL * chunks * ((long long)K * N + (long long)K * K));
}

template <int KT, typename Kernel>
cudaError_t run_pass(Kernel kernel, const CUtensorMap& y,
                     const CUtensorMap& b, dim3 grid, const Params& p,
                     cudaStream_t stream) {
  constexpr size_t smem = Cfg<KT, Pass::MuXUpdate>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(y, b, p);
  return cudaGetLastError();
}

template <int KT>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap y1, dl1, y2, xc2;
  const bool ok =
      make_map(&y1, F32, 4, a.y, a.N, a.M, a.ld_y, SS, BR, SW) &&
      make_map(&dl1, BF, 2, a.dl, 3 * KT, a.N, 3 * KT, 64, SS, SW) &&
      make_map(&y2, F32, 4, a.y, a.N, a.M, a.ld_y, 32, SS, SW) &&
      make_map(&xc2, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, SS, SW);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const int tiles = (a.N + BR - 1) / BR;
  Params p{};
  p.M = a.M;
  p.N = a.N;
  p.K = a.K;
  p.eps = a.eps;
  p.x = static_cast<const float*>(a.x);
  p.x_new = static_cast<float*>(a.x_new);
  p.chunk_rows = a.chunk_rows;
  p.part = static_cast<float*>(a.part);
  p.ddt = static_cast<const float*>(a.ddt);
  p.inner = a.inner;
  p.xc = static_cast<bf16*>(a.xc);
  p.tiles = tiles;

  int rc = split_cols_launch<KT>(a.d, a.K, a.N, a.dl, a.stream);
  if (rc != 0) return rc;
  const int stripes = (a.M + BR - 1) / BR;
  err = run_pass<KT>(mu_x_update<KT>, y1, dl1, stripes < sms ? stripes : sms,
                     p, a.stream);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  err = run_pass<KT>(mu_stats<KT>, y2, xc2, dim3(tiles + 1, chunks), p,
                     a.stream);
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       (long long)a.K * a.N + (long long)a.K * a.K, chunks,
                       static_cast<float*>(a.out), a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. y (M x N f32, row stride ld_y, a
// multiple of 4); x and x_new (M x K) f32; d (K x N) f32; ddt (K x K) f32;
// kt the rank tile, 64 (K <= 64) or 128 (K <= 128); inner >= 1
// refinements; chunk_rows a multiple of 32; ws a 16-byte-aligned
// workspace of ws_bytes >= workspace_bytes(kt, M, N, K, chunk_rows) bytes
// (ops/cuda_mu.py _dense_packed_workspace); out K N + K K f32 = [numd |
// gram]. Returns 0 or the first non-zero cudaError_t.
extern "C" int mu_dense_packed_launch(int kt, const void* y, int ld_y,
                                      const void* x, const void* d,
                                      const void* ddt, float eps, int M,
                                      int N, int K, int inner,
                                      int chunk_rows, void* ws,
                                      long long ws_bytes, void* x_new,
                                      void* out, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      inner < 1 || chunk_rows < 1 || chunk_rows % SS != 0 || ld_y < N ||
      ld_y % 4 != 0 || reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      ws_bytes < workspace_bytes(kt, M, N, K, chunk_rows))
    return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  unsigned char* xc = w + section(2LL * N * 3 * kt);
  unsigned char* part = xc + section(2LL * M * 3 * kt);
  const Args a{y, x, d, ddt, ld_y, eps, M, N, K, inner, chunk_rows,
               w, x_new, xc, part, out, static_cast<cudaStream_t>(stream)};
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}

// d's limbs alone (launch 1 above), so that they can be held against
// cuda_mu.column_limbs: d (K x N) f32, dl (N x 3 kt) bf16.
extern "C" int mu_dense_packed_split(int kt, const void* d, int K, int N,
                                     void* dl, void* stream) {
  if (N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return kt == 64 ? split_cols_launch<64>(d, K, N, dl, s)
                  : split_cols_launch<128>(d, K, N, dl, s);
}
