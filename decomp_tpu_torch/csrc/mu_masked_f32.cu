// Masked multiplicative-update NMF statistics on f32 data with a 0/1 mask
// as bits, on Hopper (sm_90a): every f32 product as bf16x6 limb products
// on wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:522
// mu_stats_masked (pallas_call :540, body _masked_kernel :222-273) for f32
// data and a 0/1 mask, where that kernel runs its products at
// Precision.HIGHEST (pallas_mu.py:67-75); bf16 data run
// mu_masked_packed.cu, weighted masks mu_kl_stats.cu. Given my = mask * y
// (M, N) f32, the mask as bits (M, W) int32 (bit j of word w in row r is
// mask[r, 32 w + j]; W = ceil(N / 32) rounded up to a multiple of 4, pad
// bits 0), x (M, K) f32, d (K, N) f32, 1 <= K <= 128, it returns
//   R1 = x d,            E1 = f32(mask) R1
//   x_new = x * (my d^T) / (E1 d^T + eps)                        (M, K) f32
//   R2 = x_new d,        E2 = f32(mask) R2
//   numd = x_new^T my,   dend = x_new^T E2                       (K, N) f32
// the function of MU_MASKED in mu_kl_stats.cu at its f32 quantisation
// points (cdt = f32: E is not rounded; x_new is formed from the f32 x).
//
// Products: each f32 product as the six bf16 limb products of the TPU's
// Precision.HIGHEST, each stage's big chain summed in its own registers
// and added with round-to-nearest f32 adds, no TF32 (wgmma_chain.cuh). E =
// f32(mask) R is formed in f32, so no product has the mask as an operand.
//
// What bounds it on an H100. Six f32 products of 2 MNK, six limb products
// each: 72 MNK bf16 operations. At 100,000 x 1,000, K = 50 (config 4),
// 3.6e11 operations, 0.364 ms at 989 TFLOP/s, against ~0.45 GB (my 400 MB
// read once, the bits 12.8 MB, x, x_new, d and the statistics: 0.135 ms at
// 3.35 TB/s): bound by operations. Full-f32 FMAs would take 0.896 ms (12
// MNK at 67 TFLOP/s); mu_kl_stats.cu's f32 path runs them so, on 64-row
// stripes with no copy ring, and reads the mask dense, 4 bytes an entry,
// in both its passes. Here the products run on wgmma from a TMA ring and
// the mask is read as its bits (a 32nd of the bytes). K <= 64 takes a KT =
// 64 instance: config 4's K = 50 issues 28% more tensor work than counted.
//
// Schedule: five launches, the chain of wgmma_chain.cuh (a producer
// warpgroup's TMA ring, two consumer warpgroups on wgmma, setmaxnreg). A
// consumer thread holds one accumulator (KC x 32 f32) beside R's chains;
// two accumulators and R do not fit its 232 registers at KT = 128, so each
// pass forms one of the four sums:
//   1. split_cols: d's limbs dl (N x 3 KT bf16, column_limbs' layout);
//   2. num (Pass::MaskNum): a persistent block per SM walks 128-row
//      stripes; per 32-column stage my (one 128 x 32 box) is split into
//      limbs in registers and acc += my_s dl_s^T; num is written into
//      x_new's rows, where launch 3 reads it;
//   3. x update (Pass::MaskXUpdate): persistent stripes; the stripe's x
//      limbs resident (split by the threads), dl and the stripe's mask
//      words (a 128 x 4 word box a stage) streamed, no my: R1 = x dl_s^T,
//      E1 = bits R1, acc += E1 dl_s. The epilogue forms x_new = x num /
//      (acc + eps) from the f32 x and num and writes x_new over num and
//      its limbs xc (M x 3 KT bf16, stored by TMA from the resident rows);
//   4. statistics (Pass::MaskNumd and Pass::MaskDend, one launch): a grid
//      of (numd's 128-column N tiles, then dend's) x (row chunk), each
//      kind its own instance of the chain (one instance holding both
//      behind a branch spilled). numd's tiles stream xc and my (four 32 x
//      32 boxes read at transposed positions): numd^T += my_s^T x_new_s.
//      dend's keep the tile's d limbs resident and stream xc and the
//      stage's mask words: R2'^T = d_tile^T x_new_s^T, E2^T = bits R2'^T,
//      dend^T += E2^T x_new_s. Each chunk writes its partial [numd | dend];
//   5. the fixed-order reduction of nmf_common.cuh over the chunks.
// my and the bits are read twice, num once more (M x K), nothing M x N is
// written. No float atomics: a rerun gives the same bits. Ragged M, N and
// K are masked: TMA zero-fills boxes outside the tensors, the limbs are
// zero past K, pad bits are 0, E is 0 outside the matrix and the chunk, so
// eps = 0 gives no NaN there.
//
// The wrapper (ops/cuda_mu.py) gives my with 16-byte-aligned rows (a
// padded copy where N % 4 != 0), the bits 16-byte aligned, the chunks from
// the shape alone (cuda_mu.masked_f32_block_rows) and one workspace for d's
// limbs, xc and the partials.

#include "wgmma_chain.cuh"

namespace {

// The passes under names of their own (the profiler tells them apart).
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    masked_num(const __grid_constant__ CUtensorMap tm_my,
               const __grid_constant__ CUtensorMap tm_d, const Params p) {
  chain_pass<KT, Pass::MaskNum>(tm_my, tm_d, tm_d, p);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    masked_x_update(const __grid_constant__ CUtensorMap tm_d,
                    const __grid_constant__ CUtensorMap tm_xc,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const Params p) {
  chain_pass<KT, Pass::MaskXUpdate>(tm_d, tm_d, tm_xc, p, &tm_mask);
}

// numd's tiles at x indices below p.tiles, dend's after them: two
// instances of the chain, a block running one.
template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    masked_stats(const __grid_constant__ CUtensorMap tm_my,
                 const __grid_constant__ CUtensorMap tm_xc,
                 const __grid_constant__ CUtensorMap tm_d,
                 const __grid_constant__ CUtensorMap tm_mask,
                 const Params p) {
  if ((int)blockIdx.x < p.tiles)
    chain_pass<KT, Pass::MaskNumd>(tm_my, tm_xc, tm_xc, p);
  else
    chain_pass<KT, Pass::MaskDend>(tm_my, tm_xc, tm_d, p, &tm_mask);
}

template <int KT>
constexpr size_t stats_smem() {
  return Cfg<KT, Pass::MaskNumd>::kSmem > Cfg<KT, Pass::MaskDend>::kSmem
             ? Cfg<KT, Pass::MaskNumd>::kSmem
             : Cfg<KT, Pass::MaskDend>::kSmem;
}

struct Args {
  const void *my, *mask, *x, *d;
  int ld_my, words;
  float eps;
  int M, N, K, chunk_rows;
  void *dl, *xc, *part, *x_new, *out;
  cudaStream_t stream;
};

// Bytes of a workspace section, in whole KB (TMA reads tensors whose
// rows start 16-byte aligned).
constexpr long long section(long long bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

// The workspace: d's limbs (N x 3 kt bf16), xc (M x 3 kt bf16), then the
// partials (chunks x 2 K N f32), each section KB-aligned.
long long workspace_bytes(int kt, int M, int N, int K, int chunk_rows) {
  const long long chunks = (M + chunk_rows - 1) / chunk_rows;
  return section(2LL * N * 3 * kt) + section(2LL * M * 3 * kt) +
         section(4LL * chunks * 2 * K * N);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int KT>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapDataType F32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  constexpr CUtensorMapDataType I32 = CU_TENSOR_MAP_DATA_TYPE_INT32;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr CUtensorMapSwizzle NONE = CU_TENSOR_MAP_SWIZZLE_NONE;
  CUtensorMap my1, dl1, xc1, mk1, my2, xc2, dl2, mk2;
  const bool ok =
      make_map(&my1, F32, 4, a.my, a.N, a.M, a.ld_my, SS, BR, SW) &&
      make_map(&dl1, BF, 2, a.dl, 3 * KT, a.N, 3 * KT, 64, SS, SW) &&
      make_map(&xc1, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, 64, SW) &&
      make_map(&mk1, I32, 4, a.mask, a.words, a.M, a.words, 4, BR, NONE) &&
      make_map(&my2, F32, 4, a.my, a.N, a.M, a.ld_my, 32, SS, SW) &&
      make_map(&xc2, BF, 2, a.xc, 3 * KT, a.M, 3 * KT, 64, SS, SW) &&
      make_map(&dl2, BF, 2, a.dl, 3 * KT, a.N, 3 * KT, 64, BR, SW) &&
      make_map(&mk2, I32, 4, a.mask, a.words, a.M, a.words, 4, SS, NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = prepare(masked_num<KT>, Cfg<KT, Pass::MaskNum>::kSmem);
  if (err == cudaSuccess)
    err = prepare(masked_x_update<KT>, Cfg<KT, Pass::MaskXUpdate>::kSmem);
  if (err == cudaSuccess) err = prepare(masked_stats<KT>, stats_smem<KT>());
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
  p.tiles = tiles;

  int rc = split_cols_launch<KT>(a.d, a.K, a.N, a.dl, a.stream);
  if (rc != 0) return rc;
  const int stripes = (a.M + BR - 1) / BR;
  const int persistent = stripes < sms ? stripes : sms;
  masked_num<KT><<<persistent, kThreads, Cfg<KT, Pass::MaskNum>::kSmem,
                   a.stream>>>(my1, dl1, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  masked_x_update<KT><<<persistent, kThreads,
                        Cfg<KT, Pass::MaskXUpdate>::kSmem, a.stream>>>(
      dl1, xc1, mk1, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  masked_stats<KT><<<dim3(2 * tiles, chunks), kThreads, stats_smem<KT>(),
                     a.stream>>>(
      my2, xc2, dl2, mk2, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       2LL * a.K * a.N, chunks, static_cast<float*>(a.out),
                       a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N f32, row stride ld_my, a
// multiple of 4); mask the packed bits (M x words int32, words % 4 == 0,
// 16-byte aligned); x and x_new (M x K) f32; d (K x N) f32; kt the rank
// tile, 64 (K <= 64) or 128 (K <= 128); chunk_rows a multiple of 32; ws a
// 16-byte-aligned workspace of ws_bytes >= workspace_bytes(kt, M, N, K,
// chunk_rows) bytes (ops/cuda_mu.py _masked_f32_workspace); out 2 K N f32
// = [numd | dend]. Returns 0 or the first non-zero cudaError_t.
extern "C" int mu_masked_f32_launch(int kt, const void* my, int ld_my,
                                    const void* mask, int words,
                                    const void* x, const void* d, float eps,
                                    int M, int N, int K, int chunk_rows,
                                    void* ws, long long ws_bytes,
                                    void* x_new, void* out, void* stream) {
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      chunk_rows < 1 || chunk_rows % SS != 0 || ld_my < N ||
      ld_my % 4 != 0 || words % 4 != 0 || words * 32 < N ||
      reinterpret_cast<uintptr_t>(mask) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      ws_bytes < workspace_bytes(kt, M, N, K, chunk_rows))
    return (int)cudaErrorInvalidValue;
  unsigned char* w = static_cast<unsigned char*>(ws);
  unsigned char* xc = w + section(2LL * N * 3 * kt);
  unsigned char* part = xc + section(2LL * M * 3 * kt);
  const Args a{my, mask, x, d, ld_my, words, eps, M, N, K, chunk_rows,
               w, xc, part, x_new, out, static_cast<cudaStream_t>(stream)};
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}
