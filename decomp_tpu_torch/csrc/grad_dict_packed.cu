// The masked dictionary gradient on f32 data with a bit-packed 0/1 mask,
// on Hopper (sm_90a): every f32 product as bf16x6 limb products on wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_lasso.py:225
// masked_grad_dict (pallas_call :243, body _grad_dict_kernel :201-218) for
// f32 data and a 0/1 mask. Given my = mask * y (M, N) f32, the mask as bits
// (M, W) int32 (bit j of word w in row r is mask[r, 32 w + j]; W =
// ceil(N / 32) rounded up to a multiple of 4, pad bits 0), x (M, K) f32,
// 1 <= K <= 128, and d (K, N) as its three bf16 limbs, it returns
//   G = x^T (f32(mask) (x d) - my)                              (K, N) f32
// at the TPU kernel's f32 quantisation points: both products at the TPU's
// Precision.HIGHEST (bf16x6 there, and here); the residual E = f32(mask) R
// - my formed in f32 with round-to-nearest operations and not rounded
// further (R - my where the bit is set, -my where it is clear).
//
// What bounds it on an H100. 12 bf16 passes of 2 MNK operations (two f32
// products, six limb products each): at 100,000 x 1,024, K = 128, 3.15e11
// operations, 0.318 ms at 989 TFLOP/s, against ~0.48 GB (my 409.6 MB, the
// bits 12.8 MB, x 51.2 MB, d and G: ~0.14 ms at 3.35 TB/s): bound by
// operations. G = x^T E has the shape of dense KL's statistics pass, so it
// is that pass of wgmma_chain.cuh (Pass::GradDict) with E formed as
// lasso_grad_packed.cu forms it. Three launches:
//   1. split_rows: x's limbs xc (M x 3 KT bf16, row m = [limb 0 of x[m] |
//      limb 1 | limb 2], each KT wide, zero past K; split_bf16x3's
//      round-to-nearest limbs), one thread per 8 features of a row;
//   2. grad_dict_stats: a grid of (128-column N tile) x (row chunk). The
//      tile's d limbs are resident as d_tile^T (128 x KT, by TMA); a
//      producer thread streams xc, my (four 32 x 32 boxes read at
//      transposed positions) and the stage's 32 rows' four mask words of
//      the tile (a 32 x 4 int32 box), 32 rows a stage: R'^T = d_tile^T
//      x_s^T, E^T = bits R'^T - my_s^T, G^T += E^T x_s. Each chunk writes
//      its partial as (K, N);
//   3. the fixed-order reduction of nmf_common.cuh over the partials.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, pad bits are 0, and E is 0 outside the matrix and the chunk. K <= 64
// takes a KT = 64 instance.
//
// The wrapper (ops/cuda_dl.py) gives d's limbs as one (N, 3 KT) bf16 array
// (cuda_mu.column_limbs, made once per call: d changes every outer
// iteration), the chunks from the shape alone (cuda_mu.kl_packed_block_rows)
// and my with 16-byte-aligned rows (a padded copy where N % 4 != 0).

#include "wgmma_chain.cuh"

namespace {

template <int KT>
__global__ void __launch_bounds__(THREADS)
    split_rows(const float* __restrict__ x, int M, int K,
               bf16* __restrict__ xc) {
  constexpr int G = KT / 8;   // groups of 8 features per row
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)M * G) return;
  const long long r = e / G;
  const int c0 = (int)(e % G) * 8;
  float v[8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    v[u] = c0 + u < K ? __ldg(x + r * K + c0 + u) : 0.f;
  uint32_t w[3][4];
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    uint32_t f[3];
    split_pair(v[2 * pp], v[2 * pp + 1], f);
#pragma unroll
    for (int l = 0; l < 3; ++l) w[l][pp] = f[l];
  }
#pragma unroll
  for (int l = 0; l < 3; ++l)
    *reinterpret_cast<uint4*>(xc + r * (3 * KT) + l * KT + c0) =
        make_uint4(w[l][0], w[l][1], w[l][2], w[l][3]);
}

template <int KT>
__global__ void __launch_bounds__(kThreads, 1)
    grad_dict_stats(const __grid_constant__ CUtensorMap tm_my,
                    const __grid_constant__ CUtensorMap tm_xc,
                    const __grid_constant__ CUtensorMap tm_d,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const Params p) {
  chain_pass<KT, Pass::GradDict>(tm_my, tm_xc, tm_d, p, &tm_mask);
}

template <int KT>
int split(const float* x, int M, int K, bf16* xc, cudaStream_t stream) {
  const long long n = (long long)M * (KT / 8);
  split_rows<KT><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0,
                   stream>>>(x, M, K, xc);
  return (int)cudaGetLastError();
}

struct Args {
  const void *my, *mask, *x, *dl;
  int ld_my, words, M, N, K, chunk_rows;
  void *xc, *part, *out;
  cudaStream_t stream;
};

template <int KT>
int launch(const Args& a) {
  using C = Cfg<KT, Pass::GradDict>;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap my, xc, dl, mask;
  const bool ok =
      make_map(&my, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.my, a.N, a.M,
               a.ld_my, 32, SS, SW) &&
      make_map(&xc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.xc, 3 * KT, a.M,
               3 * KT, 64, SS, SW) &&
      make_map(&dl, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.dl, 3 * KT, a.N,
               3 * KT, 64, BR, SW) &&
      make_map(&mask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.mask, a.words, a.M,
               a.words, 4, SS, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!ok) return (int)cudaErrorInvalidValue;
  int rc = split<KT>(static_cast<const float*>(a.x), a.M, a.K,
                     static_cast<bf16*>(a.xc), a.stream);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      grad_dict_stats<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.M, a.N, a.K, 0.f, nullptr, nullptr, nullptr, nullptr,
                 a.chunk_rows, static_cast<float*>(a.part)};
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  grad_dict_stats<KT><<<dim3((a.N + BR - 1) / BR, chunks), kThreads,
                        C::kSmem, a.stream>>>(my, xc, dl, mask, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       (long long)a.K * a.N, chunks,
                       static_cast<float*>(a.out), a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. my (M x N f32, row stride ld_my, a
// multiple of 4); mask the packed bits (M x words int32, words % 4 == 0,
// 16-byte aligned); x (M x K) f32; dl d's limbs (N x 3 kt bf16: row n =
// [limb 0 | limb 1 | limb 2] of d[:, n], each kt wide, zero past K); kt the
// rank tile, 64 (K <= 64) or 128 (K <= 128); chunk_rows a multiple of 32;
// xc (M x 3 kt) bf16 scratch; part chunks x K N f32 scratch with chunks =
// ceil(M / chunk_rows); out K N f32 = G. Returns 0 or the first non-zero
// cudaError_t.
extern "C" int grad_dict_packed_launch(int kt, const void* my, int ld_my,
                                       const void* mask, int words,
                                       const void* x, const void* dl, int M,
                                       int N, int K, int chunk_rows,
                                       void* xc, void* part, void* out,
                                       void* stream) {
  const Args a{my, mask, x, dl, ld_my, words, M, N, K, chunk_rows,
               xc, part, out, static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || K < 1 || K > kt || (kt != 64 && kt != 128) ||
      chunk_rows < 1 || chunk_rows % SS != 0 || ld_my < N ||
      ld_my % 4 != 0 || words % 4 != 0 || words * 32 < N)
    return (int)cudaErrorInvalidValue;
  return kt == 64 ? launch<64>(a) : launch<128>(a);
}

// x's limbs alone, as launch 1 writes them (xc, M x 3 kt bf16), so that a
// check can hold the layout against cuda_mu.column_limbs(x^T, kt).
extern "C" int grad_dict_split_launch(int kt, const void* x, int M, int K,
                                      void* xc, void* stream) {
  if (M < 1 || K < 1 || K > kt || (kt != 64 && kt != 128))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  bf16* out = static_cast<bf16*>(xc);
  return kt == 64 ? split<64>(xf, M, K, out, s) : split<128>(xf, M, K, out, s);
}
