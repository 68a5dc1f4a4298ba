// The masked dictionary gradient on Hopper (sm_90a), on wgmma: f32 data
// with every f32 product as bf16x6 limb products (L = 3), and bf16 data
// with each product one bf16 pass (L = 1); a 0/1 mask as packed bits, or a
// weighted mask as a dense tile of weights in the data's dtype.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_lasso.py:225
// masked_grad_dict (pallas_call :243, body _grad_dict_kernel :201-218).
// Given my = mask * y (M, N), the mask as bits (M, W) int32 (bit j of word
// w in row r is mask[r, 32 w + j]; W = ceil(N / 32) rounded up to a
// multiple of 4, pad bits 0) or as weights (M, N) in my's dtype, x (M, K),
// 1 <= K <= 128, and d (K, N) as its L bf16 limbs, it returns
//   G = x^T cdt(f32(mask) (x d) - f32(my))                      (K, N) f32
// at the TPU kernel's quantisation points, cdt the data's dtype: at f32
// both products at the TPU's Precision.HIGHEST (bf16x6 there, and here)
// and the residual E = f32(mask) R - my formed in f32 with round-to-nearest
// operations and not rounded further (R - my where the bit is set, -my
// where it is clear); at bf16 both products on bf16 operands summed in f32
// and E rounded to bf16 from the f32 residual (:208's .astype(d.dtype)).
//
// What bounds it on an H100, at 100,000 x 1,024, K = 128:
//   - f32: 12 bf16 passes of 2 MNK operations (two f32 products, six limb
//     products each), 3.15e11 operations, 0.318 ms at 989 TFLOP/s, against
//     ~0.48 GB (my 409.6 MB, the bits 12.8 MB, x 51.2 MB, d and G: ~0.14
//     ms at 3.35 TB/s): bound by operations; weighted, the f32 weights
//     for the bits make ~0.88 GB (0.26 ms), still below the operations;
//   - bf16: 2 passes, 5.2e10 operations, 0.053 ms, against 244 MB (my
//     204.8 MB, the bits 12.8 MB, x 25.6 MB, d 0.26 MB, G 0.5 MB: 0.073
//     ms): bound by bytes; weighted, 436 MB with the bf16 weights (0.130
//     ms).
// G = x^T E has the shape of dense KL's statistics pass, so it is that pass
// of wgmma_chain.cuh (Pass::GradDict, or Pass::GradDictW on weights) with E
// formed as lasso_grad_packed.cu forms it. Three launches at f32, two at
// bf16:
//   1. (f32 only) split_rows of sm90_common.cuh (shared with
//      grad_wide.cu): x's limbs xc (M x 3 KT bf16, row m = [limb 0 of x[m]
//      | limb 1 | limb 2], each KT wide, zero past K; split_bf16x3's
//      round-to-nearest limbs), one thread per 8 features of a row. bf16 x
//      is its own limb and is streamed as it is;
//   2. grad_dict_stats: a grid of (128-column N tile) x (row chunk). The
//      tile's d limbs are resident as d_tile^T (128 x L KT, by TMA); a
//      producer thread streams x's limbs, my (128-byte boxes of 32 f32 or
//      64 bf16 columns by 32 rows, read at transposed positions) and the
//      stage's 32 rows' four mask words of the tile (a 32 x 4 int32 box)
//      or its weights (boxes as my's), 32 rows a stage (a ring of 3 stages
//      at f32, K > 64, 2 weighted; 10 of 17 KB at bf16, which is bound by
//      bytes, 8 of 24 KB weighted): R'^T = d_tile^T x_s^T, E^T = bits (or
//      weights) R'^T - my_s^T, G^T += E^T x_s. Each chunk writes its
//      partial as (K, N);
//   3. the fixed-order reduction of nmf_common.cuh over the partials.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, pad bits are 0, and E is 0 outside the matrix and the chunk. K <= 64
// takes a KT = 64 instance.
//
// The wrapper (ops/cuda_dl.py) gives d's limbs as one (N, L KT) bf16 array
// (cuda_mu.column_limbs, made once per call: d changes every outer
// iteration), the chunks from the shape alone (cuda_mu.kl_packed_block_rows),
// my and the weights with 16-byte-aligned rows (a padded copy where N is
// not a multiple of 4 f32 or 8 bf16) and, at bf16, x likewise (a padded
// copy where K % 8 != 0).

#include "wgmma_chain.cuh"

namespace {

// tm_mask: the bits, or (W) the weights in my's boxes.
template <int KT, int L, bool W>
__global__ void __launch_bounds__(kThreads, 1)
    grad_dict_stats(const __grid_constant__ CUtensorMap tm_my,
                    const __grid_constant__ CUtensorMap tm_xc,
                    const __grid_constant__ CUtensorMap tm_d,
                    const __grid_constant__ CUtensorMap tm_mask,
                    const Params p) {
  chain_pass<KT, W ? Pass::GradDictW : Pass::GradDict, L>(tm_my, tm_xc, tm_d,
                                                          p, &tm_mask);
}

// mask: the bits (words per row) or, W, the weights (row stride words).
struct Args {
  const void *my, *mask, *x, *dl;
  int ld_my, words, ld_x, M, N, K, chunk_rows;
  void *xc, *part, *out;
  cudaStream_t stream;
};

template <int KT, int L, bool W>
int launch(const Args& a) {
  using C = Cfg<KT, W ? Pass::GradDictW : Pass::GradDict, L>;
  constexpr CUtensorMapSwizzle SW = CU_TENSOR_MAP_SWIZZLE_128B;
  constexpr bool F32 = L == 3;
  constexpr CUtensorMapDataType TT = F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap my, xc, dl, mask;
  // f32: x's limbs (xc, written by launch 1); bf16: x itself.
  const bool ok =
      make_map(&my, TT, F32 ? 4 : 2, a.my, a.N, a.M, a.ld_my, F32 ? 32 : 64,
               SS, SW) &&
      make_map(&xc, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, F32 ? a.xc : a.x,
               F32 ? 3 * KT : a.K, a.M, F32 ? 3 * KT : a.ld_x, 64, SS, SW) &&
      make_map(&dl, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.dl, L * KT, a.N,
               L * KT, 64, BR, SW) &&
      (W ? make_map(&mask, TT, F32 ? 4 : 2, a.mask, a.N, a.M, a.words,
                    F32 ? 32 : 64, SS, SW)
         : make_map(&mask, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.mask, a.words,
                    a.M, a.words, 4, SS, CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return (int)cudaErrorInvalidValue;
  if constexpr (F32) {
    const int rc = launch_split_rows(static_cast<const float*>(a.x), a.M,
                                     a.K, KT, static_cast<bf16*>(a.xc),
                                     a.stream);
    if (rc != 0) return rc;
  }
  cudaError_t err = cudaFuncSetAttribute(
      grad_dict_stats<KT, L, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const Params p{a.M, a.N, a.K, 0.f, nullptr, nullptr, nullptr, nullptr,
                 a.chunk_rows, static_cast<float*>(a.part)};
  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  grad_dict_stats<KT, L, W><<<dim3((a.N + BR - 1) / BR, chunks), kThreads,
                              C::kSmem, a.stream>>>(my, xc, dl, mask, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       (long long)a.K * a.N, chunks,
                       static_cast<float*>(a.out), a.stream);
}

// Both C entries: the checks they share, the mask's own (W: the weights'
// row stride in a.words, 16-byte aligned as my's; else the bits' words a
// row), then the instance.
template <bool W>
int entry(int limbs, int kt, const Args& a) {
  const int per = limbs == 3 ? 4 : 8;   // elements in 16 bytes
  const bool mask_ok = W ? a.words >= a.N && a.words % per == 0
                         : a.words % 4 == 0 && a.words * 32 >= a.N;
  if (a.M < 1 || a.N < 1 || a.K < 1 || a.K > kt || (kt != 64 && kt != 128) ||
      (limbs != 1 && limbs != 3) || a.chunk_rows < 1 ||
      a.chunk_rows % SS != 0 || a.ld_my < a.N || a.ld_my % per != 0 ||
      !mask_ok ||
      (limbs == 3 ? a.ld_x != a.K : a.ld_x < a.K || a.ld_x % 8 != 0))
    return (int)cudaErrorInvalidValue;
  if (limbs == 3)
    return kt == 64 ? launch<64, 3, W>(a) : launch<128, 3, W>(a);
  return kt == 64 ? launch<64, 1, W>(a) : launch<128, 1, W>(a);
}

}  // namespace

// The C interface, loaded with ctypes. limbs 3 (f32 data: my and x f32)
// or 1 (bf16 data: my and x bf16); my (M x N, row stride ld_my, 16-byte
// aligned rows: a multiple of 4 f32 or 8 bf16); mask the packed bits (M x
// words int32, words % 4 == 0, 16-byte aligned); x (M x K, row stride ld_x:
// K at f32, a multiple of 8 at bf16); dl d's limbs (N x limbs kt bf16: row
// n = [limb 0 | limb 1 | limb 2] of d[:, n], or d[:, n] at one limb, each
// kt wide, zero past K); kt the rank tile, 64 (K <= 64) or 128 (K <= 128);
// chunk_rows a multiple of 32; xc (M x 3 kt) bf16 scratch at f32, unused at
// bf16; part chunks x K N f32 scratch with chunks = ceil(M / chunk_rows);
// out K N f32 = G. Returns 0 or the first non-zero cudaError_t.
extern "C" int grad_dict_packed_launch(int limbs, int kt, const void* my,
                                       int ld_my, const void* mask,
                                       int words, const void* x, int ld_x,
                                       const void* dl, int M, int N, int K,
                                       int chunk_rows, void* xc, void* part,
                                       void* out, void* stream) {
  return entry<false>(limbs, kt, Args{my, mask, x, dl, ld_my, words, ld_x,
                                      M, N, K, chunk_rows, xc, part, out,
                                      static_cast<cudaStream_t>(stream)});
}

// The weighted mask: as grad_dict_packed_launch with the weights w (M x N
// in my's dtype, row stride ld_w, 16-byte aligned rows as my's) for the
// bits.
extern "C" int grad_dict_weighted_launch(int limbs, int kt, const void* my,
                                         int ld_my, const void* w, int ld_w,
                                         const void* x, int ld_x,
                                         const void* dl, int M, int N, int K,
                                         int chunk_rows, void* xc, void* part,
                                         void* out, void* stream) {
  return entry<true>(limbs, kt, Args{my, w, x, dl, ld_my, ld_w, ld_x, M, N,
                                     K, chunk_rows, xc, part, out,
                                     static_cast<cudaStream_t>(stream)});
}

// x's limbs alone, as launch 1 (and grad_wide.cu's split) writes them (xc,
// M x 3 kt bf16, kt a multiple of 64: the fused tile, or the wide route's
// width), so that a check can hold the layout against
// cuda_mu.column_limbs(x^T, kt).
extern "C" int grad_dict_split_launch(int kt, const void* x, int M, int K,
                                      void* xc, void* stream) {
  if (M < 1 || K < 1 || K > kt || kt % 64 != 0)
    return (int)cudaErrorInvalidValue;
  return launch_split_rows(static_cast<const float*>(x), M, K, kt,
                           static_cast<bf16*>(xc),
                           static_cast<cudaStream_t>(stream));
}
