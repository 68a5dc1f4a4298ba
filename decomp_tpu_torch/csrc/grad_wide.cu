// The masked lasso and dictionary gradients above 128 features on Hopper
// (sm_90a), on wgmma: f32 data with every f32 product as bf16x6 limb
// products (L = 3 limbs an operand), and bf16 data with each product one
// bf16 pass (L = 1); a 0/1 mask as packed bits, or a weighted mask as
// weights in the data's dtype. Every F (rows) and K (dictionary) that the
// TPU kernels' gate takes (ops/cuda_lasso.py grad_fits: up to 1,152 f32 or
// 2,432 bf16 features at N = 1,024, 10,112 or 20,352 at N <= 128).
//
// Replaces, above 128 features, the Pallas TPU kernels
// decomp_tpu/ops/pallas_lasso.py:159 masked_grad_rows (pallas_call :176)
// and :225 masked_grad_dict (pallas_call :243). Given my = mask * y (M, N),
// the mask as bits (M, W) int32 (bit j of word w in row r is mask[r, 32 w
// + j]) or as weights (M, N) in my's dtype, x (M, K) and b (K, N) (a, or
// d) as its L bf16 limbs, they return
//   rows:       g = cdt(f32(mask) (x b) - f32(my)) b^T           (M, K)
//   dictionary: G = x^T cdt(f32(mask) (x b) - f32(my))          (K, N) f32
// at the TPU kernels' quantisation points, cdt the data's dtype: at f32
// both products at the TPU's Precision.HIGHEST (bf16x6 there, and here)
// and the residual E = f32(mask) R - my formed in f32 with round-to-nearest
// operations and not rounded further; at bf16 both products on bf16
// operands summed in f32 and E rounded to bf16 (round to nearest).
//
// Products: wide_common.cuh's bf16x6 limb products (L = 3) or one bf16
// pass (L = 1), each 64-deep chain added with round-to-nearest f32 adds:
// over K = 10,112 the chain of R is 158 such adds. No TF32.
//
// Why not the fused kernels widened: lasso_grad_packed.cu keeps a stripe's
// x resident as its limbs (96 KB at F = 128, f32) and g in registers (64 a
// thread); grad_dict_packed.cu keeps a tile's d limbs (96 KB) and G^T (128
// x KT). Both double at 256 features, past shared memory and the register
// file. So R = x b, which the two gradients share, is its own product here,
// and E goes to device memory once:
//   0. (f32 only) split_rows of sm90_common.cuh (grad_dict_packed.cu's
//      too): x's limbs xl (M x 3 Kp bf16, row m = [limb 0 of x[m] | limb 1
//      | limb 2], each Kp wide, zero past K; Kp = K rounded up to 128), one
//      thread per 8 features; bf16 x is its own limb and is read as it is;
//   1. wide_resid (wide_common.cuh) with the MaskedResid epilogue: E =
//      cdt(f32(mask) (x b) - f32(my)) (M x N in cdt), x's limbs and b's
//      (from b's limbs (N x L Kp)) in 64-deep TMA stages; the epilogue
//      reads my and the mask words or weights at R's positions and writes
//      E;
//   2. rows, wide_rows with the RowsStore epilogue: g = E b^T, a
//      persistent block per (128-row stripe) x (128-feature chunk) item,
//      E split into limbs in registers;
//   3. dictionary, wide_dict: G = x^T E, the partials of (128-column N
//      tile) x (row chunk) x (128-atom K chunk), and nmf_common.cuh's
//      fixed-order reduction sums the chunks.
// No float atomics: a rerun gives the same bits. Ragged M, N and K are
// masked: TMA zero-fills boxes outside the tensors, the limbs are zero past
// K, and E is 0 outside the matrix and the row chunk.
//
// What bounds it on an H100, at 100,000 x 1,024, F = K = 256 (the TPU
// kernel's own work: my, the mask, x, b read once, g or G written once, no
// E):
//   - f32: 12 bf16 passes of 2 MNF operations (two f32 products, six limb
//     products each), 6.29e11 operations, 0.636 ms at 989 TFLOP/s, against
//     ~0.63 GB (my 409.6 MB, x and g 102.4 MB each, the bits 12.8 MB: 0.19
//     ms at 3.35 TB/s): bound by operations;
//   - bf16: 2 passes, 1.05e11 operations, 0.106 ms, against 320 MB (0.096
//     ms): bound by operations, nearly by bytes.
// E's round trip is this route's own cost, beside that bound: 0.82 GB at
// f32 (0.245 ms of bytes, which can hide under the products) and 0.41 GB
// at bf16 (0.122 ms, about doubling the floor); x's limbs (f32) add 154 MB
// written and read again.
//
// The wrappers (ops/cuda_lasso.py, ops/cuda_dl.py) give b's limbs as one
// (N, L Kp) bf16 array (cuda_mu.column_limbs(b, Kp, L): a's once per solve,
// d's once per call), my, the weights and E with 16-byte-aligned rows (a
// multiple of 4 f32 or 8 bf16), bf16 x likewise, the scratch (xl, E, the
// partials), and the row chunks from the shape alone
// (cuda_dl.grad_wide_dict_rows).

#include "wide_common.cuh"

namespace {

// mask: the bits (ld_mask words a row) or, W, the weights (row stride
// ld_mask). K is F for the rows gradient.
struct Args {
  const void *my, *mask, *x, *bl;
  int ld_my, ld_mask, ld_x, M, N, K, kp;
  void *xl, *e;
  int ld_e;
  void* out;           // g (rows) or G (dictionary)
  int chunk_rows;      // dictionary
  void* part;          // dictionary: chunks x K N f32
  cudaStream_t stream;
};

// The x operand's map: L = 3 x's limbs (M x 3 kp), L = 1 x itself (M x K,
// row stride ld_x), in boxes of 64 x rows.
template <int L>
bool x_map(CUtensorMap* map, const Args& a, int rows) {
  return L == 3 ? limb_map(map, a.xl, 3LL * a.kp, a.M, 3LL * a.kp, rows)
                : limb_map(map, a.x, a.K, a.M, a.ld_x, rows);
}

// b's limbs (N x L kp) in boxes of 64 x rows.
template <int L>
bool b_map(CUtensorMap* map, const Args& a, int rows) {
  return limb_map(map, a.bl, (long long)L * a.kp, a.N, (long long)L * a.kp,
                  rows);
}

template <int L, bool W>
int resid(const Args& a) {
  CUtensorMap tx, tb;
  if (!x_map<L>(&tx, a, BM) || !b_map<L>(&tb, a, BN))
    return (int)cudaErrorInvalidValue;
  const MaskedResid<L, W, true> epi{static_cast<const Elt<L>*>(a.my),
                                    a.ld_my,
                                    a.mask,
                                    a.ld_mask,
                                    static_cast<Elt<L>*>(a.e),
                                    a.ld_e};
  return launch_resid<L>(tx, tb, a.M, a.N, a.K, a.kp, epi, a.stream);
}

template <int L>
int rows(const Args& a) {
  CUtensorMap te, tb;
  if (!e_map<L>(&te, a.e, a.N, a.M, a.ld_e, BM) ||
      !b_map<L>(&tb, a, RowsCfg<L>::SC))
    return (int)cudaErrorInvalidValue;
  const RowsStore<Elt<L>> epi{static_cast<Elt<L>*>(a.out), a.K};
  return launch_rows<L>(te, tb, a.M, a.N, a.K, a.kp, epi, a.stream);
}

template <int L>
int dict(const Args& a) {
  CUtensorMap te, tx;
  if (!e_map<L>(&te, a.e, a.N, a.M, a.ld_e, DR) || !x_map<L>(&tx, a, DR))
    return (int)cudaErrorInvalidValue;
  return launch_dict<L>(te, tx, a.M, a.N, a.K, a.kp, a.chunk_rows,
                        static_cast<float*>(a.part),
                        static_cast<float*>(a.out), a.stream);
}

// The checks both entries share: shapes, strides (16-byte aligned rows of
// my, the weights, E and bf16 x; f32 x contiguous), the mask's own.
bool args_ok(int limbs, bool w, const Args& a) {
  const int per = limbs == 3 ? 4 : 8;   // elements in 16 bytes
  const bool mask_ok = w ? a.ld_mask >= a.N && a.ld_mask % per == 0
                         : a.ld_mask % 4 == 0 && a.ld_mask * 32LL >= a.N;
  return a.M >= 1 && a.N >= 1 && a.K >= 1 && a.K <= a.kp &&
         a.kp % 128 == 0 && (limbs == 1 || limbs == 3) && a.ld_my >= a.N &&
         a.ld_my % per == 0 && a.ld_e >= a.N && a.ld_e % per == 0 &&
         mask_ok &&
         (limbs == 3 ? a.ld_x == a.K : a.ld_x >= a.K && a.ld_x % 8 == 0);
}

// x's limbs (f32), then E.
template <int L>
int split_resid(bool w, const Args& a) {
  if constexpr (L == 3) {
    const int rc = launch_split_rows(static_cast<const float*>(a.x), a.M,
                                     a.K, a.kp, static_cast<bf16*>(a.xl),
                                     a.stream);
    if (rc != 0) return rc;
  }
  return w ? resid<L, true>(a) : resid<L, false>(a);
}

}  // namespace

// The C interface, loaded with ctypes. limbs 3 (f32 data: my, x, g and the
// weights f32) or 1 (bf16 data: all bf16); weighted 0 (mask: the packed
// bits, M x ld_mask int32, ld_mask % 4 == 0) or 1 (mask: the weights, M x
// N, row stride ld_mask); my (M x N, row stride ld_my), E (M x N scratch in
// the data's dtype, row stride ld_e), each with 16-byte-aligned rows; x (M
// x F: f32 contiguous, ld_x == F; bf16 row stride ld_x, a multiple of 8);
// al a's limbs (N x limbs fp bf16: row n = [limb 0 | limb 1 | limb 2] of
// a[:, n], or a[:, n] at one limb, each fp wide, zero past F); fp F rounded
// up to 128; xl (M x 3 fp bf16 scratch at f32, unused at bf16); g (M x F).
// Runs split_rows (f32), wide_resid, wide_rows. Returns 0 or the first
// non-zero cudaError_t.
extern "C" int grad_wide_rows_launch(int limbs, int weighted, const void* my,
                                     int ld_my, const void* mask, int ld_mask,
                                     const void* x, int ld_x, const void* al,
                                     int M, int N, int F, int fp, void* xl,
                                     void* e, int ld_e, void* g,
                                     void* stream) {
  const Args a{my, mask, x, al, ld_my, ld_mask, ld_x, M, N, F, fp, xl, e,
               ld_e, g, 0, nullptr, static_cast<cudaStream_t>(stream)};
  if (!args_ok(limbs, weighted != 0, a)) return (int)cudaErrorInvalidValue;
  const int rc = limbs == 3 ? split_resid<3>(weighted != 0, a)
                            : split_resid<1>(weighted != 0, a);
  if (rc != 0) return rc;
  return limbs == 3 ? rows<3>(a) : rows<1>(a);
}

// The dictionary gradient: as grad_wide_rows_launch with x (M x K), dl d's
// limbs (N x limbs kp, the layout of al), chunk_rows a multiple of 32, part
// (chunks x K N f32 scratch, chunks = ceil(M / chunk_rows)) and out (K N
// f32 = G). Runs split_rows (f32), wide_resid, wide_dict and the
// reduction.
extern "C" int grad_wide_dict_launch(int limbs, int weighted, const void* my,
                                     int ld_my, const void* mask, int ld_mask,
                                     const void* x, int ld_x, const void* dl,
                                     int M, int N, int K, int kp,
                                     int chunk_rows, void* xl, void* e,
                                     int ld_e, void* part, void* out,
                                     void* stream) {
  const Args a{my, mask, x, dl, ld_my, ld_mask, ld_x, M, N, K, kp, xl, e,
               ld_e, out, chunk_rows, part, static_cast<cudaStream_t>(stream)};
  if (!args_ok(limbs, weighted != 0, a) || chunk_rows < 1 ||
      chunk_rows % DR != 0)
    return (int)cudaErrorInvalidValue;
  const int rc = limbs == 3 ? split_resid<3>(weighted != 0, a)
                            : split_resid<1>(weighted != 0, a);
  if (rc != 0) return rc;
  return limbs == 3 ? dict<3>(a) : dict<1>(a);
}
