// The whole-solve lasso kernels' shared pieces (lasso_fista_tma.cu,
// lasso_fista_wide.cu): the 512-column chunks and 16-deep Gram tiles of
// their stage images (cuda_lasso.tile_images), the tiles' swizzle and
// fragment words, the 'high' split of v, the complex mode's embedding of
// the pair Gram, the schedulable mma.sync, the two proxes, the slots'
// states and the operand's row stride.

#pragma once

#include "sm90_common.cuh"

namespace {

constexpr int NCOL = 512;                     // columns per tile chunk
constexpr int KD = 16;                        // depth of one G tile
constexpr float F32_TINY = 1.17549435e-38f;

// Real stage tiles hold up to 512 rows of G^T; complex ones up to 256 rows
// of P, which serve 512 output columns.
template <bool GROUP> constexpr int kTileRows = GROUP ? NCOL / 2 : NCOL;

// Rows of chunk c's tiles: the rows its columns read, whole 8-column
// groups of mma.sync's n (a complex pair row serves two columns).
template <bool GROUP>
__device__ __forceinline__ int chunk_rows(int F, int c) {
  return (min(NCOL, F - c * NCOL) + 7) / 8 * (GROUP ? 4 : 8);
}

// Slot states.
constexpr int EMPTY = 0, RUNNING = 1, LEAVING = 2;

// Swizzle of a 16-wide bf16 tile row (TMA's 32-byte pattern): its two
// 16-byte halves swap on rows with bit 2 set.
__device__ __forceinline__ int swz(int n, int half) {
  return n * KD + 8 * (half ^ ((n >> 2) & 1));
}

// bf16x3 split of two adjacent f32 values (lower k in the low half).
__device__ __forceinline__ void split2(float2 v, uint32_t& hi,
                                       uint32_t& lo) {
  const uint32_t ux = __float_as_uint(v.x) & 0xFFFF0000u;
  const uint32_t uy = __float_as_uint(v.y) & 0xFFFF0000u;
  hi = (ux >> 16) | uy;
  lo = pack(__float2bfloat16_rn(__fsub_rn(v.x, __uint_as_float(ux))),
            __float2bfloat16_rn(__fsub_rn(v.y, __uint_as_float(uy))));
}

__device__ __forceinline__ uint32_t word(const bf16* tile, int n, int half,
                                         int tq) {
  return *reinterpret_cast<const uint32_t*>(tile + swz(n, half) + 2 * tq);
}

// The embedding's pair at output column 2n + odd from P's pair (Re, Im)
// (Re in the low half): (Im, Re) for odd, else (Re, -Im); lo, a limb past
// the first (a rounded remainder), keeps +0.
__device__ __forceinline__ uint32_t embed_pair(uint32_t w, bool odd, bool lo) {
  if (odd) return __byte_perm(w, 0, 0x1032);
  return (lo && (w >> 16) == 0) ? w : w ^ 0x80000000u;
}

// mma.sync m16n8k16 (bf16 in, f32 accumulate) as a plain asm statement:
// unlike a volatile one, the compiler may interleave independent products.
__device__ __forceinline__ void mma_sched(float (&c)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sign(u) max(|u| - thr, 0), NaN kept.
__device__ __forceinline__ float shrink(float u, float thr) {
  const float m = __fsub_rn(fabsf(u), thr);
  if (m != m) return m;
  return m > 0.f ? copysignf(m, u) : 0.f;
}

// max(1 - thr / max(|re + i im|, tiny), 0), NaN kept.
__device__ __forceinline__ float pair_scale(float re, float im, float thr) {
  const float mag =
      __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  if (mag != mag) return mag;
  const float s = __fsub_rn(1.f, __fdiv_rn(thr, fmaxf(mag, F32_TINY)));
  return (s > 0.f || s != s) ? s : 0.f;
}

__host__ __device__ constexpr int lds_of(int fk) { return fk + 8; }


}  // namespace
