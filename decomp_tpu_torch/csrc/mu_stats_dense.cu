// Dense multiplicative-update NMF statistics on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:438
// mu_stats_dense (body _dense_kernel, pallas_mu.py:160). Given data y (M, N),
// activations x (M, K), dictionary d (K, N) in y's dtype and ddt = d d^T
// (K, K, f32) it returns
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
// 32 KB) are re-read by every block but from L2. Fusing the passes (and
// wgmma with TMA) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KP = 128;        // rank tile: any 1 <= K <= KP is taken
constexpr int BM = 128;        // rows per block of the x update
constexpr int BN = 128;        // columns per block of the statistics pass
constexpr int BK = 32;         // reduction depth of one pipeline stage
constexpr int LDT = BK + 8;    // leading dim of launch 1's streamed tiles
constexpr int LDR = KP + 8;    // leading dim of 128-wide tiles
constexpr int THREADS = 256;   // 8 warps as 4 (rows) x 2 (cols) of 32 x 64

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T, typename S>
__device__ __forceinline__ T cvt(S v) {
  return from_f32<T>(to_f32(v));
}

// One R x C window of a row-major source (row stride lds) at (r0, c0),
// staged through registers: load() issues the global reads, store() writes
// them to shared memory as T (dst[i * ldd + j]). Entries outside rows < rmax
// and cols < cmax are zero. vec_ok says that every row starts 16-byte
// aligned, so whole 16-byte groups inside the window are read at once.
template <typename S, int R, int C>
struct Stage {
  static constexpr int V = 16 / sizeof(S);
  static constexpr int NV = R * C / V / THREADS;
  static_assert(NV >= 1 && R * C % (V * THREADS) == 0, "tile shape");
  uint4 v[NV];

  __device__ __forceinline__ void load(const S* __restrict__ src,
                                       long long lds, long long r0,
                                       long long rmax, long long c0,
                                       long long cmax, bool vec_ok) {
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int e = threadIdx.x + s * THREADS;
      const int i = e / (C / V), j = (e % (C / V)) * V;
      const long long r = r0 + i, c = c0 + j;
      if (vec_ok && r < rmax && c + V <= cmax) {
        v[s] = __ldg(reinterpret_cast<const uint4*>(src + r * lds + c));
      } else {
        S tmp[V];
#pragma unroll
        for (int q = 0; q < V; ++q)
          tmp[q] = (r < rmax && c + q < cmax) ? src[r * lds + c + q]
                                              : from_f32<S>(0.f);
        memcpy(&v[s], tmp, 16);
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* dst, int ldd) const {
#pragma unroll
    for (int s = 0; s < NV; ++s) {
      const int e = threadIdx.x + s * THREADS;
      const int i = e / (C / V), j = (e % (C / V)) * V;
      if constexpr (std::is_same<S, T>::value) {
        *reinterpret_cast<uint4*>(dst + i * ldd + j) = v[s];
      } else {
        const S* p = reinterpret_cast<const S*>(&v[s]);
#pragma unroll
        for (int q = 0; q < V; ++q) dst[i * ldd + j + q] = cvt<T>(p[q]);
      }
    }
  }
};

// A scalar R x C window, for the one-off ddt load: dst[i * ldd + j].
template <typename T, typename S, int R, int C>
__device__ __forceinline__ void load_tile(T* dst, int ldd,
                                          const S* __restrict__ src,
                                          long long lds, long long rmax,
                                          long long cmax) {
  for (int e = threadIdx.x; e < R * C; e += THREADS) {
    const int i = e / C, j = e % C;
    dst[i * ldd + j] = (i < rmax && j < cmax) ? cvt<T>(src[i * lds + j])
                                              : from_f32<T>(0.f);
  }
}

// One warp: acc[mt][nt] += A[wr + 16 mt + (0..15)][k0 + (0..15)]
//                        * B[k0 + (0..15)][wc + 8 nt + (0..7)]
// over operands in shared memory. Element (m, k) of A sits at
// As[m * lda + k], or at As[k * lda + m] when A_KM; element (k, n) of B at
// Bs[n * ldb + k], or at Bs[k * ldb + n] when B_KN. acc follows mma.sync's
// accumulator layout: with g = lane / 4 and t = lane % 4, element 0..3 sits
// at (row g, col 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) of each 16 x 8 tile.
template <typename T, bool A_KM, bool B_KN> struct WarpMma;

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// Elements (row, k) and (row, k + 1) of an operand whose element (row, k)
// sits at P[row * ld + k], or at P[k * ld + row] when KM; lower half first.
template <bool KM>
__device__ __forceinline__ uint32_t pair(const bf16* P, int ld, int row,
                                         int k) {
  if (KM) return pack(P[k * ld + row], P[(k + 1) * ld + row]);
  return *reinterpret_cast<const uint32_t*>(P + row * ld + k);
}

template <bool A_KM, bool B_KN> struct WarpMma<bf16, A_KM, B_KN> {
  template <int NT>
  static __device__ __forceinline__ void run(float (&acc)[2][NT][4],
                                             const bf16* As, int lda,
                                             const bf16* Bs, int ldb, int k0,
                                             int wr, int wc, int lane) {
    const int g = lane >> 2, t = lane & 3;
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = wr + 16 * mt + g, k = k0 + 2 * t;
      a[mt][0] = pair<A_KM>(As, lda, m, k);
      a[mt][1] = pair<A_KM>(As, lda, m + 8, k);
      a[mt][2] = pair<A_KM>(As, lda, m, k + 8);
      a[mt][3] = pair<A_KM>(As, lda, m + 8, k + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = wc + 8 * nt + g, k = k0 + 2 * t;
      const uint32_t b0 = pair<B_KN>(Bs, ldb, n, k);
      const uint32_t b1 = pair<B_KN>(Bs, ldb, n, k + 8);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        float* c = acc[mt][nt];
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
            : "r"(a[mt][0]), "r"(a[mt][1]), "r"(a[mt][2]), "r"(a[mt][3]),
              "r"(b0), "r"(b1));
      }
    }
  }
};

// f32: the same tiles and accumulator layout, as full-f32 FMAs.
template <bool A_KM, bool B_KN> struct WarpMma<float, A_KM, B_KN> {
  static __device__ __forceinline__ float at(const float* P, int ld, bool km,
                                             int row, int k) {
    return km ? P[k * ld + row] : P[row * ld + k];
  }

  template <int NT>
  static __device__ __forceinline__ void run(float (&acc)[2][NT][4],
                                             const float* As, int lda,
                                             const float* Bs, int ldb, int k0,
                                             int wr, int wc, int lane) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
    for (int kk = 0; kk < 16; ++kk) {
      const int k = k0 + kk;
      float a[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        a[mt][0] = at(As, lda, A_KM, wr + 16 * mt + g, k);
        a[mt][1] = at(As, lda, A_KM, wr + 16 * mt + g + 8, k);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int n = wc + 8 * nt + 2 * t;
        const float b0 = at(Bs, ldb, B_KN, n, k);
        const float b1 = at(Bs, ldb, B_KN, n + 1, k);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float* c = acc[mt][nt];
          c[0] = fmaf(a[mt][0], b0, c[0]);
          c[1] = fmaf(a[mt][0], b1, c[1]);
          c[2] = fmaf(a[mt][1], b0, c[2]);
          c[3] = fmaf(a[mt][1], b1, c[3]);
        }
      }
    }
  }
};

// One BK-deep stage of a streamed product: acc += A_stage B_stage. The
// stage sums in its own registers and is then added to acc with an ordinary
// (round-to-nearest) f32 add. The tensor cores' f32 accumulation does not
// round to nearest, so a chain of ~600 mma.sync over the whole width drifts
// (measured ~4e-5 relative against the plain twin at N = 10,112); chains of
// BK / 16 = 2 keep it at f32 summation-order level.
template <typename T, bool A_KM, bool B_KN>
__device__ __forceinline__ void stage_mma(float (&acc)[2][8][4], const T* As,
                                          int lda, const T* Bs, int ldb,
                                          int wr, int wc, int lane) {
  float st[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[mt][nt][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16)
    WarpMma<T, A_KM, B_KN>::template run<8>(st, As, lda, Bs, ldb, k0, wr, wc,
                                            lane);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += st[mt][nt][i];
}

// Position of accumulator element i of tile (mt, nt) inside the warp's
// 32 x 64 window.
__device__ __forceinline__ int frag_row(int mt, int i, int lane) {
  return 16 * mt + (lane >> 2) + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int nt, int i, int lane) {
  return 8 * nt + 2 * (lane & 3) + (i & 1);
}

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

// Launch 3: out[i] = sum over chunks, in chunk order, of part[c][i].
__global__ void __launch_bounds__(THREADS)
    reduce_kernel(const float* __restrict__ part, long long S, int chunks,
                  float* __restrict__ out) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < S;
       i += (long long)gridDim.x * THREADS) {
    float s = part[i];
    for (int c = 1; c < chunks; ++c) s += part[(long long)c * S + i];
    out[i] = s;
  }
}

// Rows of a (rows x ld) tensor of T all start 16-byte aligned.
template <typename T>
bool rows_aligned(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (ld * sizeof(T)) % 16 == 0;
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
  const long long blocks3 = (S + THREADS - 1) / THREADS;
  reduce_kernel<<<(int)(blocks3 < 8192 ? blocks3 : 8192), THREADS, 0,
                  stream>>>(static_cast<const float*>(part), S, chunks,
                            static_cast<float*>(out));
  return (int)cudaGetLastError();
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
