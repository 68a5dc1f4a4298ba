// Building blocks shared by the NMF statistics kernels (mu_stats_dense.cu,
// mu_kl_stats.cu): dtype casts, register-staged tile loads, the warp-level
// product on mma.sync (bf16) or full-f32 FMAs (f32), stage-wise f32
// summation, and the fixed-order reductions of per-chunk partials.
//
// Every kernel here runs THREADS = 256 threads (8 warps) per block. A warp
// product covers a 32-row window of 16 x 8 mma tiles; the accumulator
// layout is mma.sync's: with g = lane / 4 and t = lane % 4, element 0..3 of
// each 16 x 8 tile sits at (row g, col 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KP = 128;        // rank tile: any 1 <= K <= KP is taken
constexpr int BK = 32;         // reduction depth of one pipeline stage
constexpr int LDT = BK + 8;    // leading dim of BK-wide tiles
constexpr int LDR = KP + 8;    // leading dim of 128-wide tiles
constexpr int THREADS = 256;   // 8 warps

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

// A scalar R x C window, for one-off loads: dst[i * ldd + j].
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
// Bs[n * ldb + k], or at Bs[k * ldb + n] when B_KN.
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
template <typename T, bool A_KM, bool B_KN, int NT>
__device__ __forceinline__ void stage_mma(float (&acc)[2][NT][4], const T* As,
                                          int lda, const T* Bs, int ldb,
                                          int wr, int wc, int lane) {
  float st[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[mt][nt][i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16)
    WarpMma<T, A_KM, B_KN>::template run<NT>(st, As, lda, Bs, ldb, k0, wr, wc,
                                             lane);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += st[mt][nt][i];
}

// Position of accumulator element i of tile (mt, nt) inside a warp's
// window.
__device__ __forceinline__ int frag_row(int mt, int i, int lane) {
  return 16 * mt + (lane >> 2) + (i >= 2 ? 8 : 0);
}
__device__ __forceinline__ int frag_col(int nt, int i, int lane) {
  return 8 * nt + 2 * (lane & 3) + (i & 1);
}

// out[i] = sum over chunks, in chunk order, of part[c][i] (stride S).
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

inline int launch_reduce(const float* part, long long S, int chunks,
                         float* out, cudaStream_t stream) {
  const long long blocks = (S + THREADS - 1) / THREADS;
  reduce_kernel<<<(int)(blocks < 8192 ? blocks : 8192), THREADS, 0,
                  stream>>>(part, S, chunks, out);
  return (int)cudaGetLastError();
}

// out[i] = sum over c < count of part[c * S + i] for few outputs and many
// partials (the dense KL kernels' column sums of x_new), one block per i:
// each thread sums a fixed strided subset in order, then a fixed tree in
// shared memory, so the result does not depend on scheduling.
__global__ void __launch_bounds__(THREADS)
    reduce_long_kernel(const float* __restrict__ part, int S, int count,
                       float* __restrict__ out) {
  __shared__ float sh[THREADS];
  float s = 0.f;
  for (int c = threadIdx.x; c < count; c += THREADS)
    s += part[(long long)c * S + blockIdx.x];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int w = THREADS / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sh[0];
}

inline int launch_reduce_long(const float* part, int S, int count, float* out,
                              cudaStream_t stream) {
  reduce_long_kernel<<<S, THREADS, 0, stream>>>(part, S, count, out);
  return (int)cudaGetLastError();
}

// Rows of a (rows x ld) tensor of T all start 16-byte aligned.
template <typename T>
bool rows_aligned(const void* p, int ld) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (ld * sizeof(T)) % 16 == 0;
}

}  // namespace
