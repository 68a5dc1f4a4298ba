// Dense multiplicative-update NMF statistics on bf16 data, on Hopper
// (sm_90a): a TMA ring, warp specialisation and wgmma.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_mu.py:438
// mu_stats_dense (pallas_call :459, body _dense_kernel :160-219) for bf16
// y and d, with f32 or bf16 x (f32 data run mu_stats_dense.cu). Given y
// (M, N), x (M, K), d (K, N) and ddt = d d^T (K, K, f32), 1 <= K <= 128,
// it returns
//   x_new = x * (y d^T) / (cdt(x_f) cdt(ddt) + eps)   (inner_iter
//           refinements that reuse the numerator y d^T)
//   numd  = cdt(x_new)^T y,  gram = cdt(x_new)^T cdt(x_new)   (f32)
// at the TPU kernel's quantisation points, as mu_stats_dense.cu: products
// take bf16 operands and sum in f32; ddt is cast to bf16 at use; the
// iterate stays f32 across refinements; x_new is stored in x's dtype; the
// statistics use bf16(x_new_f32).
//
// What bounds it on an H100. Its products are 4MNK + 4MK^2 operations; it
// must read y (2 bytes per entry) once. At 1,048,576 x 10,112, K = 128
// that is 5.4e15 operations (5.5 ms at 989 TFLOP/s) against 21.2 GB of y
// and 1.1 GB of x and x_new (6.7 ms at 3.35 TB/s): bound by bytes. Two
// passes stay, because x_new of a row needs all N columns of y, and numd
// then needs y again: one pass would have to keep the K x N statistics
// (5.2 MB of f32) or a 128-row stripe of y (2.6 MB) on one SM. So the data
// are read twice, and the design aims at both passes near the bandwidth:
//   - tiles arrive by TMA (cp.async.bulk.tensor.2d) into a ring of stages,
//     each with a "full" mbarrier (the bytes landed) and an "empty" one
//     (every consumer warp is done), fed by one thread of a producer
//     warpgroup; a stage is 64 columns (x update) or 64 rows (statistics)
//     of bf16, so every box row is 128 bytes and lands with the 128-byte
//     swizzle; with one block per SM, 4 (x update) or 6 (statistics)
//     stages keep 64 or 96 KB of y in flight per SM;
//   - two consumer warpgroups run the products as wgmma.mma_async
//     m64n128k16 from shared-memory descriptors (x update: y and d both
//     K-major; statistics: x_new^T and y both MN-major, i.e. transposed);
//   - each stage's four k16 steps sum in their own registers, the first
//     with scale-d = 0, and the stage is then added to the running sums
//     with round-to-nearest f32 adds: one long tensor-core chain drifts
//     (stage_mma of nmf_common.cuh); the 64 registers this costs come from
//     setmaxnreg (producer down to 40, consumers up to 232);
//   - the x update is persistent (one block per SM walks its stripes), so
//     the ring runs on into the next stripe while the consumers refine and
//     store this one; the refinements (4MK^2 per iteration, < 1% of the
//     work) stay on mma.sync with cdt(ddt) resident in shared memory;
//   - the x update also writes xc = bf16(x_new), (M, 128) with zero pad
//     columns, which the statistics pass reads instead of x_new in f32;
//   - the statistics pass covers 128-column N tiles plus one gram tile
//     (the fast grid dimension, so a chunk's blocks walk the same xc rows
//     together and share them through L2) x row chunks, the chunks chosen
//     by the wrapper so that the blocks make close to whole waves (8 at
//     the main path: 42 MB of partials); then the fixed-order reduction of
//     nmf_common.cuh. No float atomics: a rerun gives the same bits.
// TMA zero-fills boxes outside the tensor, which masks ragged M and N, and
// K < 128 (d is read as a 128-row box). Chunks are whole 64-row stages, so
// no stage crosses into the next chunk. TMA needs 16-byte-aligned rows: y
// and d with N % 8 != 0 come as padded copies from the wrapper
// (ops/cuda_mu.py), whose row stride (ld_y, ld_d) may exceed N.

#include "sm90_common.cuh"

namespace {

constexpr int kThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int ST = 64;               // columns (x update) / rows (stats)
constexpr int BOX = ST * ST * 2;     // one 64 x 64 bf16 box, 8 KB

// Launch 1 shared memory, from a 1024-aligned base: kRing1 stages of
// [y (128 x 64, SW128) | d (128 x 64, SW128)], then cdt(ddt) (128 x LDR),
// Xs (8 warps x 16 rows x LDR) and 2 kRing1 mbarriers.
constexpr int BM1 = 128;             // rows per stripe
constexpr int kRing1 = 4;
constexpr int kY1 = BM1 * ST * 2;
constexpr int kSlot1 = kY1 + KP * ST * 2;
constexpr size_t kSmem1 = 1024 + (size_t)kRing1 * kSlot1 +
                          (size_t)KP * LDR * 2 +
                          (size_t)kConsumerWarps * 16 * LDR * 2 +
                          16 * kRing1;

// Launch 2 shared memory, from a 1024-aligned base: kRing2 stages of
// [xc (64 x 128 as two 64-column boxes) | y (64 x 128, two boxes)], then
// 2 kRing2 mbarriers.
constexpr int BN2 = 128;             // columns per N tile
constexpr int kRing2 = 6;
constexpr int kX2 = 2 * BOX;
constexpr int kSlot2 = kX2 + 2 * BOX;
constexpr size_t kSmem2 = 1024 + (size_t)kRing2 * kSlot2 + 16 * kRing2;

// d (64 x 128 per warpgroup, f32) = A B, or += when accumulate; TRANS:
// both operands MN-major. Register i of a thread of warp w holds row
// 16 w + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) +
// i % 2: mma.sync's accumulator layout, one 16 x 8 tile per four.
template <int TRANS>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS));
}

// One 64-deep stage of a warpgroup's 64 x 128 product into st: four k16
// steps, the first of which overwrites st; STEP is the descriptors'
// advance per step in 16-byte units. Returns when the products are in st.
template <int TRANS, int STEP>
__device__ __forceinline__ void stage_wgmma(float (&st)[64], uint64_t da,
                                            uint64_t db) {
  fence_operand(st);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int k = 0; k < ST / 16; ++k)
    wgmma_m64n128<TRANS>(st, da + k * STEP, db + k * STEP, k);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operand(st);
}

// The slot's products are done in this warp: one arrival of its lane 0.
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(empty);
}

// Launch 1: the x update, persistent: block b takes stripes b, b + grid,
// ... of 128 rows. Consumer warpgroup cw holds rows 64 cw .. 64 cw + 63 of
// the stripe (its warp w4 rows 16 w4 .. 16 w4 + 15) x all 128 ranks.
template <typename X>
__global__ void __launch_bounds__(kThreads, 1)
    x_update_tma(const __grid_constant__ CUtensorMap tm_y,
                 const __grid_constant__ CUtensorMap tm_d,
                 const X* __restrict__ x, const float* __restrict__ ddt,
                 float eps, int M, int N, int K, int inner,
                 X* __restrict__ x_new, bf16* __restrict__ xc) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  bf16* Ds = reinterpret_cast<bf16*>(ring + kRing1 * kSlot1);
  bf16* Xs = Ds + KP * LDR;
  uint64_t* full = reinterpret_cast<uint64_t*>(Xs + kConsumerWarps * 16 * LDR);
  uint64_t* empty = full + kRing1;
  const int n_stripes = (M + BM1 - 1) / BM1, n_st = (N + ST - 1) / ST;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing1; ++i) {
      mbar_init(full + i);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // cdt(ddt), zero outside K x K: the refinements' B operand.
  for (int e = threadIdx.x; e < KP * KP; e += kThreads) {
    const int i = e / KP, j = e % KP;
    Ds[i * LDR + j] =
        __float2bfloat16_rn(i < K && j < K ? ddt[i * K + j] : 0.f);
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // Producer: one thread keeps the ring full, across stripes.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int g = 0;
      for (int sp = blockIdx.x; sp < n_stripes; sp += gridDim.x)
        for (int s = 0; s < n_st; ++s, ++g) {
          const int slot = g % kRing1;
          if (g >= kRing1) mbar_wait(empty + slot, ((g / kRing1) + 1) & 1);
          unsigned char* dst = ring + slot * kSlot1;
          mbar_expect(full + slot, kSlot1);
          tma_load(dst, tm_y, s * ST, sp * BM1, full + slot);
          tma_load(dst + kY1, tm_d, s * ST, 0, full + slot);
        }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 - 4;
    const int lane = threadIdx.x & 31, t2 = 2 * (lane & 3);
    const Pad xw{Xs + warp * 16 * LDR, LDR};
    const auto xs = op<false>(xw);
    const auto ds = op<true>(Pad{Ds, LDR});
    float acc[64], st[64];
    int g = 0;
    for (int sp = blockIdx.x; sp < n_stripes; sp += gridDim.x) {
      // num = y_stripe d^T over the whole width.
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int s = 0; s < n_st; ++s, ++g) {
        const int slot = g % kRing1;
        mbar_wait(full + slot, (g / kRing1) & 1);
        const unsigned char* base = ring + slot * kSlot1;
        stage_wgmma<0, 2>(st, smem_desc(base + cw * (64 * 128), 16, 1024),
                          smem_desc(base + kY1, 16, 1024));
        release(empty + slot, lane);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += st[i];
      }

      // Refinements, on the f32 iterate xf (in st): x_f <- x_f * num /
      // (cdt(x_f) cdt(ddt) + eps), the warp's 16 rows through its own Xs.
      const long long r0 =
          (long long)sp * BM1 + 64 * cw + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const long long r = r0 + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + t2 + (i & 1);
        st[i] = (r < M && c < K) ? to_f32(x[r * K + c]) : 0.f;
      }
      for (int it = 0; it < inner; ++it) {
        __syncwarp();
#pragma unroll
        for (int i = 0; i < 64; i += 2)
          *reinterpret_cast<__nv_bfloat162*>(const_cast<bf16*>(
              xw.at((lane >> 2) + 8 * ((i >> 1) & 1), 8 * (i >> 2) + t2))) =
              __floats2bfloat162_rn(st[i], st[i + 1]);
        __syncwarp();
        // One 8-column slab at a time keeps 4 denominator registers live.
#pragma unroll
        for (int nt = 0; nt < 16; ++nt) {
          float den[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < KP / 16; ++kk) {
            uint32_t af[4], bf[2];
            xs.a(af, 0, 16 * kk, lane);
            ds.b1(bf, 8 * nt, 16 * kk, lane);
            mma_bf16(den, af, bf[0], bf[1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            // Columns past K stay exactly 0 (0/eps would be NaN at eps = 0).
            const int c = 8 * nt + t2 + (i & 1);
            st[4 * nt + i] = c < K ? st[4 * nt + i] * acc[4 * nt + i] /
                                         (den[i] + eps)
                                   : 0.f;
          }
        }
      }
      // x_new in x's dtype; xc = bf16(x_new_f32) with zero pad columns.
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const long long r = r0 + 8 * ((i >> 1) & 1);
        const int c = 8 * (i >> 2) + t2;
        if (r >= M) continue;
        if (c < K) x_new[r * K + c] = cvt<X>(st[i]);
        if (c + 1 < K) x_new[r * K + c + 1] = cvt<X>(st[i + 1]);
        *reinterpret_cast<__nv_bfloat162*>(xc + r * KP + c) =
            __floats2bfloat162_rn(st[i], st[i + 1]);
      }
    }
  }
}

// Launch 2: block (j, c) with j < n_tiles writes xc[chunk c]^T y[chunk c,
// tile j]; block (n_tiles, c) writes xc[chunk c]^T xc[chunk c]. Partial c
// is [numd (K x N) | gram (K x K)]. Consumer warpgroup cw holds ranks
// 64 cw .. 64 cw + 63 x the tile's 128 columns.
__global__ void __launch_bounds__(kThreads, 1)
    stats_tma(const __grid_constant__ CUtensorMap tm_xc,
              const __grid_constant__ CUtensorMap tm_y, int M, int N, int K,
              int chunk_rows, float* __restrict__ part) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kRing2 * kSlot2);
  uint64_t* empty = full + kRing2;
  const int n_tiles = (N + BN2 - 1) / BN2;
  const bool gram = blockIdx.x == n_tiles;
  const int n0 = blockIdx.x * BN2;
  const int r_begin = blockIdx.y * chunk_rows;
  const int n_st = (min(r_begin + chunk_rows, M) - r_begin + ST - 1) / ST;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing2; ++i) {
      mbar_init(full + i);
      mbar_init(empty + i, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0)
      for (int s = 0; s < n_st; ++s) {
        const int slot = s % kRing2, r = r_begin + s * ST;
        if (s >= kRing2) mbar_wait(empty + slot, ((s / kRing2) + 1) & 1);
        unsigned char* dst = ring + slot * kSlot2;
        mbar_expect(full + slot, gram ? kX2 : kSlot2);
        tma_load(dst, tm_xc, 0, r, full + slot);
        tma_load(dst + BOX, tm_xc, 64, r, full + slot);
        if (!gram) {
          tma_load(dst + kX2, tm_y, n0, r, full + slot);
          tma_load(dst + kX2 + BOX, tm_y, n0 + 64, r, full + slot);
        }
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = threadIdx.x / 128 - 1, warp = threadIdx.x / 32 - 4;
    const int lane = threadIdx.x & 31;
    float acc[64], st[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int s = 0; s < n_st; ++s) {
      const int slot = s % kRing2;
      mbar_wait(full + slot, (s / kRing2) & 1);
      const unsigned char* base = ring + slot * kSlot2;
      // A = xc^T (ranks of this warpgroup's box), B = y (or xc for the
      // gram tile), both MN-major; a k16 step is 16 rows, 2,048 bytes.
      stage_wgmma<1, 128>(st, smem_desc(base + cw * BOX, BOX, 1024),
                          smem_desc(base + (gram ? 0 : kX2), BOX, 1024));
      release(empty + slot, lane);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += st[i];
    }

    const long long KN = (long long)K * N;
    float* out = part + (long long)blockIdx.y * (KN + (long long)K * K);
    const int kr0 = 64 * cw + 16 * (warp & 3) + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      const int kr = kr0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      if (kr >= K) continue;
      if (gram) {
        if (c < K) out[KN + kr * K + c] = acc[i];
      } else if (n0 + c < N) {
        out[kr * (long long)N + n0 + c] = acc[i];
      }
    }
  }
}

struct Args {
  const void *y, *x, *d, *ddt;
  int ld_y, ld_d;
  float eps;
  int M, N, K, inner, chunk_rows;
  void *x_new, *xc, *part, *out;
  cudaStream_t stream;
};

template <typename X>
int launch(const Args& a) {
  constexpr CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr CUtensorMapSwizzle SW128 = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap y1, d1, xc2, y2;
  const bool ok =
      make_map(&y1, BF, 2, a.y, a.N, a.M, a.ld_y, ST, BM1, SW128) &&
      make_map(&d1, BF, 2, a.d, a.N, a.K, a.ld_d, ST, KP, SW128) &&
      make_map(&xc2, BF, 2, a.xc, KP, a.M, KP, ST, ST, SW128) &&
      make_map(&y2, BF, 2, a.y, a.N, a.M, a.ld_y, ST, ST, SW128);
  if (!ok) return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(x_update_tma<X>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem1);
  if (err != cudaSuccess) return (int)err;
  const int stripes = (a.M + BM1 - 1) / BM1;
  x_update_tma<X><<<stripes < sms ? stripes : sms, kThreads, kSmem1,
                    a.stream>>>(
      y1, d1, static_cast<const X*>(a.x), static_cast<const float*>(a.ddt),
      a.eps, a.M, a.N, a.K, a.inner, static_cast<X*>(a.x_new),
      static_cast<bf16*>(a.xc));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int chunks = (a.M + a.chunk_rows - 1) / a.chunk_rows;
  err = cudaFuncSetAttribute(stats_tma,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kSmem2);
  if (err != cudaSuccess) return (int)err;
  stats_tma<<<dim3((a.N + BN2 - 1) / BN2 + 1, chunks), kThreads, kSmem2,
              a.stream>>>(xc2, y2, a.M, a.N, a.K, a.chunk_rows,
                          static_cast<float*>(a.part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_reduce(static_cast<const float*>(a.part),
                       (long long)a.K * a.N + (long long)a.K * a.K, chunks,
                       static_cast<float*>(a.out), a.stream);
}

}  // namespace

// The C interface, loaded with ctypes. y (M x N, row stride ld_y) and d (K
// x N, row stride ld_d) bf16 with 16-byte-aligned rows; x and x_new (M x K)
// f32 or bf16 (x_bf16); ddt (K x K) f32; xc (M x 128) bf16 scratch; part
// chunks x S f32 scratch with chunks = ceil(M / chunk_rows), chunk_rows a
// multiple of 64; out S f32 = [numd (K x N) | gram (K x K)]. Returns 0 or
// the first non-zero cudaError_t.
extern "C" int mu_dense_tma_launch(int x_bf16, const void* y, int ld_y,
                                   const void* x, const void* d, int ld_d,
                                   const void* ddt, float eps, int M, int N,
                                   int K, int inner, int chunk_rows,
                                   void* x_new, void* xc, void* part,
                                   void* out, void* stream) {
  const Args a{y, x, d, ddt, ld_y, ld_d, eps, M, N, K, inner, chunk_rows,
               x_new, xc, part, out, static_cast<cudaStream_t>(stream)};
  if (M < 1 || N < 1 || K < 1 || K > KP || inner < 1 || chunk_rows < ST ||
      chunk_rows % ST != 0 || ld_y < N || ld_d < N || ld_y % 8 != 0 ||
      ld_d % 8 != 0)
    return (int)cudaErrorInvalidValue;
  return x_bf16 ? launch<bf16>(a) : launch<float>(a);
}
