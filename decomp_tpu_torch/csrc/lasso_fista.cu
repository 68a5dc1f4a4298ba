// The whole batched ISTA / FISTA / acc_ista lasso solve on Hopper (sm_90a),
// one launch per solve.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_fista.py:349
// solve_rows (pallas_call :435, body _kernel :133). Given yah = y a^T
// (M, F), the Gram G = a a^T (F, F), the start x0, z0 (M, F), t0, done0,
// nit0 (M), per-feature step and threshold vectors (F) and tol, each row
// iterates on its own until |x' - x| / max(|x'|, tiny) < tol or maxiter:
//   v = z (momentum) or x;  u = v - step (v G - yah)
//   x' = sign(u) max(|u| - thresh, 0)
//   momentum: t' = (1 + sqrt(1 + 4 t^2)) / 2, z' = x' + ((t - 1) / t') (x' - x);
//   acc_ista restarts a row (t' = 1, z' = x') when (z - x').(x' - x) > 0.
// A done row keeps x, z, t and stops counting; rows entering done never
// move. fixed = 1 (the caller knows tol <= 0) drops the stopping test: rows
// that entered done are kept and the rest count maxiter iterations, the
// same bits as the exact mode at tol = 0. Outputs x, z (z = x for ISTA), t,
// done (0/1 f32) and niter (int32). Every elementwise step is written with
// the _rn intrinsics, so nothing is contracted into an FMA and the exact and
// fixed modes round identically.
//
// Complex mode (GROUP; the TPU kernel's group_fc, pallas_fista.py:192-
// 205). A complex64 row of Fc features is F = 2 Fc interleaved reals
// [re_0, im_0, re_1, im_1, ...] (a contiguous complex tensor viewed as f32),
// G the real embedding of the Hermitian Gram with the 2 x 2 block
// [[Re G_kn, Im G_kn], [-Im G_kn, Re G_kn]] at (k, n), symmetric because G
// is Hermitian, so the product, the splits and the tile loads are the real
// ones. Only the prox differs: the paired-magnitude soft threshold
// x' = u max(1 - thresh / max(|u|, tiny), 0) of each complex u = (re, im).
// In mma.sync's accumulator layout the two reals of a feature are the
// adjacent registers i = 0, 1 (row g) and i = 2, 3 (row g + 8) of one
// thread, so the pair never leaves the thread. The wrapper repeats each
// feature's step and threshold in both reals. The stopping and restart sums
// over all 2 Fc reals are the complex norms and Re<z - x', x' - x>.
//
// Precision. HILO = false ('highest'): v G in full f32 FMAs on the CUDA
// cores, never TF32. HILO = true ('high'): bf16x3 on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulation). The wrapper splits G once,
// hi = bf16(bits & 0xFFFF0000) (truncation, exact), lo = bf16_rn(G - hi),
// and passes both halves transposed (rows of G^T); the kernel splits each
// iterate the same way as it reads it, and sums hi.Ghi + hi.Glo + lo.Ghi.
//
// Schedule. One block of 256 threads owns a stripe of R = 32 rows (F <= 512)
// or R = 16 rows (F <= 1024) and runs every iteration of that stripe; it
// exits once every row is done or maxiter is reached. Stripes are
// independent, so there is no grid-wide synchronisation. x and z stay in
// shared memory in f32 for the whole solve (2 R F 4 bytes, 128 KB at
// R F = 16,384), with t, done and niter per row. Each iteration:
//   1. product: v G for the stripe, G streamed from L2 in 16-deep,
//      512-wide tiles (32 KB), double-buffered with cp.async; each warp owns
//      64 columns of every 512-column chunk, all R rows, in mma.sync's
//      16 x 8 accumulator layout (MT x NT tiles, 64 f32 per thread);
//   2. epilogue in registers: the candidate x' of every owned element, and
//      per-row partial sums of |x' - x|^2, |x'|^2 and (z - x').(x' - x);
//   3. per-row sums: a fixed order of warp shuffles, then of the 8 warps'
//      partials in shared memory; one warp updates t, done and niter;
//   4. every thread writes its elements' new x and z.
// No float atomics: two runs on the same inputs give the same bits, and a
// row's result does not depend on R or on the other rows.
//
// What bounds it on an H100. G cannot stay on chip as it does in VMEM on
// the TPU: at F = 512 it is 1 MB (f32, or its two bf16 halves) against
// 227 KB of shared memory, so every stripe re-reads all of G from L2 every
// iteration: at config 2 (M = 10,000, F = 512, R = 32) 313 stripes x 1 MB
// = 330 MB of L2 traffic per iteration of the whole batch, against 15.7
// GFLOP (bf16x3) of products. L2 bandwidth, not HBM or the tensor cores, is
// the design's cost driver; clusters with TMA multicast of G are the later
// remedy. Shared memory (~207 KB) allows one block per SM: 313 stripes make
// 2.4 waves over 132 SMs. Ragged M and F are masked in the kernel; nothing
// is padded. The complex mode at config-2-complex (Fc = 512, F = 1024,
// R = 16) reads 4 MB of G halves per stripe-iteration, 256 KB per
// row-iteration against 32 KB at config 2: it is L2-bound further below its
// operations bound.

#include "nmf_common.cuh"

namespace {

constexpr int NCOL = 512;                  // columns per tile chunk
constexpr int KD = 16;                     // depth of one G tile
constexpr int TILE_BYTES = KD * NCOL * 4;  // f32 tile, or two bf16 tiles
constexpr int NWARPS = THREADS / 32;
constexpr float F32_TINY = 1.17549435e-38f;

struct Params {
  const float* yah;
  const void* g0;  // f32 G (F x F), or bf16 hi(G)^T
  const void* g1;  // bf16 lo(G)^T (HILO only)
  const float *x0, *z0, *t0, *done0;
  const int* nit0;
  const float *step, *thr;
  float tol;
  int M, F, maxiter, momentum, restart, fixed, g_vec;
  float *x, *z, *t, *done;
  int* nit;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Swizzle of a 16-wide bf16 tile row: its two 16-byte halves swap on rows
// with bit 2 set, so the 8 rows of an mma fragment read 32 distinct banks.
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the copy of G tile s (chunk s / nks, depth s % nks) into buf.
// f32: buf[kk][n] = G[k0 + kk][c0 + n]. bf16: two tiles [n][16], hi then
// lo, row n holding G^T[c0 + n][k0 .. k0 + 15], swizzled. Whole in-range
// 16-byte groups go by cp.async; the ragged edge by plain stores (zeros
// outside the matrix), visible after the caller's barrier.
template <bool HILO>
__device__ __forceinline__ void issue_tile(const Params& p, int s, int nks,
                                           unsigned char* buf) {
  const int k0 = (s % nks) * KD, c0 = (s / nks) * NCOL;
  const int F = p.F;
#pragma unroll
  for (int q = 0; q < TILE_BYTES / 16 / THREADS; ++q) {
    const int e = threadIdx.x + q * THREADS;
    if (!HILO) {
      const int kk = e / (NCOL / 4), cn = (e % (NCOL / 4)) * 4;
      const int k = k0 + kk, c = c0 + cn;
      float* dst = reinterpret_cast<float*>(buf) + kk * NCOL + cn;
      const float* src = static_cast<const float*>(p.g0) + (long long)k * F;
      if (p.g_vec && k < F && c + 4 <= F) {
        cp_async16(dst, src + c);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[j] = (k < F && c + j < F) ? src[c + j] : 0.f;
      }
    } else {
      const int arr = e / (2 * NCOL), n = (e % (2 * NCOL)) / 2, h = e % 2;
      const int row = c0 + n, k = k0 + 8 * h;
      bf16* dst = reinterpret_cast<bf16*>(buf) + arr * NCOL * KD + swz(n, h);
      const bf16* src = static_cast<const bf16*>(arr ? p.g1 : p.g0) +
                        (long long)row * F;
      if (p.g_vec && row < F && k + 8 <= F) {
        cp_async16(dst, src + k);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          dst[j] = (row < F && k + j < F) ? src[k + j] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

// acc[mt][8 c + j] += V[rows][k0 .. k0 + 15] G[k0 .. k0 + 15][cols] for the
// warp's columns of chunk c, G tile in buf.
template <bool HILO, int MT, int NT>
__device__ __forceinline__ void tile_product(float (&acc)[MT][NT][4],
                                             const float* Vs, int lds,
                                             const unsigned char* buf, int k0,
                                             int c, int cbase, int F,
                                             int lane) {
  const int g = lane >> 2, tq = lane & 3;
  if (HILO) {
    const bf16* Bh = reinterpret_cast<const bf16*>(buf);
    const bf16* Bl = Bh + NCOL * KD;
    uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = 16 * mt + g, k = k0 + 2 * tq;
      split2(*reinterpret_cast<const float2*>(Vs + r * lds + k), ahi[mt][0],
             alo[mt][0]);
      split2(*reinterpret_cast<const float2*>(Vs + (r + 8) * lds + k),
             ahi[mt][1], alo[mt][1]);
      split2(*reinterpret_cast<const float2*>(Vs + r * lds + k + 8),
             ahi[mt][2], alo[mt][2]);
      split2(*reinterpret_cast<const float2*>(Vs + (r + 8) * lds + k + 8),
             ahi[mt][3], alo[mt][3]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (cbase + 8 * j >= F) break;  // warp-uniform: past the last column
      const int n = (cbase % NCOL) + 8 * j + g;
      const uint32_t h0 =
          *reinterpret_cast<const uint32_t*>(Bh + swz(n, 0) + 2 * tq);
      const uint32_t h1 =
          *reinterpret_cast<const uint32_t*>(Bh + swz(n, 1) + 2 * tq);
      const uint32_t l0 =
          *reinterpret_cast<const uint32_t*>(Bl + swz(n, 0) + 2 * tq);
      const uint32_t l1 =
          *reinterpret_cast<const uint32_t*>(Bl + swz(n, 1) + 2 * tq);
      // The tile's three products are summed in their own registers, the
      // small ones first, and added to acc with a round-to-nearest add: the
      // tensor cores' f32 accumulation does not round to nearest, and one
      // chain over all of F drifted from the twin (7.4e-4 relative in x at
      // config 2, against 0 for the f32 FMA path).
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(st, ahi[mt], l0, l1);
        mma_bf16(st, alo[mt], h0, h1);
        mma_bf16(st, ahi[mt], h0, h1);
        float* cc = acc[mt][8 * c + j];
#pragma unroll
        for (int i = 0; i < 4; ++i) cc[i] = __fadd_rn(cc[i], st[i]);
      }
    }
  } else {
    const float* Bt = reinterpret_cast<const float*>(buf);
#pragma unroll 4
    for (int kk = 0; kk < KD; ++kk) {
      float a[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = Vs[(16 * mt + g) * lds + k0 + kk];
        a[mt][1] = Vs[(16 * mt + g + 8) * lds + k0 + kk];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cbase + 8 * j >= F) break;
        const float2 b = *reinterpret_cast<const float2*>(
            Bt + kk * NCOL + (cbase % NCOL) + 8 * j + 2 * tq);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float* cc = acc[mt][8 * c + j];
          cc[0] = fmaf(a[mt][0], b.x, cc[0]);
          cc[1] = fmaf(a[mt][0], b.y, cc[1]);
          cc[2] = fmaf(a[mt][1], b.x, cc[2]);
          cc[3] = fmaf(a[mt][1], b.y, cc[3]);
        }
      }
    }
  }
}

// sign(u) max(|u| - thr, 0), NaN kept.
__device__ __forceinline__ float shrink(float u, float thr) {
  const float m = __fsub_rn(fabsf(u), thr);
  if (m != m) return m;
  return m > 0.f ? copysignf(m, u) : 0.f;
}

// max(1 - thr / max(|re + i im|, tiny), 0): the scale of the complex soft
// threshold, NaN kept.
__device__ __forceinline__ float pair_scale(float re, float im, float thr) {
  const float mag =
      __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im)));
  if (mag != mag) return mag;
  const float s = __fsub_rn(1.f, __fdiv_rn(thr, fmaxf(mag, F32_TINY)));
  return (s > 0.f || s != s) ? s : 0.f;
}

__host__ __device__ constexpr int lds_of(int fk, bool hilo) {
  return fk + (hilo ? 8 : 4);
}

// Shared memory, in order: Xs, Zs (R x lds f32) | two G tiles | step, thr
// (FK f32) | red (NWARPS x R x 3 f32) | t, beta (R f32) | done, nit, keep,
// rst (R int) | flag.
__host__ __device__ constexpr size_t smem_bytes(int R, int fk, bool hilo) {
  return (size_t)2 * R * lds_of(fk, hilo) * 4 + 2 * TILE_BYTES +
         (size_t)2 * fk * 4 + (size_t)NWARPS * R * 3 * 4 + (size_t)R * 6 * 4 +
         16;
}

template <bool HILO, bool GROUP, int MT, int NT>
__global__ void __launch_bounds__(THREADS, 1) solve_rows_kernel(Params p) {
  constexpr int R = 16 * MT;
  constexpr int NCH = NT / 8;
  static_assert(NT % 8 == 0 && MT * NT <= 16, "at most 64 accumulators a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int F = p.F;
  const int FK = (F + KD - 1) / KD * KD;
  const int lds = lds_of(FK, HILO);
  float* Xs = reinterpret_cast<float*>(smem_raw);
  float* Zs = Xs + R * lds;
  unsigned char* Gbuf = reinterpret_cast<unsigned char*>(Zs + R * lds);
  float* step_s = reinterpret_cast<float*>(Gbuf + 2 * TILE_BYTES);
  float* thr_s = step_s + FK;
  float* red = thr_s + FK;
  float* t_s = red + NWARPS * R * 3;
  float* beta_s = t_s + R;
  int* done_s = reinterpret_cast<int*>(beta_s + R);
  int* nit_s = done_s + R;
  int* keep_s = nit_s + R;
  int* rst_s = keep_s + R;
  int* flag_s = rst_s + R;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)blockIdx.x * R;
  const int rows = (int)min((long long)R, (long long)p.M - row0);
  const bool mom = p.momentum != 0;
  float* Vs = mom ? Zs : Xs;

  for (int e = threadIdx.x; e < R * lds; e += THREADS) {
    const int i = e / lds, j = e % lds;
    const bool in = i < rows && j < F;
    const long long off = (row0 + i) * F + j;
    Xs[e] = in ? p.x0[off] : 0.f;
    if (mom) Zs[e] = in ? p.z0[off] : 0.f;
  }
  for (int j = threadIdx.x; j < FK; j += THREADS) {
    step_s[j] = j < F ? p.step[j] : 0.f;
    thr_s[j] = j < F ? p.thr[j] : 0.f;
  }
  if (threadIdx.x < R) {
    const int i = threadIdx.x;
    const bool in = i < rows;
    t_s[i] = in ? p.t0[row0 + i] : 1.f;
    done_s[i] = in ? (p.done0[row0 + i] > 0.5f) : 1;
    nit_s[i] = in ? p.nit0[row0 + i] : 0;
  }
  __syncthreads();
  if (warp == 0) {
    const int all = __all_sync(0xffffffffu, lane >= R || done_s[lane]);
    if (lane == 0) *flag_s = all;
  }
  __syncthreads();

  const int nks = FK / KD;
  const int nst = NCH * nks;
  for (int it = 0; it < p.maxiter && !*flag_s; ++it) {
    // 1. acc = V G over the stripe.
    float acc[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    issue_tile<HILO>(p, 0, nks, Gbuf);
    cp_async_commit();
    int s = 0;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int cbase = c * NCOL + warp * 64;
      for (int ks = 0; ks < nks; ++ks, ++s) {
        if (s + 1 < nst)
          issue_tile<HILO>(p, s + 1, nks, Gbuf + ((s + 1) & 1) * TILE_BYTES);
        cp_async_commit();
        cp_async_wait1();
        __syncthreads();
        if (cbase < F)
          tile_product<HILO, MT, NT>(acc, Vs, lds,
                                     Gbuf + (s & 1) * TILE_BYTES, ks * KD, c,
                                     cbase, F, lane);
        __syncthreads();
      }
    }

    // 2. Candidates in place of acc, and per-row partial sums: q = 0
    // |x' - x|^2, q = 1 |x'|^2, q = 2 (z - x').(x' - x).
    float part[MT][2][3];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 3; ++q) part[mt][h][q] = 0.f;
    if (GROUP) {
      // Registers 2h and 2h + 1 hold columns col and col + 1 of one row: a
      // complex feature's re and im (F is even, so both are in or out).
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = frag_row(mt, 2 * h, lane);
            const int col =
                (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, 2 * h, lane);
            if (row >= rows || col >= F) {
              acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
              continue;
            }
            float v[2], u[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              v[j] = Vs[row * lds + col + j];
              const float grad =
                  __fsub_rn(acc[mt][nt][2 * h + j],
                            p.yah[(row0 + row) * F + col + j]);
              u[j] = __fsub_rn(v[j], __fmul_rn(step_s[col + j], grad));
            }
            const float sc = pair_scale(u[0], u[1], thr_s[col]);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const float xo = Xs[row * lds + col + j];
              const float xc = __fmul_rn(u[j], sc);
              acc[mt][nt][2 * h + j] = xc;
              const float d = __fsub_rn(xc, xo);
              float* pr = part[mt][h];
              pr[0] = fmaf(d, d, pr[0]);
              pr[1] = fmaf(xc, xc, pr[1]);
              pr[2] = fmaf(__fsub_rn(v[j], xc), d, pr[2]);
            }
          }
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = frag_row(mt, i, lane);
            const int col =
                (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, i, lane);
            if (row >= rows || col >= F) {
              acc[mt][nt][i] = 0.f;
              continue;
            }
            const float v = Vs[row * lds + col];
            const float xo = Xs[row * lds + col];
            const float grad = __fsub_rn(acc[mt][nt][i],
                                         p.yah[(row0 + row) * F + col]);
            const float u = __fsub_rn(v, __fmul_rn(step_s[col], grad));
            const float xc = shrink(u, thr_s[col]);
            acc[mt][nt][i] = xc;
            const float d = __fsub_rn(xc, xo);
            float* pr = part[mt][i >> 1];
            pr[0] = fmaf(d, d, pr[0]);
            pr[1] = fmaf(xc, xc, pr[1]);
            pr[2] = fmaf(__fsub_rn(v, xc), d, pr[2]);
          }
    }
    // 3. Per-row sums: the 4 lanes of a row, then the warps, in a fixed
    // order.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          float v = part[mt][h][q];
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (tq == 0) red[(warp * R + 16 * mt + 8 * h + g) * 3 + q] = v;
        }
    __syncthreads();
    if (warp == 0) {
      const int r = lane;
      int done = 1;
      if (r < R) {
        float S[3] = {0.f, 0.f, 0.f};
        for (int w = 0; w < NWARPS; ++w)
#pragma unroll
          for (int q = 0; q < 3; ++q)
            S[q] = __fadd_rn(S[q], red[(w * R + r) * 3 + q]);
        const int keep = done_s[r];
        float beta = 0.f;
        int rst = 0;
        if (mom) {
          const float t = t_s[r];
          float tc = __fmul_rn(
              0.5f, __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(
                                       1.f, __fmul_rn(__fmul_rn(4.f, t), t)))));
          beta = __fdiv_rn(__fsub_rn(t, 1.f), tc);
          rst = p.restart && S[2] > 0.f;
          if (rst) tc = 1.f;
          if (!keep) t_s[r] = tc;
        }
        int newly = 0;
        if (!p.fixed) {
          const float num = __fsqrt_rn(S[0]);
          const float den = fmaxf(__fsqrt_rn(S[1]), F32_TINY);
          newly = __fdiv_rn(num, den) < p.tol;
        }
        if (!keep) nit_s[r] += 1;
        done = keep | newly;
        done_s[r] = done;
        keep_s[r] = keep;
        beta_s[r] = beta;
        rst_s[r] = rst;
      }
      const int all = __all_sync(0xffffffffu, done);
      if (lane == 0) *flag_s = all;
    }
    __syncthreads();
    // 4. New x and z of the rows that were not done.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = frag_row(mt, i, lane);
          const int col =
              (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, i, lane);
          if (row >= rows || col >= F || keep_s[row]) continue;
          const float xc = acc[mt][nt][i];
          if (mom) {
            const float xo = Xs[row * lds + col];
            Zs[row * lds + col] =
                rst_s[row] ? xc
                           : __fadd_rn(xc, __fmul_rn(beta_s[row],
                                                     __fsub_rn(xc, xo)));
          }
          Xs[row * lds + col] = xc;
        }
    __syncthreads();
  }

  for (int e = threadIdx.x; e < rows * F; e += THREADS) {
    const int i = e / F, j = e % F;
    const long long off = (row0 + i) * F + j;
    p.x[off] = Xs[i * lds + j];
    p.z[off] = Vs[i * lds + j];
  }
  if (threadIdx.x < rows) {
    const int i = threadIdx.x;
    p.t[row0 + i] = t_s[i];
    p.done[row0 + i] = done_s[i] ? 1.f : 0.f;
    p.nit[row0 + i] = nit_s[i];
  }
}

template <bool HILO, bool GROUP, int MT, int NT>
int launch(const Params& p, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const int fk = (p.F + KD - 1) / KD * KD;
  const size_t smem = smem_bytes(R, fk, HILO);
  cudaError_t err = cudaFuncSetAttribute(
      solve_rows_kernel<HILO, GROUP, MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)p.M + R - 1) / R;
  solve_rows_kernel<HILO, GROUP, MT, NT>
      <<<(unsigned)blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool HILO, bool GROUP>
int dispatch(const Params& p, int rows, cudaStream_t stream) {
  if (rows == 32) return launch<HILO, GROUP, 2, 8>(p, stream);
  if (p.F <= NCOL) return launch<HILO, GROUP, 1, 8>(p, stream);
  return launch<HILO, GROUP, 1, 16>(p, stream);
}

}  // namespace

// The C interface, loaded with ctypes. yah, x0, z0 (M x F), t0, done0 (M),
// step, thr (F) f32; nit0 (M) int32; g0 the f32 Gram (F x F) when hi_lo is
// 0, else g0 and g1 the bf16 halves hi(G)^T and lo(G)^T. z0 is read only
// when momentum is set. rows is the stripe height: 32 (F <= 512) or 16
// (F <= 1024). group = 1 is the complex mode: F even, rows and G
// interleaved as above, step and thr repeated in both reals of a feature.
// Outputs x, z (M x F), t, done (M) f32 and nit (M) int32. Returns 0 or the
// first non-zero cudaError_t.
extern "C" int lasso_solve_rows_launch(
    int hi_lo, int momentum, int restart, int fixed, int group, int rows,
    const void* yah, const void* g0, const void* g1, const void* x0,
    const void* z0, const void* t0, const void* done0, const void* nit0,
    const void* step, const void* thr, float tol, int M, int F, int maxiter,
    void* x, void* z, void* t, void* done, void* nit, void* stream) {
  if (M < 1 || F < 1 || F > 2 * NCOL || maxiter < 0 || (group && F % 2) ||
      (rows != 16 && rows != 32) || (rows == 32 && F > NCOL))
    return (int)cudaErrorInvalidValue;
  const size_t elem = hi_lo ? 2 : 4;
  const int g_vec = reinterpret_cast<uintptr_t>(g0) % 16 == 0 &&
                    (!hi_lo || reinterpret_cast<uintptr_t>(g1) % 16 == 0) &&
                    (F * elem) % 16 == 0;
  const Params p{static_cast<const float*>(yah), g0, g1,
                 static_cast<const float*>(x0), static_cast<const float*>(z0),
                 static_cast<const float*>(t0),
                 static_cast<const float*>(done0),
                 static_cast<const int*>(nit0), static_cast<const float*>(step),
                 static_cast<const float*>(thr), tol, M, F, maxiter, momentum,
                 restart, fixed, g_vec, static_cast<float*>(x),
                 static_cast<float*>(z), static_cast<float*>(t),
                 static_cast<float*>(done), static_cast<int*>(nit)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group)
    return hi_lo ? dispatch<true, true>(p, rows, s)
                 : dispatch<false, true>(p, rows, s);
  return hi_lo ? dispatch<true, false>(p, rows, s)
               : dispatch<false, false>(p, rows, s);
}
