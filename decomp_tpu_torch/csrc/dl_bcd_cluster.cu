// One block-coordinate-descent sweep of the dictionary update on Hopper
// (sm_90a), on one thread-block cluster:
//   for k = 0 .. K-1:  u = b_k - a_k d + a_kk d_k
//                      d_k <- u / ||u||   (kept where ||u|| <= f32 tiny)
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_bcd.py:115 bcd_sweep
// (pallas_call :135, body _kernel :82) for every shape but K <= 256 atoms
// and N <= 64 channels, which csrc/dl_bcd_sm90.cu takes (ops/cuda_dl.py:
// bcd_route), up to the TPU kernel's own gate (cuda_dl.bcd_fits: the padded
// working set 4 (Kp^2 + 4 Kp Np) + 32 max(Kp, Np) <= 15 MiB, so N <= 3,712
// at K = 256, N <= 98,176 at K = 8, K <= 1,736 at N = 128). A = x^T x
// (K, K), B = x^T y (K, N) and d (K, N) are f32; d comes back swept.
//
// What bounds it on an H100. Step k + 1 reads the row step k wrote, so the
// K steps are sequential: the sweep is latency bound. Its bytes, 4 (K^2 +
// 3 K N), take 0.14 us at 256 x 64 and 4.6 us at 256 x 3,712 at 3.35 TB/s;
// its 2 K^2 N FLOP (486 MFLOP at 256 x 3,712) 7 us at 67 TFLOP/s. One step
// costs a K-long dot product for each of the N columns, one sum over all N
// columns and a division; the first is K N fused multiply-adds whose d
// operand comes from shared memory (one 16-byte read per 4 FMAs), which
// one SM streams at 128 bytes a clock, ~1 us an atom at K N = 53,248.
//
// Design: the N columns are split across a cluster of C blocks (C <= 8,
// the portable size; a function of K and N only, cuda_dl.bcd_cluster_size),
// so C SMs share each step, and the one value that crosses blocks, ||u||^2,
// goes through distributed shared memory. Measured on an H100 (700 W,
// tools/bcd_cluster_variants.py splits an atom into its steps): the
// cluster barrier's arrive with its release cost ~800 cycles an atom, more
// than the remote stores that replaced it.
//   - A block owns nb consecutive columns (a multiple of 4). They are cut
//     into groups of 4 columns, and the groups into `sets` of R groups;
//     each set's rows are split over P lanes (P a power of two, <= 32),
//     lane p taking rows p, p + P, ... Every thread owns the d entries of
//     its rows and its set's columns, for the whole sweep, and is the only
//     thread that writes them, so d needs no barrier at all.
//   - d stays on chip, in shared memory (rows of l4 float4 slots, l4 chosen
//     so the 8 lanes of a 16-byte read hit 8 distinct bank groups). Where
//     a block's columns do not all fit, the sets past `on_sets` keep their
//     d in a global scratch (dw, L2-resident: d is at most 3.8 MB), read
//     and written by their owners only; a warp is wholly in one or the
//     other, so each warp runs one of two instances of the sweep.
//   - Rows of A arrive by bulk copies (cp.async.bulk) into a ring of 4
//     stages, one row a stage, tracked by an mbarrier a stage; thread 0 of
//     each block issues row k + 4 once atom k's exchange has freed its
//     stage. Each thread reads its own columns of B's row straight
//     from global memory (16-byte loads), one atom ahead where its
//     registers allow it (R <= 2), else as it needs them.
//   - Per atom: the P lanes of a set sum their FMA chains (row order) by
//     an xor butterfly, so all hold the same bits; u = (b - s) + a_kk d_k
//     with round-to-nearest operations and no contraction (the twin's
//     b - a d + a_kk d_k); each
//     warp sums u^2 over its sets (lane p = 0 of each set, an FMA chain in
//     column order, then a butterfly), and lane r sends it into slot
//     (rank, warp) of the 128 partials of block r of the cluster (mapa +
//     st.async, each store counted on that block's exchange
//     mbarrier of the atom's parity, which thread 0 arms for the cluster's
//     C x W stores). No cluster barrier and no fence: a block waits only
//     on its own exchange mbarrier (acquire at cluster scope). Between the
//     sends and the wait each thread computes atom k + 1's products over
//     every row but row k (the deferred term of csrc/dl_bcd_sm90.cu).
//     After the wait each warp sums the 128 slots in one fixed order, so
//     every thread of every block gets the same norm and the same keep /
//     scale decision. Every lane divides its u by the norm
//     (dl_bcd_sm90.cu's shared-reciprocal division, __fdiv_rn's bits), the
//     lane that holds row k stores it (or keeps the row when ||u|| <=
//     tiny: a dead atom keeps its direction), and every lane adds a_k+1,k
//     d_k to its next sums.
//   - Why the waits suffice. A warp sends atom k's partial only after every
//     read it makes of row k of A and of the partials of atom k - 2 (the
//     partial depends on their values), so a block whose exchange for atom
//     k completed knows that every warp of the cluster is done with them:
//     thread 0 then refills row k's stage, and atom k + 2's partials, sent
//     after atom k + 1's exchange, never overwrite slots still to be read.
// No float atomics and a fixed order everywhere: reruns give the same bits.
// Ragged K and N are masked in the kernel; only A and B are padded on the
// host (row strides lda and ldb, multiples of 4, for the 16-byte copies
// and loads).

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
constexpr int WARP_SLOTS = MAX_THREADS / 32;
constexpr int SLOTS = MAX_CLUSTER * WARP_SLOTS;   // 128 partials an atom
constexpr int STAGES = 4;
constexpr size_t MAX_SMEM = 232448;

// The column and row split, computed on the host (ops/cuda_dl.py:
// bcd_cluster_plan) and checked by launch().
struct Plan {
  int K, N;        // atoms, channels
  int lda, ldb;    // row strides of A and B, in floats
  int nb;          // columns a block owns
  int sets;        // sets of R groups of 4 columns a block
  int lanes;       // P, the lanes that split a set's rows
  int on_sets;     // the sets whose d lives in shared memory (a prefix)
  int l4;          // row stride of shared d, in float4 slots
  int ldw;         // row stride of a block's global d, in floats
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, warp-aligned (release on arrive, acquire on wait).
__device__ __forceinline__ void cluster_arrive() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  __syncwarp();
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// Stage st <- row `row` of A (lda floats, a multiple of 16 bytes).
__device__ __forceinline__ void issue_row(const float* A, int lda,
                                          float* ring, uint64_t* full,
                                          int st, int row) {
  const uint32_t bytes = (uint32_t)(lda * 4);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(full + st, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + (size_t)st * lda)),
      "l"(A + (size_t)row * lda), "r"(bytes), "r"(smem_u32(full + st))
      : "memory");
}

// A warp's sum of one value a lane, in every lane (each add pairs two
// lanes' values and an f32 add commutes, so all lanes get the same bits).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

// v into word `slot` of the partials `part` of block `r` of the cluster,
// the store counted on that block's exchange mbarrier `bar` (st.async: no
// fence, the mbarrier's completion makes the word visible).
__device__ __forceinline__ void send(float* part, int slot, float v,
                                     uint64_t* bar, int r) {
  uint32_t rp, rb;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rp)
               : "r"(smem_u32(part + slot)), "r"(r));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(rb)
               : "r"(smem_u32(bar)), "r"(r));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(rp),
      "r"(__float_as_uint(v)), "r"(rb)
      : "memory");
}

// Wait for the phase of parity `parity` of an mbarrier whose completion
// other blocks' stores signal (acquire at cluster scope).
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// ||u||^2 from the 128 slots (rank-major, 0 where no warp wrote): lane l
// sums slots 4 l .. 4 l + 3 in order, then warp_sum.
__device__ __forceinline__ float cluster_norm2(const float* part, int lane) {
  const float4 v = reinterpret_cast<const float4*>(part)[lane];
  return warp_sum(__fadd_rn(__fadd_rn(__fadd_rn(v.x, v.y), v.z), v.w));
}

// A thread's d: slot i of row j, in shared or in global memory. Shared
// loads go by ld.shared in program order (measured on the H100 against the
// compiler's own loads: 17 % faster at 1,736 x 128, 1-3 % at K = 256,
// tools/bcd_cluster_variants.py).
struct SharedD {
  float4* p;        // (row 0, slot 0) of this thread's set
  int row, slot;    // strides in float4s
  __device__ __forceinline__ float4 ld(int j, int i) const {
    float4 v;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
                 : "r"(smem_u32(p + j * row + i * slot))
                 : "memory");
    return v;
  }
  __device__ __forceinline__ void st(int j, int i, float4 v) const {
    p[j * row + i * slot] = v;
  }
};
struct GlobalD {
  float4* p;
  int row, slot;
  __device__ __forceinline__ float4 ld(int j, int i) const {
    return p[(size_t)j * row + i * slot];
  }
  __device__ __forceinline__ void st(int j, int i, float4 v) const {
    p[(size_t)j * row + i * slot] = v;
  }
};

struct Ctx {
  const float* A;
  const float* B;
  const float* d0;
  float* dout;
  float* ring;
  uint64_t* full;   // the ring's mbarriers, then the two exchange ones
  float* part;
  int t, lane, warp, set, p, rank, clusters;
  bool active;
};

template <int R>
__device__ __forceinline__ void zero(float (&s)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
}

// s[i][c] = this thread's share of a d[:, column (i, c)]: an FMA chain over
// its `rows` rows j = p0, p0 + P, ... in order, row `skip` left out; then
// the butterfly over the set's P lanes. Groups go in passes of up to 4
// (16 registers of loads in flight; on the H100 passes of 2 at R = 8 took
// 1.22x as long at 8 x 98,176, tools/bcd_cluster_variants.py). With 4 or
// more groups a thread is its set's one lane, its rows are the warp's, and
// row `skip` holds u (see sweep): it is stepped over, not multiplied by 0.
template <int R, class D>
__device__ __forceinline__ void products(float (&s)[R][4], const float* arow,
                                         const D& d, int p0, int rows,
                                         int lanes, int skip) {
  constexpr int G = R < 4 ? R : 4;   // groups a pass
  zero(s);
#pragma unroll
  for (int h = 0; h < R; h += G)
    for (int m = 0, j = p0; m < rows; ++m, j += lanes) {
      if (R >= 4 && j == skip) continue;
      const float a = j == skip ? 0.f : arow[j];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float4 v = d.ld(j, h + i);
        s[h + i][0] = __fmaf_rn(a, v.x, s[h + i][0]);
        s[h + i][1] = __fmaf_rn(a, v.y, s[h + i][1]);
        s[h + i][2] = __fmaf_rn(a, v.z, s[h + i][2]);
        s[h + i][3] = __fmaf_rn(a, v.w, s[h + i][3]);
      }
    }
  for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[i][c] = __fadd_rn(s[i][c], __shfl_xor_sync(~0u, s[i][c], o));
}

// This thread's columns of row `row` of B (0 past N and for idle threads).
template <int R>
__device__ __forceinline__ void load_b(float (&b)[R][4], const float* B,
                                       int ldb, int row, const int (&col)[R],
                                       const bool (&ok)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float4 v =
        ok[i] ? __ldg(reinterpret_cast<const float4*>(B + (size_t)row * ldb +
                                                      col[i]))
              : make_float4(0.f, 0.f, 0.f, 0.f);
    b[i][0] = v.x, b[i][1] = v.y, b[i][2] = v.z, b[i][3] = v.w;
  }
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// The whole sweep for one thread whose d lives in D.
template <int R, class D>
__device__ __forceinline__ void sweep(const Ctx& x, const Plan& pl,
                                      const D& d) {
  const int K = pl.K, N = pl.N, lanes = pl.lanes;
  const int groups = pl.nb >> 2;
  const int n0 = x.rank * pl.nb;
  int col[R];
  bool ok[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int g = x.set + pl.sets * i;
    col[i] = n0 + 4 * g;
    ok[i] = x.active && g < groups && col[i] < N;
  }
  const int p0 = x.active ? x.p : K;   // an idle thread has no rows
  const int rows = p0 < K ? (K - 1 - p0) / lanes + 1 : 0;

  // d0 -> this thread's entries (0 past N).
  for (int j = p0; j < K; j += lanes)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[c] = ok[i] && col[i] + c < N ? x.d0[(size_t)j * N + col[i] + c]
                                       : 0.f;
      d.st(j, i, make_float4(v[0], v[1], v[2], v[3]));
    }
  // The entries, the zeroed partials and the mbarriers, cluster-wide.
  cluster_arrive();
  cluster_wait();
  if (x.t == 0)
    for (int r = 0; r < min(STAGES, K); ++r)
      issue_row(x.A, pl.lda, x.ring, x.full, r, r);

  // Up to 2 groups a thread, B's row for the next atom is loaded before
  // the exchange. With 4 or more (registers are short there, and K is at
  // most 63) each group's B entries are loaded where u needs them, and u
  // waits for the norm in d's row k (its lane's own entries, which the
  // row's old values leave only at this atom: a kept atom rereads them from
  // d0), not in registers.
  constexpr bool STASH = R >= 4;
  float s[R][4], u[R][4], b[R][4];
  if (!STASH) load_b(b, x.B, pl.ldb, 0, col, ok);
  mbar_wait(x.full, 0);
  products(s, x.ring, d, p0, rows, lanes, -1);

  for (int k = 0; k < K; ++k) {
    const float* ak = x.ring + (size_t)(k % STAGES) * pl.lda;
    const float akk = ak[k];
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 dk =
          x.active ? d.ld(k, i) : make_float4(0.f, 0.f, 0.f, 0.f);
      if (STASH) {
        const float4 v =
            ok[i] ? __ldg(reinterpret_cast<const float4*>(
                        x.B + (size_t)k * pl.ldb + col[i]))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
        b[i][0] = v.x, b[i][1] = v.y, b[i][2] = v.z, b[i][3] = v.w;
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        u[i][c] = ok[i] && col[i] + c < N
                      ? __fadd_rn(__fsub_rn(b[i][c], s[i][c]),
                                  __fmul_rn(akk, comp(dk, c)))
                      : 0.f;
        q = __fmaf_rn(u[i][c], u[i][c], q);
      }
      if (STASH && x.active)
        d.st(k, i, make_float4(u[i][0], u[i][1], u[i][2], u[i][3]));
    }
    // The warp's sum of u^2, one lane a set, into slot (rank, warp) of
    // every block's partials of this atom's parity; thread 0 arms its
    // block's exchange mbarrier for the cluster's C x W stores.
    q = warp_sum(x.p == 0 ? q : 0.f);
    float* part = x.part + (k & 1) * SLOTS;
    uint64_t* xbar = x.full + STAGES + (k & 1);
    if (x.t == 0) mbar_expect(xbar, x.clusters * blockDim.x / 32 * 4);
    if (x.lane < x.clusters)   // lane r sends to block r
      send(part, x.rank * WARP_SLOTS + x.warp, q, xbar, x.lane);

    // While the partials travel: atom k + 1's B row and its products over
    // every row but row k, whose term joins after the division.
    const int k1 = k + 1;
    const float* a1 = x.ring + (size_t)(k1 % STAGES) * pl.lda;
    if (k1 < K) {
      if (!STASH) load_b(b, x.B, pl.ldb, k1, col, ok);
      mbar_wait(x.full + k1 % STAGES, (k1 / STAGES) & 1);
      products(s, a1, d, p0, rows, lanes, k);
    }
    mbar_wait_cluster(xbar, (k >> 1) & 1);

    const float norm = __fsqrt_rn(cluster_norm2(part, x.lane));
    const bool keep = norm > FLT_MIN;
    const float den = fmaxf(norm, FLT_MIN);
    const float a = k1 < K ? a1[k] : 0.f;
    const bool owner = x.active && (k & (lanes - 1)) == x.p;
    // A group at a time: u / ||u||, or the row's old values for a kept
    // (dead) atom (from d0 where u took their place in row k); the lane
    // that holds row k stores it; every lane adds a_k+1,k d_k to its sums.
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float v[4];
      if (STASH) {
        const float4 w =
            x.active ? d.ld(k, i) : make_float4(0.f, 0.f, 0.f, 0.f);
        v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = u[i][c];
      }
      div4_rn(v, den, true);
      if (!keep) {
        const float4 w = !STASH && x.active
                             ? d.ld(k, i)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          v[c] = comp(w, c);
          if (STASH && ok[i] && col[i] + c < N)
            v[c] = x.d0[(size_t)k * N + col[i] + c];
        }
      }
      if (owner && (keep || STASH))
        d.st(k, i, make_float4(v[0], v[1], v[2], v[3]));
      if (k1 < K) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[i][c] = __fadd_rn(s[i][c], __fmul_rn(a, v[c]));
      }
    }
    // Every warp of the cluster sent atom k's partial after its last read
    // of row k: the stage is free.
    if (x.t == 0 && k + STAGES < K)
      issue_row(x.A, pl.lda, x.ring, x.full, k % STAGES, k + STAGES);
  }

  // This thread's entries -> dout.
  for (int j = p0; j < K; j += lanes)
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if (!ok[i]) continue;
      const float4 v = d.ld(j, i);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (col[i] + c < N) x.dout[(size_t)j * N + col[i] + c] = comp(v, c);
    }
}

// Shared memory: the ring (STAGES x lda floats) | an mbarrier a stage | the
// partials, 2 x 128 floats | shared d (K x l4 float4 slots).
// 8 groups a thread take at most 384 threads (cuda_dl.bcd_cluster_plan),
// so that each may hold 168 registers.
template <int R>
__global__ void __launch_bounds__(R == 8 ? 384 : MAX_THREADS, 1)
    bcd_sweep_cluster(const float* __restrict__ A,
                      const float* __restrict__ B,
                      const float* __restrict__ d0, float* __restrict__ dout,
                      float* __restrict__ dw, Plan pl) {
  extern __shared__ __align__(128) float sm[];
  Ctx x;
  x.A = A, x.B = B, x.d0 = d0, x.dout = dout;
  x.ring = sm;
  x.full = reinterpret_cast<uint64_t*>(sm + (size_t)STAGES * pl.lda);
  x.part = reinterpret_cast<float*>(x.full + STAGES + 2);
  float4* dsm = reinterpret_cast<float4*>(x.part + 2 * SLOTS);
  x.t = threadIdx.x;
  x.lane = x.t & 31;
  x.warp = x.t >> 5;
  x.set = x.t / pl.lanes;
  x.p = x.t & (pl.lanes - 1);
  x.rank = (int)cluster_rank();
  x.clusters = (int)gridDim.x;
  x.active = x.set < pl.sets;

  if (x.t == 0) {
    for (int s = 0; s < STAGES + 2; ++s) mbar_init(x.full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = x.t; i < 2 * SLOTS; i += blockDim.x) x.part[i] = 0.f;

  // A warp's sets are all on chip or all off it (on_sets is a multiple of
  // a warp's sets, or all of them), and its idle lanes go with its first
  // set, so this branch does not split a warp.
  if (x.warp * 32 / pl.lanes < pl.on_sets) {
    sweep<R>(x, pl, SharedD{dsm + x.set, pl.l4, pl.on_sets});
  } else {
    const int off = pl.sets - pl.on_sets;
    sweep<R>(x, pl,
             GlobalD{reinterpret_cast<float4*>(
                         dw + (size_t)x.rank * pl.K * pl.ldw) +
                         (x.set - pl.on_sets),
                     pl.ldw / 4, off});
  }
  // No block leaves before the cluster's last stores into it landed.
  cluster_arrive();
  cluster_wait();
}

size_t smem_bytes(const Plan& pl) {
  return sizeof(float) * (size_t)STAGES * pl.lda +
         sizeof(uint64_t) * (STAGES + 2) + sizeof(float) * 2 * SLOTS +
         16 * (size_t)pl.K * pl.l4;
}

template <int R>
cudaError_t launch_r(const float* A, const float* B, const float* d0,
                     float* dout, float* dw, const Plan& pl, int clusters,
                     int threads, size_t smem, cudaStream_t stream) {
  void (*kern)(const float*, const float*, const float*, float*, float*,
               Plan) = bcd_sweep_cluster<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, A, B, d0, dout, dw, pl);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes. A (K, lda) and B (K, ldb):
// contiguous f32 rows, zero past K and N, 16-byte aligned; d0 and dout
// (K, N) contiguous f32; dw: clusters x K x ldw f32 of scratch (unused and
// may be null where on_sets == sets); all on the current device. The plan
// is cuda_dl.bcd_cluster_plan's. Returns 0 or the first non-zero
// cudaError_t (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int bcd_sweep_cluster_launch(const void* A, const void* B,
                                        const void* d0, void* dout, void* dw,
                                        int K, int N, int lda, int ldb,
                                        int clusters, int threads, int nb,
                                        int R, int sets, int lanes,
                                        int on_sets, int l4, int ldw,
                                        void* stream) {
  const Plan pl{K, N, lda, ldb, nb, sets, lanes, on_sets, l4, ldw};
  const bool lanes_ok = lanes >= 1 && lanes <= 32 && !(lanes & (lanes - 1));
  const int per_warp = lanes_ok ? 32 / lanes : 1;
  if (K < 1 || N < 1 || clusters < 1 || clusters > MAX_CLUSTER ||
      threads < 32 || threads > MAX_THREADS || threads % 32 || !lanes_ok ||
      (R != 1 && R != 2 && R != 4 && R != 8) || (R == 8 && threads > 384) ||
      (R >= 4 && lanes != 1) ||   // u waits in row k: one lane a set
      nb < 4 || nb % 4 ||
      (long long)clusters * nb < N || sets < 1 ||
      (long long)sets * lanes > threads || 4LL * R * sets < nb ||
      lda % 4 || lda < K || ldb % 4 || ldb < N || on_sets < 0 ||
      on_sets > sets || (on_sets < sets && on_sets % per_warp) ||
      l4 < R * on_sets || ldw % 4 || ldw < 4 * R * (sets - on_sets) ||
      (on_sets < sets && dw == nullptr) ||
      reinterpret_cast<uintptr_t>(A) % 16 ||
      reinterpret_cast<uintptr_t>(B) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(pl);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* d = static_cast<const float*>(d0);
  float* o = static_cast<float*>(dout);
  float* w = static_cast<float*>(dw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto go = R == 1 ? launch_r<1> : R == 2 ? launch_r<2>
           : R == 4 ? launch_r<4> : launch_r<8>;
  return (int)go(a, b, d, o, w, pl, clusters, threads, smem, st);
}
