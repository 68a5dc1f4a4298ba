// The whole batched ISTA / FISTA / acc_ista lasso solve on Hopper (sm_90a)
// above 1,024 features, up to the TPU kernel's gate, at both precisions and
// in both the real and the complex mode: one launch per solve, each group
// of row slots on a thread-block cluster.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_fista.py:349
// solve_rows (pallas_call :435, body _kernel :133) at 1,024 < F reals up to
// its gate (pallas_fista.py:115 fits_vmem; cuda_lasso.solve_fits: 1,408 with
// momentum, 1,536 without, 1,280 reals = 640 complex features in the
// group_fc mode). lasso_fista_tma.cu and lasso_fista.cu stop at 1,024: a
// block keeps its rows' whole product on chip, and at F = 1,536 a thread
// would hold 96 accumulators and 96 values of x, and the ring and the
// operand more shared memory than an SM has.
//
// Design.
//   - A cluster of C = ceil(F / 512) blocks (3 everywhere in the band) owns
//     R = 16 row slots. Block c owns the 512-column chunk c of every slot
//     row: warp w the columns 512 c + 64 w .. + 63 in mma.sync's
//     accumulator layout, 32 accumulators and 32 values of x a thread, the
//     layout lasso_fista_tma.cu has at F <= 512.
//   - Each block keeps the whole product operand v (z with momentum, else
//     x; R x F f32, 98.8 KB at F = 1,536) in its shared memory, and streams
//     only its own chunk's Gram tiles: the stage images of
//     cuda_lasso.tile_images (chunk c's run of them), one bulk copy a stage
//     into a ring refilled by the last warp out, as in lasso_fista_tma.cu.
//     After its epilogue a block writes its chunk of the new v into every
//     block of the cluster (st.shared::cluster).
//   - The per-row sums (|x' - x|^2, |x'|^2, the restart product) are each
//     block's partials, summed over its warps in a fixed order, sent to
//     every block and added there in rank order: every block holds the
//     same totals, takes the same decisions and keeps the same copy of the
//     slots' state, with no float atomics. Only the queue is one block's:
//     rank 0 takes the next row indices (an integer atomicAdd) for the
//     free slots, writes the scalars of the rows that left, and hands the
//     indices to every block.
//   - Two cluster barriers an iteration: one after the partials are sent
//     (before any block writes a new v that another block's product may
//     still read), one after the new v and the next rows (before the next
//     product). A row's arithmetic depends on no other row and no slot, so
//     two runs give the same bits whatever the schedule.
//   - Precision, L bf16 limbs an operand. 'high' (L = 2) is bf16x3 as
//     pallas_fista.py:163-182 computes it: hi is the f32 value with its
//     low 16 bits cleared, lo the bf16 rounding of the remainder, and each
//     16-deep tile sums hi.lo + lo.hi + hi.hi in f32. 'highest' (L = 3) is
//     bf16x6 on the same path: three round-to-nearest limbs of v and of the
//     Gram (cuda_mu.split_bf16x3, split3 here), the six products whose limb
//     indices add up to at most 2, smallest first. Not full-f32 FMAs: a
//     thread's 32 columns x 16 deep a tile would run at the FMA rate, 1/15
//     of the tensor cores' bf16 rate, against twice 'high''s products here;
//     and one path serves both precisions.
//   - The ring holds 96 KB whatever the stage: 3 stages of a real 'high'
//     tile (512 rows x 16 deep, 2 limbs: 32 KB), 2 of a real 'highest' one
//     (48 KB), 6 and 4 in the complex mode (256 pair rows).
//   - Complex mode: as in lasso_fista_tma.cu, the kernel reads the pair
//     Gram P = (Re G, Im G), row n holding column n of G, and builds the
//     embedding's B fragments in registers: (Re, -Im) for output column 2n,
//     (Im, Re) for 2n + 1; limb 0's sign flips always, the others' unless
//     they are +0 (their remainders' zero).
// Left for later: chunks of F / C columns (the last block of a cluster at
// F = 1,152 owns 128 columns and waits at the barriers), and st.async on an
// mbarrier in place of the cluster barriers (csrc/dl_bcd_cluster.cu).

#include "lasso_common.cuh"

namespace {

constexpr int R = 16;                      // row slots a cluster
constexpr int MAX_CLUSTER = 3;             // blocks a cluster, F <= 1,536
constexpr int NWARPS = THREADS / 32;
constexpr int RING_BYTES = 96 * 1024;

// A stage: L limb tiles of kTileRows rows, 16 bf16 a row.
template <bool GROUP, int L>
constexpr int kStageBytes = L * kTileRows<GROUP> * KD * 2;
template <bool GROUP, int L>
constexpr int kStages = RING_BYTES / kStageBytes<GROUP, L>;

// A slot's next row as rank 0 hands it over: an index, or none.
constexpr int KEEP = -2, NONE = -1;

struct Params {
  const float* yah;
  const float *x0, *z0, *t0, *done0;
  const int* nit0;
  const float *step, *thr;
  const unsigned char* gimg;  // the stage images, in stream order
  float tol;
  int M, F, maxiter, momentum, restart, fixed;
  float *x, *z, *t, *done;
  int* nit;
  unsigned* queue;
  long long* slot_iters;      // one entry a cluster
};

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// The cluster barrier, every thread of every block (release on arrive,
// acquire on wait: stores to other blocks before it are seen after it).
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The address of p (this block's shared memory) in block r of the cluster.
__device__ __forceinline__ uint32_t remote(const void* p, unsigned r) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(r));
  return a;
}

__device__ __forceinline__ void st_remote(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t a, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(a), "r"(v)
               : "memory");
}
__device__ __forceinline__ void st_remote(uint32_t a, float2 v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(a),
               "f"(v.x), "f"(v.y)
               : "memory");
}

// The limbs of two adjacent f32 values (lower k in the low half): L = 2,
// the 'high' split (hi by the bitmask, lo rounded); L = 3, split3's.
template <int L>
__device__ __forceinline__ void split_v(float2 v, uint32_t (&f)[L]) {
  if constexpr (L == 2) {
    split2(v, f[0], f[1]);
  } else {
    split_pair(v.x, v.y, f);
  }
}

// The limb products of one tile, (limb of v, limb of G), smallest first:
// 'high' hi.lo, lo.hi, hi.hi; 'highest' the six with limb indices adding up
// to at most 2.
template <int L> constexpr int kPasses = L == 2 ? 3 : 6;
template <int L>
__device__ __forceinline__ constexpr int limb_v(int ps) {
  return L == 2 ? (ps == 1 ? 1 : 0)
                : (ps == 0 ? 2 : (ps == 1 || ps == 3) ? 1 : 0);
}
template <int L>
__device__ __forceinline__ constexpr int limb_g(int ps) {
  return L == 2 ? (ps == 0 ? 1 : 0)
                : (ps == 2 ? 2 : (ps == 1 || ps == 4) ? 1 : 0);
}

// acc[j] += V[0..15][k0 .. k0 + 15] G[k0 .. k0 + 15][cols] for the warp's 64
// columns (8 tiles of 8; local column base cl, global cbase), the G tile's
// L limbs (`rows` rows each) in buf. Each output tile sums its limb
// products in its own registers, then adds them to acc with one
// round-to-nearest add; four column tiles go pass by pass, so that four
// independent mma.sync chains are in flight.
template <bool GROUP, int L>
__device__ __forceinline__ void tile_product(float (&acc)[8][4],
                                             const float* Vs, int lds,
                                             const unsigned char* buf,
                                             int rows, int k0, int cl,
                                             int cbase, int F, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const bf16* B = reinterpret_cast<const bf16*>(buf);
  uint32_t a[L][4];
  {
    const int k = k0 + 2 * tq;
    uint32_t f[4][L];
    split_v<L>(*reinterpret_cast<const float2*>(Vs + g * lds + k), f[0]);
    split_v<L>(*reinterpret_cast<const float2*>(Vs + (g + 8) * lds + k),
               f[1]);
    split_v<L>(*reinterpret_cast<const float2*>(Vs + g * lds + k + 8), f[2]);
    split_v<L>(*reinterpret_cast<const float2*>(Vs + (g + 8) * lds + k + 8),
               f[3]);
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[l][i] = f[i][l];
  }
#pragma unroll
  for (int j0 = 0; j0 < 8; j0 += 4) {
    if (cbase + 8 * j0 >= F) break;  // warp-uniform: past the last column
    uint32_t b[4][L][2];
    bool in[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      in[jj] = cbase + 8 * (j0 + jj) < F;
      const int n = cl + 8 * (j0 + jj) + g;
#pragma unroll
      for (int l = 0; l < L; ++l)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const bf16* T = B + l * rows * KD;
          b[jj][l][hf] = GROUP ? embed_pair(word(T, n >> 1, hf, tq), n & 1,
                                            l > 0)
                               : word(T, n, hf, tq);
        }
    }
    float st[4][4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[jj][i] = 0.f;
#pragma unroll
    for (int ps = 0; ps < kPasses<L>; ++ps)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (!in[jj]) continue;  // warp-uniform
        mma_sched(st[jj], a[limb_v<L>(ps)], b[jj][limb_g<L>(ps)][0],
                  b[jj][limb_g<L>(ps)][1]);
      }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (!in[jj]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[j0 + jj][i] = __fadd_rn(acc[j0 + jj][i], st[jj][i]);
    }
  }
}

// Shared memory, from a 1024-aligned base: the ring | S full mbarriers, S
// release counters | Vs (R x lds f32) | step, thr of the block's chunk
// (NCOL f32 each) | red (NWARPS x R x 3 f32) | xred (MAX_CLUSTER x R x 3
// f32) | t, beta (R f32) | row, state, done, it, nit, rst, fresh, nrow (R
// int) | flags (4 int).
template <bool GROUP, int L>
__host__ __device__ constexpr size_t smem_bytes(int fk) {
  return 1024 + (size_t)RING_BYTES + 16 * kStages<GROUP, L> +
         (size_t)R * lds_of(fk) * 4 + (size_t)2 * NCOL * 4 +
         (size_t)(NWARPS + MAX_CLUSTER) * R * 3 * 4 + (size_t)R * 10 * 4 + 16;
}

// Start the copy of tile s of the block's chunk (0 <= s < nks, `bytes`
// each, from src) into stage st: one bulk copy, counted on the stage's
// full barrier.
template <bool GROUP, int L>
__device__ __forceinline__ void issue_tile(const unsigned char* src,
                                           int bytes, unsigned char* ring,
                                           uint64_t* full, int st, int s) {
  constexpr int SB = kStageBytes<GROUP, L>;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(full + st, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + st * SB)),
      "l"(src + (size_t)s * bytes), "r"(bytes), "r"(smem_u32(full + st))
      : "memory");
}

// s mod n for 0 <= s < n + S.
__device__ __forceinline__ int wrap(int s, int n) {
  while (s >= n) s -= n;
  return s;
}

template <bool GROUP, int L>
__global__ void __launch_bounds__(THREADS, 1) solve_rows_wide(Params p) {
  constexpr int S = kStages<GROUP, L>;
  constexpr int SB = kStageBytes<GROUP, L>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + RING_BYTES);
  unsigned* released = reinterpret_cast<unsigned*>(full + S);
  const int F = p.F;
  const int FK = (F + KD - 1) / KD * KD;
  const int lds = lds_of(FK);
  float* Vs = reinterpret_cast<float*>(full + 2 * S);
  float* step_s = Vs + R * lds;
  float* thr_s = step_s + NCOL;
  float* red = thr_s + NCOL;
  float* xred = red + NWARPS * R * 3;
  float* t_s = xred + MAX_CLUSTER * R * 3;
  float* beta_s = t_s + R;
  int* row_s = reinterpret_cast<int*>(beta_s + R);
  int* state_s = row_s + R;
  int* done_s = state_s + R;
  int* it_s = done_s + R;
  int* nit_s = it_s + R;
  int* rst_s = nit_s + R;
  int* fresh_s = rst_s + R;
  int* nrow_s = fresh_s + R;
  volatile int* flags = nrow_s + R;  // any slot held, any slot running

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tq = lane & 3;
  const unsigned rank = cluster_rank(), C = cluster_size();
  const bool mom = p.momentum != 0;
  const int nks = FK / KD;
  const int c0 = (int)rank * NCOL;               // the block's first column
  const int cl = warp * 64, cbase = c0 + cl;     // the warp's columns
  const int rows = chunk_rows<GROUP>(F, (int)rank);
  const int bytes = rows * KD * 2 * L;
  // Chunk c's images follow c full chunks' (only the last can be narrower).
  const unsigned char* gsrc =
      p.gimg + (size_t)rank * nks * (kTileRows<GROUP> * KD * 2 * L);

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < S; ++i)
      issue_tile<GROUP, L>(gsrc, bytes, ring, full, i, wrap(i, nks));
  }
  for (int e = threadIdx.x; e < R * lds; e += THREADS) Vs[e] = 0.f;
  for (int j = threadIdx.x; j < NCOL; j += THREADS) {
    step_s[j] = c0 + j < F ? p.step[c0 + j] : 0.f;
    thr_s[j] = c0 + j < F ? p.thr[c0 + j] : 0.f;
  }
  if (threadIdx.x < R) {
    row_s[threadIdx.x] = -1;
    state_s[threadIdx.x] = EMPTY;
    fresh_s[threadIdx.x] = 0;
  }
  // Every block of the cluster has started and set its slots up before
  // any block writes into it.
  __syncthreads();
  cluster_sync();

  long long q = 0;       // tiles consumed
  long long iters = 0;   // slot-iterations run (rank 0, thread 0)
  bool exhausted = false;
  float xr[8][4];        // x of the owned elements
  float acc[8][4];       // the product, then x', then the new v
  for (;;) {
    // A. Rank 0, warp 0: the rows that left write their scalars; every
    // free slot takes the next row from the queue, handed to every block.
    if (rank == 0 && warp == 0) {
      bool none = false;
      if (lane < R) {
        int st = state_s[lane], idx = KEEP;
        if (st == LEAVING) {
          const int r = row_s[lane];
          p.t[r] = t_s[lane];
          p.done[r] = done_s[lane] ? 1.f : 0.f;
          p.nit[r] = nit_s[lane];
          st = EMPTY;
        }
        if (st == EMPTY) {
          idx = NONE;
          if (!exhausted) {
            const unsigned u = atomicAdd(p.queue, 1u);
            if (u < (unsigned)p.M) idx = (int)u;
            else none = true;
          }
        }
        for (unsigned r = 0; r < C; ++r) st_remote(remote(nrow_s + lane, r), idx);
      }
      exhausted = exhausted || __any_sync(0xffffffffu, none);
    }
    cluster_sync();
    // A'. Every block: the free slots take their rows (the same in every
    // block).
    if (warp == 0) {
      int st = EMPTY;
      if (lane < R) {
        st = state_s[lane];
        fresh_s[lane] = 0;
        const int idx = nrow_s[lane];
        if (idx >= 0) {
          const bool in_done = p.done0[idx] > 0.5f;
          row_s[lane] = idx;
          t_s[lane] = p.t0[idx];
          nit_s[lane] = p.nit0[idx];
          it_s[lane] = 0;
          done_s[lane] = in_done;
          fresh_s[lane] = 1;
          st = (in_done || p.maxiter == 0) ? LEAVING : RUNNING;
        } else if (idx == NONE) {
          st = EMPTY;
        }
        state_s[lane] = st;
      }
      const int held = __any_sync(0xffffffffu, st != EMPTY);
      const int running = __any_sync(0xffffffffu, st == RUNNING);
      if (lane == 0) {
        flags[0] = held;
        flags[1] = running;
      }
    }
    __syncthreads();
    // B. The new rows: every block loads v's whole row into its Vs, the
    // owners x of their columns into registers.
    for (int r = 0; r < R; ++r) {
      if (!fresh_s[r]) continue;
      const long long base = (long long)row_s[r] * F;
      const float* src = mom ? p.z0 : p.x0;
      for (int j = threadIdx.x; j < F; j += THREADS)
        Vs[r * lds + j] = src[base + j];
    }
    int rowg[2];   // the global row of each owned row, -1 unless running
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row(0, 2 * h, lane);
      rowg[h] = state_s[row] == RUNNING ? row_s[row] : -1;
      if (!fresh_s[row]) continue;
      const long long base = (long long)row_s[row] * F;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = cbase + frag_col(nt, j, lane);
          if (col < F) xr[nt][2 * h + j] = p.x0[base + col];
        }
    }
    __syncthreads();
    if (!flags[0]) break;
    const bool running = flags[1] != 0;

    if (running) {
      // 1. acc = V G over the slots, the block's chunk of columns.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
      for (int ks = 0; ks < nks; ++ks, ++q) {
        const int st = (int)(q % S);
        mbar_wait(full + st, (uint32_t)((q / S) & 1));
        if (cbase < F)
          tile_product<GROUP, L>(acc, Vs, lds, ring + st * SB, rows, ks * KD,
                                 cl, cbase, F, lane);
        __syncwarp();
        // The last warp out of the stage refills it, S tiles ahead.
        if (lane == 0) {
          __threadfence_block();
          if ((atomicAdd(released + st, 1u) + 1) % NWARPS == 0) {
            __threadfence_block();
            issue_tile<GROUP, L>(gsrc, bytes, ring, full, st,
                                 wrap(ks + S, nks));
          }
        }
      }

      // 2. Candidates in place of acc, and per-row partial sums: k = 0
      // |x' - x|^2, k = 1 |x'|^2, k = 2 (z - x').(x' - x).
      float part[2][3];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) part[h][k] = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(0, 2 * h, lane);
          const int lc = cl + frag_col(nt, 2 * h, lane), col = c0 + lc;
          const int gr = rowg[h];
          if (gr < 0 || col >= F) {
            acc[nt][2 * h] = acc[nt][2 * h + 1] = 0.f;
            continue;
          }
          // Real: the pair's second column may lie past F.
          float v[2] = {0.f, 0.f}, u[2] = {0.f, 0.f};
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!GROUP && col + j >= F) continue;
            v[j] = Vs[row * lds + col + j];
            const float grad = __fsub_rn(acc[nt][2 * h + j],
                                         p.yah[(long long)gr * F + col + j]);
            u[j] = __fsub_rn(v[j], __fmul_rn(step_s[lc + j], grad));
          }
          // Registers 2h and 2h + 1 are one complex feature's re and im.
          const float sc = GROUP ? pair_scale(u[0], u[1], thr_s[lc]) : 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (!GROUP && col + j >= F) {
              acc[nt][2 * h + j] = 0.f;
              continue;
            }
            const float xo = xr[nt][2 * h + j];
            const float xc =
                GROUP ? __fmul_rn(u[j], sc) : shrink(u[j], thr_s[lc + j]);
            acc[nt][2 * h + j] = xc;
            const float d = __fsub_rn(xc, xo);
            float* pr = part[h];
            pr[0] = fmaf(d, d, pr[0]);
            pr[1] = fmaf(xc, xc, pr[1]);
            pr[2] = fmaf(__fsub_rn(v[j], xc), d, pr[2]);
          }
        }
      // 3. The block's per-row partials: the 4 lanes of a row, then the
      // warps in order; warp 0 sends them to every block.
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          float v = part[h][k];
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
          v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
          if (tq == 0) red[(warp * R + 8 * h + (lane >> 2)) * 3 + k] = v;
        }
      __syncthreads();
      if (warp == 0 && lane < R) {
        float Sm[3] = {0.f, 0.f, 0.f};
        for (int w = 0; w < NWARPS; ++w)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            Sm[k] = __fadd_rn(Sm[k], red[(w * R + lane) * 3 + k]);
        for (unsigned r = 0; r < C; ++r)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            st_remote(remote(xred + (rank * R + lane) * 3 + k, r), Sm[k]);
      }
    }
    cluster_sync();
    if (running) {
      // 4. The totals in rank order, and each running slot's step (the
      // same in every block).
      if (warp == 0 && lane < R && state_s[lane] == RUNNING) {
        const int r = lane;
        float Sm[3] = {0.f, 0.f, 0.f};
        for (unsigned b = 0; b < C; ++b)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            Sm[k] = __fadd_rn(Sm[k], xred[(b * R + r) * 3 + k]);
        float beta = 0.f;
        int rst = 0;
        if (mom) {
          const float t = t_s[r];
          float tc = __fmul_rn(
              0.5f, __fadd_rn(1.f, __fsqrt_rn(__fadd_rn(
                                       1.f, __fmul_rn(__fmul_rn(4.f, t), t)))));
          beta = __fdiv_rn(__fsub_rn(t, 1.f), tc);
          rst = p.restart && Sm[2] > 0.f;
          if (rst) tc = 1.f;
          t_s[r] = tc;
        }
        int newly = 0;
        if (!p.fixed) {
          const float num = __fsqrt_rn(Sm[0]);
          const float den = fmaxf(__fsqrt_rn(Sm[1]), F32_TINY);
          newly = __fdiv_rn(num, den) < p.tol;
        }
        nit_s[r] += 1;
        it_s[r] += 1;
        beta_s[r] = beta;
        rst_s[r] = rst;
        if (newly || it_s[r] >= p.maxiter) {
          done_s[r] = newly;
          state_s[r] = LEAVING;
        }
      }
      if (rank == 0 && threadIdx.x == 0) iters += R;
      __syncthreads();
      // 5. New x (registers) and v of the running rows, the block's
      // columns written into every block's Vs.
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = frag_row(0, 2 * h, lane);
          const int col = cbase + frag_col(nt, 2 * h, lane);
          if (rowg[h] < 0 || col >= F) continue;
          float vn[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float xc = acc[nt][2 * h + j];
            const float xo = xr[nt][2 * h + j];
            vn[j] = !mom || rst_s[row]
                        ? xc
                        : __fadd_rn(xc,
                                    __fmul_rn(beta_s[row], __fsub_rn(xc, xo)));
            xr[nt][2 * h + j] = xc;
            acc[nt][2 * h + j] = vn[j];
          }
          float* dst = Vs + row * lds + col;
          if (col + 1 < F) {
            for (unsigned r = 0; r < C; ++r)
              st_remote(remote(dst, r), make_float2(vn[0], vn[1]));
          } else {
            for (unsigned r = 0; r < C; ++r) st_remote(remote(dst, r), vn[0]);
          }
        }
    }

    // C. The owners write x and z of the leaving rows (z = x without
    // momentum): rows that ran this iteration from registers, rows that
    // entered done from what step B loaded.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = frag_row(0, 2 * h, lane);
      if (state_s[row] != LEAVING) continue;
      const long long base = (long long)row_s[row] * F;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = cbase + frag_col(nt, j, lane);
          if (col >= F) continue;
          p.x[base + col] = xr[nt][2 * h + j];
          p.z[base + col] = rowg[h] >= 0 ? acc[nt][2 * h + j]
                                         : Vs[row * lds + col];
        }
    }
  }

  // Drain: the S tiles issued past the last one consumed land before the
  // block exits; no block leaves while another may still read it.
  if (rank == 0 && threadIdx.x == 0) p.slot_iters[blockIdx.x / C] = iters;
  for (int j = 0; j < S; ++j, ++q)
    mbar_wait(full + (int)(q % S), (uint32_t)((q / S) & 1));
  cluster_sync();
}

template <bool GROUP, int L>
int launch(const Params& p, int csize, int clusters, cudaStream_t stream) {
  const size_t smem = smem_bytes<GROUP, L>((p.F + KD - 1) / KD * KD);
  void (*kern)(Params) = solve_rows_wide<GROUP, L>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * csize, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // No more clusters than run at once: the rest would only wait.
  int fit = 0;
  err = cudaOccupancyMaxActiveClusters(&fit, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (fit < 1) return (int)cudaErrorInvalidConfiguration;
  if (clusters > fit) cfg.gridDim = dim3(fit * csize, 1, 1);
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes. yah, x0, z0 (M x F), t0, done0 (M),
// step, thr (F) f32; nit0 (M) int32; gimg the stage images of the Gram's
// limbs (16-byte aligned): limbs = 2 ('high': cuda_lasso.split_hi_lo's hi
// and lo) or 3 ('highest': cuda_mu.split_bf16x3's), laid out as
// cuda_lasso.tile_images lays them: for each chunk c of 512 output columns
// and each depth step of 16, the limbs' tiles of chunk_rows(F, c) rows n of
// B^T (B(k, n) = G[k, n]; in the complex mode, group = 1 and F even, rows of
// the pair Gram P, row n holding (Re G[k, n], Im G[k, n]), up to 256 of them
// a chunk), 16 bf16 a row with the 16-byte halves swapped on rows with bit 2
// set, zeros past the matrix. z0 is read only when momentum is set.
// 1 <= F <= 1,536 (the caller holds F to the TPU kernel's gate); a cluster
// of ceil(F / 512) blocks owns 16 rows. clusters: at most that many
// clusters (fewer where fewer run at once). queue is an int32 zero;
// slot_iters (clusters) int64, zeroed, receives each cluster's
// slot-iterations. Outputs x, z (M x F), t, done (M) f32 and nit (M) int32.
// Returns 0 or the first non-zero cudaError_t.
extern "C" int lasso_solve_rows_wide_launch(
    int limbs, int momentum, int restart, int fixed, int group, int clusters,
    const void* yah, const void* gimg, const void* x0, const void* z0,
    const void* t0, const void* done0, const void* nit0, const void* step,
    const void* thr, float tol, int M, int F, int maxiter, void* x, void* z,
    void* t, void* done, void* nit, void* queue, void* slot_iters,
    void* stream) {
  if (M < 1 || F < 1 || F > MAX_CLUSTER * NCOL || maxiter < 0 ||
      (group && F % 2) || (limbs != 2 && limbs != 3) || clusters < 1 ||
      reinterpret_cast<uintptr_t>(gimg) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const float*>(yah),
                 static_cast<const float*>(x0), static_cast<const float*>(z0),
                 static_cast<const float*>(t0),
                 static_cast<const float*>(done0),
                 static_cast<const int*>(nit0), static_cast<const float*>(step),
                 static_cast<const float*>(thr),
                 static_cast<const unsigned char*>(gimg), tol, M, F, maxiter,
                 momentum, restart, fixed, static_cast<float*>(x),
                 static_cast<float*>(z), static_cast<float*>(t),
                 static_cast<float*>(done), static_cast<int*>(nit),
                 static_cast<unsigned*>(queue),
                 static_cast<long long*>(slot_iters)};
  const int csize = (F + NCOL - 1) / NCOL;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group)
    return limbs == 2 ? launch<true, 2>(p, csize, clusters, s)
                      : launch<true, 3>(p, csize, clusters, s);
  return limbs == 2 ? launch<false, 2>(p, csize, clusters, s)
                    : launch<false, 3>(p, csize, clusters, s);
}
