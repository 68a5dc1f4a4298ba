// The whole batched ISTA / FISTA / acc_ista lasso solve on Hopper (sm_90a)
// at precision 'high' (bf16x3 on the tensor cores), one launch per solve:
// persistent blocks whose row slots are refilled from a queue, and the Gram
// streamed by bulk copies through a ring of stages.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_fista.py:349
// solve_rows (pallas_call :435, body _kernel :133), real and group_fc
// (complex) mode, for hi_lo = true. It computes what lasso_fista.cu's HILO
// path computes, bit for bit, for every row: the same 16-deep tiles in
// ascending k, the same three mma.sync products per tile summed in their own
// registers (hi.lo, lo.hi, then hi.hi) and added with __fadd_rn, the same
// column ownership (warp w owns columns 512 c + 64 w .. + 63 of every chunk
// c, in mma.sync's accumulator layout), the same _rn epilogue and the same
// fixed order of per-row sums. A row's arithmetic depends on no other row
// and on no slot, so where a row runs changes none of its bits.
// lasso_fista.cu keeps 'highest' (full f32 FMAs) and is the reference this
// kernel is held against.
//
// What bounds it on an H100, and what the design does about it.
//   - G does not fit on chip (1 MB of bf16 halves at F = 512 against 227 KB
//     of shared memory), so every block streams all of G from L2 once per
//     iteration of its R row slots. The stream is a ring of S stages
//     filled by the TMA unit's bulk copy (cp.async.bulk), S tiles ahead,
//     with a full mbarrier per stage; the eight warps wait on a stage's
//     barrier, never on a block-wide one per tile. A warp done with a stage
//     counts itself out on the stage's counter, and the last one refills
//     it with the tile S ahead. (A ninth, producer warp would cap the block
//     at 168 registers a thread, and the 32-slot variant spills there: it
//     keeps 64 accumulators and 64 values of x a thread.) A stage is one
//     16-deep tile of a 512-column chunk, hi then lo: 32 KB for a full
//     chunk, and only the rows the chunk's columns read for a narrower one
//     (chunk_rows), so a small F streams no padding. The wrapper lays the
//     Gram's halves out once per solve as these stage images, in stream
//     order and already swizzled as lasso_fista.cu swizzles its tiles (the
//     16-byte halves of a row swap on rows with bit 2 set), so one bulk
//     copy moves a stage and the fragment addressing is unchanged; a
//     tensor map over the plain halves would issue a request per 32-byte
//     box row. The last warp out issues the copy, and the slowest warp is
//     the one that pays for it, so the issue does no division.
//   - The products: each warp keeps four independent mma.sync chains in
//     flight (tile_product), where lasso_fista.cu ran one at a time.
//     Measured on the card, one block alone runs an iteration no faster
//     than a block in a full wave, so the per-SM work, not the card's
//     aggregate L2 rate, sets the pace.
//   - Schedule: one persistent block per SM owns R slots (R = 32 at F <=
//     512, 16 up to 1,024). A slot's row leaves when it stops (tol, its own
//     maxiter, or it came in done) and writes x, z, t, done and niter; the
//     slot then takes the next row index from a device counter (an integer
//     atomicAdd; no float atomics, so two runs give the same bits). A stripe
//     no longer iterates until its slowest row stops, and there is no
//     partial last wave: only the drain is left, when the last rows run in
//     blocks whose other slots are empty. Each block counts its slot-
//     iterations (empty slots included) into slot_iters, so the caller can
//     read the schedule's waste as sum(slot_iters) / sum(niter).
//   - x lives in registers in the accumulator's layout (only the owning
//     thread reads it, in the epilogue); shared memory holds the product's
//     operand v (z for the momentum methods, else x) in f32, so four 32 KB
//     stages fit beside it.
//   - Complex mode: the Gram is read once. lasso_fista.cu reads the real
//     embedding [[Re, Im], [-Im, Re]] (4 MB of halves at Fc = 512); here the
//     kernel reads P = (Re G, Im G) as interleaved pairs, row n holding
//     column n of G (2 MB), and builds each mma.sync B fragment in registers:
//     (Re, -Im) for output column 2n, (Im, Re) for 2n + 1. The split is
//     symmetric in sign, hi(-v) = -hi(v) and lo(-v) = -lo(v), except that
//     lo is +0 for both signs when the remainder is exactly 0; so hi's sign
//     bit flips always and lo's unless lo is +0. The fragments hold the
//     embedding's bits (tests/test_torch_lasso_tma.py checks this on the
//     host), so the result stays bit-identical.
// Left for later: wgmma (it would change the in-tile summation and so the
// bits) and a CTA pair that shares each tile by TMA multicast (it halves
// the L2 reads, which do not set the pace yet).

#include "lasso_common.cuh"

namespace {

constexpr int NWARPS = THREADS / 32;

// A stage: the hi then the lo tile (kTileRows rows each).
template <bool GROUP>
constexpr int kStageBytes = 2 * kTileRows<GROUP> * KD * 2;
template <bool GROUP> constexpr int kStages = GROUP ? 8 : 4;

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
  long long* slot_iters;
};

// acc[mt][8 c + j] += V[rows][k0 .. k0 + 15] G[k0 .. k0 + 15][cols] for the
// warp's columns of chunk c, G tile (hi then lo, `rows` rows each) in buf. Each output tile
// keeps lasso_fista.cu's order: its three products summed in their own
// registers, the small ones first (hi.lo, lo.hi, hi.hi), then added to acc
// with one round-to-nearest add. The products of G = 4 / MT column tiles
// and the MT row tiles (four chains) go pass by pass, so that four
// independent mma.sync chains are in flight where lasso_fista.cu had one.
template <bool GROUP, int MT, int NT>
__device__ __forceinline__ void tile_product(float (&acc)[MT][NT][4],
                                             const float* Vs, int lds,
                                             const unsigned char* buf,
                                             int rows, int k0, int c,
                                             int cbase, int F, int lane) {
  constexpr int G = 4 / MT;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* Bh = reinterpret_cast<const bf16*>(buf);
  const bf16* Bl = Bh + rows * KD;
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
  for (int j0 = 0; j0 < 8; j0 += G) {
    if (cbase + 8 * j0 >= F) break;  // warp-uniform: past the last column
    uint32_t h[G][2], l[G][2];
    bool in[G];
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      in[jj] = cbase + 8 * (j0 + jj) < F;
      const int n = (cbase % NCOL) + 8 * (j0 + jj) + g;
      if (GROUP) {
        const int nu = n >> 1;
        const bool odd = n & 1;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          h[jj][hf] = embed_pair(word(Bh, nu, hf, tq), odd, false);
          l[jj][hf] = embed_pair(word(Bl, nu, hf, tq), odd, true);
        }
      } else {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          h[jj][hf] = word(Bh, n, hf, tq);
          l[jj][hf] = word(Bl, n, hf, tq);
        }
      }
    }
    float st[G][MT][4];
#pragma unroll
    for (int jj = 0; jj < G; ++jj)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) st[jj][mt][i] = 0.f;
#pragma unroll
    for (int pass = 0; pass < 3; ++pass)
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        if (!in[jj]) continue;  // warp-uniform
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint32_t(&a)[4] = pass == 1 ? alo[mt] : ahi[mt];
          const uint32_t(&b)[2] = pass == 0 ? l[jj] : h[jj];
          mma_sched(st[jj][mt], a, b[0], b[1]);
        }
      }
#pragma unroll
    for (int jj = 0; jj < G; ++jj) {
      if (!in[jj]) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float* cc = acc[mt][8 * c + j0 + jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) cc[i] = __fadd_rn(cc[i], st[jj][mt][i]);
      }
    }
  }
}

// Shared memory, from a 1024-aligned base: S stages | S full mbarriers, S
// release counters (uint32) | Vs (R x lds f32) | step, thr (FK f32) | red
// (NWARPS x R x 3 f32) | t, beta (R f32) | row, state, done, it, nit, rst,
// fresh (R int) | flags (4 int).
template <bool GROUP>
__host__ __device__ constexpr size_t smem_bytes(int R, int fk) {
  return 1024 + (size_t)kStages<GROUP> * kStageBytes<GROUP> +
         16 * kStages<GROUP> + (size_t)R * lds_of(fk) * 4 +
         (size_t)2 * fk * 4 + (size_t)NWARPS * R * 3 * 4 + (size_t)R * 9 * 4 +
         16;
}

// The stream of stage images: nst = NCH nks tiles an iteration, tile s of
// chunk c = s / nks (only chunk 0 can precede another, and it is then a
// full one), bytes0 and bytes1 the size of a chunk-0 and a chunk-1 image
// (64 bytes a row: 16 bf16, hi and lo).
struct Stream {
  const unsigned char* gimg;
  int nks, nst, bytes0, bytes1;
};

// Issue tile s (0 <= s < nst) of the stream into stage st: one bulk copy.
// The last warp out of a stage runs this, so it is on the block's critical
// path: no division, no 64-bit remainder.
template <bool GROUP>
__device__ __forceinline__ void issue_tile(const Stream& sm,
                                           unsigned char* ring, uint64_t* full,
                                           int st, int s) {
  constexpr int SB = kStageBytes<GROUP>;
  const bool c1 = s >= sm.nks;
  const int bytes = c1 ? sm.bytes1 : sm.bytes0;
  const unsigned char* src =
      sm.gimg + (c1 ? (size_t)sm.nks * sm.bytes0 + (size_t)(s - sm.nks) * bytes
                    : (size_t)s * bytes);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_expect(full + st, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(ring + st * SB)),
      "l"(src), "r"(bytes), "r"(smem_u32(full + st))
      : "memory");
}

// s mod nst for 0 <= s < nst + S.
__device__ __forceinline__ int wrap(int s, int nst) {
  while (s >= nst) s -= nst;
  return s;
}

template <bool GROUP, int MT, int NT>
__global__ void __launch_bounds__(THREADS, 1)
    solve_rows_tma(Params p) {
  constexpr int R = 16 * MT;
  constexpr int NCH = NT / 8;
  constexpr int S = kStages<GROUP>;
  constexpr int SB = kStageBytes<GROUP>;
  static_assert(NT % 8 == 0 && MT * NT <= 16, "at most 64 accumulators a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * SB);
  unsigned* released = reinterpret_cast<unsigned*>(full + S);
  const int F = p.F;
  const int FK = (F + KD - 1) / KD * KD;
  const int lds = lds_of(FK);
  float* Vs = reinterpret_cast<float*>(full + 2 * S);
  float* step_s = Vs + R * lds;
  float* thr_s = step_s + FK;
  float* red = thr_s + FK;
  float* t_s = red + NWARPS * R * 3;
  float* beta_s = t_s + R;
  int* row_s = reinterpret_cast<int*>(beta_s + R);
  int* state_s = row_s + R;
  int* done_s = state_s + R;
  int* it_s = done_s + R;
  int* nit_s = it_s + R;
  int* rst_s = nit_s + R;
  int* fresh_s = rst_s + R;
  volatile int* flags = fresh_s + R;  // any slot held, any slot running

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const bool mom = p.momentum != 0;
  const int nks = FK / KD;
  const int nst = NCH * nks;   // tiles per iteration
  const Stream sm{p.gimg, nks, nst, chunk_rows<GROUP>(F, 0) * KD * 4,
                  NCH > 1 ? chunk_rows<GROUP>(F, 1) * KD * 4 : 0};

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int i = 0; i < S; ++i)
      issue_tile<GROUP>(sm, ring, full, i, wrap(i, nst));
  }
  for (int e = threadIdx.x; e < R * lds; e += THREADS) Vs[e] = 0.f;
  for (int j = threadIdx.x; j < FK; j += THREADS) {
    step_s[j] = j < F ? p.step[j] : 0.f;
    thr_s[j] = j < F ? p.thr[j] : 0.f;
  }
  if (threadIdx.x < R) {
    row_s[threadIdx.x] = -1;
    state_s[threadIdx.x] = EMPTY;
    fresh_s[threadIdx.x] = 0;
  }
  __syncthreads();

  long long q = 0;       // tiles consumed
  long long iters = 0;   // slot-iterations run (thread 0)
  bool exhausted = false;
  float xr[MT][NT][4];   // x of the owned elements
  for (;;) {
    // A. Warp 0: leaving rows write their scalars and free their slot;
    // empty slots take the next rows from the queue.
    if (warp == 0) {
      int st = EMPTY;
      bool none = false;
      if (lane < R) {
        st = state_s[lane];
        fresh_s[lane] = 0;
        if (st == LEAVING) {
          const int r = row_s[lane];
          p.t[r] = t_s[lane];
          p.done[r] = done_s[lane] ? 1.f : 0.f;
          p.nit[r] = nit_s[lane];
          st = EMPTY;
        }
        if (st == EMPTY && !exhausted) {
          const unsigned idx = atomicAdd(p.queue, 1u);
          if (idx < (unsigned)p.M) {
            const int r = (int)idx;
            const bool in_done = p.done0[r] > 0.5f;
            row_s[lane] = r;
            t_s[lane] = p.t0[r];
            nit_s[lane] = p.nit0[r];
            it_s[lane] = 0;
            done_s[lane] = in_done;
            fresh_s[lane] = 1;
            st = (in_done || p.maxiter == 0) ? LEAVING : RUNNING;
          } else {
            none = true;
          }
        }
        state_s[lane] = st;
      }
      exhausted = exhausted || __any_sync(0xffffffffu, none);
      const int held = __any_sync(0xffffffffu, st != EMPTY);
      const int running = __any_sync(0xffffffffu, st == RUNNING);
      if (lane == 0) {
        flags[0] = held;
        flags[1] = running;
      }
    }
    __syncthreads();
    // B. The owners load the new rows: x into registers, v into Vs.
    int rowg[MT][2];   // the global row of each owned row, -1 unless running
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = frag_row(mt, 2 * h, lane);
        rowg[mt][h] = state_s[row] == RUNNING ? row_s[row] : -1;
        if (!fresh_s[row]) continue;
        const long long base = (long long)row_s[row] * F;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col =
                (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, j, lane);
            if (col >= F) continue;
            const float xv = p.x0[base + col];
            xr[mt][nt][2 * h + j] = xv;
            Vs[row * lds + col] = mom ? p.z0[base + col] : xv;
          }
      }
    __syncthreads();
    if (!flags[0]) break;

    if (flags[1]) {
      // 1. acc = V G over the slots.
      float acc[MT][NT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int cbase = c * NCOL + warp * 64;
        const int rows = chunk_rows<GROUP>(F, c);
        for (int ks = 0; ks < nks; ++ks, ++q) {
          const int st = (int)(q % S);
          mbar_wait(full + st, (uint32_t)((q / S) & 1));
          if (cbase < F)
            tile_product<GROUP, MT, NT>(acc, Vs, lds, ring + st * SB, rows,
                                        ks * KD, c, cbase, F, lane);
          __syncwarp();
          // The last warp out of the stage refills it, S tiles ahead. The
          // fences order every warp's reads of the stage (released through
          // the counter) before the copy that overwrites it.
          if (lane == 0) {
            __threadfence_block();
            if ((atomicAdd(released + st, 1u) + 1) % NWARPS == 0) {
              __threadfence_block();
              issue_tile<GROUP>(sm, ring, full, st,
                                wrap(c * nks + ks + S, nst));
            }
          }
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
          for (int k = 0; k < 3; ++k) part[mt][h][k] = 0.f;
      if (GROUP) {
        // Registers 2h and 2h + 1 hold a complex feature's re and im.
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = frag_row(mt, 2 * h, lane);
              const int col =
                  (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, 2 * h, lane);
              const int gr = rowg[mt][h];
              if (gr < 0 || col >= F) {
                acc[mt][nt][2 * h] = acc[mt][nt][2 * h + 1] = 0.f;
                continue;
              }
              float v[2], u[2];
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                v[j] = Vs[row * lds + col + j];
                const float grad =
                    __fsub_rn(acc[mt][nt][2 * h + j],
                              p.yah[(long long)gr * F + col + j]);
                u[j] = __fsub_rn(v[j], __fmul_rn(step_s[col + j], grad));
              }
              const float sc = pair_scale(u[0], u[1], thr_s[col]);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float xo = xr[mt][nt][2 * h + j];
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
              const int gr = rowg[mt][i >> 1];
              if (gr < 0 || col >= F) {
                acc[mt][nt][i] = 0.f;
                continue;
              }
              const float v = Vs[row * lds + col];
              const float xo = xr[mt][nt][i];
              const float grad =
                  __fsub_rn(acc[mt][nt][i], p.yah[(long long)gr * F + col]);
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
      // order; warp 0 updates each running slot.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            float v = part[mt][h][k];
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
            v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
            if (tq == 0) red[(warp * R + 16 * mt + 8 * h + g) * 3 + k] = v;
          }
      __syncthreads();
      if (warp == 0 && lane < R && state_s[lane] == RUNNING) {
        const int r = lane;
        float Sm[3] = {0.f, 0.f, 0.f};
        for (int w = 0; w < NWARPS; ++w)
#pragma unroll
          for (int k = 0; k < 3; ++k)
            Sm[k] = __fadd_rn(Sm[k], red[(w * R + r) * 3 + k]);
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
      if (threadIdx.x == 0) iters += R;
      __syncthreads();
      // 4. New x and z of the running rows.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = frag_row(mt, i, lane);
            const int col =
                (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, i, lane);
            if (rowg[mt][i >> 1] < 0 || col >= F) continue;
            const float xc = acc[mt][nt][i];
            const float xo = xr[mt][nt][i];
            Vs[row * lds + col] =
                !mom || rst_s[row]
                    ? xc
                    : __fadd_rn(xc, __fmul_rn(beta_s[row], __fsub_rn(xc, xo)));
            xr[mt][nt][i] = xc;
          }
    }

    // C. The owners write x and z of the leaving rows (z = x without
    // momentum); warp 0 writes their scalars in step A.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = frag_row(mt, 2 * h, lane);
        if (state_s[row] != LEAVING) continue;
        const long long base = (long long)row_s[row] * F;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col =
                (nt / 8) * NCOL + warp * 64 + frag_col(nt % 8, j, lane);
            if (col >= F) continue;
            p.x[base + col] = xr[mt][nt][2 * h + j];
            p.z[base + col] = Vs[row * lds + col];
          }
      }
    __syncthreads();
  }

  // Drain: the S tiles issued past the last one consumed land before the
  // block exits.
  if (threadIdx.x == 0) p.slot_iters[blockIdx.x] = iters;
  for (int j = 0; j < S; ++j, ++q)
    mbar_wait(full + (int)(q % S), (uint32_t)((q / S) & 1));
}

template <bool GROUP, int MT, int NT>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  constexpr int R = 16 * MT;
  const int fk = (p.F + KD - 1) / KD * KD;
  const size_t smem = smem_bytes<GROUP>(R, fk);
  cudaError_t err = cudaFuncSetAttribute(
      solve_rows_tma<GROUP, MT, NT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  solve_rows_tma<GROUP, MT, NT><<<blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <bool GROUP>
int dispatch(const Params& p, int rows, int blocks, cudaStream_t stream) {
  if (rows == 32) return launch<GROUP, 2, 8>(p, blocks, stream);
  if (p.F <= NCOL) return launch<GROUP, 1, 8>(p, blocks, stream);
  return launch<GROUP, 1, 16>(p, blocks, stream);
}

}  // namespace

// The C interface, loaded with ctypes. yah, x0, z0 (M x F), t0, done0 (M),
// step, thr (F) f32; nit0 (M) int32; gimg the stage images of the Gram's
// bf16x3 halves (16-byte aligned): for each chunk c of 512 output columns
// and each depth step of 16, in that order, the hi then the lo tile of
// chunk_rows(F, c) rows n of B^T (B(k, n) = G[k, n]; in the complex mode,
// group = 1 and F even, rows of the pair Gram P, row n holding (Re G[k, n],
// Im G[k, n]), up to 256 of them a chunk), 16 bf16 a row with the 16-byte
// halves swapped on rows with bit 2 set, zeros past the matrix. z0 is read
// only when momentum is set. rows is the slot count per block: 32 (F <=
// 512) or 16 (F <= 1024); blocks the grid (one per SM at most). queue is an int32
// zero; slot_iters (blocks) int64 receives each block's slot-iterations.
// Outputs x, z (M x F), t, done (M) f32 and nit (M) int32. Returns 0 or the
// first non-zero cudaError_t.
extern "C" int lasso_solve_rows_tma_launch(
    int momentum, int restart, int fixed, int group, int rows, int blocks,
    const void* yah, const void* gimg, const void* x0, const void* z0,
    const void* t0, const void* done0, const void* nit0, const void* step,
    const void* thr, float tol, int M, int F, int maxiter, void* x, void* z,
    void* t, void* done, void* nit, void* queue, void* slot_iters,
    void* stream) {
  if (M < 1 || F < 1 || F > 2 * NCOL || maxiter < 0 || (group && F % 2) ||
      (rows != 16 && rows != 32) || (rows == 32 && F > NCOL) || blocks < 1 ||
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return group ? dispatch<true>(p, rows, blocks, s)
               : dispatch<false>(p, rows, blocks, s);
}
