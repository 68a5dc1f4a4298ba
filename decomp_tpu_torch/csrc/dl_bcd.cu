// One block-coordinate-descent sweep of the dictionary update on Hopper
// (sm_90a), in one launch:
//   for k = 0 .. K-1:  u = b_k - a_k d + a_kk d_k
//                      d_k <- u / ||u||   (kept where ||u|| <= f32 tiny)
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_bcd.py:115 bcd_sweep
// (pallas_call :135, body _kernel :82). A = x^T x (K, K), B = x^T y (K, N)
// and d (K, N) are f32; d comes back swept. Step k + 1 reads the row that
// step k wrote, so the sweep is sequential over atoms: one thread block
// runs all of it.
//
// The first design, on no route: ops/cuda_dl.py's bcd_route sends K <=
// 256 atoms and N <= 64 channels to csrc/dl_bcd_sm90.cu (d in registers)
// and every other shape to csrc/dl_bcd_cluster.cu (one thread-block
// cluster). Only cuda_dl._bcd_shared_launch reaches this kernel, so that
// the replacements can be timed in turns with it.
//
// What bounds it on an H100. 2 K^2 N FLOP against 4 (K^2 + 3 K N) bytes:
// at K = 256, N = 64 (BASELINE config 3) 8.4 MFLOP and 0.46 MB, 0.13 us at
// either peak. Neither is the limit: K dependent steps are, each a short
// chain of shared-memory reads, shuffles and two barriers, so the kernel is
// latency bound and its cost is microseconds per atom.
//
// Design. d stays in shared memory for the whole sweep (K x ld f32, ld = N
// rounded up to odd so that the 32 lanes of a warp, which read 32 rows of
// one column, hit 32 banks) and is updated in place. A does not fit (256 KB
// at K = 256), but step k needs only row k of A and of B: they are streamed
// with cp.async into two row buffers, row k + 1 in flight while step k
// computes, so A and B are each read once. Per atom:
//   (a) each warp owns columns n = warp, warp + 16, ...; its lanes split
//       the K-long sum a_k d[:, n] (lane l takes j = l, l + 32, ...), sum
//       their slice with FMAs and combine it by an xor butterfly of
//       shuffles (every lane ends with the same bits). Lane 0 forms u_n
//       with round-to-nearest intrinsics (no contraction: the twin's
//       b - a d + a_kk d_k), stores it, and sums u_n^2 over its columns;
//   barrier;
//   (b) every thread sums the 16 warps' partials in warp order, and the
//       row is scaled, or kept when ||u|| <= tiny (a dead atom keeps its
//       direction); the next rows' copies are waited for;
//   barrier.
// No atomics, so reruns give the same bits. Ragged K and N are handled by
// the loop bounds; nothing is padded. The largest shape is what shared
// memory holds: 4 (K ld + 2 (K + N) + N + 16) bytes <= 227 KB, e.g. K =
// 256, N = 208. csrc/dl_bcd_cluster.cu lifts that limit with a cluster of
// blocks splitting N and ||u||^2 reduced through distributed shared
// memory.

#include <cuda_runtime.h>
#include <float.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr size_t MAX_SMEM = 232448;  // 227 KB, the most a block may take

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Row k of A (K floats) and of B (N floats) into buf = [a_k | b_k].
__device__ __forceinline__ void fetch_rows(float* buf,
                                           const float* __restrict__ A,
                                           const float* __restrict__ B,
                                           int K, int N, int k) {
  const float* a = A + (long long)k * K;
  const float* b = B + (long long)k * N;
  for (int i = threadIdx.x; i < K + N; i += THREADS)
    cp_async4(buf + i, i < K ? a + i : b + (i - K));
  asm volatile("cp.async.commit_group;\n" ::);
}

// Shared memory: D (K x ld) | two row buffers of K + N | U (N) | part (16).
__global__ void __launch_bounds__(THREADS)
    bcd_sweep_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const float* __restrict__ d0, int K, int N, int ld,
                     float* __restrict__ dout) {
  extern __shared__ __align__(16) float sm[];
  float* D = sm;
  float* rows = D + (size_t)K * ld;
  float* U = rows + 2 * (K + N);
  float* part = U + N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long KN = (long long)K * N;

  fetch_rows(rows, A, B, K, N, 0);
  for (long long i = threadIdx.x; i < KN; i += THREADS)
    D[(i / N) * ld + i % N] = d0[i];
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const float* a = rows + (k & 1) * (K + N);
    const float* b = a + K;
    if (k + 1 < K) fetch_rows(rows + ((k + 1) & 1) * (K + N), A, B, K, N,
                              k + 1);
    const float akk = a[k];
    float sq = 0.f;
    for (int n = warp; n < N; n += WARPS) {
      float s = 0.f;
      for (int j = lane; j < K; j += 32) s = fmaf(a[j], D[j * ld + n], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        const float u =
            __fadd_rn(__fsub_rn(b[n], s), __fmul_rn(akk, D[k * ld + n]));
        U[n] = u;
        sq = __fmaf_rn(u, u, sq);
      }
    }
    if (lane == 0) part[warp] = sq;
    __syncthreads();

    float ss = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) ss = __fadd_rn(ss, part[w]);
    const float norm = __fsqrt_rn(ss);
    if (norm > FLT_MIN) {
      const float den = fmaxf(norm, FLT_MIN);
      for (int n = threadIdx.x; n < N; n += THREADS)
        D[k * ld + n] = __fdiv_rn(U[n], den);
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();
  }

  for (long long i = threadIdx.x; i < KN; i += THREADS)
    dout[i] = D[(i / N) * ld + i % N];
}

size_t smem_bytes(int K, int N) {
  const size_t ld = (size_t)(N | 1);
  return sizeof(float) *
         ((size_t)K * ld + 2 * ((size_t)K + N) + (size_t)N + WARPS);
}

}  // namespace

// The C interface, loaded with ctypes. A (K, K), B (K, N), d0 and dout
// (K, N): contiguous f32 on the current device. Returns 0 or the first
// non-zero cudaError_t (cudaErrorInvalidValue where the shape does not fit
// shared memory).
extern "C" int bcd_sweep_launch(const void* A, const void* B, const void* d0,
                                int K, int N, void* dout, void* stream) {
  if (K < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(K, N);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bcd_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  bcd_sweep_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<const float*>(d0), K, N, N | 1, static_cast<float*>(dout));
  return (int)cudaGetLastError();
}
