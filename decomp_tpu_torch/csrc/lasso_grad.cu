// The masked lasso gradient on Hopper (sm_90a), one launch:
//   g = (mask * (x a) - my) a^T        (M x F)
//
// The first design of the dense-mask gradient, on no route:
// lasso_grad_packed.cu's weighted instance takes a dense (weighted) mask,
// and ops/cuda_lasso.py reaches this kernel only through the private
// _grad_dense_mma_launch, to time it beside that instance.
//
// Replaces the Pallas TPU kernel decomp_tpu/ops/pallas_lasso.py:159
// masked_grad_rows (pallas_call :176, body _grad_rows_kernel :144). my =
// mask * y and mask are (M, N), x (M, F), a (F, N), all in the data's dtype
// (cdt, bf16 or f32), 1 <= F <= KP = 128. With the TPU kernel's
// quantisation points: products take cdt operands and sum in f32; the
// residual E = cdt(f32(mask) * R - f32(my)) is formed in f32 from R = x a;
// g is stored in cdt (x's dtype). bf16 products run on the tensor cores
// (mma.sync, f32 accumulation), f32 products as full-f32 FMAs (never
// TF32), with nmf_common.cuh's warp products and staged loads.
//
// Schedule: the first launch of csrc/mu_kl_stats.cu's masked MU with
// another elementwise step and one accumulator. One block of 256 threads per
// 64-row stripe keeps the stripe's x in shared memory and loops over N in
// 32-wide stages of (my, mask, a), prefetched through registers into
// double-buffered shared memory. Per stage it forms R (64 x 32) in
// registers, writes E to shared memory in cdt and adds E a_stage^T to g
// (64 x F, f32 in registers, summed stage by stage). Each block owns its
// rows of g, so there is no cross-block sum; the M x N residual never
// reaches device memory, and my and mask are read once.
//
// What bounds it on an H100. 4 M N F FLOP against (2 M N + 2 M F + F N)
// elements of cdt. At M = 100,000, N = 1,024, F = 128: 52 GFLOP and 0.92
// GB in f32 (0.78 ms at 67 TFLOP/s of f32 FMA, 0.27 ms at 3.35 TB/s: the
// FMAs bound it), 0.46 GB in bf16 (0.14 ms: HBM bounds it). a (0.5 MB in
// f32) is re-read from L2 by every stripe. Ragged M, N and F are masked in
// the kernel; nothing is padded.

#include "nmf_common.cuh"

namespace {

constexpr int BM = 64;  // rows per block

template <typename T>
constexpr size_t grad_smem() {
  return (size_t)(BM * LDR + BM * LDT + 2 * (2 * BM + KP) * LDT) * sizeof(T);
}

// Warps: the R product as 2 (rows of 32) x 4 (cols of 8); g as 2 (rows of
// 32) x 4 (cols of 32). Shared memory: Xs (BM x LDR) | Es (BM x LDT) | two
// stages of [my (BM x LDT) | mask (BM x LDT) | a (KP x LDT)].
template <typename T>
__global__ void __launch_bounds__(THREADS)
    masked_grad_kernel(const T* __restrict__ my, const T* __restrict__ mask,
                       const T* __restrict__ x, const T* __restrict__ a,
                       int M, int N, int F, T* __restrict__ g, bool y_vec,
                       bool a_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Xs = reinterpret_cast<T*>(smem_raw);
  T* Es = Xs + BM * LDR;
  T* stage0 = Es + BM * LDT;
  constexpr int STAGE = (2 * BM + KP) * LDT;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wr_r = (warp & 1) * 32, wc_r = (warp >> 1) * 8;
  const int wr = (warp & 1) * 32, wc = (warp >> 1) * 32;
  const long long row0 = (long long)blockIdx.x * BM;

  load_tile<T, T, BM, KP>(Xs, LDR, x + row0 * F, F, M - row0, F);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  Stage<T, BM, BK> ys, ms;
  Stage<T, KP, BK> as;
  ys.load(my, N, row0, M, 0, N, y_vec);
  ms.load(mask, N, row0, M, 0, N, y_vec);
  as.load(a, N, 0, F, 0, N, a_vec);
  ys.store(stage0, LDT);
  ms.store(stage0 + BM * LDT, LDT);
  as.store(stage0 + 2 * BM * LDT, LDT);
  __syncthreads();
  const int n_stages = (N + BK - 1) / BK;
  for (int s = 0; s < n_stages; ++s) {
    const T* Ys = stage0 + (s & 1) * STAGE;
    const T* Ms = Ys + BM * LDT;
    const T* As = Ys + 2 * BM * LDT;
    const bool more = s + 1 < n_stages;
    if (more) {
      const long long c_next = (long long)(s + 1) * BK;
      ys.load(my, N, row0, M, c_next, N, y_vec);
      ms.load(mask, N, row0, M, c_next, N, y_vec);
      as.load(a, N, 0, F, c_next, N, a_vec);
    }
    // R = x a_stage (BM x BK), then E into shared memory.
    float r[2][1][4] = {};
#pragma unroll
    for (int k0 = 0; k0 < KP; k0 += 16)
      WarpMma<T, false, true>::template run<1>(r, Xs, LDR, As, LDT, k0, wr_r,
                                               wc_r, lane);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wr_r + frag_row(mt, i, lane);
        const int col = wc_r + frag_col(0, i, lane);
        const bool in = row0 + row < M && (long long)s * BK + col < N;
        Es[row * LDT + col] =
            in ? from_f32<T>(__fsub_rn(
                     __fmul_rn(to_f32(Ms[row * LDT + col]), r[mt][0][i]),
                     to_f32(Ys[row * LDT + col])))
               : from_f32<T>(0.f);
      }
    __syncthreads();
    stage_mma<T, false, false>(acc, Es, LDT, As, LDT, wr, wc, lane);
    if (more) {
      T* next = stage0 + ((s + 1) & 1) * STAGE;
      ys.store(next, LDT);
      ms.store(next + BM * LDT, LDT);
      as.store(next + 2 * BM * LDT, LDT);
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long gr = row0 + wr + frag_row(mt, i, lane);
        const int c = wc + frag_col(nt, i, lane);
        if (gr < M && c < F) g[gr * F + c] = from_f32<T>(acc[mt][nt][i]);
      }
}

template <typename T>
int launch(const void* my, const void* mask, const void* x, const void* a,
           int M, int N, int F, void* g, cudaStream_t stream) {
  constexpr size_t smem = grad_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      masked_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool y_vec = rows_aligned<T>(my, N) && rows_aligned<T>(mask, N);
  masked_grad_kernel<T><<<(M + BM - 1) / BM, THREADS, smem, stream>>>(
      static_cast<const T*>(my), static_cast<const T*>(mask),
      static_cast<const T*>(x), static_cast<const T*>(a), M, N, F,
      static_cast<T*>(g), y_vec, rows_aligned<T>(a, N));
  return (int)cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes. t_bf16 selects the dtype (bf16 or
// f32) of my, mask, x, a and g. Returns 0 or the first non-zero cudaError_t.
extern "C" int masked_grad_rows_launch(int t_bf16, const void* my,
                                       const void* mask, const void* x,
                                       const void* a, int M, int N, int F,
                                       void* g, void* stream) {
  if (M < 1 || N < 1 || F < 1 || F > KP) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_bf16) return launch<bf16>(my, mask, x, a, M, N, F, g, s);
  return launch<float>(my, mask, x, a, M, N, F, g, s);
}
