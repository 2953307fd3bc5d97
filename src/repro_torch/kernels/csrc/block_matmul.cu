// Tiled matrix product C = A @ B for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel kernels/block_matmul.py::_matmul_kernel (and its
// entry block_matmul) of the JAX package.  What it computes is that kernel's
// function, not its block structure: A row-major (M, K), B row-major (K, N),
// inputs float32 or bfloat16, every product summed in a float32 accumulator,
// the result cast once to float32 or bfloat16.  The TPU kernel carries its
// accumulator across a sequential K grid in VMEM; here a thread block owns one
// output tile and walks K in a loop of its own, keeping the accumulator in
// registers.  Ragged M, N and K are masked at the edge tiles inside the
// kernel, so the host pads nothing.
//
// What bounds it.  On the serving path it computes every CNN stage's 1x1
// pointwise convolution, (H*W, C) @ (C, C): for inceptionv4 at 64x64 input
// M = H*W runs 1024, 1024, 256, 256, ..., 1 while C runs 8 .. 256.  The
// largest of these is 2*256*256*256 = 33.5 MFLOP and under 1 MB, a
// microsecond or less of the card's float32 rate or memory rate, so at these
// shapes the kernel is bound by launch latency and by the bytes it moves,
// not by operations.  The design therefore stays simple: one 64x64 output
// tile per block of 256 threads, 16-deep K slices staged through shared
// memory as float32, a 4x4 register micro-tile per thread (strided by 16 so
// that shared-memory reads are conflict-free and global stores coalesce),
// and float32 FMAs.  Tensor cores (wgmma), TMA and a pipelined ring of
// stages are for large shapes and come later.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;   // output rows per block
constexpr int BN = 64;   // output columns per block
constexpr int BK = 16;   // depth of one K slice in shared memory
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // columns per thread
constexpr int THREADS_N = BN / TN;               // 16
constexpr int THREADS = (BM / TM) * THREADS_N;   // 256

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
block_matmul_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
                    TOut* __restrict__ c, int m, int n, int k) {
  // A's slice is kept transposed (k-major) so that both operands are read
  // along the tile's fast axis in the inner loop; the extra column spreads
  // the transposing stores over the banks.
  __shared__ float as[BK][BM + 1];
  __shared__ float bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % THREADS_N;
  const int ty = tid / THREADS_N;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += BK) {
    // Stage the (BM x BK) slice of A and the (BK x BN) slice of B, with
    // zeros outside the matrices so the edge tiles need no other masking.
#pragma unroll
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      const int r = idx / BK;
      const int kk = idx % BK;
      const int gr = row0 + r;
      const int gk = k0 + kk;
      as[kk][r] = (gr < m && gk < k)
                      ? load_f32(a + static_cast<size_t>(gr) * k + gk)
                      : 0.0f;
    }
#pragma unroll
    for (int idx = tid; idx < BK * BN; idx += THREADS) {
      const int kk = idx / BN;
      const int cc = idx % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      bs[kk][cc] = (gk < k && gc < n)
                       ? load_f32(b + static_cast<size_t>(gk) * n + gc)
                       : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM];
      float bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = bs[kk][tx + j * THREADS_N];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty + i * (BM / TM);
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx + j * THREADS_N;
      if (gc < n) store_f32(c + static_cast<size_t>(gr) * n + gc, acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
void launch(const void* a, const void* b, void* c, int m, int n, int k,
            cudaStream_t stream) {
  const dim3 grid((m + BM - 1) / BM, (n + BN - 1) / BN);
  block_matmul_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(a), static_cast<const TIn*>(b),
      static_cast<TOut*>(c), m, n, k);
}

}  // namespace

// C (m, n) = A (m, k) @ B (k, n), all row-major and contiguous.  in_bf16 and
// out_bf16 pick bfloat16 (1) or float32 (0) for the inputs and the output.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int block_matmul(const void* a, const void* b, void* c, int m,
                            int n, int k, int in_bf16, int out_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) {
    if (out_bf16)
      launch<__nv_bfloat16, __nv_bfloat16>(a, b, c, m, n, k, s);
    else
      launch<__nv_bfloat16, float>(a, b, c, m, n, k, s);
  } else {
    if (out_bf16)
      launch<float, __nv_bfloat16>(a, b, c, m, n, k, s);
    else
      launch<float, float>(a, b, c, m, n, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}
