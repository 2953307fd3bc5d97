// Matrix product C = A @ B for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel kernels/block_matmul.py::_matmul_kernel (entry
// block_matmul) of the JAX package.  What it computes is that kernel's
// function, not its block structure: A row-major (M, K), B row-major (K, N),
// both float32 or both bfloat16, every product summed in a float32
// accumulator, the result cast once to float32 or bfloat16.  The TPU kernel
// carries its accumulator across a sequential K grid in VMEM; here a block
// owns an output tile and walks K itself.  Ragged M, N and K are handled
// inside the kernels (zero-filled loads, masked stores): the host pads
// nothing.
//
// Two routes, fixed by type and shape (kernels/matmul.py::route mirrors the
// dispatch in block_matmul() below; neither gives way to the other):
//
//   bfloat16, K % 8 == 0, N % 8 == 0, M * N * K >= BLOCK_MATMUL_TC_MIN_MNK
//       -> tensor-core kernel (tc::gemm_kernel); needs 16-byte-aligned A, B
//   everything else, every float32 call -> CUDA-core kernel (cc::gemm_kernel)
//
// What bounds it.  On the serving path the kernel computes every CNN stage's
// 1x1 pointwise convolution, (H*W, C) @ (C, C) in float32: (M, K = N) runs
// 1024x8, 1024x16, 256x16 .. 32, 64x32 .. 64, 16x64 .. 128, 4x160, 4x192 and
// 1x256 (inceptionv4 and mnasnet).  The largest is 0.52 MFLOP and moves
// under 300 KB, well under a microsecond of the card's float32 rate or memory
// rate: at every path shape what bounds the kernel is latency -- the launch,
// one trip to memory and back, the depth of the dependent FMA chain -- and
// how much of the card a handful of blocks can use.  Large bfloat16
// products, as in the 4096^3 yardstick, are bound by operations: 137 GFLOP
// is 0.139 ms of the tensor cores' 989 TFLOP/s.
//
// CUDA-core route (float32 FMAs; float32 on the tensor cores would be TF32
// and break the float32 tolerances; at 0.52 MFLOP they would buy nothing).
//  - One round trip: the block starts cp.async copies of its whole K extent
//    (a ring of two stages, each 32 to 128 deep; K <= 256 at every path
//    shape) before the first FMA waits.  Copies are 16 bytes where a row's
//    length and base allow (every path shape), one element otherwise
//    (ragged shapes).  Where K is longer the ring refills a stage as soon as
//    it has been read.
//  - The output tile is chosen from the shape (cc_dispatch), so that the
//    path's products spread over 8 to 64 blocks instead of 1 to 16:
//      M <= 4 (the GEMV end)        4 x 8 tile, K split over 8 warps
//      M <= 16, or M <= 64, K >= 32 16 x 8 tile, K split over 8 warps
//      N <= 8                       32 x 8 tile, one output per thread
//      N <= 64, K <= 256            16 x 16 tile, one output per thread
//      otherwise                    64 x 64 tile, 4 x 4 outputs per thread
//    Where K is split, each warp sums a slice of every stage and the
//    partial sums meet in shared memory, so that (1, 256, 256) runs as 32
//    blocks of 32-deep chains, not 4 blocks of 256-deep ones.
//  - Operands stay in their input type in shared memory and are widened at
//    the FMA; A's rows are padded by 16 bytes so that the rows a warp reads
//    fall in distinct banks.
//
// Tensor-core route (bfloat16 operands with 16-byte rows, above a size
// threshold measured on the card).
//  - A 128 x 256 output tile per block of three warpgroups: two consumers
//    own 64 rows each and run wgmma.mma_async m64n256k16 (float32
//    accumulators, 128 registers a thread); one producer thread starts the
//    TMA copies.  setmaxnreg moves registers from the producer warpgroup to
//    the consumers.
//  - K is walked in 64-deep stages in a ring of 4 (48 KB a stage) on
//    mbarriers: "full" completes when a stage's bytes have landed (TMA's
//    complete_tx), "empty" when all 8 consumer warps have finished their
//    wgmma on it.
//  - TMA writes both operands in the 128-byte-swizzle layout that wgmma
//    reads: A (128 rows x 64 K) K-major; B as four 64 K x 64 N panels,
//    MN-major, read with wgmma's transpose bit, so no transposed copy is
//    made.  TMA zero-fills boxes past M, N and K, so nothing is masked on
//    the way in; the epilogue masks its stores and casts to the output type.
//  - The tensor maps are built on the host per call (cuTensorMapEncodeTiled,
//    fetched through cudaGetDriverEntryPoint, so nothing links libcuda) and
//    passed as __grid_constant__ kernel parameters; the dynamic shared-memory
//    size is set once per device, so a launch captured in a CUDA graph makes
//    no other call.
//  A persistent grid, a TMA store epilogue and clusters are left for later.
#include <cuda.h>   // CUtensorMap and its enums only: no libcuda symbol is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

// The tensor-core route takes bfloat16 products with M * N * K at or above
// this (kernels/matmul.py::TENSOR_CORE_MIN_MNK).  A build may override it
// to force either route when the two are compared.
#ifndef BLOCK_MATMUL_TC_MIN_MNK
#define BLOCK_MATMUL_TC_MIN_MNK 2097152LL
#endif

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(bf16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Allows `kernel` `bytes` of dynamic shared memory (needed above 48 KB) once
// per device, at the first launch, so that a launch captured into a CUDA
// graph makes no call but the launch itself.  `configured` has bit d set once
// done on device d.
cudaError_t allow_dynamic_smem(const void* kernel, size_t bytes, unsigned& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    configured |= 1u << dev;
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// CUDA-core route: every float32 call, and bfloat16 calls that do not take
// the tensor cores.  See the note at the top.
// ---------------------------------------------------------------------------
namespace cc {

constexpr int THREADS = 256;
constexpr int STAGES = 2;

// An output tile of BM x BN per block; each thread owns a TM x TN micro-tile
// (rows RY apart, columns CX apart) of one of KS groups that split K.
template <int BM_, int BN_, int TM_, int TN_, int KS_, int KC_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_, KS = KS_, KC = KC_;
  static constexpr int RY = BM / TM, CX = BN / TN;
  static_assert(KS * RY * CX == THREADS, "one thread per micro-tile and K group");
  static_assert(KC % 8 == 0 && BN % 8 == 0, "whole 16-byte chunks per row in either type");
};

using Gemv = Tile<4, 8, 1, 1, 8, 128>;
using Narrow = Tile<16, 8, 2, 2, 8, 128>;
using Col8 = Tile<32, 8, 1, 1, 1, 64>;
using Col16 = Tile<16, 16, 1, 1, 1, 64>;
using Square = Tile<64, 64, 4, 4, 1, 32>;

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [r0, r0 + ROWS) and columns [c0, c0 + COLS) of a row-major
// (rows, cols) matrix into dst[r * LD + c], zeros outside the matrix.  With
// `vec` (cols * sizeof(T) a multiple of 16, a 16-byte-aligned base, c0 a
// multiple of 16 bytes) in 16-byte cp.async chunks, each wholly inside or
// wholly outside a row; otherwise one element at a time (cp.async of 4 bytes
// for float32, a plain load and store for bfloat16).
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int rows, int cols,
                                          int r0, int c0, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    constexpr int CHUNKS = COLS / V;
    for (int idx = threadIdx.x; idx < ROWS * CHUNKS; idx += THREADS) {
      const int r = idx / CHUNKS;
      const int c = (idx % CHUNKS) * V;
      const bool in = r0 + r < rows && c0 + c < cols;
      const T* from = in ? src + static_cast<size_t>(r0 + r) * cols + c0 + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(smem_addr(dst + r * LD + c)), "l"(from), "r"(in ? 16 : 0) : "memory");
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += THREADS) {
    const int r = idx / COLS;
    const int c = idx % COLS;
    const bool in = r0 + r < rows && c0 + c < cols;
    const T* from = in ? src + static_cast<size_t>(r0 + r) * cols + c0 + c : src;
    if constexpr (sizeof(T) == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(smem_addr(dst + r * LD + c)), "l"(from), "r"(in ? 4 : 0) : "memory");
    } else {
      dst[r * LD + c] = in ? *from : T(0.0f);
    }
  }
}

template <typename T, typename TO, class C>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const T* __restrict__ a, const T* __restrict__ b, TO* __restrict__ c, int m, int n,
            int k, int n_tiles_n, bool vec_a, bool vec_b) {
  constexpr int LDA = C::KC + 16 / sizeof(T);   // A's rows padded by 16 bytes
  constexpr int A_ELEMS = C::BM * LDA;
  constexpr int STAGE = A_ELEMS + C::KC * C::BN;
  __shared__ __align__(16) T tiles[STAGES * STAGE];   // per stage: A [BM][LDA], B [KC][BN]
  __shared__ float partial[C::KS > 1 ? C::KS * C::BM * C::BN : 1];

  const int tid = threadIdx.x;
  const int tx = tid % C::CX;
  const int ty = tid / C::CX % C::RY;
  const int g = tid / (C::CX * C::RY);   // K group
  const int row0 = static_cast<int>(blockIdx.x) / n_tiles_n * C::BM;
  const int col0 = static_cast<int>(blockIdx.x) % n_tiles_n * C::BN;
  const int n_stages = (k + C::KC - 1) / C::KC;

  auto load_stage = [&](int slot, int k0) {
    T* as = tiles + slot * STAGE;
    load_tile<T, C::BM, C::KC, LDA>(as, a, m, k, row0, k0, vec_a);
    load_tile<T, C::KC, C::BN, C::BN>(as + A_ELEMS, b, k, n, k0, col0, vec_b);
  };

  // Every copy of the first STAGES stages (all of K when K <= STAGES * KC)
  // is in flight before the first wait.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (s < n_stages) load_stage(s, s * C::KC);
    cp_async_commit();
  }

  float acc[C::TM][C::TN];
#pragma unroll
  for (int i = 0; i < C::TM; ++i)
#pragma unroll
    for (int j = 0; j < C::TN; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_stages; ++t) {
    cp_async_wait<STAGES - 1>();   // one group per stage, empty ones included
    __syncthreads();
    const T* as = tiles + (t % STAGES) * STAGE;
    const T* bs = as + A_ELEMS;
    const int depth = min(C::KC, k - t * C::KC);
    int lo = 0, hi = depth;
    if constexpr (C::KS > 1) {
      const int per = (depth + C::KS - 1) / C::KS;
      lo = min(g * per, depth);
      hi = min(lo + per, depth);
    }
#pragma unroll 4
    for (int kk = lo; kk < hi; ++kk) {
      float av[C::TM], bv[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) av[i] = to_f32(as[(ty + i * C::RY) * LDA + kk]);
#pragma unroll
      for (int j = 0; j < C::TN; ++j) bv[j] = to_f32(bs[kk * C::BN + tx + j * C::CX]);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int j = 0; j < C::TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();   // every warp is done with this slot before it is refilled
    if (t + STAGES < n_stages) load_stage(t % STAGES, (t + STAGES) * C::KC);
    cp_async_commit();
  }

  if constexpr (C::KS == 1) {
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int gr = row0 + ty + i * C::RY;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < C::TN; ++j) {
        const int gc = col0 + tx + j * C::CX;
        if (gc < n) store_f32(c + static_cast<size_t>(gr) * n + gc, acc[i][j]);
      }
    }
  } else {
    constexpr int OUT = C::BM * C::BN;
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int j = 0; j < C::TN; ++j)
        partial[g * OUT + (ty + i * C::RY) * C::BN + tx + j * C::CX] = acc[i][j];
    __syncthreads();
    for (int o = tid; o < OUT; o += THREADS) {
      float sum = 0.0f;
#pragma unroll
      for (int s = 0; s < C::KS; ++s) sum += partial[s * OUT + o];
      const int gr = row0 + o / C::BN;
      const int gc = col0 + o % C::BN;
      if (gr < m && gc < n) store_f32(c + static_cast<size_t>(gr) * n + gc, sum);
    }
  }
}

template <typename T, typename TO, class C>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  const long long n_tiles_n = (n + C::BN - 1) / C::BN;
  const long long tiles = (m + C::BM - 1) / C::BM * n_tiles_n;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = 16 / sizeof(T);
  gemm_kernel<T, TO, C><<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<TO*>(c), m, n, k,
      static_cast<int>(n_tiles_n), k % V == 0 && aligned16(a), n % V == 0 && aligned16(b));
  return static_cast<int>(cudaGetLastError());
}

// The output tile from the shape; see the note at the top.
template <typename T, typename TO>
int dispatch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  if (m <= 4) return launch<T, TO, Gemv>(a, b, c, m, n, k, stream);
  if (m <= 16 || (m <= 64 && k >= 32)) return launch<T, TO, Narrow>(a, b, c, m, n, k, stream);
  if (n <= 8) return launch<T, TO, Col8>(a, b, c, m, n, k, stream);
  if (n <= 64 && k <= 256) return launch<T, TO, Col16>(a, b, c, m, n, k, stream);
  return launch<T, TO, Square>(a, b, c, m, n, k, stream);
}

}  // namespace cc

// ---------------------------------------------------------------------------
// Tensor-core route: bfloat16, K and N multiples of 8, M * N * K at or above
// BLOCK_MATMUL_TC_MIN_MNK.  See the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BM = 128;                       // output rows per block
constexpr int BN = 256;                       // output columns per block
constexpr int BK = 64;                        // K per stage: one 128-byte swizzle row
constexpr int STAGES = 4;
constexpr int CONSUMERS = 2;                  // warpgroups of 64 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);   // + the producer warpgroup
constexpr int A_BYTES = BM * BK * 2;          // 16 KB, K-major
constexpr int PANEL = BK * 64 * 2;            // 8 KB: 64 K rows x 64 columns of B
constexpr int STAGE_BYTES = A_BYTES + BN / 64 * PANEL;   // 48 KB
constexpr int ATOM = 1024;                    // bytes in one 8-row swizzle atom
constexpr size_t SMEM = STAGES * STAGE_BYTES + 2 * STAGES * 8 + ATOM;   // + alignment slack

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Spins until the phase of parity `parity` of barrier `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// One TMA box of `map` at (inner, outer) into shared memory at `dst`,
// counted on barrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(inner), "r"(outer), "r"(bar)
      : "memory");
}

// wgmma's shared-memory matrix descriptor with the 128-byte swizzle:
// start address, leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         1ull << 62;
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the wgmma's start or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 256, float32) += a (64 x 16) b (16 x 256): a K-major and b
// MN-major (the transpose bit set), both in shared memory.
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <typename TO>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
            TO* __restrict__ c, int m, int n, int k) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (smem_addr(smem_raw) + ATOM - 1) & ~uint32_t(ATOM - 1);
  const uint32_t full = ring + STAGES * STAGE_BYTES;   // STAGES barriers of 8 bytes
  const uint32_t empty = full + STAGES * 8;

  const int n_tiles_n = (n + BN - 1) / BN;
  const int row0 = static_cast<int>(blockIdx.x) / n_tiles_n * BM;
  const int col0 = static_cast<int>(blockIdx.x) % n_tiles_n * BN;
  const int n_k = (k + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // Producer: one thread keeps the ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) {
      for (int t = 0; t < n_k; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);   // passes at once on the first lap
        mbar_expect_tx(full + 8 * s, STAGE_BYTES);
        const uint32_t st = ring + s * STAGE_BYTES;
        tma_load(st, &map_a, full + 8 * s, t * BK, row0);
#pragma unroll
        for (int p = 0; p < BN / 64; ++p)
          tma_load(st + A_BYTES + p * PANEL, &map_b, full + 8 * s, col0 + 64 * p, t * BK);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.0f;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32 % 4;   // within the consumer warpgroup

  for (int t = 0; t < n_k; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + 8 * s, (t / STAGES) & 1);
    const uint32_t a_s = ring + s * STAGE_BYTES + wg * 64 * 128;   // this warpgroup's 64 rows
    const uint32_t b_s = ring + s * STAGE_BYTES + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: a 16-deep step is 32 bytes along a swizzled 128-byte row; 8-row
      // groups are one atom apart.  B: a step is 16 K rows (two atoms) down
      // every panel; the leading offset is the stride between the four
      // 64-column panels, the stride offset the one between 8-row groups.
      wgmma_n256(d, smem_desc(a_s + kk * 32, 16, ATOM), smem_desc(b_s + kk * 2 * ATOM, PANEL, ATOM));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  // Thread t of warp w holds rows 16 w + t / 4 and + 8 of its 64, columns
  // 8 j + 2 (t % 4) and + 1 in d[4 j .. 4 j + 3].  N % 8 == 0, so a column
  // pair is wholly inside or outside the matrix.
  const int r0 = row0 + wg * 64 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j + 2 * (lane % 4);
    if (col >= n) continue;
    if constexpr (sizeof(TO) == 4) {
      if (r0 < m) *reinterpret_cast<float2*>(c + static_cast<size_t>(r0) * n + col) = make_float2(d[4 * j], d[4 * j + 1]);
      if (r1 < m) *reinterpret_cast<float2*>(c + static_cast<size_t>(r1) * n + col) = make_float2(d[4 * j + 2], d[4 * j + 3]);
    } else {
      if (r0 < m) *reinterpret_cast<__nv_bfloat162*>(c + static_cast<size_t>(r0) * n + col) = __floats2bfloat162_rn(d[4 * j], d[4 * j + 1]);
      if (r1 < m) *reinterpret_cast<__nv_bfloat162*>(c + static_cast<size_t>(r1) * n + col) = __floats2bfloat162_rn(d[4 * j + 2], d[4 * j + 3]);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A map of a row-major (outer, inner) bfloat16 matrix in boxes of
// (box_outer, 64) elements, 128-byte swizzled, zeros outside the matrix.
bool make_map(CUtensorMap* map, const void* base, int inner, int outer, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner), static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TO>
int launch(const void* a, const void* b, void* c, int m, int n, int k, cudaStream_t stream) {
  // TMA reads 16-byte-aligned rows (the wrapper checks the bases too).
  if (!aligned16(a) || !aligned16(b)) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long tiles = static_cast<long long>((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, k, m, BM) || !make_map(&map_b, b, n, k, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned configured = 0;
  const cudaError_t err =
      allow_dynamic_smem(reinterpret_cast<const void*>(gemm_kernel<TO>), SMEM, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  gemm_kernel<TO><<<static_cast<unsigned>(tiles), THREADS, SMEM, stream>>>(
      map_a, map_b, static_cast<TO*>(c), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// C (m, n) = A (m, k) @ B (k, n), all row-major and contiguous.  in_bf16 and
// out_bf16 pick bfloat16 (1) or float32 (0) for the inputs and the output.
// bfloat16 inputs with k and n multiples of 8 and m * n * k at or above
// BLOCK_MATMUL_TC_MIN_MNK take the tensor-core kernel, which needs
// 16-byte-aligned a and b; everything else the CUDA-core kernel.  Launches on
// `stream` without synchronising and returns the CUDA error of the launch (0
// when it was accepted).
extern "C" int block_matmul(const void* a, const void* b, void* c, int m, int n, int k,
                            int in_bf16, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16 && k % 8 == 0 && n % 8 == 0 &&
      static_cast<long long>(m) * n * k >= BLOCK_MATMUL_TC_MIN_MNK)
    return out_bf16 ? tc::launch<bf16>(a, b, c, m, n, k, s) : tc::launch<float>(a, b, c, m, n, k, s);
  if (in_bf16)
    return out_bf16 ? cc::dispatch<bf16, bf16>(a, b, c, m, n, k, s)
                    : cc::dispatch<bf16, float>(a, b, c, m, n, k, s);
  return out_bf16 ? cc::dispatch<float, bf16>(a, b, c, m, n, k, s)
                  : cc::dispatch<float, float>(a, b, c, m, n, k, s);
}
