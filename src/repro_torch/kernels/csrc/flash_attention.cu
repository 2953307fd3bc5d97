// Causal flash attention, optionally restricted to a sliding window, for
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel kernels/flash_attention.py::_flash_kernel (and its
// entry flash_attention, with the GQA wrapper kernels/ops.py::causal_attention)
// of the JAX package.  What it computes is that function: for each batch b,
// query head h and query position i,
//
//   out[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h/G]) v[b, j, h/G]
//
// over the keys j <= i (and i - j < window when window > 0), with G = H / KV
// query heads per KV head.  Scores, the running max m, the running sum l and
// the output accumulator are float32; for bfloat16 inputs the probabilities
// are rounded to bfloat16 before the product with v, as the TPU kernel casts
// p to v's dtype, while l sums them unrounded.  The output is in q's dtype.
//
// Layout.  q and out are (B, S, H, hd), k and v (B, S, KV, hd), all
// contiguous: the natural layout of the model, so no transposed or
// head-repeated copies are made.  A block reads KV head h / G directly.
//
// Two routes, fixed by type and head size (kernels/flash_attention.py::route
// mirrors this dispatch; neither gives way to the other at run time):
//
//   bfloat16, hd in {64, 96, 128, 256} -> tensor-core kernel (tc::flash_kernel)
//   bfloat16, hd in {16, 32}; every float32 shape -> CUDA-core kernel
//                                                    (flash_kernel)
//
// float32 stays off the tensor cores: there they would compute in TF32,
// which breaks the float32 tolerances.  hd 16 and 32 occur in tests only.
// hd 96 (phi-3-vision: 3072 / 32 heads) is not a multiple of the 64-column,
// 128-byte-swizzle panels the other head dims use; it takes 32-column,
// 64-byte-swizzle panels instead (tc::Panel), so q, k and v are read as
// they are, never padded to 128.
//
// What bounds it.  On the serving path (gemma3-1b: B = 2, S = 2048, H = 4,
// KV = 1, hd = 256, bfloat16) one global layer needs about 17 GFLOP of
// unmasked work and moves about 10 MB, so it is bound by operations: the
// tensor cores' 989 TFLOP/s in bfloat16, the CUDA cores' 67 TFLOP/s in
// float32.
//
// Both kernels share the block structure.  The TPU kernel carries
// (m, l, acc) across a sequential KV grid axis in VMEM.  Here blocks run in
// parallel and in no order, so one block owns one (batch*head, 64-query
// tile) and walks the KV tiles in a loop of its own.  Query tiles are issued
// heaviest first (the last tile of a causal row sees the most keys).  KV
// tiles that lie wholly outside the causal window of the query tile are
// skipped: the masked scores they would add carry weight exp(NEG_INF - m) = 0
// once any real score is seen, and the diagonal tile, always processed,
// holds one for every row, so the function is unchanged.  A row whose first
// processed tile is all masked gets m = NEG_INF and p = exp(0) = 1 there; the
// correction exp(m_prev - m_new) = 0 wipes that when a real score arrives.
// NEG_INF is finite (-1e30), as in the reference: -inf would make
// exp(-inf - -inf) NaN.  l is guarded by max(l, 1e-30) before the division.
// Ragged S is masked inside the kernel and rows past S are not stored.
//
// The CUDA-core kernel computes both products with float32 FMAs (a 4x2 or
// 4x4 register micro-tile per thread for the scores, a 4x(hd/16) micro-tile
// for the output, operands staged in shared memory as float32 with rows
// padded by one element so that neither product has bank conflicts), with m
// and l in shared memory and the accumulator in registers.
//
// The tensor-core kernel runs both products on Hopper's tensor cores with
// wgmma (sm_90a).  One warpgroup (128 threads) owns 64 query rows.
//  - Shared memory holds the q tile once and a two-stage ring of (k, v)
//    tiles of 64 keys (32 at hd 256, see kv_tile), loaded with 16-byte
//    cp.async copies (rows past S zero-filled) while the previous tile is
//    computed.  Every tile is stored in one of wgmma's canonical swizzled
//    layouts, chosen by hd (tc::Panel).  At hd 64, 128 and 256: 64-column
//    (128-byte) panels of 8-row, 1024-byte atoms, the 16-byte chunk c of row
//    r at chunk c ^ (r % 8), from a 1024-byte-aligned base (128-byte
//    swizzle).  At hd 96: three 32-column (64-byte) panels of 8-row,
//    512-byte atoms, chunk c of row r at c ^ ((r >> 1) % 4), from a
//    512-byte-aligned base (64-byte swizzle).  At hd 256 that is 32 KB +
//    2 x (16 + 16) KB = 96 KB, two blocks per SM; at hd 128, 80 KB; at hd
//    96, 60 KB.
//  - S = q k^T is wgmma m64n64k16 (m64n32k16 at hd 256) with both operands
//    in shared memory over hd / 16 steps; k stored [key][d] is already
//    K-major, so no transpose.
//  - The online softmax works on the accumulator fragment itself: thread t
//    of warp w holds rows 16 w + t / 4 and + 8, columns 8 j + 2 (t % 4) and
//    + 1.  Row maxima take two __shfl_xor_sync steps within the quad of
//    threads that share a row; m stays in registers, and l is kept as a
//    per-thread partial sum, reduced across the quad once at the end.  The
//    softmax runs in base 2 (scores times scale * log2 e, then exp2).
//  - O += P v takes P from registers: the S fragment, rounded to packed
//    bfloat16, is wgmma's A-register layout for k16 (as in FlashAttention-3).
//    That rounding is the TPU kernel's cast of p to v's type; l sums p
//    before it.  v stored [key][d] is MN-major for B, which bfloat16 wgmma
//    reads with its transpose bit, so there is no transposed copy.  One
//    wgmma per panel of v (m64n64k16, or m64n32k16 on hd 96's 32-column
//    panels) keeps each B operand inside one swizzle atom along N, so only
//    the stride between 8-key groups matters.
//  - Generic-proxy writes (cp.async) are ordered before the async proxy's
//    reads (wgmma) by fence.proxy.async and a barrier.
//  - GQA packing (the query heads of one KV head stacked into the 64 rows)
//    was weighed and not taken: at the path's shapes a (batch, KV head)'s
//    keys and values (2 MB) stay in L2, so it would save L2 traffic only,
//    while it would cut each tile to 16 query positions and the grid is the
//    same 256 blocks either way.
// wgmma on the tensor cores, not TMA or warp specialisation, is what this
// version is about; a producer warp, persistent blocks and overlapping one
// tile's softmax with the next tile's products are left for a later one.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int WARPS = THREADS / 32;
constexpr int BQ = 64;              // query rows per block

// KV rows per tile: 64, or 32 at hd = 256, so that shared memory stays near
// 100 KB and two blocks fit on one SM.
template <int HD>
struct KvTile {
  static constexpr int value = HD >= 256 ? 32 : 64;
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// p as the product with v sees it: unchanged for float32, rounded to
// bfloat16 (to nearest even, as torch's and XLA's casts) for bfloat16.
__device__ __forceinline__ float as_v_type(float p, const float*) { return p; }
__device__ __forceinline__ float as_v_type(float p, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(p));
}

template <int HD>
constexpr size_t smem_bytes() {
  constexpr int BK = KvTile<HD>::value;
  return sizeof(float) *
         (BQ * (HD + 1)      // q tile
          + BK * (HD + 1)    // k tile, then v tile
          + BQ * (BK + 1)    // scores, then probabilities
          + 3 * BQ);         // m, l, correction per row
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int s_len, int h_q,
             int h_kv, float scale, int window) {
  constexpr int BK = KvTile<HD>::value;
  constexpr int TM = BQ / 16;   // rows per thread (scores and output)
  constexpr int TN = BK / 16;   // score columns per thread
  constexpr int TD = HD / 16;   // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;                    // [BQ][HD + 1]
  float* kvs = qs + BQ * (HD + 1);     // k: [BK][HD + 1]; v: [BK][HD]
  float* ss = kvs + BK * (HD + 1);     // [BQ][BK + 1]
  float* m_s = ss + BQ * (BK + 1);
  float* l_s = m_s + BQ;
  float* c_s = l_s + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;    // between tokens
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const T* qb = q + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const T* vb = v + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  T* ob = o + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;

  for (int idx = tid; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int gq = q0 + r;
    qs[r * (HD + 1) + d] = gq < s_len ? load_f32(qb + gq * q_stride + d) : 0.0f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  float acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) acc[i][j] = 0.0f;

  // Keys [k_begin, k_end) hold every unmasked score of this query tile.
  const int k_end = min(q0 + BQ, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous v tile and probabilities are consumed
    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int gk = k0 + r;
      kvs[r * (HD + 1) + d] = gk < s_len ? load_f32(kb + gk * kv_stride + d) : 0.0f;
    }
    __syncthreads();

    float sc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[TM];
      float bk[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < TN; ++j) bk[j] = kvs[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = tx + 16 * j;
        const int kp = k0 + c;
        const bool keep = kp <= qp && kp < s_len && (window <= 0 || qp - kp < window);
        ss[r * (BK + 1) + c] = keep ? sc[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();   // scores complete; the k tile is free

    for (int idx = tid; idx < BK * HD; idx += THREADS) {
      const int r = idx / HD;
      const int d = idx % HD;
      const int gk = k0 + r;
      kvs[r * HD + d] = gk < s_len ? load_f32(vb + gk * kv_stride + d) : 0.0f;
    }
    // Online softmax: each warp owns rows warp, warp + 8, ...
    for (int r = warp; r < BQ; r += WARPS) {
      float* row = ss + r * (BK + 1);
      float mx = NEG_INF;
      for (int c = lane; c < BK; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int c = lane; c < BK; c += 32) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = as_v_type(p, q);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();   // probabilities, corrections and the v tile are ready

#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TD; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[TM];
      float vv[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) p[i] = ss[(ty + 16 * i) * (BK + 1) + kk];
#pragma unroll
      for (int j = 0; j < TD; ++j) vv[j] = kvs[kk * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  // l_s was last written before the loop's final barrier.
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
    const int gq = q0 + r;
    if (gq >= s_len) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < TD; ++j)
      store_f32(ob + gq * q_stride + tx + 16 * j, acc[i][j] / l);
  }
}

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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int kv, float scale, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static unsigned configured = 0;
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(flash_kernel<T, HD>),
                                       smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + BQ - 1) / BQ, b * h);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int b,
             int s, int h, int kv, int hd, float scale, int window,
             cudaStream_t stream) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 32: return launch<T, 32>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 96: return launch<T, 96>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, h, kv, scale, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core route: bfloat16, hd in {64, 96, 128, 256}.  See the note at the
// top.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;   // one warpgroup
constexpr int BQ = 64;         // query rows per block: wgmma's M
constexpr float LOG2E = 1.4426950408889634f;

// The swizzle panels of a tile, chosen by head_dim.  wgmma reads a tile in
// panels as wide as its swizzle, stored one after another: a panel row is
// 128 bytes (64 bfloat16 columns) when hd is a multiple of 64, else 64
// bytes (32 columns: hd 96 is three panels).  An atom is 8 rows of a panel.
// The 16-byte chunk c of a panel's row r lies at chunk c ^ (r % 8) of the
// row at 128 bytes (the byte address's bits 4-6 XOR bits 7-9: CUTLASS's
// Swizzle<3,4,3>), at chunk c ^ ((r >> 1) % 4) at 64 (bits 4-5 XOR bits 7-8:
// Swizzle<2,4,3>); load_tile writes them so.  Tiles start on an atom
// boundary, so the address bits are the tile's own.
template <int HD>
struct Panel {
  static_assert(HD % 32 == 0, "whole 32-column panels");
  static constexpr bool WIDE = HD % 64 == 0;
  static constexpr int COLS = WIDE ? 64 : 32;   // bfloat16 columns of a panel
  static constexpr int ROW = 2 * COLS;          // bytes of a panel row
  static constexpr int CHUNKS = ROW / 16;       // 16-byte chunks of a panel row
  static constexpr int ATOM = 8 * ROW;          // bytes of an 8-row atom
  static constexpr int STEPS = ROW / 32;        // k16 steps (32 bytes) in a panel row
  static constexpr uint64_t MODE = WIDE ? 1 : 2;   // descriptor bits 62-63: 128B or 64B swizzle
};

// Keys per KV tile: N of q k^T, K of P v.  At hd 256 a 64-key tile needs
// more than the 255 registers a thread may have (the output fragment alone
// is 128) and spills; 32 keys fit, and halve the ring, so that two blocks
// share an SM and one's softmax overlaps the other's products.
template <int HD>
constexpr int kv_tile() { return HD == 256 ? 32 : 64; }

template <int HD>
struct Smem {
  static constexpr int BK = kv_tile<HD>();
  static constexpr int Q = BQ * HD * 2;        // bytes of the q tile
  static constexpr int KV = BK * HD * 2;       // bytes of a k or a v tile
  static constexpr int STAGE = 2 * KV;         // k then v
  static constexpr size_t BYTES = Q + 2 * STAGE + Panel<HD>::ATOM;   // + alignment slack
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copies rows [row0, row0 + ROWS) of an (S, HD) bfloat16 matrix whose rows
// lie `stride` elements apart into the tile at shared address `dst`: one
// panel of ROWS rows after another (Panel<HD>), each 16-byte chunk at its
// swizzled place in its row.  Rows at or past s_len are zero-filled
// (src-size 0; the source address then points at row 0).  The swizzle is
// written out here, not in a member of Panel: inlined from a helper, the
// XORs take their operands in another order and the SASS at hd 64, 128 and
// 256 changes.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t stride,
                                          int row0, int s_len) {
  using P = Panel<HD>;
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int g = row0 + r;
    const bool in = g < s_len;
    const bf16* from = src + static_cast<size_t>(in ? g : 0) * stride + c * 8;
    const uint32_t to = dst + (c / P::CHUNKS) * (ROWS * P::ROW) + r * P::ROW +
                        ((P::WIDE ? ((c % 8) ^ (r % 8)) : ((c % 4) ^ ((r >> 1) % 4))) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0) : "memory");
  }
}

// wgmma's shared-memory matrix descriptor with swizzle MODE (Panel::MODE):
// start address, leading and stride byte offsets, each in 16-byte units.
template <uint64_t MODE>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         MODE << 62;
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
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

// d (64 x N, float32) = a (64 x 16) b (16 x N) [+ d when accumulate], a and
// b both K-major in shared memory; N is 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    static_assert(N == 32, "N is 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (64 x N, float32) += a (64 x 16, bfloat16 pairs in registers) b, with b
// (16 x N) MN-major in shared memory (the transpose bit set); N is 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(N == 32, "N is 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, int s_len, int h_q,
             int h_kv, float scale, int window) {
  using P = Panel<HD>;
  constexpr int NP = HD / P::COLS;   // panels of q, k, v and the output
  constexpr int NF = P::COLS / 2;    // floats of one panel's output fragment
  using S = Smem<HD>;
  constexpr int BK = S::BK;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + P::ATOM - 1) & ~uint32_t(P::ATOM - 1);
  const uint32_t ring = q_s + S::Q;   // stage st: k at ring + st * STAGE, v at + KV

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  // Block i takes query tile n_qt - 1 - i / (B * H) of (batch, head)
  // i % (B * H): every (batch, head)'s heaviest tile first.
  const int n_qt = (s_len + BQ - 1) / BQ;
  const int n_bh = gridDim.x / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int bh = blockIdx.x % n_bh;
  const int b = bh / h_q;
  const int h = bh % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;    // between tokens
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const bf16* qb = q + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const bf16* vb = v + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  bf16* ob = o + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;

  // Keys [k_begin, k_end) hold every unmasked score of this query tile.
  const int k_end = min(q0 + BQ, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_tile<HD, BQ>(q_s, qb, q_stride, q0, s_len);
  load_tile<HD, BK>(ring, kb, kv_stride, k_begin, s_len);
  load_tile<HD, BK>(ring + S::KV, vb, kv_stride, k_begin, s_len);
  cp_async_commit();

  // This thread's rows of the tile and the first of its columns.
  const int qp0 = q0 + 16 * warp + lane / 4;
  const int qp1 = qp0 + 8;
  const int col = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;

  float acc[NP][NF];   // the output, one m64 x COLS fragment per panel
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[p][i] = 0.0f;
  float sc[BK / 2];    // scores, then probabilities, of one tile
  float m0 = NEG_INF, m1 = NEG_INF;   // running max of rows qp0, qp1 (base 2)
  float l0 = 0.0f, l1 = 0.0f;         // this thread's part of their sums

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    const uint32_t ks = ring + (t & 1) * S::STAGE;
    const uint32_t vs = ks + S::KV;
    if (t + 1 < n_tiles) {   // the next tile into the other stage
      const uint32_t next = ring + ((t + 1) & 1) * S::STAGE;
      load_tile<HD, BK>(next, kb, kv_stride, k0 + BK, s_len);
      load_tile<HD, BK>(next + S::KV, vb, kv_stride, k0 + BK, s_len);
    }
    cp_async_commit();   // empty on the last tile, so that one group stays behind
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // q and this tile's k, v have landed, from every thread

    // S = q k^T over hd / 16 steps of 16: a step's 32 bytes lie inside one
    // panel row, so the descriptors advance by 32 bytes within a panel and
    // by a whole panel every P::STEPS steps (4 at 128 bytes, 2 at 64).
    // The first step overwrites sc; zeroing it here, and not carrying the
    // last tile's probabilities into the wgmma, keeps them from staying live
    // in registers across P v.
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t step = (kk % P::STEPS) * 32;
      wgmma_ss<BK>(sc, smem_desc<P::MODE>(q_s + (kk / P::STEPS) * (BQ * P::ROW) + step, 16, P::ATOM),
                   smem_desc<P::MODE>(ks + (kk / P::STEPS) * (BK * P::ROW) + step, 16, P::ATOM),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // Scale to base 2 and mask: causal, window, keys past S.
    const bool need_mask = k0 + BK - 1 > q0 || k0 + BK > s_len ||
                           (window > 0 && q0 + BQ - 1 - k0 >= window);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      float x = sc[i] * scale2;
      if (need_mask) {
        const int kp = k0 + 8 * (i / 4) + col + (i % 2);
        const int qp = (i / 2) % 2 ? qp1 : qp0;
        const bool keep = kp <= qp && kp < s_len && (window <= 0 || qp - kp < window);
        x = keep ? x : NEG_INF;
      }
      sc[i] = x;
    }

    // Online softmax of rows qp0 (i % 4 in {0, 1}) and qp1 (i % 4 in {2, 3});
    // the four threads of a quad share a row.
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2) mx1 = fmaxf(mx1, sc[i]);
      else mx0 = fmaxf(mx0, sc[i]);
    }
#pragma unroll
    for (int off = 1; off <= 2; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0);
    const float corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i / 2) % 2) {
        sc[i] = exp2f(sc[i] - mn1);
        sum1 += sc[i];
      } else {
        sc[i] = exp2f(sc[i] - mn0);
        sum0 += sc[i];
      }
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < NF; ++i) acc[p][i] *= (i / 2) % 2 ? corr1 : corr0;

    // P as wgmma's A fragment for keys [16 kk, 16 kk + 16): the score
    // fragment's columns 16 kk .. 16 kk + 15 are its registers 8 kk .. 8 kk + 7.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);

    // O += P v: per 16-key step, one m64 x COLS x k16 per panel of v.
    // Within a panel an 8-key atom is P::ATOM bytes; the next 8 keys lie one
    // atom on, which both offsets name (a panel spans one atom along N).
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        wgmma_rs<P::COLS>(acc[p], pa[kk],
                          smem_desc<P::MODE>(vs + p * (BK * P::ROW) + kk * 16 * P::ROW, P::ATOM, P::ATOM));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.0f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.0f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int j = 0; j < P::COLS / 8; ++j) {
      const int c = p * P::COLS + 8 * j + col;
      if (qp0 < s_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qp0) * q_stride + c) =
            __floats2bfloat162_rn(acc[p][4 * j] * inv0, acc[p][4 * j + 1] * inv0);
      if (qp1 < s_len)
        *reinterpret_cast<__nv_bfloat162*>(ob + static_cast<size_t>(qp1) * q_stride + c) =
            __floats2bfloat162_rn(acc[p][4 * j + 2] * inv1, acc[p][4 * j + 3] * inv1);
    }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h,
           int kv, float scale, int window, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: rows are hd * 2 bytes apart, so the
  // bases must be 16-byte aligned (the wrapper checks this too).
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = static_cast<long long>((s + BQ - 1) / BQ) * b * h;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = Smem<HD>::BYTES;
  static unsigned configured = 0;
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(flash_kernel<HD>),
                                       smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(blocks));
  flash_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), s, h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

// out (b, s, h, hd) = causal attention of q (b, s, h, hd) over k, v
// (b, s, kv, hd), all contiguous, with kv dividing h; window > 0 keeps only
// the last `window` keys of each query.  hd is 16, 32, 64, 96, 128 or 256;
// is_bf16 picks bfloat16 (1) or float32 (0) for every tensor.  bfloat16 at
// hd 64, 96, 128 and 256 takes the tensor-core kernel and needs
// 16-byte-aligned bases; everything else the CUDA-core kernel.  Launches on
// `stream` without synchronising and returns the CUDA error of the launch (0
// when it was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int s, int h, int kv, int hd,
                               float scale, int window, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch<float>(q, k, v, o, b, s, h, kv, hd, scale, window, st);
  switch (hd) {
    case 16: return launch<__nv_bfloat16, 16>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 32: return launch<__nv_bfloat16, 32>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 64: return tc::launch<64>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 96: return tc::launch<96>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 128: return tc::launch<128>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 256: return tc::launch<256>(q, k, v, o, b, s, h, kv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
