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
// Block structure.  The TPU kernel carries (m, l, acc) across a sequential
// KV grid axis in VMEM.  Here blocks run in parallel and in no order, so one
// block owns one (batch*head, 64-query tile) and walks the KV tiles in a loop
// of its own, with m and l in shared memory and the accumulator in registers.
// Query tiles are issued heaviest first (the last tile of a causal row sees
// the most keys).  KV tiles that lie wholly outside the causal window of the
// query tile are skipped: the masked scores they would add carry weight
// exp(NEG_INF - m) = 0 once any real score is seen, and the diagonal tile,
// always processed, holds one for every row, so the function is unchanged.
// A row whose first processed tile is all masked gets m = NEG_INF and
// p = exp(0) = 1 there; the correction exp(m_prev - m_new) = 0 wipes that
// when a real score arrives.  NEG_INF is finite (-1e30), as in the
// reference: -inf would make exp(-inf - -inf) NaN.  l is guarded by
// max(l, 1e-30) before the division.  Ragged S is masked inside the kernel.
//
// What bounds it.  On the serving path (gemma3-1b: B = 2, S = 2048, H = 4,
// KV = 1, hd = 256, bfloat16) one global layer needs about 17 GFLOP of
// unmasked work and moves about 10 MB, so it is bound by operations.  This
// first version computes both products with float32 FMAs on the CUDA cores
// (a 4x2 or 4x4 register micro-tile per thread for the scores, a 4x(hd/16)
// micro-tile for the output, operands staged in shared memory as float32
// with rows padded by one element so that neither product has bank
// conflicts), so it is bound by the CUDA cores' 67 TFLOP/s, not the tensor
// cores' 989.  wgmma on bfloat16 tiles, TMA and a pipelined ring of KV
// tiles are for a later version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int s, int h, int kv, float scale, int window,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  // Above 48 KB a block's shared memory must be allowed explicitly, once
  // per device; done at the first launch, so that a launch captured into a
  // CUDA graph makes no call but the launch itself.
  static unsigned configured = 0;   // bit d: done on device d
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1u << dev;
  }
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
    case 128: return launch<T, 128>(q, k, v, o, b, s, h, kv, scale, window, stream);
    case 256: return launch<T, 256>(q, k, v, o, b, s, h, kv, scale, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (b, s, h, hd) = causal attention of q (b, s, h, hd) over k, v
// (b, s, kv, hd), all contiguous, with kv dividing h; window > 0 keeps only
// the last `window` keys of each query.  hd is 16, 32, 64, 128 or 256;
// is_bf16 picks bfloat16 (1) or float32 (0) for every tensor.  Launches on
// `stream` without synchronising and returns the CUDA error of the launch
// (0 when it was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int s, int h, int kv, int hd,
                               float scale, int window, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, b, s, h, kv, hd, scale, window, st);
  return dispatch<float>(q, k, v, o, b, s, h, kv, hd, scale, window, st);
}
