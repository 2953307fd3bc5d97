// Gradient of causal (optionally sliding-window) GQA attention for Hopper
// (sm_90a), with a plain C interface.
//
// The JAX package has no backward kernel: it trains through pure jnp code
// (models/layers.py::attention_chunked, the oracle of the TPU kernel
// kernels/flash_attention.py::_flash_kernel) that XLA differentiates.  The
// port runs that function through the hand-written forward kernel
// (flash_attention.cu), so its gradient is a hand-written kernel too: this
// file.  For out = softmax(scale * q k^T + mask) v, per batch b, query head
// h, query row i and key j (KV head h / G, G = H / KV):
//
//   p_ij   = exp(scale * q_i . k_j - lse_i)      (0 where masked)
//   dv_j  += sum_{h in group} sum_i p_ij do_i
//   dp_ij  = do_i . v_j
//   ds_ij  = p_ij (dp_ij - delta_i),  delta_i = do_i . out_i
//   dq_i   = scale * sum_j ds_ij k_j
//   dk_j  += scale * sum_{h in group} sum_i ds_ij q_i
//
// The forward kernel rounds p to bfloat16 before p v for bfloat16 inputs;
// the gradient treats that rounding as the identity, as JAX's autodiff of
// p.astype(v.dtype) in attention_chunked does.
//
// Layout.  q, out, do and dq are (B, S, H, hd); k, v, dk and dv are
// (B, S, KV, hd); all contiguous, all float32 or all bfloat16.  Arithmetic
// is float32 throughout (bfloat16 inputs are widened when staged); the
// gradients are stored in the input type.  lse and delta are float32
// (B, H, S) scratch that the caller allocates.
//
// Three kernels, launched in order on one stream:
//  (a) stats_kernel: one block per (b*h, query tile).  It recomputes each
//      row's log-sum-exp over its visible keys (the forward pass without
//      p v; the forward kernel does not keep it) and delta = do . out.
//  (b) dkdv_kernel: one block per (b*KV, key tile).  It walks the query
//      tiles that can see its keys (q >= k; q - k < window when windowed:
//      the other tiles are skipped, as the forward skips KV tiles) and,
//      inside that loop, the G query heads of its group, so the GQA sum
//      stays in the block's registers: no atomics, and the result does not
//      depend on the order in which blocks run.
//  (c) dq_kernel: one block per (b*h, query tile), walking the key tiles in
//      its causal window.
// (b) and (c) both recompute p and ds; sharing them would need atomics on
// dq or a (B, H, S, S) buffer.
//
// Masking.  The forward's NEG_INF is finite (-1e30).  Here no masked score
// ever reaches exp: p and ds are set to 0 for every (row, key) that
// `visible` rejects, which covers the causal mask, the window, and rows and
// keys past S (ragged S; those rows are staged as zeros and never stored).
//
// What bounds it.  Five products of the forward's size (q k^T and do v^T
// recomputed, then ds k, ds^T q and p^T do), about 2.5 times the forward's
// operations, plus q k^T once more in (a).  At the training path's shapes
// (qwen1.5-0.5b: B = 2, S = 2048, H = KV = 16, hd 64; gemma3-1b: H = 4,
// KV = 1, hd 256, window 512 and global) that is tens of GFLOP per call
// against a few tens of MB moved, so the bound is operations: the CUDA
// cores' 67 TFLOP/s in float32.
//
// Design: simple and right first, on the CUDA cores with float32 FMAs.
// 256 threads as 16 x 16; tiles of 64 rows (32 at hd 256, so that the four
// staged tiles of (b) fit in shared memory); every product is a register
// micro-tile per thread over operands staged in shared memory as float32,
// rows padded by one element so that no product has bank conflicts.  A
// tensor-core (bfloat16 wgmma) backward is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;        // 16 x 16 threads
constexpr int WARPS = THREADS / 32;

// Rows of a query tile and of a key tile.
template <int HD>
struct Tile {
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

// Whether query position qp attends to key position kp.
__device__ __forceinline__ bool visible(int qp, int kp, int s_len, int window) {
  return kp <= qp && qp < s_len && (window <= 0 || qp - kp < window);
}

// Rows [r0, r0 + ROWS) of a (B, S, heads, HD) tensor at one (b, head),
// `base` pointing at (b, 0, head, 0) and `stride` elements between
// positions, staged as float32 in dst[ROWS][HD + 1]; rows past S are zero.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(float* dst, const T* base, size_t stride, int r0,
                                      int s_len) {
  for (int idx = threadIdx.x; idx < ROWS * HD; idx += THREADS) {
    const int r = idx / HD;
    const int d = idx % HD;
    const int g = r0 + r;
    dst[r * (HD + 1) + d] = g < s_len ? load_f32(base + g * stride + d) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] and the same for
// (c, e) into acc2: two products that share the loop over d.
template <int HD, int TM, int TN>
__device__ __forceinline__ void two_products(const float* a, const float* b,
                                             const float* c, const float* e,
                                             float (&acc)[TM][TN], float (&acc2)[TM][TN],
                                             int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc[i][j] = 0.0f;
      acc2[i][j] = 0.0f;
    }
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float ar[TM], cr[TM], br[TN], er[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      ar[i] = a[(ty + 16 * i) * (HD + 1) + d];
      cr[i] = c[(ty + 16 * i) * (HD + 1) + d];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      br[j] = b[(tx + 16 * j) * (HD + 1) + d];
      er[j] = e[(tx + 16 * j) * (HD + 1) + d];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
        acc2[i][j] = fmaf(cr[i], er[j], acc2[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// (a) Row statistics: lse = m + log l over the row's visible keys, and
// delta = do . out.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t stats_smem() {
  constexpr int T = Tile<HD>::value;
  return sizeof(float) * (2 * T * (HD + 1) + T * (T + 1) + 2 * T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
             const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
             int s_len, int h_q, int h_kv, float scale, int window) {
  constexpr int BT = Tile<HD>::value;
  constexpr int TM = BT / 16;

  extern __shared__ float smem[];
  float* qs = smem;                    // [BT][HD + 1]
  float* ks = qs + BT * (HD + 1);      // [BT][HD + 1]
  float* ss = ks + BT * (HD + 1);      // [BT][BT + 1] scaled scores
  float* m_s = ss + BT * (BT + 1);
  float* l_s = m_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int lane = tid % 32;
  const int warp = tid / 32;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // heaviest tiles first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  float* lse_b = lse + static_cast<size_t>(blockIdx.y) * s_len;
  float* delta_b = delta + static_cast<size_t>(blockIdx.y) * s_len;

  stage<T, HD, BT>(qs, q + q_off, q_stride, q0, s_len);
  for (int r = tid; r < BT; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.0f;
  }

  const int k_end = min(q0 + BT, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BT) * BT : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();   // the previous tile's scores are consumed
    stage<T, HD, BT>(ks, kb, kv_stride, k0, s_len);
    __syncthreads();
    float sc[TM][TM];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j) sc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float a[TM], bk[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < TM; ++j) bk[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) sc[i][j] = fmaf(a[i], bk[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TM; ++j)
        ss[(ty + 16 * i) * (BT + 1) + tx + 16 * j] = sc[i][j] * scale;
    __syncthreads();
    // Each warp owns rows warp, warp + 8, ...; masked keys add nothing.
    for (int r = warp; r < BT; r += WARPS) {
      const int qp = q0 + r;
      const float* row = ss + r * (BT + 1);
      float mx = NEG_INF;
      for (int c = lane; c < BT; c += 32)
        if (visible(qp, k0 + c, s_len, window)) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_s[r], mx);
      float sum = 0.0f;
      for (int c = lane; c < BT; c += 32)
        if (visible(qp, k0 + c, s_len, window)) sum += expf(row[c] - m_new);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0 && mx > NEG_INF) {   // a tile with no visible key changes nothing
        l_s[r] = l_s[r] * expf(m_s[r] - m_new) + sum;
        m_s[r] = m_new;
      }
    }
  }
  __syncthreads();
  for (int r = warp; r < BT; r += WARPS) {
    const int qp = q0 + r;
    if (qp >= s_len) continue;
    const size_t at = q_off + static_cast<size_t>(qp) * q_stride;
    float dot = 0.0f;
    for (int d = lane; d < HD; d += 32) dot = fmaf(load_f32(dout + at + d), load_f32(o + at + d), dot);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      // Every row sees its own key, so l >= 1 here.
      lse_b[qp] = m_s[r] + logf(l_s[r]);
      delta_b[qp] = dot;
    }
  }
}

// ---------------------------------------------------------------------------
// p and ds of one (query tile, key tile) pair, from the two products'
// micro-tiles: rows ty + 16 i, keys tx + 16 j.
// ---------------------------------------------------------------------------
template <int BT, int TM>
__device__ __forceinline__ void p_and_ds(float (&sc)[TM][TM], float (&dp)[TM][TM],
                                         const float* lse_s, const float* delta_s, float* ps,
                                         float* dss, int q0, int k0, int s_len, int window,
                                         float scale, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = tx + 16 * j;
      float p = 0.0f;
      float ds = 0.0f;
      if (visible(q0 + r, k0 + c, s_len, window)) {
        p = expf(sc[i][j] * scale - lse_s[r]);
        ds = p * (dp[i][j] - delta_s[r]);
      }
      if (ps != nullptr) ps[r * (BT + 1) + c] = p;
      dss[r * (BT + 1) + c] = ds;
    }
  }
}

// ---------------------------------------------------------------------------
// (b) dK and dV of one key tile, summed over the query heads of its group.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t dkdv_smem() {
  constexpr int T = Tile<HD>::value;
  return sizeof(float) * (4 * T * (HD + 1) + 2 * T * (T + 1) + 2 * T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            int s_len, int h_q, int h_kv, float scale, int window) {
  constexpr int BT = Tile<HD>::value;
  constexpr int TM = BT / 16;   // rows (keys) per thread
  constexpr int TD = HD / 16;   // columns per thread

  extern __shared__ float smem[];
  float* ks = smem;                    // [BT][HD + 1]
  float* vs = ks + BT * (HD + 1);
  float* qs = vs + BT * (HD + 1);
  float* dos = qs + BT * (HD + 1);
  float* ps = dos + BT * (HD + 1);     // [BT][BT + 1], query-major
  float* dss = ps + BT * (BT + 1);
  float* lse_s = dss + BT * (BT + 1);
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int k0 = blockIdx.x * BT;      // early keys see the most queries: first
  const int b = blockIdx.y / h_kv;
  const int hk = blockIdx.y % h_kv;
  const int group = h_q / h_kv;
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;

  stage<T, HD, BT>(ks, k + kv_off, kv_stride, k0, s_len);
  stage<T, HD, BT>(vs, v + kv_off, kv_stride, k0, s_len);

  float dk_acc[TM][TD];
  float dv_acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      dk_acc[i][j] = 0.0f;
      dv_acc[i][j] = 0.0f;
    }

  // Queries [k0, q_end) hold every visible pair of this key tile.
  const int q_end = window > 0 ? min(s_len, k0 + BT - 1 + window) : s_len;
  for (int q0 = k0; q0 < q_end; q0 += BT) {
    for (int g = 0; g < group; ++g) {
      const int h = hk * group + g;
      const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
      const size_t stat_off = (static_cast<size_t>(b) * h_q + h) * s_len;
      __syncthreads();   // the previous q, do, p and ds are consumed
      stage<T, HD, BT>(qs, q + q_off, q_stride, q0, s_len);
      stage<T, HD, BT>(dos, dout + q_off, q_stride, q0, s_len);
      for (int r = tid; r < BT; r += THREADS) {
        const bool in = q0 + r < s_len;
        lse_s[r] = in ? lse[stat_off + q0 + r] : 0.0f;
        delta_s[r] = in ? delta[stat_off + q0 + r] : 0.0f;
      }
      __syncthreads();
      float sc[TM][TM], dp[TM][TM];
      two_products<HD>(qs, ks, dos, vs, sc, dp, tx, ty);   // q k^T, do v^T
      p_and_ds<BT>(sc, dp, lse_s, delta_s, ps, dss, q0, k0, s_len, window, scale, tx, ty);
      __syncthreads();
      // dv[c] += sum_r p[r][c] do[r];  dk[c] += sum_r ds[r][c] q[r]
#pragma unroll 2
      for (int r = 0; r < BT; ++r) {
        float pr[TM], dsr[TM], dor[TD], qr[TD];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          pr[i] = ps[r * (BT + 1) + ty + 16 * i];
          dsr[i] = dss[r * (BT + 1) + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < TD; ++j) {
          dor[j] = dos[r * (HD + 1) + tx + 16 * j];
          qr[j] = qs[r * (HD + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TD; ++j) {
            dv_acc[i][j] = fmaf(pr[i], dor[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsr[i], qr[j], dk_acc[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= s_len) continue;
    const size_t at = kv_off + static_cast<size_t>(kp) * kv_stride;
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      store_f32(dk + at + tx + 16 * j, dk_acc[i][j] * scale);
      store_f32(dv + at + tx + 16 * j, dv_acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dQ of one query tile of one head.
// ---------------------------------------------------------------------------
template <int HD>
constexpr size_t dq_smem() {
  constexpr int T = Tile<HD>::value;
  return sizeof(float) * (4 * T * (HD + 1) + T * (T + 1) + 2 * T);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int s_len, int h_q,
          int h_kv, float scale, int window) {
  constexpr int BT = Tile<HD>::value;
  constexpr int TM = BT / 16;
  constexpr int TD = HD / 16;

  extern __shared__ float smem[];
  float* qs = smem;                    // [BT][HD + 1]
  float* dos = qs + BT * (HD + 1);
  float* ks = dos + BT * (HD + 1);
  float* vs = ks + BT * (HD + 1);
  float* dss = vs + BT * (HD + 1);     // [BT][BT + 1]
  float* lse_s = dss + BT * (BT + 1);
  float* delta_s = lse_s + BT;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BT;   // heaviest tiles first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const size_t stat_off = static_cast<size_t>(blockIdx.y) * s_len;

  stage<T, HD, BT>(qs, q + q_off, q_stride, q0, s_len);
  stage<T, HD, BT>(dos, dout + q_off, q_stride, q0, s_len);
  for (int r = tid; r < BT; r += THREADS) {
    const bool in = q0 + r < s_len;
    lse_s[r] = in ? lse[stat_off + q0 + r] : 0.0f;
    delta_s[r] = in ? delta[stat_off + q0 + r] : 0.0f;
  }

  float dq_acc[TM][TD];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TD; ++j) dq_acc[i][j] = 0.0f;

  const int k_end = min(q0 + BT, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BT) * BT : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BT) {
    __syncthreads();   // the previous k, v and ds are consumed
    stage<T, HD, BT>(ks, k + kv_off, kv_stride, k0, s_len);
    stage<T, HD, BT>(vs, v + kv_off, kv_stride, k0, s_len);
    __syncthreads();
    float sc[TM][TM], dp[TM][TM];
    two_products<HD>(qs, ks, dos, vs, sc, dp, tx, ty);
    p_and_ds<BT>(sc, dp, lse_s, delta_s, nullptr, dss, q0, k0, s_len, window, scale, tx, ty);
    __syncthreads();
    // dq[r] += sum_c ds[r][c] k[c]
#pragma unroll 2
    for (int c = 0; c < BT; ++c) {
      float dsr[TM], kr[TD];
#pragma unroll
      for (int i = 0; i < TM; ++i) dsr[i] = dss[(ty + 16 * i) * (BT + 1) + c];
#pragma unroll
      for (int j = 0; j < TD; ++j) kr[j] = ks[c * (HD + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TD; ++j) dq_acc[i][j] = fmaf(dsr[i], kr[j], dq_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= s_len) continue;
    const size_t at = q_off + static_cast<size_t>(qp) * q_stride;
#pragma unroll
    for (int j = 0; j < TD; ++j) store_f32(dq + at + tx + 16 * j, dq_acc[i][j] * scale);
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
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, int b, int s, int h,
           int kv, float scale, int window, cudaStream_t stream) {
  constexpr int BT = Tile<HD>::value;
  static unsigned configured_stats = 0, configured_dkdv = 0, configured_dq = 0;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dot = static_cast<const T*>(dout);
  const int tiles = (s + BT - 1) / BT;

  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(stats_kernel<T, HD>),
                                       stats_smem<HD>(), configured_stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<T, HD><<<dim3(tiles, b * h), THREADS, stats_smem<HD>(), stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, s, h, kv, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dkdv_kernel<T, HD>), dkdv_smem<HD>(),
                           configured_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, HD><<<dim3(tiles, b * kv), THREADS, dkdv_smem<HD>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), s, h, kv, scale,
      window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dq_kernel<T, HD>), dq_smem<HD>(),
                           configured_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD><<<dim3(tiles, b * h), THREADS, dq_smem<HD>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s, h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, float* lse, float* delta, int b, int s, int h,
             int kv, int hd, float scale, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    case 96: return launch<T, 96>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    case 256: return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, b, s, h, kv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq (b, s, h, hd), dk and dv (b, s, kv, hd) = the gradient of causal
// attention out = attention(q, k, v) (flash_attention.cu's function, same
// scale and window) given out and its gradient dout (b, s, h, hd).  All
// tensors contiguous, kv dividing h, hd 16, 32, 64, 96, 128 or 256; is_bf16
// picks bfloat16 (1) or float32 (0) for every tensor.  lse and delta are
// float32 scratch of b * h * s elements each.  Launches three kernels on
// `stream` without synchronising and returns the first CUDA error (0 when
// every launch was accepted).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, int b, int s, int h, int kv, int hd,
                                   float scale, int window, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || kv < 1 || h % kv) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* l = static_cast<float*>(lse);
  auto* d = static_cast<float*>(delta);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dout, dq, dk, dv, l, d, b, s, h, kv, hd, scale,
                                   window, st);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, d, b, s, h, kv, hd, scale, window, st);
}
