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
// (B, S, KV, hd); all contiguous, all float32 or all bfloat16, each
// starting on a 16-byte boundary.  Arithmetic is float32 throughout; the
// gradients are stored in the input type.  lse and delta are float32
// (B, H, S) scratch that the caller allocates, and so is `partial`, one
// float32 (dk, dv) tile per slot of the dK/dV work list.
//
// Four kernels, launched in order on one stream:
//  (a) stats_kernel: one block per (b*h, query tile), heaviest tiles first.
//      It recomputes each row's log-sum-exp over its visible keys (the
//      forward pass without p v; the forward kernel does not keep it) and
//      delta = do . out.
//  (b) dkdv_kernel: one block per item of a work list that the wrapper
//      builds once per shape (kernels/flash_attention.py::dkdv_work).  An
//      item is a run of (query tile, query head) steps of one (b*KV, key
//      tile): the key tile's k and v stay in shared memory while the steps'
//      q, do, lse and delta stream through, and the GQA sum stays in the
//      block's registers.  A key tile whose steps exceed the call's steps
//      over 132 SMs is cut into several items, heaviest first in the list;
//      an item of a cut tile writes its float32 partial dk, dv to its slot.
//  (c) dkdv_reduce_kernel: one block per cut key tile; it sums the tile's
//      partials in slot order and writes dk, dv.
//  (d) dq_kernel: one block per (b*h, query tile), heaviest tiles first,
//      walking the key tiles in its causal window.
// (b) and (d) both recompute p and ds; sharing them would need atomics on
// dq or a (B, H, S, S) buffer.  No kernel uses atomics and every sum runs
// in one fixed order, so two calls on the same inputs give the same bits.
//
// Masking.  The forward's NEG_INF is finite (-1e30).  Here no masked score
// ever reaches exp: p and ds are set to 0 for every (row, key) that
// `visible` rejects, which covers the causal mask, the window, and rows and
// keys past S (ragged S; those rows are staged as zeros and never stored).
//
// What bounds it.  Five products of the forward's size (q k^T and do v^T
// recomputed, then ds k, ds^T q and p^T do), about 2.5 times the forward's
// operations, plus q k^T once more in (a) and q k^T, do v^T once more in
// (d).  At the training path's shapes (qwen1.5-0.5b: B = 2, S = 2048,
// H = KV = 16, hd 64; gemma3-1b: H = 4, KV = 1, hd 256, window 512 and
// global) that is tens of GFLOP per call against a few tens of MB moved,
// so the bound is operations: 0.64 ms at qwen's shape on the CUDA cores'
// 67 TFLOP/s in float32, 0.26 ms at the split-TF32 rate (495 / 3 TFLOP/s).
// mma.sync does not reach 495: on the H100 one HMMA.1688.F32.TF32 takes
// about two SM cycles (PERF.md, PR 21), so split TF32 on mma.sync tops out
// near 71 TFLOP/s, and this design's own floor at qwen's shape, with its
// seven split products and one float64 product, is about 1 ms.
//
// Design.
//  - Products on the tensor cores: every product is mma.sync.m16n8k8 on
//    TF32 operands with float32 accumulators.  An operand that is not exact
//    in TF32 (float32 inputs; p and ds always) is split into a high and a
//    low part and takes three mmas, hi*hi + hi*lo + lo*hi (tf32.cuh, shared
//    with wkv6.cu and flash_attention.cu); a bfloat16 input is exact, so a
//    product of two takes one mma and one with p or ds two.  The CUDA
//    cores' float32 FMAs, fed one shared-memory load per one or two FMAs,
//    were the old ceiling.
//  - Precision: the tensor core cuts the low bits of each sum it forms, so
//    every product adds its tensor-core accumulators into a float32 sum
//    every CHAIN k8 steps.  In (d), do v^T runs on the FP64 tensor cores
//    (mma.m8n8k4.f64: exact products, float64 sums): dq_i sums ds_ij k_j
//    with ds_ij = p_ij (dp_ij - delta_i), and in a peaked row dp_ij and
//    delta_i cancel, so dp's error reaches dq whole.  With split TF32
//    such rows read 1.34e-4 of their norm against the plain version at
//    qwen's shape (the limit is 1e-4); with float64, 1.6e-5 against the
//    plain version in float64, where the float32 plain version itself
//    reads 6.7e-5.  (b) keeps split TF32: dk and dv sum over many queries
//    and read about 5e-6.
//  - Fragments: tiles of rows x hd are staged in the input type with rows
//    padded by 16 bytes, so that the fragment reads of q k^T ([g][t4]) and
//    of the row-contracting products ([2 t4][g]) are free of bank
//    conflicts.  p^T, ds^T (and ds in (d)) go through shared memory as
//    float32 with rows padded to 8 mod 32 floats: each thread writes and
//    reads pairs of columns as one float2.  A product that contracts over
//    rows permutes the k index inside each k8 step alike on both sides
//    (k index t4 -> row 2 t4, t4 + 4 -> 2 t4 + 1), which makes those pairs
//    the A fragment.  Where a warp has few n8 tiles (hd 128 and 256),
//    successive k8 steps take separate accumulators (CHAINS), and (b) runs
//    q k^T and do v^T in one loop, so that mmas do not wait on each other.
//  - Staging: a two-stage cp.async ring; in (b) each next step's q, do,
//    lse and delta, in (a) and (d) each next key tile's k (and v), load
//    while the current one computes, and rows past S are zero-filled by
//    the copy.  A tile pair that the mask cannot touch (most of them)
//    takes a path without the per-element `visible` test.
//  - Balance: the work list gives no block more than the call's steps
//    over 132 (at gemma3-1b's global layers 124 steps against 256 for the
//    first key tile of a grid of key tiles), so the early key tiles no
//    longer set the call's time.
//  - Tiles: 64 rows up to hd 96; at hd 128 and 256, 32-row tiles in (b):
//    at hd 256, 64 key rows would hold 128 accumulator registers a thread
//    for dk and dv alone, whether d streams through in panels or not, and
//    (b) is at 255 registers with 32.  (a) and (d) take 64 query rows up
//    to hd 128.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tf32::divisor_upto;
using tf32::exact_tf32;
using tf32::ld;
using tf32::to_tf32;

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use on sm_90
constexpr int ITEM_FIELDS = 7;       // kernels/flash_attention.py::DKDV_ITEM_FIELDS
constexpr int SPLIT_FIELDS = 4;      // (bkv, key tile, first slot, slots)
// k8 steps that a product runs on one tensor-core accumulator before adding
// it, in float32, to its sum: the tensor core cuts the low bits of each
// sum it forms, and a short chain keeps that cut small against the sum.
constexpr int CHAIN = 4;
// Independent tensor-core accumulators a warp keeps busy per product: with
// fewer n8 tiles than this, hi*hi products of successive k8 steps go to
// separate accumulators, so that no mma waits on the one before it.
constexpr int CHAINS = 4;

// Rows of the dK/dV kernel's key tiles and of the query tiles of its steps
// (kernels/flash_attention.py::bwd_tile_rows).
template <int HD>
struct KvTile {
  static constexpr int value = HD <= 96 ? 64 : 32;
};

// Query rows (BM) and key rows (BN) of the stats and dQ kernels' tiles.
template <int HD>
struct QTile {
  static constexpr int BM = HD <= 128 ? 64 : 32;
  static constexpr int BN = HD <= 96 ? 64 : 32;
};

// Elements between rows of a staged [rows][HD] tile: 16 bytes of padding.
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(bf16* p, float v) { *p = __float2bfloat16(v); }

// Whether query position qp attends to key position kp.
__device__ __forceinline__ bool visible(int qp, int kp, int s_len, int window) {
  return kp <= qp && qp < s_len && (window <= 0 || qp - kp < window);
}

// Whether every query of [q0, q0 + nq) sees every key of [k0, k0 + nk):
// then the tile pair needs no mask.
__device__ __forceinline__ bool all_visible(int q0, int nq, int k0, int nk, int s_len, int window) {
  return k0 + nk - 1 <= q0 && q0 + nq - 1 < s_len && (window <= 0 || q0 + nq - 1 - k0 < window);
}

// Accumulators of one product of NT n8 tiles: SETS for the hi*hi mmas,
// taken in turn over k8 steps, and one for the hi*lo and lo*hi corrections;
// flush() adds them, in float32, to the product's sum and clears them.
template <int NT>
struct Acc {
  static constexpr int SETS = NT >= CHAINS ? 1 : CHAINS / NT;
  float c[SETS][NT][4] = {};
  float e[NT][4] = {};

  __device__ __forceinline__ void flush(float (&sum)[NT][4]) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float t = e[j][q];
        e[j][q] = 0.0f;
#pragma unroll
        for (int s = 0; s < SETS; ++s) {
          t += c[s][j][q];
          c[s][j][q] = 0.0f;
        }
        sum[j][q] += t;
      }
  }
};

// c += a * b on split operands (hi*hi into c, corrections into e); the lo
// products of an exact side are 0 and are skipped.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_split(float (&c)[4], float (&e)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                          uint32_t bl1) {
  if constexpr (!AX) tf32::mma(e, al, bh0, bh1);
  if constexpr (!BX) tf32::mma(e, ah, bl0, bl1);
  tf32::mma(c, ah, bh0, bh1);
}

// One k8 step at column k of a product of two [rows][HD] tiles over d, into
// hi*hi accumulator set `set` of `acc`: the warp's 16 x 8 NT block at
// (m0, n0), `ar` = A + (m0 + g) * SA + t4 and `br` = B + (n0 + g) * SA + t4.
// Fragments: a = A[g][t4], A[g + 8][t4], A[g][t4 + 4], A[g + 8][t4 + 4];
// b = B[g][t4], B[g][t4 + 4].
template <typename T, int HD, int NT>
__device__ __forceinline__ void rows_step(Acc<NT>& acc, int set, const T* ar, const T* br, int k) {
  constexpr int SA = row_stride<T, HD>();
  constexpr bool X = exact_tf32<T>();
  uint32_t ah[4], al[4];
  to_tf32<X>(ld(ar + k), ah[0], al[0]);
  to_tf32<X>(ld(ar + 8 * SA + k), ah[1], al[1]);
  to_tf32<X>(ld(ar + k + 4), ah[2], al[2]);
  to_tf32<X>(ld(ar + 8 * SA + k + 4), ah[3], al[3]);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    uint32_t bh0, bl0, bh1, bl1;
    to_tf32<X>(ld(br + 8 * j * SA + k), bh0, bl0);
    to_tf32<X>(ld(br + 8 * j * SA + k + 4), bh1, bl1);
    mma_split<X, X>(acc.c[set][j], acc.e[j], ah, al, bh0, bh1, bl0, bl1);
  }
}

// sum1[j] += sum_d A1[m0 + r][d] B1[n0 + 8 j + c][d] (q k^T, do v^T and
// their transposes), and the same for (A2, B2, sum2) when TWO: two
// products over one loop, so that their mmas interleave.
template <typename T, int HD, int NT, bool TWO>
__device__ __forceinline__ void rows_by_rows(float (&sum1)[NT][4], float (&sum2)[NT][4], const T* a1,
                                             const T* b1, const T* a2, const T* b2, int m0, int n0,
                                             int lane) {
  constexpr int SA = row_stride<T, HD>();
  constexpr int SETS = Acc<NT>::SETS;
  constexpr int STEPS = divisor_upto(HD / 8, CHAIN * SETS);   // k8 steps per chunk
  const int g = lane / 4, t4 = lane % 4;
  const int ao = (m0 + g) * SA + t4, bo = (n0 + g) * SA + t4;
  Acc<NT> acc1, acc2;
#pragma unroll 1
  for (int k0 = 0; k0 < HD; k0 += 8 * STEPS) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      rows_step<T, HD, NT>(acc1, s % SETS, a1 + ao, b1 + bo, k0 + 8 * s);
      if constexpr (TWO) rows_step<T, HD, NT>(acc2, s % SETS, a2 + ao, b2 + bo, k0 + 8 * s);
    }
    acc1.flush(sum1);
    if constexpr (TWO) acc2.flush(sum2);
  }
}

// c += a * b, m8n8k4, float64 operands and accumulators (the FP64 tensor
// cores): a = A[g][t4], b = B[t4][g], c = C[g][2 t4], C[g][2 t4 + 1].
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// rows_by_rows of one product on the FP64 tensor cores: the same block and
// C layout (the rows g and g + 8 as two m8 tiles), every product exact and
// every sum in float64, rounded to float32 once at the end.  Successive k4
// steps alternate between two accumulator sets where NT alone gives fewer
// than CHAINS chains.
template <typename T, int HD, int NT>
__device__ __forceinline__ void rows_by_rows_f64(float (&acc)[NT][4], const T* a, const T* b, int m0,
                                                 int n0, int lane) {
  constexpr int SA = row_stride<T, HD>();
  constexpr int SETS = 2 * NT >= CHAINS ? 1 : 2;
  const int g = lane / 4, t4 = lane % 4;
  const T* ar = a + (m0 + g) * SA + t4;
  const T* br = b + (n0 + g) * SA + t4;
  double c[SETS][NT][2][2] = {};
#pragma unroll 2
  for (int k0 = 0; k0 < HD; k0 += 4 * SETS) {
#pragma unroll
    for (int s = 0; s < SETS; ++s) {
      const int k = k0 + 4 * s;
      const double top = ld(ar + k);
      const double bottom = ld(ar + 8 * SA + k);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const double bj = ld(br + 8 * j * SA + k);
        dmma(c[s][j][0], top, bj);
        dmma(c[s][j][1], bottom, bj);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      double t = 0.0;
#pragma unroll
      for (int s = 0; s < SETS; ++s) t += c[s][j][q / 2][q % 2];
      acc[j][q] += static_cast<float>(t);
    }
}

// sum[j] += sum_r P[m0 + i][r] X[r][n0 + 8 j + c] over r in [0, R): P is
// float32 [.][SP] (p^T, ds^T or ds), X a [R][HD] tile of T (do, q or k).
// Inside each k8 step, k index t4 stands for row 2 t4 and t4 + 4 for
// 2 t4 + 1 on both sides, so a thread's A fragment is two float2 reads of
// P and its B fragment X[k + 2 t4][g], X[k + 2 t4 + 1][g].
template <typename T, int HD, int R, int SP, int NT>
__device__ __forceinline__ void rows_by_cols(float (&sum)[NT][4], const float* p, const T* x, int m0,
                                             int n0, int lane) {
  constexpr int SA = row_stride<T, HD>();
  constexpr bool X = exact_tf32<T>();
  constexpr int SETS = Acc<NT>::SETS;
  constexpr int STEPS = divisor_upto(R / 8, CHAIN * SETS);   // k8 steps per chunk
  const int g = lane / 4, t4 = lane % 4;
  const float* pr = p + (m0 + g) * SP + 2 * t4;
  const T* xr = x + 2 * t4 * SA + n0 + g;
  Acc<NT> acc;
#pragma unroll 1
  for (int k0 = 0; k0 < R; k0 += 8 * STEPS) {
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int k = k0 + 8 * s;
      const float2 top = *reinterpret_cast<const float2*>(pr + k);
      const float2 bottom = *reinterpret_cast<const float2*>(pr + 8 * SP + k);
      uint32_t ah[4], al[4];
      tf32::split(top.x, ah[0], al[0]);
      tf32::split(bottom.x, ah[1], al[1]);
      tf32::split(top.y, ah[2], al[2]);
      tf32::split(bottom.y, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh0, bl0, bh1, bl1;
        to_tf32<X>(ld(xr + k * SA + 8 * j), bh0, bl0);
        to_tf32<X>(ld(xr + (k + 1) * SA + 8 * j), bh1, bl1);
        mma_split<false, X>(acc.c[s % SETS][j], acc.e[j], ah, al, bh0, bh1, bl0, bl1);
      }
    }
    acc.flush(sum);
  }
}

// Rows [row0, row0 + ROWS) of a (B, S, heads, HD) tensor at one (b, head),
// `src` pointing at (b, 0, head, 0) and `stride` elements between
// positions, copied into a [ROWS][row_stride] tile at shared address `dst`;
// rows past S are zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, size_t stride, int row0, int s_len) {
  constexpr int SA = row_stride<T, HD>();
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // elements per 16-byte chunk
  constexpr int CH = HD / PER;
  for (int idx = static_cast<int>(threadIdx.x); idx < ROWS * CH; idx += THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool in = row0 + r < s_len;
    tf32::cp_async16(dst + static_cast<uint32_t>((r * SA + c * PER) * sizeof(T)),
                     src + static_cast<size_t>(in ? row0 + r : 0) * stride + c * PER, in);
  }
}

// ROWS floats of one (b, h) row statistic from position row0; zero past S.
template <int ROWS>
__device__ __forceinline__ void load_vec(uint32_t dst, const float* src, int row0, int s_len) {
  for (int r = static_cast<int>(threadIdx.x); r < ROWS; r += THREADS) {
    const bool in = row0 + r < s_len;
    tf32::cp_async4(dst + 4 * r, src + (in ? row0 + r : 0), in);
  }
}

// Merges running softmax statistics (m2, l2) into (m, l).
__device__ __forceinline__ void merge_stats(float& m, float& l, float m2, float l2) {
  const float mx = fmaxf(m, m2);
  l = l * expf(m - mx) + l2 * expf(m2 - mx);
  m = mx;
}

// The running (max, sum) of one thread's rows qp, qp + 8 after one key
// tile: its columns kp + 8 j + c of the scaled scores `sc`.  Without MASK
// the caller has found every pair of the tiles visible.
template <bool MASK, int NT>
__device__ __forceinline__ void online_stats(float (&mrow)[2], float (&lrow)[2], const float (&sc)[NT][4], int qp,
                                             int kp, int s_len, int window, float scale) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (!MASK || visible(qp + 8 * e, kp + 8 * j + c, s_len, window)) mx = fmaxf(mx, sc[j][2 * e + c] * scale);
    if (mx > NEG_INF) {   // a tile with no visible key changes nothing
      const float m_new = fmaxf(mrow[e], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!MASK || visible(qp + 8 * e, kp + 8 * j + c, s_len, window))
            sum += expf(sc[j][2 * e + c] * scale - m_new);
      lrow[e] = lrow[e] * expf(mrow[e] - m_new) + sum;
      mrow[e] = m_new;
    }
  }
}

// ---------------------------------------------------------------------------
// (a) Row statistics: lse = m + log l over the row's visible keys, and
// delta = do . out.
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct StatsSmem {
  static constexpr int BM = QTile<HD>::BM;
  static constexpr int BN = QTile<HD>::BN;
  static constexpr int WM = BM / 16;
  static constexpr int WN = WARPS / WM;
  static constexpr int SA = row_stride<T, HD>();
  static constexpr int QS = 0;                                   // q  [BM][SA]
  static constexpr int RING = QS + BM * SA * sizeof(T);          // k  [2][BN][SA]
  static constexpr int KTILE = BN * SA * sizeof(T);
  static constexpr int ML = RING + 2 * KTILE;                    // (m, l) [WN][BM][2]
  static constexpr int BYTES = ML + WN * BM * 2 * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
stats_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
             const T* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
             int s_len, int h_q, int h_kv, float scale, int window) {
  using M = StatsSmem<T, HD>;
  constexpr int BM = M::BM, BN = M::BN, WM = M::WM, WN = M::WN;
  constexpr int NT = BN / (8 * WN);
  static_assert(M::BYTES <= SMEM_LIMIT, "stats_kernel's tiles exceed shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const T* qs = reinterpret_cast<const T*>(smem + M::QS);
  float* ml = reinterpret_cast<float*>(smem + M::ML);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 16 * (warp % WM);
  const int wn = warp / WM;
  const int n0 = wn * (BN / WN);

  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * BM;  // heaviest first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;

  const int k_end = min(q0 + BM, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BN) * BN : 0;
  const int n_tiles = (k_end - k_begin + BN - 1) / BN;

  load_rows<T, HD, BM>(base + M::QS, q + q_off, q_stride, q0, s_len);
  load_rows<T, HD, BN>(base + M::RING, kb, kv_stride, k_begin, s_len);
  tf32::cp_async_commit();

  // Running (max, sum) of this thread's columns for rows m0 + g, m0 + g + 8.
  float mrow[2] = {NEG_INF, NEG_INF}, lrow[2] = {0.0f, 0.0f};
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles)
      load_rows<T, HD, BN>(base + M::RING + ((i + 1) & 1) * M::KTILE, kb, kv_stride, k_begin + (i + 1) * BN,
                           s_len);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const int k0 = k_begin + i * BN;
    const T* ks = reinterpret_cast<const T*>(smem + M::RING + (i & 1) * M::KTILE);
    float sc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    rows_by_rows<T, HD, NT, false>(sc, sc, qs, ks, qs, ks, m0, n0, lane);
    if (all_visible(q0, BM, k0, BN, s_len, window))
      online_stats<false, NT>(mrow, lrow, sc, q0 + m0 + g, k0 + n0 + 2 * t4, s_len, window, scale);
    else
      online_stats<true, NT>(mrow, lrow, sc, q0 + m0 + g, k0 + n0 + 2 * t4, s_len, window, scale);
    __syncthreads();   // this key tile's stage is consumed
  }

  // The four threads of a row, then the WN warps of a row, in a fixed order.
#pragma unroll
  for (int e = 0; e < 2; ++e) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      const float m2 = __shfl_xor_sync(0xffffffffu, mrow[e], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, lrow[e], off);
      merge_stats(mrow[e], lrow[e], m2, l2);
    }
    if (t4 == 0) {
      ml[(wn * BM + m0 + g + 8 * e) * 2] = mrow[e];
      ml[(wn * BM + m0 + g + 8 * e) * 2 + 1] = lrow[e];
    }
  }
  __syncthreads();
  float* lse_b = lse + static_cast<size_t>(blockIdx.y) * s_len;
  float* delta_b = delta + static_cast<size_t>(blockIdx.y) * s_len;
  for (int r = warp; r < BM; r += WARPS) {
    const int qp = q0 + r;
    if (qp >= s_len) continue;
    const size_t at = q_off + static_cast<size_t>(qp) * q_stride;
    float dot = 0.0f;
    for (int d = lane; d < HD; d += 32) dot = fmaf(ld(dout + at + d), ld(o + at + d), dot);
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) {
      float m = ml[r * 2], l = ml[r * 2 + 1];
      for (int w = 1; w < WN; ++w) merge_stats(m, l, ml[(w * BM + r) * 2], ml[(w * BM + r) * 2 + 1]);
      // Every row sees its own key, so l >= 1 here.
      lse_b[qp] = m + logf(l);
      delta_b[qp] = dot;
    }
  }
}

// p and ds of the warp's fragments of s (or s^T) and dp (or dp^T): row
// positions rp = r0 + m0 + g (+ 8), column positions cp = c0 + n0 + 8 j +
// 2 t4 (+ 1); the row statistics are indexed by the query, the row when
// QUERY_ROWS, the column otherwise.  p (when `ps` is given) and ds are
// written as float2 pairs to [.][SP] tiles.  Without MASK the caller has
// found every pair of the tiles visible.
template <bool QUERY_ROWS, bool MASK, int NT, int SP>
__device__ __forceinline__ void p_and_ds(const float (&sc)[NT][4], const float (&dp)[NT][4],
                                         const float* lse_s, const float* delta_s, float* ps, float* dss,
                                         int r0, int c0, int m0, int n0, int lane, int s_len, int window,
                                         float scale) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + g + 8 * e;
      const int n = n0 + 8 * j + 2 * t4;
      float p[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int qi = QUERY_ROWS ? m : n + c;
        const int qp = QUERY_ROWS ? r0 + m : c0 + n + c;
        const int kp = QUERY_ROWS ? c0 + n + c : r0 + m;
        p[c] = 0.0f;
        ds[c] = 0.0f;
        if (!MASK || visible(qp, kp, s_len, window)) {
          p[c] = expf(sc[j][2 * e + c] * scale - lse_s[qi]);
          ds[c] = p[c] * (dp[j][2 * e + c] - delta_s[qi]);
        }
      }
      if (ps != nullptr) *reinterpret_cast<float2*>(ps + m * SP + n) = make_float2(p[0], p[1]);
      *reinterpret_cast<float2*>(dss + m * SP + n) = make_float2(ds[0], ds[1]);
    }
}

// ---------------------------------------------------------------------------
// (b) dK and dV of one work item: a run of (query tile, query head) steps of
// one key tile, summed over the query heads of its group.
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct DkdvSmem {
  static constexpr int R = KvTile<HD>::value;     // key rows and query rows
  static constexpr int WM = R / 16;
  static constexpr int WN = WARPS / WM;
  static constexpr int SA = row_stride<T, HD>();
  static constexpr int SP = R + 8;
  static constexpr int TILE = R * SA * sizeof(T);
  static constexpr int KS = 0;                          // k [R][SA]
  static constexpr int VS = KS + TILE;                  // v
  static constexpr int STAGE = 2 * TILE + 2 * R * 4;    // q, do [R][SA]; lse, delta [R]
  static constexpr int RING = VS + TILE;                // [2] stages
  static constexpr int PT = RING + 2 * STAGE;           // p^T  [R][SP] float
  static constexpr int DST = PT + R * SP * 4;           // ds^T [R][SP] float
  static constexpr int BYTES = DST + R * SP * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
            float* __restrict__ partial, const int* __restrict__ items, int s_len, int h_q,
            int h_kv, float scale, int window) {
  using M = DkdvSmem<T, HD>;
  constexpr int R = M::R, WM = M::WM, WN = M::WN, SP = M::SP;
  constexpr int NTA = R / (8 * WN);    // n8 tiles of s^T per warp
  constexpr int NTB = HD / (8 * WN);   // n8 tiles of dk, dv per warp
  static_assert(M::BYTES <= SMEM_LIMIT, "dkdv_kernel's tiles exceed shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const T* ks = reinterpret_cast<const T*>(smem + M::KS);
  const T* vs = reinterpret_cast<const T*>(smem + M::VS);
  float* pt = reinterpret_cast<float*>(smem + M::PT);
  float* dst = reinterpret_cast<float*>(smem + M::DST);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 16 * (warp % WM);
  const int wn = warp / WM;
  const int n0a = wn * (R / WN);
  const int n0b = wn * (HD / WN);

  const int* it = items + static_cast<size_t>(blockIdx.x) * ITEM_FIELDS;
  const int bkv = it[0], kt = it[1], h0 = it[2], h1 = it[3], t0 = it[4], t1 = it[5], slot = it[6];
  const int b = bkv / h_kv;
  const int hk = bkv % h_kv;
  const int group = h_q / h_kv;
  const int k0 = kt * R;
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const int nh = h1 - h0;
  const int steps = (t1 - t0) * nh;

  // Step i of the item: query tile t0 + i / nh of head h0 + i % nh.
  auto load_step = [&](int i, int stage) {
    const int h = hk * group + h0 + i % nh;
    const int q0 = (t0 + i / nh) * R;
    const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
    const size_t stat_off = (static_cast<size_t>(b) * h_q + h) * s_len;
    const uint32_t st = base + M::RING + stage * M::STAGE;
    load_rows<T, HD, R>(st, q + q_off, q_stride, q0, s_len);
    load_rows<T, HD, R>(st + M::TILE, dout + q_off, q_stride, q0, s_len);
    load_vec<R>(st + 2 * M::TILE, lse + stat_off, q0, s_len);
    load_vec<R>(st + 2 * M::TILE + 4 * R, delta + stat_off, q0, s_len);
  };

  load_rows<T, HD, R>(base + M::KS, k + kv_off, kv_stride, k0, s_len);
  load_rows<T, HD, R>(base + M::VS, v + kv_off, kv_stride, k0, s_len);
  load_step(0, 0);
  tf32::cp_async_commit();

  float dka[NTB][4], dva[NTB][4];
#pragma unroll
  for (int j = 0; j < NTB; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dka[j][c] = 0.0f;
      dva[j][c] = 0.0f;
    }

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1, (i + 1) & 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = smem + M::RING + (i & 1) * M::STAGE;
    const T* qs = reinterpret_cast<const T*>(st);
    const T* dos = reinterpret_cast<const T*>(st + M::TILE);
    const float* lse_s = reinterpret_cast<const float*>(st + 2 * M::TILE);
    const float* delta_s = lse_s + R;
    const int q0 = (t0 + i / nh) * R;

    float sc[NTA][4], dp[NTA][4];
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[j][c] = 0.0f;
        dp[j][c] = 0.0f;
      }
    rows_by_rows<T, HD, NTA, true>(sc, dp, ks, qs, vs, dos, m0, n0a, lane);   // s^T = k q^T, dp^T = v do^T
    if (all_visible(q0, R, k0, R, s_len, window))
      p_and_ds<false, false, NTA, SP>(sc, dp, lse_s, delta_s, pt, dst, k0, q0, m0, n0a, lane, s_len, window, scale);
    else
      p_and_ds<false, true, NTA, SP>(sc, dp, lse_s, delta_s, pt, dst, k0, q0, m0, n0a, lane, s_len, window, scale);
    __syncthreads();
    rows_by_cols<T, HD, R, SP, NTB>(dva, pt, dos, m0, n0b, lane);    // dv += p^T do
    rows_by_cols<T, HD, R, SP, NTB>(dka, dst, qs, m0, n0b, lane);    // dk += ds^T q
    __syncthreads();   // this stage, p^T and ds^T are consumed
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int m = m0 + g + 8 * e;
    const int kp = k0 + m;
#pragma unroll
    for (int j = 0; j < NTB; ++j) {
      const int col = n0b + 8 * j + 2 * t4;
      if (slot >= 0) {
        float* part = partial + static_cast<size_t>(slot) * 2 * R * HD + m * HD + col;
        *reinterpret_cast<float2*>(part) = make_float2(dka[j][2 * e], dka[j][2 * e + 1]);
        *reinterpret_cast<float2*>(part + R * HD) = make_float2(dva[j][2 * e], dva[j][2 * e + 1]);
      } else if (kp < s_len) {
        const size_t at = kv_off + static_cast<size_t>(kp) * kv_stride + col;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          store_f32(dk + at + c, dka[j][2 * e + c] * scale);
          store_f32(dv + at + c, dva[j][2 * e + c]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (c) dK and dV of the key tiles that the work list cut into several items:
// each tile's partials summed in slot order.
// ---------------------------------------------------------------------------
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ splits, T* __restrict__ dk,
              T* __restrict__ dv, int s_len, int h_kv, float scale) {
  constexpr int R = KvTile<HD>::value;
  const int* sp = splits + static_cast<size_t>(blockIdx.x) * SPLIT_FIELDS;
  const int bkv = sp[0], kt = sp[1], first = sp[2], n = sp[3];
  const int b = bkv / h_kv;
  const int hk = bkv % h_kv;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const float* part = partial + static_cast<size_t>(first) * 2 * R * HD;
  for (int e = static_cast<int>(threadIdx.x); e < 2 * R * HD; e += THREADS) {
    float sum = 0.0f;
    for (int p = 0; p < n; ++p) sum += part[static_cast<size_t>(p) * 2 * R * HD + e];
    const int which = e / (R * HD);
    const int r = (e / HD) % R;
    const int kp = kt * R + r;
    if (kp >= s_len) continue;
    const size_t at = kv_off + static_cast<size_t>(kp) * kv_stride + e % HD;
    if (which == 0)
      store_f32(dk + at, sum * scale);
    else
      store_f32(dv + at, sum);
  }
}

// ---------------------------------------------------------------------------
// (d) dQ of one query tile of one head.
// ---------------------------------------------------------------------------
template <typename T, int HD>
struct DqSmem {
  static constexpr int BM = QTile<HD>::BM;
  static constexpr int BN = QTile<HD>::BN;
  static constexpr int WM = BM / 16;
  static constexpr int WN = WARPS / WM;
  static constexpr int SA = row_stride<T, HD>();
  static constexpr int SP = BN + 8;
  static constexpr int QTILE = BM * SA * sizeof(T);
  static constexpr int KTILE = BN * SA * sizeof(T);
  static constexpr int QS = 0;                          // q  [BM][SA]
  static constexpr int DOS = QS + QTILE;                // do [BM][SA]
  static constexpr int LSE = DOS + QTILE;               // lse, delta [BM]
  static constexpr int RING = LSE + 2 * BM * 4;         // [2] stages of k, v [BN][SA]
  static constexpr int DSS = RING + 4 * KTILE;          // ds [BM][SP] float
  static constexpr int BYTES = DSS + BM * SP * 4;
};

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int s_len, int h_q,
          int h_kv, float scale, int window) {
  using M = DqSmem<T, HD>;
  constexpr int BM = M::BM, BN = M::BN, WM = M::WM, WN = M::WN, SP = M::SP;
  constexpr int NTA = BN / (8 * WN);
  constexpr int NTB = HD / (8 * WN);
  static_assert(M::BYTES <= SMEM_LIMIT, "dq_kernel's tiles exceed shared memory");
  extern __shared__ __align__(16) unsigned char smem[];
  const T* qs = reinterpret_cast<const T*>(smem + M::QS);
  const T* dos = reinterpret_cast<const T*>(smem + M::DOS);
  const float* lse_s = reinterpret_cast<const float*>(smem + M::LSE);
  const float* delta_s = lse_s + BM;
  float* dss = reinterpret_cast<float*>(smem + M::DSS);
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = 16 * (warp % WM);
  const int wn = warp / WM;
  const int n0a = wn * (BN / WN);
  const int n0b = wn * (HD / WN);

  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * BM;  // heaviest first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const size_t stat_off = static_cast<size_t>(blockIdx.y) * s_len;

  const int k_end = min(q0 + BM, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BN) * BN : 0;
  const int n_tiles = (k_end - k_begin + BN - 1) / BN;
  auto load_kv = [&](int i) {
    const uint32_t st = base + M::RING + (i & 1) * 2 * M::KTILE;
    load_rows<T, HD, BN>(st, k + kv_off, kv_stride, k_begin + i * BN, s_len);
    load_rows<T, HD, BN>(st + M::KTILE, v + kv_off, kv_stride, k_begin + i * BN, s_len);
  };

  load_rows<T, HD, BM>(base + M::QS, q + q_off, q_stride, q0, s_len);
  load_rows<T, HD, BM>(base + M::DOS, dout + q_off, q_stride, q0, s_len);
  load_vec<BM>(base + M::LSE, lse + stat_off, q0, s_len);
  load_vec<BM>(base + M::LSE + 4 * BM, delta + stat_off, q0, s_len);
  load_kv(0);
  tf32::cp_async_commit();

  float dqa[NTB][4];
#pragma unroll
  for (int j = 0; j < NTB; ++j) dqa[j][0] = dqa[j][1] = dqa[j][2] = dqa[j][3] = 0.0f;

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) load_kv(i + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const unsigned char* st = smem + M::RING + (i & 1) * 2 * M::KTILE;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = reinterpret_cast<const T*>(st + M::KTILE);
    float sc[NTA][4], dp[NTA][4];
#pragma unroll
    for (int j = 0; j < NTA; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[j][c] = 0.0f;
        dp[j][c] = 0.0f;
      }
    rows_by_rows<T, HD, NTA, false>(sc, sc, qs, ks, qs, ks, m0, n0a, lane);   // s = q k^T
    rows_by_rows_f64<T, HD, NTA>(dp, dos, vs, m0, n0a, lane);   // dp = do v^T, in float64
    const int k0 = k_begin + i * BN;
    if (all_visible(q0, BM, k0, BN, s_len, window))
      p_and_ds<true, false, NTA, SP>(sc, dp, lse_s, delta_s, nullptr, dss, q0, k0, m0, n0a, lane, s_len, window,
                                     scale);
    else
      p_and_ds<true, true, NTA, SP>(sc, dp, lse_s, delta_s, nullptr, dss, q0, k0, m0, n0a, lane, s_len, window,
                                    scale);
    __syncthreads();
    rows_by_cols<T, HD, BN, SP, NTB>(dqa, dss, ks, m0, n0b, lane);   // dq += ds k
    __syncthreads();   // this stage and ds are consumed
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int qp = q0 + m0 + g + 8 * e;
    if (qp >= s_len) continue;
    const size_t at = q_off + static_cast<size_t>(qp) * q_stride;
#pragma unroll
    for (int j = 0; j < NTB; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) store_f32(dq + at + n0b + 8 * j + 2 * t4 + c, dqa[j][2 * e + c] * scale);
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

struct Work {
  float* partial;
  const int* items;
  int n_items;
  const int* splits;
  int n_splits;
};

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, const Work& w, int b, int s, int h,
           int kv, float scale, int window, cudaStream_t stream) {
  static unsigned configured_stats = 0, configured_dkdv = 0, configured_dq = 0;
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* dot = static_cast<const T*>(dout);
  const int q_tiles = (s + QTile<HD>::BM - 1) / QTile<HD>::BM;

  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(stats_kernel<T, HD>),
                                       StatsSmem<T, HD>::BYTES, configured_stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<T, HD><<<dim3(q_tiles, b * h), THREADS, StatsSmem<T, HD>::BYTES, stream>>>(
      qt, kt, static_cast<const T*>(o), dot, lse, delta, s, h, kv, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dkdv_kernel<T, HD>), DkdvSmem<T, HD>::BYTES,
                           configured_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, HD><<<w.n_items, THREADS, DkdvSmem<T, HD>::BYTES, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), w.partial, w.items, s, h, kv,
      scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (w.n_splits > 0) {
    dkdv_reduce_kernel<T, HD><<<w.n_splits, THREADS, 0, stream>>>(w.partial, w.splits, static_cast<T*>(dk),
                                                             static_cast<T*>(dv), s, kv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dq_kernel<T, HD>), DqSmem<T, HD>::BYTES,
                           configured_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, HD><<<dim3(q_tiles, b * h), THREADS, DqSmem<T, HD>::BYTES, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dq), s, h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o, const void* dout,
             void* dq, void* dk, void* dv, float* lse, float* delta, const Work& w, int b, int s, int h,
             int kv, int hd, float scale, int window, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    case 32: return launch<T, 32>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    case 64: return launch<T, 64>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    case 96: return launch<T, 96>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    case 128: return launch<T, 128>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    case 256: return launch<T, 256>(q, k, v, o, dout, dq, dk, dv, lse, delta, w, b, s, h, kv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int HD>
int smem_of(int kernel) {
  switch (kernel) {
    case 0: return StatsSmem<T, HD>::BYTES;
    case 1: return DkdvSmem<T, HD>::BYTES;
    case 2: return DqSmem<T, HD>::BYTES;
    default: return -1;
  }
}

template <typename T>
int smem_dispatch(int hd, int kernel) {
  switch (hd) {
    case 16: return smem_of<T, 16>(kernel);
    case 32: return smem_of<T, 32>(kernel);
    case 64: return smem_of<T, 64>(kernel);
    case 96: return smem_of<T, 96>(kernel);
    case 128: return smem_of<T, 128>(kernel);
    case 256: return smem_of<T, 256>(kernel);
    default: return -1;
  }
}

}  // namespace

// dq (b, s, h, hd), dk and dv (b, s, kv, hd) = the gradient of causal
// attention out = attention(q, k, v) (flash_attention.cu's function, same
// scale and window) given out and its gradient dout (b, s, h, hd).  All
// tensors contiguous and 16-byte-aligned, kv dividing h, hd 16, 32, 64, 96,
// 128 or 256; is_bf16 picks bfloat16 (1) or float32 (0) for every tensor.
// lse and delta are float32 scratch of b * h * s elements each.  `items`
// (n_items rows of 7 ints) and `splits` (n_splits rows of 4) are the dK/dV
// work list and its cut key tiles (kernels/flash_attention.py::dkdv_work,
// dkdv_splits) in device memory; `partial` holds 2 * rows * hd floats per
// slot they name.  Launches the kernels on `stream` without synchronising
// and returns the first CUDA error (0 when every launch was accepted).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, void* partial, const void* items, int n_items,
                                   const void* splits, int n_splits, int b, int s, int h, int kv,
                                   int hd, float scale, int window, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b < 1 || s < 1 || kv < 1 || h % kv || n_items < 1 || n_splits < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(b) * h > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto* l = static_cast<float*>(lse);
  auto* d = static_cast<float*>(delta);
  const Work w{static_cast<float*>(partial), static_cast<const int*>(items), n_items,
               static_cast<const int*>(splits), n_splits};
  if (is_bf16)
    return dispatch<bf16>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, hd, scale, window, st);
  return dispatch<float>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, hd, scale, window, st);
}

// Dynamic shared memory (bytes) of one kernel of this file at head_dim hd
// and type is_bf16: kernel 0 stats, 1 dK/dV, 2 dQ (the reduction takes
// none); -1 for another hd or kernel.
extern "C" int flash_attention_bwd_smem(int hd, int is_bf16, int kernel) {
  return is_bf16 ? smem_dispatch<bf16>(hd, kernel) : smem_dispatch<float>(hd, kernel);
}
