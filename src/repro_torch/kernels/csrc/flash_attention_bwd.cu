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
// starting on a 16-byte boundary.  Sums are float32; the gradients are
// stored in the input type.  lse and delta are float32 (B, H, S) scratch
// that the caller allocates, and so is `partial`, one float32 (dk, dv)
// tile per slot of the dK/dV work list.
//
// Two routes, fixed by type and head size (kernels/flash_attention.py::
// bwd_route mirrors this dispatch; neither gives way to the other):
//
//   bfloat16, hd in {64, 96, 128, 256} -> wgmma kernels (tc::), bfloat16
//                                         operands, float32 accumulators
//   every float32 shape; bfloat16, hd in {16, 32}
//                                      -> split-TF32 mma.sync kernels
//
// Both have the same four kernels, launched in order on one stream:
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
// The split-TF32 route is described first, then the wgmma route.
//
// Masking.  The forward's NEG_INF is finite (-1e30).  Here no masked score
// ever reaches exp: p and ds are set to 0 for every (row, key) that
// `visible` rejects, which covers the causal mask, the window, and rows and
// keys past S (ragged S; those rows are staged as zeros and never stored).
//
// What bounds it (split TF32).  Five products of the forward's size (q k^T and do v^T
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
// Design (split TF32).
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
//
// The wgmma route (tc::).  bfloat16 inputs are exact bfloat16 operands for
// the card's bfloat16 tensor cores (989 TFLOP/s, some 14 times split TF32
// on mma.sync), so every product is one wgmma with float32 accumulators.
// Its own floor is eight products of the forward's size: (a) q k^T; (b)
// k q^T, v do^T, p^T do and ds^T q; (d) q k^T, do v^T and ds k: 0.139 ms
// at qwen1.5-0.5b's production shape (1, 4096, 16, 16, 64) at 989 TFLOP/s.
//  - Numerics: p and ds are rounded to bfloat16 before their products, as
//    the forward rounds p before p v and as FlashAttention does; the
//    scores and dp = do v^T take exact bfloat16 operands into float32
//    accumulators, so in a peaked row dp - delta cancels as exactly as in
//    the float32 plain version.  lse is kept in base 2 (scores times
//    scale log2 e), so p = exp2(s - lse2).
//  - Tiles: every q, do and key tile is 64 rows, wgmma's M; the dK/dV work
//    list is built for 64-row tiles (bwd_tile_rows).  Tiles are stored in
//    wgmma's swizzled panels (wgmma.cuh, shared with flash_attention.cu),
//    so one stored tile is read K-major where hd is the reduction (s^T =
//    k q^T, dp^T = v do^T, s = q k^T, dp = do v^T: both operands from
//    shared memory) and MN-major, through the descriptor's transpose bit,
//    where the tile's rows are (dv += p^T do, dk += ds^T q, dq += ds k):
//    no transposed copy is ever made.
//  - Fragments: p^T and ds^T (p and ds in (d)) are formed on the score
//    accumulators, lse and delta read per column in (b), per row in (d),
//    and rounded into wgmma's A-register layout: columns 16 kk .. 16 kk +
//    15 of a 64 x N accumulator are registers 8 kk .. 8 kk + 7 of the A
//    fragment of K step kk (as the forward's P), so the row-contracting
//    products read A from registers and never touch shared memory.
//  - (b) at hd 128 and 256: dk and dv at 64 key rows are hd floats a
//    thread each in one warpgroup, and would spill beside s^T and dp^T.
//    Two warpgroups share the key tile: warpgroup 0 computes s^T and p^T
//    and owns dv, warpgroup 1 computes dp^T and owns dk, taking p^T
//    (float32, 16 KB) from warpgroup 0 through shared memory behind a
//    named barrier, each thread the element it holds of dp^T.  At hd 64
//    and 96 one warpgroup holds both.
//  - (d) at hd 256 walks 32-key tiles: the dq fragment alone is 128
//    registers a thread.  Elsewhere 64.
//  - Staging: a two-stage cp.async ring (q, do, lse2 and delta of the next
//    step in (b); the next k, v tile in (a) and (d)), rows past S
//    zero-filled, fence.proxy.async before wgmma reads what cp.async wrote.
//    Deeper rings (3, 4 stages) and two query warpgroups sharing each k, v
//    tile in (a) and (d) were tried and were no faster (PERF.md).
//  - (c) spreads each cut tile's sums over several blocks: at hd 256 the
//    work list cuts a few dozen key tiles, and one block each left most of
//    the card idle.
//  - What bounds it: (a), (b) and (d) each take exp of every visible score
//    again, and (a) is a whole pass over q k^T for lse alone, which the
//    forward could hand over; the products themselves run at a fraction
//    of the tensor cores' rate (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32.cuh"
#include "wgmma.cuh"

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
// each tile's partials ([slot][dk, dv][R][HD] floats) summed in slot order;
// both routes.  Block (x, y) takes the elements y, y + gridDim.y, ... (in
// units of THREADS) of cut tile x: every element's sum runs in slot order
// whatever the grid.
// ---------------------------------------------------------------------------
template <typename T, int HD, int R>
__global__ void __launch_bounds__(THREADS)
dkdv_reduce_kernel(const float* __restrict__ partial, const int* __restrict__ splits, T* __restrict__ dk,
              T* __restrict__ dv, int s_len, int h_kv, float scale) {
  const int* sp = splits + static_cast<size_t>(blockIdx.x) * SPLIT_FIELDS;
  const int bkv = sp[0], kt = sp[1], first = sp[2], n = sp[3];
  const int b = bkv / h_kv;
  const int hk = bkv % h_kv;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const float* part = partial + static_cast<size_t>(first) * 2 * R * HD;
  for (int e = static_cast<int>(blockIdx.y * THREADS + threadIdx.x); e < 2 * R * HD;
       e += THREADS * static_cast<int>(gridDim.y)) {
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
    dkdv_reduce_kernel<T, HD, KvTile<HD>::value><<<w.n_splits, THREADS, 0, stream>>>(
        w.partial, w.splits, static_cast<T*>(dk), static_cast<T*>(dv), s, kv, scale);
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

template <typename T, int HD>
int smem_of(int kernel) {
  switch (kernel) {
    case 0: return StatsSmem<T, HD>::BYTES;
    case 1: return DkdvSmem<T, HD>::BYTES;
    case 2: return DqSmem<T, HD>::BYTES;
    default: return -1;
  }
}

// ---------------------------------------------------------------------------
// wgmma route: bfloat16 at hd 64, 96, 128 and 256.  See the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma;   // Panel, load_tile, smem_desc and the wgmma instructions

constexpr int WG = 128;         // threads of a warpgroup
constexpr int TILE_ROWS = 64;   // rows of every q, do tile and of the dK/dV kernel's key tiles: wgmma's M
constexpr int NS = TILE_ROWS / 2;   // floats a thread holds of a 64 x 64 score fragment
constexpr float LOG2E = 1.4426950408889634f;

// Warpgroups of the dK/dV kernel: from hd 128 one would hold dK and dV
// (hd floats a thread) beside S^T and dP^T (32 each) and spill, so two
// share the key tile, warpgroup 0 owning dV and 1 dK.
template <int HD>
constexpr int dkdv_groups() { return HD >= 128 ? 2 : 1; }

// Keys per tile of the dQ kernel: N of q k^T and do v^T, K of ds k.  At hd
// 256 the dQ fragment alone is 128 registers a thread; 32 keys keep s, dp
// and ds beside it, as in the forward's tc::kv_tile.
template <int HD>
constexpr int dq_keys() { return HD == 256 ? 32 : 64; }

// The first atom-aligned shared address of the dynamic shared memory.
template <int HD>
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* smem) {
  constexpr uint32_t A = Panel<HD>::ATOM;
  return (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + A - 1) & ~(A - 1);
}

// d (64 x N) = a b^T over HD, a (64 rows) and b (N rows) K-major tiles at
// shared addresses `a`, `b`, into d from zero (the caller fences and
// commits): HD / 16 wgmmas, each step's 32 bytes inside one panel row.
template <int HD, int N>
__device__ __forceinline__ void rows_by_rows(float (&d)[N / 2], uint32_t a, uint32_t b) {
  using P = Panel<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t step = (kk % P::STEPS) * 32;
    wgmma_ss<N>(d, smem_desc<P::MODE>(a + (kk / P::STEPS) * (TILE_ROWS * P::ROW) + step, 16, P::ATOM),
                smem_desc<P::MODE>(b + (kk / P::STEPS) * (N * P::ROW) + step, 16, P::ATOM), kk > 0);
  }
}

// acc (64 x HD, one fragment per panel) += x (64 x K, bfloat16 A fragments
// in registers) times the K-row tile at `b`, read MN-major: one wgmma per
// 16-row step and panel (the caller fences and commits).
template <int HD, int K>
__device__ __forceinline__ void rows_by_cols(float (&acc)[HD / Panel<HD>::COLS][Panel<HD>::COLS / 2],
                                             const uint32_t (&x)[K / 16][4], uint32_t b) {
  using P = Panel<HD>;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int p = 0; p < HD / P::COLS; ++p)
      wgmma_rs<P::COLS>(acc[p], x[kk], smem_desc<P::MODE>(b + p * (K * P::ROW) + kk * 16 * P::ROW, P::ATOM, P::ATOM));
}

// A fragment of 64 x N as wgmma's A registers for K = N: columns
// 16 kk .. 16 kk + 15 are registers 8 kk .. 8 kk + 7, rounded to bfloat16.
template <int N>
__device__ __forceinline__ void to_a(const float (&x)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// Stores a 64 x HD accumulator (one fragment per panel) times `mul`: rows
// r0 + row to `out` (bfloat16, `stride` elements between rows; rows at or
// past s_len skipped) or, when `part` is given, all 64 rows to that
// [64][HD] float32 tile.
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / Panel<HD>::COLS][Panel<HD>::COLS / 2],
                                           float mul, bf16* out, size_t stride, int r0, int s_len,
                                           float* part) {
  using P = Panel<HD>;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) % WG / 32;
#pragma unroll
  for (int p = 0; p < HD / P::COLS; ++p)
#pragma unroll
    for (int i = 0; i < P::COLS / 2; i += 2) {
      const int row = 16 * warp + lane / 4 + 8 * ((i / 2) % 2);
      const int col = p * P::COLS + 8 * (i / 4) + 2 * (lane % 4);
      if (part != nullptr)
        *reinterpret_cast<float2*>(part + row * HD + col) = make_float2(acc[p][i], acc[p][i + 1]);
      else if (r0 + row < s_len)
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<size_t>(r0 + row) * stride + col) =
            __floats2bfloat162_rn(acc[p][i] * mul, acc[p][i + 1] * mul);
    }
}

// ---------------------------------------------------------------------------
// (a) Row statistics: lse2 = (m + log l) log2 e over the row's visible keys
// (the scores' log-sum-exp in base 2, as the other kernels take exp2), and
// delta = do . out.
// ---------------------------------------------------------------------------
template <int HD>
struct StatsSmem {
  static constexpr int BK = 64;
  static constexpr int Q = TILE_ROWS * HD * 2;
  static constexpr int K = BK * HD * 2;
  static constexpr int BYTES = Q + 2 * K + Panel<HD>::ATOM;   // q, [2] k; + alignment slack
};

template <int HD>
__global__ void __launch_bounds__(WG, 1)
stats_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ o,
             const bf16* __restrict__ dout, float* __restrict__ lse, float* __restrict__ delta,
             int s_len, int h_q, int h_kv, float scale, int window) {
  using M = StatsSmem<HD>;
  constexpr int BM = TILE_ROWS, BK = M::BK;
  static_assert(M::BYTES <= SMEM_LIMIT, "tc::stats_kernel's tiles exceed shared memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = aligned_base<HD>(smem_raw);
  const uint32_t ring = q_s + M::Q;

  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * BM;  // heaviest first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const bf16* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;

  const int k_end = min(q0 + BM, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_tile<HD, BM, WG>(q_s, q + q_off, q_stride, q0, s_len);
  load_tile<HD, BK, WG>(ring, kb, kv_stride, k_begin, s_len);
  cp_async_commit();

  const int qp0 = q0 + 16 * warp + lane / 4;   // this thread's rows: qp0 and qp0 + 8
  const int col = 2 * (lane % 4);
  const float scale2 = scale * LOG2E;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the rows (base 2), shared by the quad
  float l[2] = {0.0f, 0.0f};         // this thread's part of their sums
  float sc[BK / 2];
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    if (t + 1 < n_tiles) load_tile<HD, BK, WG>(ring + ((t + 1) & 1) * M::K, kb, kv_stride, k0 + BK, s_len);
    cp_async_commit();   // empty on the last tile, so that one group stays behind
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();     // q and this tile's k have landed, from every thread

#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.0f;
    wgmma_fence();
    rows_by_rows<HD, BK>(sc, q_s, ring + (t & 1) * M::K);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool need_mask = !all_visible(q0, BM, k0, BK, s_len, window);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float mx = NEG_INF;
#pragma unroll
      for (int i = 2 * e; i < BK / 2; i += 4)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[i + c] * scale2;
          if (need_mask && !visible(qp0 + 8 * e, k0 + 8 * (i / 4) + col + c, s_len, window)) x = NEG_INF;
          sc[i + c] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[e], mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 2 * e; i < BK / 2; i += 4) sum += exp2f(sc[i] - m_new) + exp2f(sc[i + 1] - m_new);
      // A row whose tiles so far were all masked has m = NEG_INF and sums
      // exp2(0) = 1 per key; its first real score makes this factor 0.
      l[e] = l[e] * exp2f(m[e] - m_new) + sum;
      m[e] = m_new;
    }
    __syncthreads();   // this k stage is consumed
  }

  float* lse_b = lse + static_cast<size_t>(blockIdx.y) * s_len;
  float* delta_b = delta + static_cast<size_t>(blockIdx.y) * s_len;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 1);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 2);
    // Every row sees its own key, so l >= 1 here.
    if (lane % 4 == 0 && qp0 + 8 * e < s_len) lse_b[qp0 + 8 * e] = m[e] + log2f(l[e]);
  }
  for (int r = warp; r < BM; r += WG / 32) {
    const int qp = q0 + r;
    if (qp >= s_len) continue;
    const size_t at = q_off + static_cast<size_t>(qp) * q_stride;
    float dot = 0.0f;
    for (int d = 2 * lane; d < HD; d += 64) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dout + at + d));
      const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + at + d));
      dot = fmaf(a.x, c.x, fmaf(a.y, c.y, dot));
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) delta_b[qp] = dot;
  }
}

// ---------------------------------------------------------------------------
// (b) dK and dV of one work item: a run of (query tile, query head) steps of
// one key tile, summed over the query heads of its group.
// ---------------------------------------------------------------------------
template <int HD>
struct DkdvSmem {
  static constexpr int G = dkdv_groups<HD>();
  static constexpr int THREADS = G * WG;
  static constexpr int TILE = TILE_ROWS * HD * 2;       // bytes of a k, v, q or do tile
  static constexpr int KS = 0;                          // k
  static constexpr int VS = TILE;                       // v
  static constexpr int RING = 2 * TILE;                 // [2] stages of q, do
  static constexpr int STATS = RING + 4 * TILE;         // [2] stages of lse2, delta [64] floats
  static constexpr int PX = STATS + 2 * 2 * TILE_ROWS * 4;   // p^T from warpgroup 0 to 1: [NS][WG] floats
  static constexpr int BYTES = PX + (G > 1 ? NS * WG * 4 : 0) + Panel<HD>::ATOM;
};

// p^T = exp2(s^T scale2 - lse2) on a thread's fragment of s^T (rows: keys
// k0 + row, columns: queries q0 + col of the step), 0 where the pair is
// not visible; lse2 read per column.  Without `mask` the caller has found
// every pair of the tiles visible.
__device__ __forceinline__ void probs_t(float (&s)[NS], const float* lse_s, int q0, int k0, int s_len,
                                        int window, float scale2, bool mask) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int row = 16 * (static_cast<int>(threadIdx.x) % WG / 32) + lane / 4;
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const int c = 8 * (i / 4) + 2 * (lane % 4);
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
    const int kp = k0 + row + 8 * ((i / 2) % 2);
    float p0 = exp2f(s[i] * scale2 - l2.x);
    float p1 = exp2f(s[i + 1] * scale2 - l2.y);
    if (mask) {
      if (!visible(q0 + c, kp, s_len, window)) p0 = 0.0f;
      if (!visible(q0 + c + 1, kp, s_len, window)) p1 = 0.0f;
    }
    s[i] = p0;
    s[i + 1] = p1;
  }
}

// ds^T = p^T (dp^T - delta) on a thread's fragment, delta read per column;
// p^T is 0 wherever the pair is not visible, and so is ds^T.
__device__ __forceinline__ void grads_t(float (&dp)[NS], const float (&p)[NS], const float* delta_s) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
#pragma unroll
  for (int i = 0; i < NS; i += 2) {
    const float2 d = *reinterpret_cast<const float2*>(delta_s + 8 * (i / 4) + 2 * (lane % 4));
    dp[i] = p[i] * (dp[i] - d.x);
    dp[i + 1] = p[i + 1] * (dp[i + 1] - d.y);
  }
}

template <int HD>
__global__ void __launch_bounds__(DkdvSmem<HD>::THREADS, 1)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
            float* __restrict__ partial, const int* __restrict__ items, int s_len, int h_q,
            int h_kv, float scale, int window) {
  using P = Panel<HD>;
  using M = DkdvSmem<HD>;
  constexpr int R = TILE_ROWS, G = M::G, NP = HD / P::COLS, NF = P::COLS / 2;
  static_assert(M::BYTES <= SMEM_LIMIT, "tc::dkdv_kernel's tiles exceed shared memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = aligned_base<HD>(smem_raw);
  unsigned char* smem = smem_raw + (base - static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)));
  const uint32_t ks = base + M::KS, vs = base + M::VS;

  const int tid = static_cast<int>(threadIdx.x);
  const int wg = tid / WG;   // 0 when G == 1
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
  const float scale2 = scale * LOG2E;

  // Step i of the item: query tile t0 + i / nh of head h0 + i % nh.
  auto load_step = [&](int i, int stage) {
    const int h = hk * group + h0 + i % nh;
    const int q0 = (t0 + i / nh) * R;
    const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
    const size_t stat_off = (static_cast<size_t>(b) * h_q + h) * s_len;
    const uint32_t st = base + M::RING + stage * 2 * M::TILE;
    load_tile<HD, R, M::THREADS>(st, q + q_off, q_stride, q0, s_len);
    load_tile<HD, R, M::THREADS>(st + M::TILE, dout + q_off, q_stride, q0, s_len);
    if (tid < 2 * R) {   // lse2 then delta, zero past S
      const int r = tid % R;
      const bool in = q0 + r < s_len;
      tf32::cp_async4(base + M::STATS + (stage * 2 * R + tid) * 4,
                      (tid < R ? lse : delta) + stat_off + (in ? q0 + r : 0), in);
    }
  };

  load_tile<HD, R, M::THREADS>(ks, k + kv_off, kv_stride, k0, s_len);
  load_tile<HD, R, M::THREADS>(vs, v + kv_off, kv_stride, k0, s_len);
  load_step(0, 0);
  cp_async_commit();

  // G == 1: acc[0] is dV and acc[1] dK; G == 2: acc[0] is warpgroup 0's dV
  // or warpgroup 1's dK.
  float acc[G == 1 ? 2 : 1][NP][NF];
#pragma unroll
  for (int a = 0; a < (G == 1 ? 2 : 1); ++a)
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < NF; ++i) acc[a][p][i] = 0.0f;
  float* px = reinterpret_cast<float*>(smem + M::PX) + tid % WG;   // p^T element i at px[i * WG]

  for (int i = 0; i < steps; ++i) {
    if (i + 1 < steps) load_step(i + 1, (i + 1) & 1);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // k, v and this step's stage have landed, from every thread
    const uint32_t qs = base + M::RING + (i & 1) * 2 * M::TILE;
    const uint32_t dos = qs + M::TILE;
    const float* lse_s = reinterpret_cast<const float*>(smem + M::STATS) + (i & 1) * 2 * R;
    const float* delta_s = lse_s + R;
    const int q0 = (t0 + i / nh) * R;
    const bool mask = !all_visible(q0, R, k0, R, s_len, window);

    float s[NS], dp[NS];
    uint32_t x[R / 16][4];
    if constexpr (G == 1) {
      // s^T = k q^T and dp^T = v do^T, then dV += p^T do, dK += ds^T q.
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = dp[j] = 0.0f;
      wgmma_fence();
      rows_by_rows<HD, R>(s, ks, qs);
      rows_by_rows<HD, R>(dp, vs, dos);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);
      probs_t(s, lse_s, q0, k0, s_len, window, scale2, mask);
      grads_t(dp, s, delta_s);
      uint32_t y[R / 16][4];
      to_a<R>(s, x);
      to_a<R>(dp, y);
      wgmma_fence();
      rows_by_cols<HD, R>(acc[0], x, dos);
      rows_by_cols<HD, R>(acc[1], y, qs);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        fence_regs(acc[0][p]);
        fence_regs(acc[1][p]);
      }
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) {
        fence_regs(x[kk]);
        fence_regs(y[kk]);
      }
    } else if (wg == 0) {
      // s^T = k q^T -> p^T, handed to warpgroup 1; dV += p^T do.
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = 0.0f;
      wgmma_fence();
      rows_by_rows<HD, R>(s, ks, qs);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      probs_t(s, lse_s, q0, k0, s_len, window, scale2, mask);
#pragma unroll
      for (int j = 0; j < NS; ++j) px[j * WG] = s[j];
      asm volatile("bar.arrive 1, %0;\n" :: "n"(2 * WG) : "memory");
      to_a<R>(s, x);
      wgmma_fence();
      rows_by_cols<HD, R>(acc[0], x, dos);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[0][p]);
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) fence_regs(x[kk]);
    } else {
      // dp^T = v do^T; with warpgroup 0's p^T, ds^T; dK += ds^T q.
#pragma unroll
      for (int j = 0; j < NS; ++j) dp[j] = 0.0f;
      wgmma_fence();
      rows_by_rows<HD, R>(dp, vs, dos);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dp);
      asm volatile("bar.sync 1, %0;\n" :: "n"(2 * WG) : "memory");
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j] = px[j * WG];
      grads_t(dp, s, delta_s);
      to_a<R>(dp, x);
      wgmma_fence();
      rows_by_cols<HD, R>(acc[0], x, qs);
      wgmma_commit();
      wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[0][p]);
#pragma unroll
      for (int kk = 0; kk < R / 16; ++kk) fence_regs(x[kk]);
    }
    __syncthreads();   // this stage and p^T are consumed
  }

  // dK is stored times scale; a cut key tile's items write float32
  // partials [slot][dk, dv][64][HD] for dkdv_reduce_kernel.
  float* part = slot >= 0 ? partial + static_cast<size_t>(slot) * 2 * R * HD : nullptr;
  const bool is_dk = G == 2 && wg == 1;
  store_rows<HD>(acc[0], is_dk ? scale : 1.0f, is_dk ? dk + kv_off : dv + kv_off, kv_stride, k0, s_len,
                 part == nullptr ? nullptr : part + (is_dk ? 0 : R * HD));
  if constexpr (G == 1)
    store_rows<HD>(acc[1], scale, dk + kv_off, kv_stride, k0, s_len, part);
}

// ---------------------------------------------------------------------------
// (d) dQ of one query tile of one head.
// ---------------------------------------------------------------------------
template <int HD>
struct DqSmem {
  static constexpr int BK = dq_keys<HD>();
  static constexpr int Q = TILE_ROWS * HD * 2;
  static constexpr int KV = BK * HD * 2;
  static constexpr int RING = 2 * Q;                               // after q, do
  static constexpr int BYTES = RING + 4 * KV + Panel<HD>::ATOM;    // [2] stages of k, v; + slack
};

template <int HD>
__global__ void __launch_bounds__(WG, 1)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, bf16* __restrict__ dq, int s_len, int h_q,
          int h_kv, float scale, int window) {
  using P = Panel<HD>;
  using M = DqSmem<HD>;
  constexpr int BM = TILE_ROWS, BK = M::BK, NP = HD / P::COLS, NF = P::COLS / 2;
  static_assert(M::BYTES <= SMEM_LIMIT, "tc::dq_kernel's tiles exceed shared memory");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = aligned_base<HD>(smem_raw);
  const uint32_t do_s = q_s + M::Q;
  const uint32_t ring = q_s + M::RING;   // stage st: k at ring + 2 st KV, v at + KV

  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(blockIdx.x)) * BM;  // heaviest first
  const int b = blockIdx.y / h_q;
  const int h = blockIdx.y % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const size_t q_off = static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const size_t kv_off = static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;

  const int k_end = min(q0 + BM, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  auto load_kv = [&](int t) {
    const uint32_t st = ring + (t & 1) * 2 * M::KV;
    load_tile<HD, BK, WG>(st, k + kv_off, kv_stride, k_begin + t * BK, s_len);
    load_tile<HD, BK, WG>(st + M::KV, v + kv_off, kv_stride, k_begin + t * BK, s_len);
  };

  load_tile<HD, BM, WG>(q_s, q + q_off, q_stride, q0, s_len);
  load_tile<HD, BM, WG>(do_s, dout + q_off, q_stride, q0, s_len);
  load_kv(0);
  cp_async_commit();

  // This thread's rows qp0 and qp0 + 8, their lse2 and delta (0 past S).
  const int qp0 = q0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const float* lse_b = lse + static_cast<size_t>(blockIdx.y) * s_len;
  const float* delta_b = delta + static_cast<size_t>(blockIdx.y) * s_len;
  float lr[2], dr[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const bool in = qp0 + 8 * e < s_len;
    lr[e] = in ? lse_b[qp0 + 8 * e] : 0.0f;
    dr[e] = in ? delta_b[qp0 + 8 * e] : 0.0f;
  }
  const float scale2 = scale * LOG2E;

  float acc[NP][NF];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int i = 0; i < NF; ++i) acc[p][i] = 0.0f;
  float s[BK / 2], dp[BK / 2];
  uint32_t x[BK / 16][4];
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    if (t + 1 < n_tiles) load_kv(t + 1);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();   // q, do and this tile's k, v have landed, from every thread
    const uint32_t ks = ring + (t & 1) * 2 * M::KV;

    // s = q k^T and dp = do v^T; ds = p (dp - delta), p = exp2(s scale2 - lse2).
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) s[j] = dp[j] = 0.0f;
    wgmma_fence();
    rows_by_rows<HD, BK>(s, q_s, ks);
    rows_by_rows<HD, BK>(dp, do_s, ks + M::KV);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);
    const bool mask = !all_visible(q0, BM, k0, BK, s_len, window);
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int e = (j / 2) % 2;
      float p = exp2f(s[j] * scale2 - lr[e]);
      if (mask && !visible(qp0 + 8 * e, k0 + 8 * (j / 4) + col + j % 2, s_len, window)) p = 0.0f;
      dp[j] = p * (dp[j] - dr[e]);
    }

    // dq += ds k: k read MN-major, the tile's keys the reduction.
    to_a<BK>(dp, x);
    wgmma_fence();
    rows_by_cols<HD, BK>(acc, x, ks);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(x[kk]);
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  store_rows<HD>(acc, scale, dq + q_off, q_stride, q0, s_len, nullptr);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
           void* dq, void* dk, void* dv, float* lse, float* delta, const Work& w, int b, int s, int h,
           int kv, float scale, int window, cudaStream_t stream) {
  using Ds = DkdvSmem<HD>;
  static unsigned configured_stats = 0, configured_dkdv = 0, configured_dq = 0;
  const auto* qt = static_cast<const bf16*>(q);
  const auto* kt = static_cast<const bf16*>(k);
  const auto* vt = static_cast<const bf16*>(v);
  const auto* dot = static_cast<const bf16*>(dout);
  const int q_tiles = (s + TILE_ROWS - 1) / TILE_ROWS;

  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(stats_kernel<HD>), StatsSmem<HD>::BYTES,
                                       configured_stats);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_kernel<HD><<<dim3(q_tiles, b * h), WG, StatsSmem<HD>::BYTES, stream>>>(
      qt, kt, static_cast<const bf16*>(o), dot, lse, delta, s, h, kv, scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dkdv_kernel<HD>), Ds::BYTES, configured_dkdv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<HD><<<w.n_items, Ds::THREADS, Ds::BYTES, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dk), static_cast<bf16*>(dv), w.partial, w.items, s, h, kv,
      scale, window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  if (w.n_splits > 0) {
    // A cut tile's 2 x 64 x HD sums over REDUCE_SPAN blocks, 8 a thread:
    // one block a tile, as the split-TF32 route launches it, leaves most of
    // the card idle at hd 256, where a few dozen tiles are cut.
    constexpr int REDUCE_SPAN = 2 * TILE_ROWS * HD / (8 * THREADS);
    dkdv_reduce_kernel<bf16, HD, TILE_ROWS><<<dim3(w.n_splits, REDUCE_SPAN), THREADS, 0, stream>>>(


        w.partial, w.splits, static_cast<bf16*>(dk), static_cast<bf16*>(dv), s, kv, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = allow_dynamic_smem(reinterpret_cast<const void*>(dq_kernel<HD>), DqSmem<HD>::BYTES, configured_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<HD><<<dim3(q_tiles, b * h), WG, DqSmem<HD>::BYTES, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<bf16*>(dq), s, h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int smem_of(int kernel) {
  switch (kernel) {
    case 0: return StatsSmem<HD>::BYTES;
    case 1: return DkdvSmem<HD>::BYTES;
    case 2: return DqSmem<HD>::BYTES;
    default: return -1;
  }
}

}  // namespace tc

}  // namespace

// dq (b, s, h, hd), dk and dv (b, s, kv, hd) = the gradient of causal
// attention out = attention(q, k, v) (flash_attention.cu's function, same
// scale and window) given out and its gradient dout (b, s, h, hd).  All
// tensors contiguous and 16-byte-aligned, kv dividing h, hd 16, 32, 64, 96,
// 128 or 256; is_bf16 picks bfloat16 (1) or float32 (0) for every tensor.
// bfloat16 at hd 64, 96, 128 and 256 takes the wgmma kernels (tc::),
// everything else the split-TF32 ones.  lse and delta are float32 scratch
// of b * h * s elements each.  `items` (n_items rows of 7 ints) and
// `splits` (n_splits rows of 4) are the dK/dV work list and its cut key
// tiles (kernels/flash_attention.py::dkdv_work, dkdv_splits, at the route's
// tile rows) in device memory; `partial` holds 2 * rows * hd floats per
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
  if (is_bf16) {
    switch (hd) {
      case 16: return launch<bf16, 16>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      case 32: return launch<bf16, 32>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      case 64: return tc::launch<64>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      case 96: return tc::launch<96>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      case 128: return tc::launch<128>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      case 256: return tc::launch<256>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 16: return launch<float, 16>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    case 32: return launch<float, 32>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    case 64: return launch<float, 64>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    case 96: return launch<float, 96>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    case 128: return launch<float, 128>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    case 256: return launch<float, 256>(q, k, v, o, dout, dq, dk, dv, l, d, w, b, s, h, kv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of one kernel that a call at head_dim hd
// and type is_bf16 launches: kernel 0 stats, 1 dK/dV, 2 dQ (the reduction
// takes none); -1 for another hd or kernel.
extern "C" int flash_attention_bwd_smem(int hd, int is_bf16, int kernel) {
  if (is_bf16) {
    switch (hd) {
      case 16: return smem_of<bf16, 16>(kernel);
      case 32: return smem_of<bf16, 32>(kernel);
      case 64: return tc::smem_of<64>(kernel);
      case 96: return tc::smem_of<96>(kernel);
      case 128: return tc::smem_of<128>(kernel);
      case 256: return tc::smem_of<256>(kernel);
      default: return -1;
    }
  }
  switch (hd) {
    case 16: return smem_of<float, 16>(kernel);
    case 32: return smem_of<float, 32>(kernel);
    case 64: return smem_of<float, 64>(kernel);
    case 96: return smem_of<float, 96>(kernel);
    case 128: return smem_of<float, 128>(kernel);
    case 256: return smem_of<float, 256>(kernel);
    default: return -1;
  }
}
