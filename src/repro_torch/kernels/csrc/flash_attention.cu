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
// contiguous and 16-byte-aligned (both kernels copy 16-byte chunks with
// cp.async): the natural layout of the model, so no transposed or
// head-repeated copies are made.  A block reads KV head h / G directly.
//
// Two kernels, both on the tensor cores, fixed by type and head size
// (kernels/flash_attention.py::route mirrors this dispatch; neither gives
// way to the other at run time):
//
//   bfloat16, hd in {64, 96, 128, 256} -> wgmma kernel (tc::flash_kernel)
//   every float32 shape; bfloat16, hd in {16, 32}
//                                      -> split-TF32 mma.sync kernel
//                                         (mma::flash_kernel)
//
// hd 16 and 32 occur in tests only.  hd 96 (phi-3-vision: 3072 / 32 heads)
// is not a multiple of the 64-column, 128-byte-swizzle panels the other
// wgmma head dims use; it takes 32-column, 64-byte-swizzle panels instead
// (Panel, in wgmma.cuh), so q, k and v are read as they are, never padded
// to 128.
//
// What bounds it.  On the serving path (gemma3-1b: B = 2, S = 2048, H = 4,
// KV = 1, hd = 256, bfloat16) one global layer needs about 17 GFLOP of
// unmasked work and moves about 10 MB, so it is bound by operations: the
// tensor cores' 989 TFLOP/s in bfloat16.  The float32 train path's calls
// (qwen1.5-0.5b: (2, 2048, 16, 16, 64); gemma3-1b's) need as much work at
// float32 accuracy, which the tensor cores give as split TF32 at a third
// of TF32's 495 TFLOP/s (165), where the CUDA cores' float32 FMAs peak at
// 67; on mma.sync the H100 runs TF32 at about 210-250 TFLOP/s (PERF.md,
// tools/flash_fwd_variants.py), split TF32 at 70-85, so mma.sync's
// instruction rate, not the 165, is this kernel's ceiling.
//
// Both kernels share the block structure.  The TPU kernel carries
// (m, l, acc) across a sequential KV grid axis in VMEM.  Here blocks run in
// parallel and in no order, so one block owns one (batch*head, 64-query
// tile) and walks the KV tiles in a loop of its own.  Query tiles are issued
// heaviest first across every (batch, head) (the last tile of a causal row
// sees the most keys).  KV tiles that lie wholly outside the causal window
// of the query tile are skipped: the masked scores they would add carry
// weight exp(NEG_INF - m) = 0 once any real score is seen, and the diagonal
// tile, always processed, holds one for every row, so the function is
// unchanged.  A row whose first processed tile is all masked gets
// m = NEG_INF and p = exp(0) = 1 there; the correction exp(m_prev - m_new)
// = 0 wipes that when a real score arrives.  NEG_INF is finite (-1e30), as
// in the reference: -inf would make exp(-inf - -inf) NaN.  l is guarded by
// max(l, 1e-30) before the division.  Ragged S is masked inside the kernel
// and rows past S are not stored.  Both run the softmax in base 2 (scores
// times scale * log2 e, then exp2) on the score fragment in registers:
// thread t of a warp holds rows t / 4 and + 8 of the warp's 16, columns
// 8 j + 2 (t % 4) and + 1; row maxima take two __shfl_xor_sync steps within
// the quad of threads that share a row, and l is a per-thread partial sum,
// reduced across the quad once at the end.
//
// The split-TF32 kernel (mma::flash_kernel) keeps float32 accuracy on the
// tensor cores, where the CUDA-core kernel it replaced fed every FMA with
// shared-memory loads and took the scores through shared memory:
//  - Products: S = q k^T and O += P v on mma.sync.m16n8k8 TF32 (tf32.cuh).
//    A float32 operand is split into a high and a low TF32 part and a
//    product takes lo*hi + hi*lo + hi*hi; a bfloat16 operand, and p rounded
//    to bfloat16, are exact, so bfloat16 takes one mma a product.
//  - Accumulation: the tensor core cuts the low bits of each sum it forms,
//    so q k^T adds its accumulators into a float32 sum every CHAIN k8 steps
//    over d, and each KV tile's P v goes into zeroed accumulators, folded
//    into O on the CUDA cores as O = O * corr + PV: O's running sum never
//    lives in the tensor core across tiles.
//  - Fragments: four warps own 16 query rows each, with every key of the
//    tile and all of d, so that the softmax needs no exchange between warps.
//    At hd 256 that would be 128 registers a thread for O alone, and the
//    kernel spilled: there eight warps take the 64 rows, the two of a row
//    group half of d each (mma::d_split); they add each other's partial
//    scores through shared memory behind a barrier of their own, so both
//    hold the same sum and run the same softmax, and each keeps half of O.
//    Where a warp's d is 64 or less, q's fragments are split once and held
//    in registers for the whole KV walk; above, they are read from shared
//    memory and split per k8 step.  P's A fragment is the score accumulator itself: inside each
//    k8 step of P v, k index t4 stands for key 2 t4 and t4 + 4 for 2 t4 + 1,
//    on P's side and on v's alike, so accumulator columns (2 t4, 2 t4 + 1)
//    are A's (t4, t4 + 4) without shuffles.  Staged rows are padded by 16
//    bytes, so that the [row g][col t4] reads of q and k and the
//    [2 t4][g] reads of v are free of bank conflicts.
//  - Staging: q once, then a two-stage cp.async ring of (k, v) tiles, the
//    next tile loading while the current one computes; rows past S are
//    zero-filled by the copy.  A tile whose keys every row of the warp sees
//    takes a softmax without the per-element mask test.
//  - Tiles: 64 query rows; 64 keys up to hd 64 and 32 above (mma::kv_tile),
//    so that no instantiation spills and shared memory stays within
//    227 KB: float32 25,600 / 46,080 / 87,040 bytes at hd 16 / 32 / 64,
//    76,800 / 101,376 / 216,064 at hd 96 / 128 / 256; bfloat16 15,360 /
//    25,600 at hd 16 / 32 (mma::Smem; flash_attention_smem reports them).
//    O takes a warp's d / 2 registers a thread, so P v passes over d in
//    groups of n8 tiles.
//
// The wgmma kernel runs both products on Hopper's tensor cores with wgmma
// (sm_90a).  One warpgroup (128 threads) owns 64 query rows.
//  - Shared memory holds the q tile once and a two-stage ring of (k, v)
//    tiles of 64 keys (32 at hd 256, see kv_tile), loaded with 16-byte
//    cp.async copies (rows past S zero-filled) while the previous tile is
//    computed.  Every tile is stored in one of wgmma's canonical swizzled
//    layouts, chosen by hd (Panel, in wgmma.cuh).  At hd 64, 128 and 256:
//    64-column (128-byte) panels of 8-row, 1024-byte atoms, the 16-byte chunk c of row
//    r at chunk c ^ (r % 8), from a 1024-byte-aligned base (128-byte
//    swizzle).  At hd 96: three 32-column (64-byte) panels of 8-row,
//    512-byte atoms, chunk c of row r at c ^ ((r >> 1) % 4), from a
//    512-byte-aligned base (64-byte swizzle).  At hd 256 that is 32 KB +
//    2 x (16 + 16) KB = 96 KB, two blocks per SM; at hd 128, 80 KB; at hd
//    96, 60 KB.
//  - S = q k^T is wgmma m64n64k16 (m64n32k16 at hd 256) with both operands
//    in shared memory over hd / 16 steps; k stored [key][d] is already
//    K-major, so no transpose.
//  - The online softmax works on the accumulator fragment itself (above);
//    m stays in registers.
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

#include "tf32.cuh"
#include "wgmma.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int SMEM_LIMIT = 232448;   // dynamic shared memory a block may use on sm_90

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

// cp.async copies 16-byte chunks: rows are hd * sizeof(T) bytes apart, so
// the bases must be 16-byte aligned (the wrapper checks this too).
bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  return true;
}

// ---------------------------------------------------------------------------
// Split-TF32 route: every float32 shape, bfloat16 at hd 16 and 32.  See the
// note at the top.
// ---------------------------------------------------------------------------
namespace mma {

using bf16 = __nv_bfloat16;
using tf32::divisor_upto;
using tf32::exact_tf32;
using tf32::ld;
using tf32::to_tf32;

constexpr int BQ = 64;         // query rows per block: four row groups of 16
constexpr float LOG2E = 1.4426950408889634f;
// k8 steps of q k^T that run on one tensor-core accumulator before it is
// added, in float32, to the score sum: the tensor core cuts the low bits of
// each sum it forms, and a short chain keeps that cut small against the sum.
constexpr int CHAIN = 4;

// Keys per KV tile: 64 up to hd 64; 32 above, where the output fragment
// (hd / 2 registers a thread) and the staged rows grow.
template <int HD>
__host__ __device__ constexpr int kv_tile() { return HD <= 64 ? 64 : 32; }

// Warps that share a row group's d: 2 at hd 256, each with half of O's
// columns (64 registers a thread, not 128, which spill).
template <int HD>
__host__ __device__ constexpr int d_split() { return HD >= 256 ? 2 : 1; }

// Shared memory: the q tile, two stages of (k, v) tiles, each a [rows][SA]
// array of T with rows padded by 16 bytes, and, where warps split d, each
// warp's partial scores, [warp][element of the fragment][lane] floats.
template <typename T, int HD>
struct Smem {
  static constexpr int BK = kv_tile<HD>();
  static constexpr int WD = d_split<HD>();
  static constexpr int THREADS = 128 * WD;
  static constexpr int SA = HD + 16 / static_cast<int>(sizeof(T));   // elements between rows
  static constexpr int Q = BQ * SA * static_cast<int>(sizeof(T));   // bytes of the q tile
  static constexpr int KV = BK * SA * static_cast<int>(sizeof(T));  // bytes of a k or a v tile
  static constexpr int STAGE = 2 * KV;                                // k then v
  static constexpr int RING = Q;
  static constexpr int XS = RING + 2 * STAGE;                         // partial scores
  static constexpr int BYTES = XS + (WD > 1 ? THREADS * BK / 2 * 4 : 0);
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// c += a b on TF32 operands, all into c: lo*hi and hi*lo where a side is
// split (AX, BX: whether a, b are exact), then hi*hi.
template <bool AX, bool BX>
__device__ __forceinline__ void mma_x(float (&c)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                      uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  if constexpr (!AX) tf32::mma(c, al, bh0, bh1);
  if constexpr (!BX) tf32::mma(c, ah, bl0, bl1);
  tf32::mma(c, ah, bh0, bh1);
}

// Rows [row0, row0 + ROWS) of a (B, S, heads, HD) tensor at one (b, head),
// `src` pointing at (b, 0, head, 0) and `stride` elements between
// positions, copied into a [ROWS][SA] tile at shared address `dst`; rows
// past S are zero-filled (the source address then points at row 0).
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, size_t stride, int row0, int s_len) {
  constexpr int SA = Smem<T, HD>::SA;
  constexpr int PER = 16 / static_cast<int>(sizeof(T));   // elements per 16-byte chunk
  constexpr int CH = HD / PER;
  for (int idx = static_cast<int>(threadIdx.x); idx < ROWS * CH; idx += Smem<T, HD>::THREADS) {
    const int r = idx / CH;
    const int c = idx % CH;
    const bool in = row0 + r < s_len;
    tf32::cp_async16(dst + static_cast<uint32_t>((r * SA + c * PER) * sizeof(T)),
                     src + static_cast<size_t>(in ? row0 + r : 0) * stride + c * PER, in);
  }
}

// q's A fragment for k8 step kk: a = q[g][8 kk + t4], q[g + 8][..],
// q[g][8 kk + t4 + 4], q[g + 8][..] of the warp's rows, `qr` pointing at
// q[g][t4] in the staged tile.
template <typename T, int SA>
__device__ __forceinline__ void q_fragment(const T* qr, int kk, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  constexpr bool X = exact_tf32<T>();
  to_tf32<X>(ld(qr + 8 * kk), hi[0], lo[0]);
  to_tf32<X>(ld(qr + 8 * SA + 8 * kk), hi[1], lo[1]);
  to_tf32<X>(ld(qr + 8 * kk + 4), hi[2], lo[2]);
  to_tf32<X>(ld(qr + 8 * SA + 8 * kk + 4), hi[3], lo[3]);
}

// One KV tile's online softmax on this thread's score fragment `sc`
// (rows qp, qp + 8; keys kp + 8 j and + 1): scales to base 2, masks (causal,
// window, keys past S) unless the caller found every pair visible, and
// turns the scores into p = exp2(s - m_new), updating m and this thread's
// partial l; corr[r] = exp2(m_prev - m_new) is the factor on O's row r.
template <bool MASK, int NK>
__device__ __forceinline__ void online_softmax(float (&sc)[NK][4], float (&m)[2], float (&l)[2],
                                               float (&corr)[2], int qp, int kp, int s_len, int window,
                                               float scale2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qp + 8 * r;
    float mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int key = kp + 8 * j + c;
        float x = sc[j][2 * r + c] * scale2;
        if (MASK && !(key <= row && key < s_len && (window <= 0 || row - key < window))) x = NEG_INF;
        sc[j][2 * r + c] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx);
    corr[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = exp2f(sc[j][2 * r + c] - m_new);
        sc[j][2 * r + c] = p;
        sum += p;
      }
    l[r] = l[r] * corr[r] + sum;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(Smem<T, HD>::THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int s_len, int h_q, int h_kv, float scale, int window) {
  using M = Smem<T, HD>;
  constexpr int BK = M::BK, SA = M::SA, WD = M::WD;
  constexpr int NK = BK / 8;          // n8 tiles of the scores; k8 steps of P v
  constexpr int ND = HD / WD / 8;     // a warp's k8 steps of q k^T; its n8 tiles of the output
  constexpr int STEPS = divisor_upto(ND, CHAIN);
  // Output n8 tiles per pass of P v: independent accumulators, as many as
  // the registers left beside O allow.
  constexpr int GD = divisor_upto(ND, 8);
  constexpr bool X = exact_tf32<T>();
  constexpr bool Q_REGS = HD / WD <= 64;
  static_assert(M::BYTES <= SMEM_LIMIT, "mma::flash_kernel's tiles exceed shared memory");
  static_assert(ND % STEPS == 0 && ND % GD == 0, "whole chains and passes");
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int rg = WD > 1 ? warp % 4 : warp;                // the warp's row group
  const int d_off = WD > 1 ? (warp / 4) * (HD / WD) : 0;  // and its first column of d

  // Block i takes query tile n_qt - 1 - i / (B * H) of (batch, head)
  // i % (B * H): every (batch, head)'s heaviest tile first.
  const int n_qt = (s_len + BQ - 1) / BQ;
  const int n_bh = static_cast<int>(gridDim.x) / n_qt;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_bh) * BQ;
  const int bh = static_cast<int>(blockIdx.x) % n_bh;
  const int b = bh / h_q;
  const int h = bh % h_q;
  const int hk = h / (h_q / h_kv);
  const size_t q_stride = static_cast<size_t>(h_q) * HD;    // between tokens
  const size_t kv_stride = static_cast<size_t>(h_kv) * HD;
  const T* qb = q + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;
  const T* kb = k + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  const T* vb = v + static_cast<size_t>(b) * s_len * kv_stride + static_cast<size_t>(hk) * HD;
  T* ob = o + static_cast<size_t>(b) * s_len * q_stride + static_cast<size_t>(h) * HD;

  // Keys [k_begin, k_end) hold every unmasked score of this query tile.
  const int k_end = min(q0 + BQ, s_len);
  const int k_begin = window > 0 ? (max(0, q0 - window + 1) / BK) * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  load_rows<T, HD, BQ>(base, qb, q_stride, q0, s_len);
  load_rows<T, HD, BK>(base + M::RING, kb, kv_stride, k_begin, s_len);
  load_rows<T, HD, BK>(base + M::RING + M::KV, vb, kv_stride, k_begin, s_len);
  tf32::cp_async_commit();

  const int w0 = q0 + 16 * rg;   // the warp's first query
  const int qp = w0 + g;         // this thread's rows: qp and qp + 8
  const T* qr = reinterpret_cast<const T*>(smem) + (16 * rg + g) * SA + d_off + t4;
  uint32_t qh[Q_REGS ? ND : 1][4], ql[Q_REGS ? ND : 1][4];
  if constexpr (Q_REGS) {
    tf32::cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) q_fragment<T, SA>(qr, kk, qh[kk], ql[kk]);
  }

  float out[ND][4];   // O, unnormalised: rows g, g + 8 of the warp, columns d_off + 8 i + 2 t4, + 1
#pragma unroll
  for (int i = 0; i < ND; ++i) out[i][0] = out[i][1] = out[i][2] = out[i][3] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF};   // running max of the rows (base 2)
  float l[2] = {0.0f, 0.0f};         // this thread's part of their sums
  const float scale2 = scale * LOG2E;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = k_begin + t * BK;
    if (t + 1 < n_tiles) {   // the next tile into the other stage
      const uint32_t next = base + M::RING + ((t + 1) & 1) * M::STAGE;
      load_rows<T, HD, BK>(next, kb, kv_stride, k0 + BK, s_len);
      load_rows<T, HD, BK>(next + M::KV, vb, kv_stride, k0 + BK, s_len);
    }
    tf32::cp_async_commit();   // empty on the last tile, so that one group stays behind
    tf32::cp_async_wait<1>();
    __syncthreads();           // this tile's k, v have landed, from every thread
    const T* ks = reinterpret_cast<const T*>(smem + M::RING + (t & 1) * M::STAGE);
    const T* vs = ks + BK * SA;

    // S = q k^T: NK n8 tiles of keys over the warp's ND k8 steps of d,
    // STEPS at a time on the tensor core, then into the float32 sum.
    // b = k[8 j + g][d_off + 8 kk + t4], k[8 j + g][d_off + 8 kk + t4 + 4].
    float sc[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.0f;
    const T* kr = ks + g * SA + d_off + t4;
    // q's fragments in registers need compile-time indices, so the chunks
    // unroll; streamed from shared memory they run one at a time, which
    // keeps the loads of later chunks from piling up in registers beside O.
#pragma unroll (Q_REGS ? ND / STEPS : 1)
    for (int d0 = 0; d0 < ND; d0 += STEPS) {
      float c[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
#pragma unroll
      for (int s = 0; s < STEPS; ++s) {
        const int kk = d0 + s;
        uint32_t ah[4], al[4];
        if constexpr (Q_REGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[e] = qh[kk][e];
            al[e] = ql[kk][e];
          }
        } else {
          q_fragment<T, SA>(qr, kk, ah, al);
        }
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          uint32_t bh0, bl0, bh1, bl1;
          to_tf32<X>(ld(kr + 8 * j * SA + 8 * kk), bh0, bl0);
          to_tf32<X>(ld(kr + 8 * j * SA + 8 * kk + 4), bh1, bl1);
          mma_x<X, X>(c[j], ah, al, bh0, bh1, bl0, bl1);
        }
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += c[j][e];
    }
    if constexpr (WD > 1) {
      // The two warps of a row group add each other's partial scores: the
      // same float32 sum in both, so both run the same softmax.
      float* xs = reinterpret_cast<float*>(smem + M::XS);
      float* mine = xs + warp * 32 * 4 * NK + lane;
      const float* other = xs + (warp ^ 4) * 32 * 4 * NK + lane;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 * j + e) * 32] = sc[j][e];
      asm volatile("bar.sync %0, 64;\n" :: "r"(1 + rg) : "memory");   // the row group's two warps
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += other[(4 * j + e) * 32];
    }

    float corr[2];
    if (k0 + BK - 1 <= w0 && k0 + BK <= s_len && (window <= 0 || w0 + 15 - k0 < window))
      online_softmax<false, NK>(sc, m, l, corr, qp, k0 + 2 * t4, s_len, window, scale2);
    else
      online_softmax<true, NK>(sc, m, l, corr, qp, k0 + 2 * t4, s_len, window, scale2);

    // P as the A fragment of k8 step j of P v: k index t4 is key 8 j + 2 t4
    // and t4 + 4 is key 8 j + 2 t4 + 1, so a = (sc[j][0], sc[j][2],
    // sc[j][1], sc[j][3]).  For bfloat16, p is rounded to v's type first.
    uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float pa[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (X)
          to_tf32<X>(__bfloat162float(__float2bfloat16(pa[e])), ph[j][e], pl[j][e]);
        else
          to_tf32<X>(pa[e], ph[j][e], pl[j][e]);
      }
    }

    // O = O * corr + P v, GD output n8 tiles a pass, each on zeroed
    // accumulators over the tile's NK k8 steps.
    // b = v[8 j + 2 t4][d_off + 8 i + g], v[8 j + 2 t4 + 1][d_off + 8 i + g].
    const T* vr = vs + 2 * t4 * SA + d_off + g;
#pragma unroll
    for (int i0 = 0; i0 < ND; i0 += GD) {
      float acc[GD][4];
#pragma unroll
      for (int i = 0; i < GD; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int i = 0; i < GD; ++i) {
          uint32_t bh0, bl0, bh1, bl1;
          to_tf32<X>(ld(vr + 8 * j * SA + 8 * (i0 + i)), bh0, bl0);
          to_tf32<X>(ld(vr + (8 * j + 1) * SA + 8 * (i0 + i)), bh1, bl1);
          mma_x<X, X>(acc[i], ph[j], pl[j], bh0, bh1, bl0, bl1);
        }
#pragma unroll
      for (int i = 0; i < GD; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[i0 + i][e] = out[i0 + i][e] * corr[e / 2] + acc[i][e];
    }
    __syncthreads();   // every warp is done with this stage (and the scores) before they are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv0 = 1.0f / fmaxf(l[0], 1e-30f);
  const float inv1 = 1.0f / fmaxf(l[1], 1e-30f);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    const int c = d_off + 8 * i + 2 * t4;
    if (qp < s_len) store2(ob + static_cast<size_t>(qp) * q_stride + c, out[i][0] * inv0, out[i][1] * inv0);
    if (qp + 8 < s_len)
      store2(ob + static_cast<size_t>(qp + 8) * q_stride + c, out[i][2] * inv1, out[i][3] * inv1);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int h, int kv,
           float scale, int window, cudaStream_t stream) {
  if (!aligned16({q, k, v, o})) return static_cast<int>(cudaErrorMisalignedAddress);
  const long long blocks = static_cast<long long>((s + BQ - 1) / BQ) * b * h;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = Smem<T, HD>::BYTES;
  static unsigned configured = 0;
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(flash_kernel<T, HD>), smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_kernel<T, HD><<<static_cast<unsigned>(blocks), Smem<T, HD>::THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), static_cast<T*>(o), s,
      h, kv, scale, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mma

// ---------------------------------------------------------------------------
// wgmma route: bfloat16, hd in {64, 96, 128, 256}.  See the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

using namespace wgmma;   // Panel, load_tile, smem_desc and the wgmma instructions

constexpr int THREADS = 128;   // one warpgroup
constexpr int BQ = 64;         // query rows per block: wgmma's M
constexpr float LOG2E = 1.4426950408889634f;

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
  if (!aligned16({q, k, v, o})) return static_cast<int>(cudaErrorMisalignedAddress);
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
// (b, s, kv, hd), all contiguous and 16-byte-aligned, with kv dividing h;
// window > 0 keeps only the last `window` keys of each query.  hd is 16, 32,
// 64, 96, 128 or 256; is_bf16 picks bfloat16 (1) or float32 (0) for every
// tensor.  bfloat16 at hd 64, 96, 128 and 256 takes the wgmma kernel;
// everything else the split-TF32 mma.sync kernel.  Launches on `stream`
// without synchronising and returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int s, int h, int kv, int hd,
                               float scale, int window, int is_bf16,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (hd) {
      case 16: return mma::launch<__nv_bfloat16, 16>(q, k, v, o, b, s, h, kv, scale, window, st);
      case 32: return mma::launch<__nv_bfloat16, 32>(q, k, v, o, b, s, h, kv, scale, window, st);
      case 64: return tc::launch<64>(q, k, v, o, b, s, h, kv, scale, window, st);
      case 96: return tc::launch<96>(q, k, v, o, b, s, h, kv, scale, window, st);
      case 128: return tc::launch<128>(q, k, v, o, b, s, h, kv, scale, window, st);
      case 256: return tc::launch<256>(q, k, v, o, b, s, h, kv, scale, window, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (hd) {
    case 16: return mma::launch<float, 16>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 32: return mma::launch<float, 32>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 64: return mma::launch<float, 64>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 96: return mma::launch<float, 96>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 128: return mma::launch<float, 128>(q, k, v, o, b, s, h, kv, scale, window, st);
    case 256: return mma::launch<float, 256>(q, k, v, o, b, s, h, kv, scale, window, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory (bytes) of the kernel that a call at head_dim hd
// and type is_bf16 launches; -1 for another hd.
extern "C" int flash_attention_smem(int hd, int is_bf16) {
  if (is_bf16) {
    switch (hd) {
      case 16: return mma::Smem<__nv_bfloat16, 16>::BYTES;
      case 32: return mma::Smem<__nv_bfloat16, 32>::BYTES;
      case 64: return static_cast<int>(tc::Smem<64>::BYTES);
      case 96: return static_cast<int>(tc::Smem<96>::BYTES);
      case 128: return static_cast<int>(tc::Smem<128>::BYTES);
      case 256: return static_cast<int>(tc::Smem<256>::BYTES);
      default: return -1;
    }
  }
  switch (hd) {
    case 16: return mma::Smem<float, 16>::BYTES;
    case 32: return mma::Smem<float, 32>::BYTES;
    case 64: return mma::Smem<float, 64>::BYTES;
    case 96: return mma::Smem<float, 96>::BYTES;
    case 128: return mma::Smem<float, 128>::BYTES;
    case 256: return mma::Smem<float, 256>::BYTES;
    default: return -1;
  }
}
