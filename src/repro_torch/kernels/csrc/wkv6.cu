// RWKV6 WKV recurrence for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel kernels/wkv6.py::_wkv6_kernel (and its entry
// wkv6_chunked, with the wrapper kernels/ops.py::wkv6) of the JAX package.
// What it computes is that function, per batch b and head h, with the state
// S (hd x hd, float32) starting from `state0` (zero when it is null):
//
//   out_t = r_t^T (S + diag(u) k_t v_t^T)
//   S     = diag(w_t) S + k_t v_t^T
//
// and, unlike the TPU kernel, it also writes the final S: the model's
// prefill keeps it as the decode cache (the reference takes it from
// models/rwkv.py::wkv_scan).  Inputs are (B, T, H, hd), contiguous; r, k, v
// share float32 or bfloat16, w is float32 or bfloat16, u is (H, hd)
// float32; out is (B, T, H, hd) float32 and the state (B, H, hd, hd)
// float32, S[i][j] with i over k and j over v.  w = 0 and w -> 1 are legal.
//
// Two routes, fixed by head size (kernels/wkv6.py::route mirrors this
// dispatch; neither gives way to the other at run time):
//
//   hd 64, r, k, v float32 or bfloat16
//                                -> chunk kernel (tc::chunk_kernel), a chunk
//                                   of 64 tokens at a time, its products on
//                                   the tensor cores
//   hd 8, 16, 32                 -> token kernel (wkv6_kernel), the exact
//                                   recurrence one token at a time on the
//                                   CUDA cores (the reduced models' sizes)
//
// What bounds it.  On the serving path (rwkv6-7b: B = 2, T = 2048, H = 64,
// hd = 64, r, k, v bfloat16, w float32) a call reads r, k, v, w and the
// state and writes out and the final state: 0.0714 ms at 3.35 TB/s, as
// chip_smoke.py's wkv_bound reckons it.  Its 5 hd^2 operations per token
// and head take 0.0054 ms at the bfloat16 tensor-core rate, so the bound is
// the bytes.  On the train path (the same shape, r, k, v and w float32) the
// bytes take 0.1014 ms and the operations 0.080 ms at the float32 rate.
// What kept the token kernel at 8 to 11 times those bounds is the serial
// chain: 2048 dependent token steps per block, one block per SM.  The chunk
// kernel's chain is 32 dependent chunk steps, each of them wide.
//
// Token kernel.  The recurrence is parallel over the state's columns:
// column j of S evolves with v_t[j] alone.  One block owns one (b, h) and
// 4*hd threads; thread (j, g) keeps rows g, g+4, g+8, ... of column j in
// registers (8 floats at hd = 32) and the four partial dot products
// r_t . S[:, j] meet through two warp shuffles.  The block walks T in
// chunks of 32 tokens: each chunk's r, k, v, w are staged in shared memory
// with coalesced loads, the bonus r_t . (u * k_t) of each token is reduced
// once per chunk, the 32 steps then run with no block barrier, and the
// chunk's outputs leave through shared memory as coalesced stores.  It
// multiplies by w_t in [0, 1] each step, so it is stable at any length.
//
// Chunk kernel.  One block (16 warps) owns one (b, h), as the TPU kernel's
// grid row does, and walks T in chunks of L = 64 tokens, the state carried
// from chunk to chunk in registers (a copy in shared memory for the
// products that read it).  Within a chunk, with a[t] = sum_{j<t} log2 w_j
// per channel (a[0] = 0):
//
//   out_t = (r_t 2^a[t]) S + sum_{s<t} (sum_c r_tc k_sc 2^(a[t]-a[s+1])_c) v_s
//           + (r_t . (u k_t)) v_t
//   S'    = diag(2^a[L]) S + sum_s (k_s 2^(a[L]-a[s+1]))^T v_s
//
// that is out = A v + (r 2^a) S with A the chunk's lower-triangular 64 x 64
// matrix of pair weights (the bonus on its diagonal).
//
// The stability rule.  The TPU kernel forms k / c_incl = k 2^-a, which
// overflows once a chunk's sum of |log w| passes about 88 (w = 0 gives
// -inf).  Here every factor is 2^x with x a sum of log2 w over the tokens
// between an earlier and a later position, so x <= 0 and the factor lies in
// [0, 1]; and no x is a difference of two prefix sums, so there is no
// -inf - -inf and no cancellation of two large sums.  The chunk is cut into
// four sub-blocks of 16 tokens (p_i = 16 i, total T_i of log2 w), each cut
// into four groups of 4 tokens (totals U):
//  - R^_t = r_t 2^(sum_{p_i<=j<t} log2 w_j), a running sum forward from the
//    start of t's sub-block, and K^_s = k_s 2^(sum_{s<j<p_i+16} log2 w_j),
//    backward from its end; R'_t and K'_s the same over t's or s's group;
//  - F[i][j] = 2^(T_j + ... + T_{i-1}) and, inside sub-block i,
//    G[i][a][b] = 2^(U_b + ... + U_{a-1}), per channel;
//  - a query t of sub-block i and a key s of an earlier sub-block j meet
//    through (R^_t F[i][j+1]) . K^_s: a tensor-core product per pair of
//    sub-blocks (6 per chunk), 16 x 16 over hd;
//  - inside a sub-block, a query of group a and a key of an earlier group b
//    meet through (R'_t G[i][a][b+1]) . K'_s: a tensor-core product per
//    (sub-block, b) (12 per chunk);
//  - inside a group the pairwise decay prod_{s<j<t} w_j is built by running
//    products of w (FMULs, no exp), and the bonus r_t . (u k_t) takes the
//    diagonal;
//  - out = A v + (R^ F[i][0]) S and S' = diag(F[4][0]) S + (K^ F[4][j+1])^T v
//    on the tensor cores.
// log2 w is clamped at -100 (w < 2^-100 is taken as 2^-100), so every sum is
// finite even at w = 0.  What that leaves is a term that w = 0 multiplies by
// exactly 0 multiplied by at most 2^-100 instead: below 1e-27 at any state
// of size 1e3, far under the tolerance of 2e-3.  The running products use
// the unclamped w, so there w = 0 gives exactly 0.
//
// Precision.  The products run on TF32 operands (mma.sync m16n8k8, float32
// accumulators).  One TF32 rounding of each operand (2^-11) leaves errors of
// 2e-2 at the path's sizes, ten times the 2e-3 tolerance, so each operand
// that is not exact in TF32 is split into a high and a low TF32 part and a
// product takes hi*hi + hi*lo + lo*hi: float32 accuracy at three times the
// tensor-core work.  Every operand but v is a float32 value whatever the
// input type (a decayed r or k, A, S).  v is exact in TF32 when it is
// bfloat16, and A v and (K^ F)^T v then take two products (hi*v + lo*v);
// float32 v is split as well, and they take three.
//
// Work and loads.  Per chunk: phase 1 (all warps) forms R^, K^, R', K', v in
// float32, T, U, G; then F (warps 0-7) while warps 8-15 bring chunk c + 1's
// v into the stage; phase 2 splits the warps: warps 0-7 build A (the
// running products inside groups, then the 12 group-pair and the 6
// sub-block-pair tiles) while warps 8-15 form (R^ F) S into their output
// tiles and S' into their state tiles; phase 3: warps 8-15 add A v and
// store out, while warps 0-7 bring chunk c + 1's r, k and w into the stage.
// The copies are 16-byte cp.async (rows past T zero-filled, so they count
// as k = v = 0 and w = 1), and they need r, k, v and w to start on 16-byte
// boundaries.  One stage suffices: nothing reads chunk c's v after phase 1
// or its r, k, w after phase 2.  Shared memory is 198.5 KB per block for
// float32 r, k, v, w and 174.5 KB for bfloat16 r, k, v (one block per SM:
// 512 threads take the register file), set once per device so that a
// launch captured into a CUDA graph is the launch alone.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "tf32.cuh"

namespace {

constexpr int G = 4;      // row groups per state column
constexpr int L = 32;     // tokens per staged chunk

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(G * HD)
wkv6_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
            const TR* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ state0,
            float* __restrict__ out, float* __restrict__ state, int t_len,
            int n_heads) {
  constexpr int THREADS = G * HD;
  constexpr int WARPS = THREADS / 32;
  constexpr int R = HD / G;   // state rows per thread

  __shared__ float r_s[L][HD];
  __shared__ float k_s[L][HD];
  __shared__ float v_s[L][HD];
  __shared__ float w_s[L][HD];
  __shared__ float o_s[L][HD];
  __shared__ float bonus_s[L];   // r_t . (u * k_t)
  __shared__ float u_s[HD];

  const int tid = threadIdx.x;
  const int j = tid / G;     // state column (v index)
  const int g = tid % G;     // row group: rows g + G * ii
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int bh = blockIdx.x;
  const int h = bh % n_heads;
  const size_t row_stride = static_cast<size_t>(n_heads) * HD;   // between tokens
  const size_t base = static_cast<size_t>(bh / n_heads) * t_len * row_stride +
                      static_cast<size_t>(h) * HD;

  for (int i = tid; i < HD; i += THREADS) u_s[i] = u[h * HD + i];

  float st[R];
  const size_t s_base = static_cast<size_t>(bh) * HD * HD;
#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    st[ii] = state0 ? state0[s_base + static_cast<size_t>(g + G * ii) * HD + j] : 0.0f;

  for (int t0 = 0; t0 < t_len; t0 += L) {
    const int n = min(L, t_len - t0);
    __syncthreads();   // the previous chunk's buffers are consumed
    for (int idx = tid; idx < n * HD; idx += THREADS) {
      const int t = idx / HD;
      const int i = idx % HD;
      const size_t off = base + static_cast<size_t>(t0 + t) * row_stride + i;
      r_s[t][i] = load_f32(r + off);
      k_s[t][i] = load_f32(k + off);
      v_s[t][i] = load_f32(v + off);
      w_s[t][i] = load_f32(w + off);
    }
    __syncthreads();
    for (int t = warp; t < n; t += WARPS) {
      float part = 0.0f;
      for (int i = lane; i < HD; i += 32) part = fmaf(r_s[t][i], u_s[i] * k_s[t][i], part);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) bonus_s[t] = part;
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = v_s[t][j];
      float part = 0.0f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = g + G * ii;
        part = fmaf(r_s[t][i], st[ii], part);
        st[ii] = fmaf(w_s[t][i], st[ii], k_s[t][i] * vj);
      }
      // The G row groups of column j are neighbouring lanes of one warp.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (g == 0) o_s[t][j] = part + bonus_s[t] * vj;
    }
    __syncthreads();
    for (int idx = tid; idx < n * HD; idx += THREADS) {
      const int t = idx / HD;
      const int i = idx % HD;
      out[base + static_cast<size_t>(t0 + t) * row_stride + i] = o_s[t][i];
    }
  }

#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    state[s_base + static_cast<size_t>(g + G * ii) * HD + j] = st[ii];
}

template <typename TR, typename TW, int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, float* out, float* state,
           int b, int t, int h, cudaStream_t stream) {
  wkv6_kernel<TR, TW, HD><<<b * h, G * HD, 0, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k),
      static_cast<const TR*>(v), static_cast<const TW*>(w), u, state0, out,
      state, t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, typename TW>
int dispatch(const void* r, const void* k, const void* v, const void* w,
             const float* u, const float* state0, float* out, float* state,
             int b, int t, int h, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<TR, TW, 8>(r, k, v, w, u, state0, out, state, b, t, h, stream);
    case 16: return launch<TR, TW, 16>(r, k, v, w, u, state0, out, state, b, t, h, stream);
    case 32: return launch<TR, TW, 32>(r, k, v, w, u, state0, out, state, b, t, h, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Chunk route: hd 64.  See the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int HD = 64;
constexpr int CL = 64;                // tokens per chunk
constexpr int SUB = 16;               // tokens per sub-block
constexpr int NSUB = CL / SUB;
constexpr int NF = NSUB + 1;          // F[i][j], 0 <= j <= i <= NSUB
constexpr int GRP = 4;                // tokens per group: a sub-block holds four
constexpr int NG = 6;                 // G[i][a][b], 1 <= b <= a < SUB / GRP, per sub-block
constexpr int THREADS = 512;          // 16 warps; phase 1 maps (channel, sub-block, direction)
constexpr int DIAG_WARPS = 8;         // warps 0-7 build A and load r, k, w; 8-15 load v and run the products
constexpr int LOADERS = DIAG_WARPS * 32;
constexpr float LOG2_FLOOR = -100.0f;
// Row strides (floats) of the float32 tiles, padded so that the mma
// fragment reads are free of bank conflicts: SA for tiles read as [g][t4]
// (A rows, or B stored n-major), SB for tiles read as [t4][g] (B stored
// k-major).
constexpr int SA = HD + 4;
constexpr int SB = HD + 8;
static_assert(THREADS == 2 * HD * NSUB, "phase 1 gives each thread one channel of one sub-block");

// Byte offsets into the dynamic shared memory: the stage (r, k, v, w as
// they arrive), then the float32 tiles.
template <typename TR, typename TW>
struct Smem {
  static constexpr int RKV = CL * HD * static_cast<int>(sizeof(TR));   // one r, k or v tile
  static constexpr int RH = 3 * RKV + CL * HD * static_cast<int>(sizeof(TW));   // R^ [CL][SA]
  static constexpr int KH = RH + CL * SA * 4;                       // K^ [CL][SA]
  static constexpr int VF = KH + CL * SA * 4;                       // v  [CL][SB]
  static constexpr int AM = VF + CL * SB * 4;                       // A  [CL][SA]
  static constexpr int ST = AM + CL * SA * 4;                       // S  [HD][SB]
  static constexpr int FF = ST + HD * SB * 4;                       // F  [NF][NF][HD]
  static constexpr int TS = FF + NF * NF * HD * 4;                  // T  [NSUB][HD]
  static constexpr int US = TS + NSUB * HD * 4;                     // u  [HD]
  static constexpr int RG = US + HD * 4;                            // R' [CL][SA]
  static constexpr int KG = RG + CL * SA * 4;                       // K' [CL][SA]
  static constexpr int GF = KG + CL * SA * 4;                       // G  [NSUB][NG][HD]
  static constexpr size_t BYTES = GF + NSUB * NG * HD * 4;
  static_assert(BYTES <= 232448, "one block's shared memory on Hopper");
};

// The split-TF32 products and cp.async copies, shared with
// flash_attention_bwd.cu (tf32.cuh).
using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait_all;
using tf32::exact_tf32;
using tf32::mma;
using tf32::mma3;
using tf32::split;

// c += a * v for the two products whose B operand is v, with a given as
// its hi and lo TF32 parts: hi*hi into c, the corrections into cc.  v exact
// in TF32 (bfloat16) has no lo part and takes hi*v + lo*v; float32 v is
// split too and takes hi*hi + lo*hi + hi*lo, as mma3 does.
template <bool EXACT>
__device__ __forceinline__ void mma_v(float (&c)[4], float (&cc)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  tf32::to_tf32<EXACT>(b0, bh0, bl0);
  tf32::to_tf32<EXACT>(b1, bh1, bl1);
  mma(cc, al, bh0, bh1);
  if constexpr (!EXACT) mma(cc, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// Two consecutive values from shared memory as float32.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Sums v[0..3] over the warp's 32 lanes and leaves row j's sum on lanes
// 8 j .. 8 j + 7 (a reduce-scatter: six shuffles for four sums).
__device__ __forceinline__ float reduce4(const float (&v)[4], int lane) {
  const bool hi16 = lane & 16, hi8 = lane & 8;
  float a = hi16 ? v[2] : v[0], b = hi16 ? v[3] : v[1];
  a += __shfl_xor_sync(0xffffffffu, hi16 ? v[0] : v[2], 16);
  b += __shfl_xor_sync(0xffffffffu, hi16 ? v[1] : v[3], 16);
  float x = hi8 ? b : a;
  x += __shfl_xor_sync(0xffffffffu, hi8 ? a : b, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x;
}

// The hardware's log2 and exp2 (MUFU): absolute error about 2^-22 in log2 w,
// about 1e-5 relative over a sub-block's sum, far under the tolerance.
// lg2 of 0 is -inf (clamped to LOG2_FLOOR by the caller); ex2 of a large
// negative sum is 0.
__device__ __forceinline__ float fast_log2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copies the CL rows of one chunk, starting at `src` (rows `stride`
// elements apart, row `row0` of the sequence), densely into shared memory
// at `dst`, as thread `lt` of NT loading threads.  Rows at or past t_len are
// zero-filled.
template <int NT, typename T>
__device__ __forceinline__ void load_chunk(int lt, uint32_t dst, const T* src, size_t stride, int row0,
                                           int t_len) {
  constexpr int CHUNKS = HD * static_cast<int>(sizeof(T)) / 16;   // 16-byte chunks per row
  constexpr int PER_ROW = 16 / static_cast<int>(sizeof(T));
  static_assert(CL * CHUNKS % NT == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < CL * CHUNKS / NT; ++it) {
    const int idx = lt + it * NT;
    const int row = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const bool in = row0 + row < t_len;
    cp_async16(dst + idx * 16, src + static_cast<size_t>(in ? row : 0) * stride + c * PER_ROW, in);
  }
}

template <typename TR, typename TW>
__global__ void __launch_bounds__(THREADS, 1)
chunk_kernel(const TR* __restrict__ r, const TR* __restrict__ k,
             const TR* __restrict__ v, const TW* __restrict__ w,
             const float* __restrict__ u, const float* __restrict__ state0,
             float* __restrict__ out, float* __restrict__ state, int t_len,
             int n_heads) {
  using M = Smem<TR, TW>;
  constexpr bool V_EXACT = exact_tf32<TR>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* const rh = reinterpret_cast<float*>(smem + M::RH);
  float* const kh = reinterpret_cast<float*>(smem + M::KH);
  float* const vf = reinterpret_cast<float*>(smem + M::VF);
  float* const am = reinterpret_cast<float*>(smem + M::AM);
  float* const st = reinterpret_cast<float*>(smem + M::ST);
  float* const ff = reinterpret_cast<float*>(smem + M::FF);
  float* const ts = reinterpret_cast<float*>(smem + M::TS);
  float* const us = reinterpret_cast<float*>(smem + M::US);
  float* const rg = reinterpret_cast<float*>(smem + M::RG);
  float* const kg = reinterpret_cast<float*>(smem + M::KG);
  float* const gf = reinterpret_cast<float*>(smem + M::GF);
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;    // mma fragment row group
  const int t4 = lane % 4;   // and thread in group
  const int bh = static_cast<int>(blockIdx.x);
  const int h = bh % n_heads;
  const size_t row_stride = static_cast<size_t>(n_heads) * HD;   // between tokens
  const size_t base = static_cast<size_t>(bh / n_heads) * t_len * row_stride +
                      static_cast<size_t>(h) * HD;
  const int n_chunks = (t_len + CL - 1) / CL;

  // Warps 0-7 ("diagonal warps") build A and load r, k, w; warps 8-15
  // ("product warps") load v, run the products with S and own the output
  // and the state.  A scheduler holds warps w, w + 4, w + 8 and w + 12: two
  // of each kind.
  const bool diag_warp = warp < DIAG_WARPS;
  auto chunk_off = [&](int c) { return base + static_cast<size_t>(c) * CL * row_stride; };
  auto issue_rkw = [&](int c) {   // diagonal warps
    load_chunk<LOADERS>(tid, smem_addr, r + chunk_off(c), row_stride, c * CL, t_len);
    load_chunk<LOADERS>(tid, smem_addr + M::RKV, k + chunk_off(c), row_stride, c * CL, t_len);
    load_chunk<LOADERS>(tid, smem_addr + 3 * M::RKV, w + chunk_off(c), row_stride, c * CL, t_len);
  };
  auto issue_v = [&](int c) {     // product warps
    load_chunk<LOADERS>(tid - LOADERS, smem_addr + 2 * M::RKV, v + chunk_off(c), row_stride, c * CL, t_len);
  };
  if (diag_warp) {
    issue_rkw(0);
  } else {
    issue_v(0);
  }
  cp_async_commit();

  if (tid < HD) us[tid] = u[h * HD + tid];
  // A product warp's tiles, 2 x 2 m16n8 fragments each: of the output,
  // rows 32 mp .. 32 mp + 31 (sub-blocks 2 mp and 2 mp + 1) and columns
  // 16 np .. 16 np + 15; of the state, the same rows (over k) and columns
  // (over v).
  const int pw = warp - DIAG_WARPS;
  const int mp = pw / 4;
  const int np = pw % 4;
  const size_t s_base = static_cast<size_t>(bh) * HD * HD;
  float sacc[2][2][4] = {};
  if (!diag_warp) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 32 * mp + 16 * mi + g + 8 * (q / 2);
          const int col = 16 * np + 8 * j + 2 * t4 + q % 2;
          sacc[mi][j][q] = state0 ? state0[s_base + static_cast<size_t>(row) * HD + col] : 0.0f;
          st[row * SB + col] = sacc[mi][j][q];
        }
  }

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();     // chunk c has landed for every thread
    const int n = min(CL, t_len - c * CL);
    const TR* const rs = reinterpret_cast<const TR*>(smem);
    const TR* const ks = rs + CL * HD;
    const TR* const vs = ks + CL * HD;
    const TW* const ws = reinterpret_cast<const TW*>(smem + 3 * M::RKV);

    // Phase 1: thread (ch, i, dir) takes channel ch of sub-block i: running
    // sums of log2 w over the sub-block and over each group of 4 tokens,
    // forward (dir 0: R^ and R', v as float32, the sub-block's total T_i and
    // the group factors G) or backward (dir 1: K^ and K').
    {
      const int ch = tid % HD;
      const int i = (tid / HD) % NSUB;
      const bool fwd = tid < THREADS / 2;
      float lw[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int t = i * SUB + q;
        lw[q] = t < n ? fmaxf(fast_log2(load_f32(ws + t * HD + ch)), LOG2_FLOOR) : 0.0f;
      }
      float acc = 0.0f, grp = 0.0f, tot[SUB / GRP];
      if (fwd) {
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
          const int t = i * SUB + q;
          const float x = load_f32(rs + t * HD + ch);
          rh[t * SA + ch] = x * fast_exp2(acc);
          rg[t * SA + ch] = x * fast_exp2(grp);
          vf[t * SB + ch] = load_f32(vs + t * HD + ch);
          acc += lw[q];
          grp += lw[q];
          if (q % GRP == GRP - 1) {
            tot[q / GRP] = grp;
            grp = 0.0f;
          }
        }
        ts[i * HD + ch] = acc;
        // G[i][a][b] = 2^(U_b + ... + U_{a-1}), U the group totals.
        float* gi = gf + i * NG * HD + ch;
        gi[0 * HD] = 1.0f;                                // (1, 1)
        gi[1 * HD] = fast_exp2(tot[1]);                   // (2, 1)
        gi[2 * HD] = 1.0f;                                // (2, 2)
        gi[3 * HD] = fast_exp2(tot[1] + tot[2]);          // (3, 1)
        gi[4 * HD] = fast_exp2(tot[2]);                   // (3, 2)
        gi[5 * HD] = 1.0f;                                // (3, 3)
      } else {
#pragma unroll
        for (int q = SUB - 1; q >= 0; --q) {
          const int t = i * SUB + q;
          const float x = load_f32(ks + t * HD + ch);
          kh[t * SA + ch] = x * fast_exp2(acc);
          kg[t * SA + ch] = x * fast_exp2(grp);
          acc += lw[q];
          grp = q % GRP == 0 ? 0.0f : grp + lw[q];
        }
      }
    }
    __syncthreads();
    // F[i+1][j] = 2^(T_j + ... + T_i) for j <= i, and F[i][i] = 1, on the
    // diagonal warps; the product warps bring chunk c + 1's v into the stage
    // (chunk c's is in vf now).
    if (!diag_warp) {
      if (c + 1 < n_chunks) issue_v(c + 1);
    } else {
      const int ch = tid % HD;
      const int i = tid / HD;
      float acc = 0.0f;
      for (int j = i; j >= 0; --j) {
        acc += ts[j * HD + ch];
        ff[((i + 1) * NF + j) * HD + ch] = fast_exp2(acc);
      }
      ff[(i * NF + i) * HD + ch] = 1.0f;
      if (i == NSUB - 1) ff[(NSUB * NF + NSUB) * HD + ch] = 1.0f;
    }
    __syncthreads();

    float o[2][2][4] = {}, oc[2][2][4] = {};
    if (diag_warp) {
      // Phase 2, diagonal warps: A.  First the pairs inside each group of 4
      // tokens, by running products.  Warp w takes groups 2 (w % 2) and
      // 2 (w % 2) + 1 of sub-block w / 2.  Lane l holds channels 2 l and
      // 2 l + 1 of the group's four rows as q = r_t prod_{s<j<t} w_j; the rows
      // walk the group's keys together, and each key's four sums meet in one
      // reduce-scatter.
      const int c0 = 2 * lane;
      const int p = (warp / 2) * SUB;
      const int mine = lane / 8;   // the row whose sums this lane ends up with
      const float2 uu = load2(us + c0);
#pragma unroll 1
      for (int grp = 0; grp < 2; ++grp) {
        const int r0 = GRP * (2 * (warp % 2) + grp);   // the group's first row
        float2 q[GRP];
        float part[GRP][GRP];   // [key][row]
#pragma unroll
        for (int j = 0; j < GRP; ++j) {
          const int t = p + r0 + j;
          q[j] = load2(rs + t * HD + c0);
          const float2 kt = load2(ks + t * HD + c0);
          part[0][j] = fmaf(q[j].x * uu.x, kt.x, q[j].y * uu.y * kt.y);
        }
        const int tl = r0 + mine;
        const int t = p + tl;
        const float bonus = reduce4(part[0], lane);
        if (lane % 8 == 0) am[t * SA + t] = bonus;   // on the diagonal
#pragma unroll
        for (int e = 2 * (lane % 8); e < 2 * (lane % 8) + 2; ++e)
          if (e > tl) am[t * SA + p + e] = 0.0f;
        // Keys r0 + 2 down to r0; row j takes those below it.
#pragma unroll
        for (int e = 0; e < GRP - 1; ++e) {
          const int sl = r0 + GRP - 2 - e;
          const float2 kv = load2(ks + (p + sl) * HD + c0);
          const float2 wv = load2(ws + (p + sl) * HD + c0);
#pragma unroll
          for (int j = 0; j < GRP; ++j) {
            const bool on = GRP - 2 - e < j;   // sl < r0 + j
            part[e][j] = on ? fmaf(q[j].x, kv.x, q[j].y * kv.y) : 0.0f;
            if (on) {
              q[j].x *= wv.x;
              q[j].y *= wv.y;
            }
          }
        }
        float sum[GRP - 1];
#pragma unroll
        for (int e = 0; e < GRP - 1; ++e) sum[e] = reduce4(part[e], lane);
#pragma unroll
        for (int e = 0; e < GRP - 1; ++e) {
          const int sl = r0 + GRP - 2 - e;
          if (lane % 8 == 0 && sl < tl) am[t * SA + p + sl] = sum[e];
        }
      }
      // Then the pairs between groups of one sub-block: the query rows of
      // group a and the keys of an earlier group b meet through
      // (R'_a G[i][a][b+1]) K'_b^T, one 16 x 8 tile (the sub-block's rows,
      // group b's keys and four more whose sums are dropped) per (i, b).
#pragma unroll 1
      for (int unit = warp; unit < NSUB * (SUB / GRP - 1); unit += DIAG_WARPS) {
        const int i = unit / (SUB / GRP - 1);
        const int b = unit % (SUB / GRP - 1);
        const int m0 = i * SUB;
        const int n0 = m0 + GRP * b;
        const int a0 = g / GRP, a1 = (g + 8) / GRP;   // the groups of rows g and g + 8
        // G[i][a][b+1] for a > b; 0 for rows whose sums are dropped.
        const float* gi = gf + i * NG * HD;
        const float* g0 = a0 > b ? gi + (a0 * (a0 - 1) / 2 + b) * HD : nullptr;
        const float* g1 = a1 > b ? gi + (a1 * (a1 - 1) / 2 + b) * HD : nullptr;
        float acc[4] = {}, corr[4] = {};
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float a[4] = {
              g0 ? rg[(m0 + g) * SA + k0 + t4] * g0[k0 + t4] : 0.0f,
              g1 ? rg[(m0 + g + 8) * SA + k0 + t4] * g1[k0 + t4] : 0.0f,
              g0 ? rg[(m0 + g) * SA + k0 + t4 + 4] * g0[k0 + t4 + 4] : 0.0f,
              g1 ? rg[(m0 + g + 8) * SA + k0 + t4 + 4] * g1[k0 + t4 + 4] : 0.0f};
          mma3(acc, corr, a, kg[(n0 + g) * SA + k0 + t4], kg[(n0 + g) * SA + k0 + t4 + 4]);
        }
        if (t4 < GRP / 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int row = g + 8 * (q / 2);
            if (row / GRP > b) am[(m0 + row) * SA + n0 + 2 * t4 + q % 2] = acc[q] + corr[q];
          }
        }
      }
      // Then the six sub-blocks below the diagonal, A[i][j], i > j, =
      // (R^_i F[i][j+1]) K^_j^T, as twelve 16 x 8 tiles on the tensor cores.
#pragma unroll 1
      for (int unit = (warp + DIAG_WARPS / 2) % DIAG_WARPS; unit < NSUB * (NSUB - 1); unit += DIAG_WARPS) {
        const int blk = unit / 2;
        const int i = blk < 1 ? 1 : blk < 3 ? 2 : 3;
        const int j = blk - i * (i - 1) / 2;
        const int m0 = i * SUB;
        const int n0 = j * SUB + (unit % 2) * 8;
        const float* fr = ff + (i * NF + j + 1) * HD;
        float acc[4] = {}, corr[4] = {};
#pragma unroll
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float f0 = fr[k0 + t4], f1 = fr[k0 + t4 + 4];
          const float a[4] = {
              rh[(m0 + g) * SA + k0 + t4] * f0, rh[(m0 + g + 8) * SA + k0 + t4] * f0,
              rh[(m0 + g) * SA + k0 + t4 + 4] * f1, rh[(m0 + g + 8) * SA + k0 + t4 + 4] * f1};
          mma3(acc, corr, a, kh[(n0 + g) * SA + k0 + t4], kh[(n0 + g) * SA + k0 + t4 + 4]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          am[(m0 + g + 8 * (q / 2)) * SA + n0 + 2 * t4 + q % 2] = acc[q] + corr[q];
      }
    } else {
      // Phase 2, product warps: the products that need no A.  The state
      // tiles' S' = diag(F[4][0]) S + sum_j (K^_j F[4][j+1])^T v_j into
      // sacc, then the output tiles' (R^ F[i][0]) S into o: in this order,
      // o's accumulators are not live while S' is formed.  Both loops
      // unroll by 2: by 4 they spill at the 128 registers that 512 threads
      // leave a thread, in one type pair or another.
      {
        const float* fs = ff + (NSUB * NF) * HD;
        float sc[2][2][4] = {};
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const float d0 = fs[32 * mp + 16 * mi + g], d1 = fs[32 * mp + 16 * mi + g + 8];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            sacc[mi][j][0] *= d0;
            sacc[mi][j][1] *= d0;
            sacc[mi][j][2] *= d1;
            sacc[mi][j][3] *= d1;
          }
        }
#pragma unroll 2
        for (int k0 = 0; k0 < CL; k0 += 8) {
          const float* fk = fs + (k0 / SUB + 1) * HD;
          float b[2][2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            b[j][0] = vf[(k0 + t4) * SB + 16 * np + 8 * j + g];
            b[j][1] = vf[(k0 + t4 + 4) * SB + 16 * np + 8 * j + g];
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            const int m0 = 32 * mp + 16 * mi;
            const float e0 = fk[m0 + g], e1 = fk[m0 + g + 8];
            uint32_t a_hi[4], a_lo[4];
            split(kh[(k0 + t4) * SA + m0 + g] * e0, a_hi[0], a_lo[0]);
            split(kh[(k0 + t4) * SA + m0 + g + 8] * e1, a_hi[1], a_lo[1]);
            split(kh[(k0 + t4 + 4) * SA + m0 + g] * e0, a_hi[2], a_lo[2]);
            split(kh[(k0 + t4 + 4) * SA + m0 + g + 8] * e1, a_hi[3], a_lo[3]);
#pragma unroll
            for (int j = 0; j < 2; ++j) mma_v<V_EXACT>(sacc[mi][j], sc[mi][j], a_hi, a_lo, b[j][0], b[j][1]);
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int q = 0; q < 4; ++q) sacc[mi][j][q] += sc[mi][j][q];
      }
#pragma unroll 2
      for (int k0 = 0; k0 < HD; k0 += 8) {
        float b[2][2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          b[j][0] = st[(k0 + t4) * SB + 16 * np + 8 * j + g];
          b[j][1] = st[(k0 + t4 + 4) * SB + 16 * np + 8 * j + g];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int m0 = 32 * mp + 16 * mi;
          const float* fr = ff + ((2 * mp + mi) * NF) * HD;
          const float f0 = fr[k0 + t4], f1 = fr[k0 + t4 + 4];
          const float a[4] = {
              rh[(m0 + g) * SA + k0 + t4] * f0, rh[(m0 + g + 8) * SA + k0 + t4] * f0,
              rh[(m0 + g) * SA + k0 + t4 + 4] * f1, rh[(m0 + g + 8) * SA + k0 + t4 + 4] * f1};
#pragma unroll
          for (int j = 0; j < 2; ++j) mma3(o[mi][j], oc[mi][j], a, b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();

    // Phase 3: the diagonal warps load chunk c + 1's r, k and w into the
    // stage (chunk c's were last read in phase 2); the product warps write
    // out = A v + o for their output tiles.
    if (diag_warp) {
      if (c + 1 < n_chunks) issue_rkw(c + 1);
    } else {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int i = 2 * mp + mi;
        const int m0 = i * SUB;
        for (int k0 = 0; k0 < (i + 1) * SUB; k0 += 8) {
          const int a0 = (m0 + g) * SA + k0 + t4;
          uint32_t a_hi[4], a_lo[4];
          split(am[a0], a_hi[0], a_lo[0]);
          split(am[a0 + 8 * SA], a_hi[1], a_lo[1]);
          split(am[a0 + 4], a_hi[2], a_lo[2]);
          split(am[a0 + 8 * SA + 4], a_hi[3], a_lo[3]);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int col = 16 * np + 8 * j + g;
            mma_v<V_EXACT>(o[mi][j], oc[mi][j], a_hi, a_lo, vf[(k0 + t4) * SB + col], vf[(k0 + t4 + 4) * SB + col]);
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + g + 8 * half;
          if (row >= n) continue;
          float* dst = out + base + static_cast<size_t>(c * CL + row) * row_stride;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(dst + 16 * np + 8 * j + 2 * t4) =
                make_float2(o[mi][j][2 * half] + oc[mi][j][2 * half],
                            o[mi][j][2 * half + 1] + oc[mi][j][2 * half + 1]);
        }
      }
    }
    cp_async_commit();   // chunk c + 1's copies (empty at the end)
    __syncthreads();     // every warp has read S, A and this chunk's stage
    if (!diag_warp) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            st[(32 * mp + 16 * mi + g + 8 * (q / 2)) * SB + 16 * np + 8 * j + 2 * t4 + q % 2] =
                sacc[mi][j][q];
    }
  }

  if (!diag_warp) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = 32 * mp + 16 * mi + g + 8 * (q / 2);
          const int col = 16 * np + 8 * j + 2 * t4 + q % 2;
          state[s_base + static_cast<size_t>(row) * HD + col] = sacc[mi][j][q];
        }
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

template <typename TR, typename TW>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, float* out, float* state,
           int b, int t, int h, cudaStream_t stream) {
  // cp.async copies 16-byte chunks: rows are hd elements apart, so the bases
  // must be 16-byte aligned (the wrapper checks this too).
  for (const void* ptr : {r, k, v, w})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr size_t smem = Smem<TR, TW>::BYTES;
  static unsigned configured = 0;
  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(chunk_kernel<TR, TW>), smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  chunk_kernel<TR, TW><<<b * h, THREADS, smem, stream>>>(
      static_cast<const TR*>(r), static_cast<const TR*>(k), static_cast<const TR*>(v),
      static_cast<const TW*>(w), u, state0, out, state, t, h);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR>
int launch(const void* r, const void* k, const void* v, const void* w,
           const float* u, const float* state0, float* out, float* state,
           int b, int t, int h, int w_bf16, cudaStream_t stream) {
  if (w_bf16) return launch<TR, bf16>(r, k, v, w, u, state0, out, state, b, t, h, stream);
  return launch<TR, float>(r, k, v, w, u, state0, out, state, b, t, h, stream);
}

}  // namespace tc

}  // namespace

// out (b, t, h, hd) and the final state (b, h, hd, hd), both float32, of the
// WKV6 recurrence over r, k, v, w (b, t, h, hd, contiguous) and u (h, hd,
// float32) from state0 (b, h, hd, hd, float32; null for zero).  hd is 8,
// 16, 32 or 64; rkv_bf16 and w_bf16 pick bfloat16 (1) or float32 (0) for
// r, k, v and for w.  hd 64 takes the chunk kernel and needs 16-byte-aligned
// r, k, v, w; hd 8, 16 and 32 the token kernel.  Launches on `stream`
// without synchronising and returns the CUDA error of the launch (0 when it
// was accepted).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* state0,
                    void* out, void* state, int b, int t, int h, int hd,
                    int rkv_bf16, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(state);
  if (hd == 64) {
    if (rkv_bf16) return tc::launch<__nv_bfloat16>(r, k, v, w, uf, s0, of, sf, b, t, h, w_bf16, st);
    return tc::launch<float>(r, k, v, w, uf, s0, of, sf, b, t, h, w_bf16, st);
  }
  if (rkv_bf16) {
    if (w_bf16)
      return dispatch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
    return dispatch<__nv_bfloat16, float>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
  }
  if (w_bf16)
    return dispatch<float, __nv_bfloat16>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
  return dispatch<float, float>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
}

// Dynamic shared memory (bytes) of the chunk kernel for r, k, v and w of
// the given types (1: bfloat16, 0: float32), as its launches ask for it.
extern "C" int wkv6_smem(int rkv_bf16, int w_bf16) {
  using tc::bf16;
  if (rkv_bf16) return static_cast<int>(w_bf16 ? tc::Smem<bf16, bf16>::BYTES : tc::Smem<bf16, float>::BYTES);
  return static_cast<int>(w_bf16 ? tc::Smem<float, bf16>::BYTES : tc::Smem<float, float>::BYTES);
}
