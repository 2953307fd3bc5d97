// Gradient of the RWKV6 WKV recurrence for Hopper (sm_90a), with a plain C
// interface.
//
// The JAX package has no backward kernel for kernels/wkv6.py::_wkv6_kernel:
// it trains through XLA's autodiff of models/rwkv.py::wkv_scan.  This file
// is the port's counterpart of that gradient, the backward of
// kernels/wkv6.py::_WKV6 (whose forward is csrc/wkv6.cu).  For each batch b
// and head h, with S_t the state after token t (S_0 the given initial
// state, S_T the returned final state), G_t = dL/dS_t, G_T the final
// state's incoming gradient (zero when it is null), and t running from T
// down to 1:
//
//   vd_t     = v_t . dout_t                                (a scalar)
//   dr_t[i]  = sum_j S_{t-1}[i,j] dout_t[j] + u[i] k_t[i] vd_t
//   dk_t[i]  = sum_j G_t[i,j] v_t[j]        + r_t[i] u[i] vd_t
//   dv_t[j]  = sum_i G_t[i,j] k_t[i]        + (sum_i r_t[i] u[i] k_t[i]) dout_t[j]
//   dw_t[i]  = sum_j G_t[i,j] S_{t-1}[i,j]
//   du[i]   += r_t[i] k_t[i] vd_t             (summed over b and t)
//   G_{t-1}  = diag(w_t) G_t + r_t dout_t^T
//   d(state) = G_0
//
// Inputs are as the forward takes them: r, k, v, w (B, T, H, hd),
// contiguous, r, k, v float32 or bfloat16 and w float32 or bfloat16; u
// (H, hd), the initial state and its gradient (B, H, hd, hd) and dout
// (B, T, H, hd), all float32.  dr, dk, dv are written in r's type, dw in
// w's; du is written as float32 partials (B, H, ceil(T / L), hd), one per
// (b, h, chunk), which the wrapper sums; d(state) is float32.  hd is 8, 16,
// 32 or 64.  Every operand starts on a 16-byte boundary (cp.async).
//
// The chunk form.  T is cut into chunks of L = 64 tokens.  For chunk c let
// S_c be the state before it and G_c the state's gradient after it; inside
// the chunk every decay between an earlier and a later position is a
// product of w over the tokens between them, P(a..b) = w_a ... w_b (1 when
// empty), so it lies in [0, 1].  Three kernels, launched in this order on
// one stream, each over a grid of (b, h, chunk) blocks or of state elements:
//
//  - sums_kernel, one block per (b, h, chunk): the chunk's total decay
//    W_c = P(0..L-1) and, on the tensor cores, dS_c = sum_s (k_s
//    P(s+1..L-1))^T v_s and dG_c = sum_t (r_t P(0..t-1))^T dout_t, the
//    factors as running products of w.
//  - scan_kernel, one thread per four state elements: S_{c+1} = diag(W_c)
//    S_c + dS_c forward from the initial state and G_{c-1} = diag(W_c) G_c +
//    dG_c backward from the final state's gradient, 32 steps at rwkv6-7b's
//    train shape in place of 2048; it writes S_c and G_c over dS_c and dG_c
//    (the checkpoints) and d(state).
//  - grads_kernel, one block per (b, h, chunk), from S_c, G_c and the
//    chunk's rows staged with cp.async: with dA[t][s] = dout_t . v_s and A
//    the chunk's pair matrix of the forward (A[t][s] = sum_i r_t[i] k_s[i]
//    P(s+1..t-1)[i] for s < t, the bonus r_t . (u k_t) on its diagonal),
//      dv = A^T dout + (k P(s+1..L-1)) G_c,
//      dr = sum_{s<t} dA[t][s] (k_s P(s+1..t-1)) + (dout S_c^T) P(0..t-1) + bonus,
//      dk = sum_{t>s} dA[t][s] (r_t P(s+1..t-1)) + (v G_c^T) P(s+1..L-1) + bonus.
//    The chunk is cut into four sub-blocks of SUB = 16 tokens, with pf_t =
//    P(p..t-1) from t's sub-block start p, pb_s = P(s+1..e) to s's
//    sub-block end e, the sub-block totals T_a and F[a][b] = T_b ...
//    T_{a-1}: a pair (t, s) of sub-blocks a > b decays by pb_s F[a][b+1]
//    pf_t, so its part of A, dr and dk is a tensor-core product (pf_t and
//    pb_s applied to an operand or to the product's rows); pairs inside a
//    sub-block walk their running products on the CUDA cores.
//    dw_t = rowsum(G_t * S_{t-1}) is taken in the same block, exactly, term
//    by term: S_{t-1} is a sum of decayed sources (S_c and each k_s v_s^T,
//    s < t), G_t one of (G_c and each r_s' dout_s'^T, s' > t), and each
//    pair of sources meets through a dot product that the products above
//    already form (S_c dout_s', G_c v_s, dout_s' . v_s) or a row sum of
//    S_c * G_c, decayed by products of w.  With S^a the state before t's
//    sub-block a and G^a the gradient after it,
//      dw_t = pf_t pb_t rowsum(S^a * G^a) + pf_t sum_{s>t in a} P(t+1..s-1) r_s (S^a dout_s)
//           + pb_t sum_{s<t in a} P(s+1..t-1) k_s (G^a v_s) + the pairs s < t < s' in a,
//    where rowsum(S^a * G^a) comes from column sums of the tiles of S_c
//    dout^T, G_c v^T and dA_cb (k pb)_b over whole sub-blocks, and the rest
//    are per-channel running products over one sub-block.  du's partials
//    go out per block.
//
// Precision.  The products run on TF32 mma.sync.m16n8k8 with float32
// accumulators, every inexact operand split into a high and a low TF32 part
// (csrc/tf32.cuh): three products, two where one side is v in bfloat16
// (exact in TF32).  dA = dout v^T feeds no subtraction, so split TF32 holds
// it at float32 accuracy.
//
// The traps this design keeps out:
//  - No un-decaying.  Nothing divides by w (w = 0 is legal): every factor
//    is a running product of w, or a product of sub-block totals (no exp
//    or log), and S only moves forward, G only backward.
//  - dw as sum_j G_t[i,j] S_{t-1}[i,j], expanded into its sources (no
//    identity through suffix sums of r dr - k dk, which divides by w and
//    subtracts large sums), so w = 0 gives a finite dw.
//  - Rows past T count as k = v = r = dout = 0 and w = 1.
//  - Determinism.  No atomics: every sum is taken in a fixed order, so two
//    calls give the same bits.
//
// What bounds it.  At rwkv6-7b's train shape (B = 2, T = 2048, H = 64,
// hd = 64, float32) the function reads r, k, v, w and dout and writes dr,
// dk, dv and dw: 0.60 GB, 0.18 ms at 3.35 TB/s.  Its 14 hd^2 operations per
// token and head take 0.22 ms at the CUDA cores' 67 TFLOP/s, the bound
// chip_smoke.py reports.  This design moves the checkpoints of S and G,
// 67 MB each: written by sums_kernel, read and rewritten by the scan, read
// by grads_kernel, 0.54 GB more (1.14 GB, 0.34 ms); and sums_kernel reads
// the chunks' rows a second time, 0.34 GB, so its own byte floor is
// 1.47 GB, 0.44 ms.  Its tensor-core work (about 16 hd^2 per token, three
// times over for the split) is about 0.1 ms at TF32's 495 TFLOP/s.  What
// holds it above that (tools/wkv6_bwd_phases.py): grads_kernel is most of
// the call, one block of 199 KB of shared memory an SM, so a block's
// staging of its rows is not hidden behind another block's products, and
// its products issue about a dozen shared-memory loads a k-step of three
// HMMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "tf32.cuh"

namespace {

constexpr int L = 64;             // tokens per chunk: checkpoints of S and G every L tokens
constexpr int SUB = 16;           // tokens per sub-block of a chunk (grads_kernel)
constexpr int NSUB = L / SUB;
constexpr int NF = NSUB + 1;      // F[a][b], 0 <= b <= a <= NSUB
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_AHEAD = 8;     // chunk summaries a scan thread loads at once
static_assert(L % SUB == 0, "a chunk is whole sub-blocks");

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait_all;

__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int n_chunks(int t_len) { return (t_len + L - 1) / L; }

// Where (b, h)'s rows start in a (B, T, H, hd) tensor and how far apart
// its tokens are.
struct Rows {
  size_t base, stride;
  __device__ Rows(int bh, int t_len, int n_heads, int hd)
      : base(static_cast<size_t>(bh / n_heads) * t_len * n_heads * hd +
             static_cast<size_t>(bh % n_heads) * hd),
        stride(static_cast<size_t>(n_heads) * hd) {}
  __device__ size_t at(int t) const { return base + static_cast<size_t>(t) * stride; }
};

// An m16 x k8 A fragment as TF32 operands: hi and lo parts, or the values
// themselves (lo = 0) where they are exact in TF32.
template <bool EX>
struct Frag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ explicit Frag(const float (&a)[4]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) tf32::to_tf32<EX>(a[q], hi[q], lo[q]);
  }
};

// c += a b on the tensor cores (b: the k8 x n8 fragment b0, b1), b split
// hi/lo unless its values are exact in TF32: hi*hi into c, the corrections
// into cc.
template <bool EXA, bool EXB>
__device__ __forceinline__ void mma_frag(float (&c)[4], float (&cc)[4], const Frag<EXA>& a, float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  tf32::to_tf32<EXB>(b0, bh0, bl0);
  tf32::to_tf32<EXB>(b1, bh1, bl1);
  if constexpr (!EXA) tf32::mma(cc, a.lo, bh0, bh1);
  if constexpr (!EXB) tf32::mma(cc, a.hi, bl0, bl1);
  tf32::mma(c, a.hi, bh0, bh1);
}

template <bool EXA, bool EXB>
__device__ __forceinline__ void mma_split(float (&c)[4], float (&cc)[4], const float (&a)[4], float b0,
                                          float b1) {
  mma_frag<EXA, EXB>(c, cc, Frag<EXA>(a), b0, b1);
}

// Sums v[0..15] over the warp's 32 lanes and leaves v[j]'s sum on lanes
// 2 j and 2 j + 1 (a reduce-scatter: 16 shuffles for 16 sums).
__device__ __forceinline__ float reduce16(const float (&v)[16], int lane) {
  float x8[8], x4[4], x2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int m = 0; m < 8; ++m)
    x8[m] = (b4 ? v[8 + m] : v[m]) + __shfl_xor_sync(0xffffffffu, b4 ? v[m] : v[8 + m], 16);
#pragma unroll
  for (int m = 0; m < 4; ++m)
    x4[m] = (b3 ? x8[4 + m] : x8[m]) + __shfl_xor_sync(0xffffffffu, b3 ? x8[m] : x8[4 + m], 8);
#pragma unroll
  for (int m = 0; m < 2; ++m)
    x2[m] = (b2 ? x4[2 + m] : x4[m]) + __shfl_xor_sync(0xffffffffu, b2 ? x4[m] : x4[2 + m], 4);
  float x = (b1 ? x2[1] : x2[0]) + __shfl_xor_sync(0xffffffffu, b1 ? x2[0] : x2[1], 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 1);
}

__device__ __forceinline__ uint32_t smem_addr(const float* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copies tokens t0 .. t0 + L - 1 of (b, h)'s rows of `src` into dst[L][STRIDE]
// as float32, as thread `tid` of NT: float32 rows by 16-byte cp.async,
// bfloat16 ones through registers; rows at or past t0 + n are zero.  The
// caller commits, waits and synchronises.
template <int HD, int STRIDE, int NT, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, const Rows& rows, int t0,
                                      int n, int tid) {
  if constexpr (std::is_same<T, float>::value) {
    constexpr int CH = HD / 4;   // 16-byte pieces per row
    for (int idx = tid; idx < L * CH; idx += NT) {
      const int t = idx / CH, c = idx % CH;
      const bool in = t < n;
      cp_async16(smem_addr(dst + t * STRIDE + 4 * c), src + rows.at(t0 + (in ? t : 0)) + 4 * c, in);
    }
  } else {
    for (int idx = tid; idx < L * HD / 2; idx += NT) {
      const int t = idx / (HD / 2), c = 2 * (idx % (HD / 2));
      float2 x = make_float2(0.0f, 0.0f);
      if (t < n) x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src + rows.at(t0 + t) + c));
      dst[t * STRIDE + c] = x.x;
      dst[t * STRIDE + c + 1] = x.y;
    }
  }
}

// w = 1 on the staged rows at or past n (after the copies have landed).
template <int HD, int STRIDE, int NT>
__device__ __forceinline__ void pad_decays(float* w_s, int n, int tid) {
  for (int idx = n * HD + tid; idx < L * HD; idx += NT) w_s[(idx / HD) * STRIDE + idx % HD] = 1.0f;
}

// ---------------------------------------------------------------------------
// Chunk summaries: W_c, dS_c, dG_c.
// ---------------------------------------------------------------------------
template <int HD>
struct SumsSmem {
  static constexpr int THREADS = 4 * HD < 64 ? 64 : 4 * HD;
  static constexpr int S = HD + 8;   // row stride: fragments are read as [t4][g]
  static constexpr size_t BYTES = static_cast<size_t>(5) * L * S * sizeof(float);   // r, k, v, dout, w
};

template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(SumsSmem<HD>::THREADS)
sums_kernel(const TR* __restrict__ r, const TR* __restrict__ k, const TR* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ dout, float* __restrict__ ck_s,
            float* __restrict__ ck_g, float* __restrict__ decay, int t_len, int n_heads) {
  constexpr int NT = SumsSmem<HD>::THREADS;
  constexpr int S = SumsSmem<HD>::S;
  extern __shared__ __align__(16) float smem[];
  float* const r_s = smem;
  float* const k_s = r_s + L * S;
  float* const v_s = k_s + L * S;
  float* const d_s = v_s + L * S;
  float* const w_s = d_s + L * S;

  const int tid = static_cast<int>(threadIdx.x);
  const int nc = n_chunks(t_len);
  const int blk = static_cast<int>(blockIdx.x);
  const int bh = blk / nc, c = blk % nc;
  const Rows rows(bh, t_len, n_heads, HD);
  const int t0 = c * L, n = min(L, t_len - t0);
  stage<HD, S, NT>(r_s, r, rows, t0, n, tid);
  stage<HD, S, NT>(k_s, k, rows, t0, n, tid);
  stage<HD, S, NT>(v_s, v, rows, t0, n, tid);
  stage<HD, S, NT>(d_s, dout, rows, t0, n, tid);
  stage<HD, S, NT>(w_s, w, rows, t0, n, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  pad_decays<HD, S, NT>(w_s, n, tid);
  __syncthreads();

  // Running products per channel: r_t P(0..t-1) over r (and the total,
  // W_c), k_s P(s+1..L-1) over k.
  for (int item = tid; item < 2 * HD; item += NT) {
    const int ch = item % HD;
    float p = 1.0f;
    if (item < HD) {
      for (int t = 0; t < L; ++t) {
        r_s[t * S + ch] *= p;
        p *= w_s[t * S + ch];
      }
      decay[static_cast<size_t>(blk) * HD + ch] = p;
    } else {
      for (int t = L - 1; t >= 0; --t) {
        k_s[t * S + ch] *= p;
        p *= w_s[t * S + ch];
      }
    }
  }
  __syncthreads();

  // dS = K~^T v and dG = R~^T dout in 16 x 8 tiles over (i, j), summed over
  // the chunk's tokens; at hd 8 a tile's rows 8-15 are outside and dropped.
  constexpr int MT = (HD + 15) / 16, NTL = HD / 8;
  constexpr bool FULL = HD % 16 == 0;
  constexpr bool EXV = tf32::exact_tf32<TR>();
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  for (int unit = warp; unit < 2 * MT * NTL; unit += NT / 32) {
    const bool is_g = unit >= MT * NTL;
    const int mn = unit % (MT * NTL);
    const int m0 = 16 * (mn / NTL), n0 = 8 * (mn % NTL);
    const float* a_s = is_g ? r_s : k_s;
    const float* b_s = is_g ? d_s : v_s;
    const bool hi_in = FULL || m0 + g + 8 < HD;
    float acc[4] = {}, corr[4] = {};
#pragma unroll 4
    for (int k0 = 0; k0 < L; k0 += 8) {
      const float* a0 = a_s + (k0 + t4) * S + m0 + g;
      const float a[4] = {a0[0], hi_in ? a0[8] : 0.0f, a0[4 * S], hi_in ? a0[4 * S + 8] : 0.0f};
      const float b0 = b_s[(k0 + t4) * S + n0 + g], b1 = b_s[(k0 + t4 + 4) * S + n0 + g];
      if (is_g) mma_split<false, false>(acc, corr, a, b0, b1);
      else mma_split<false, EXV>(acc, corr, a, b0, b1);
    }
    float* out = (is_g ? ck_g : ck_s) + static_cast<size_t>(blk) * HD * HD;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = m0 + g + 8 * (q / 2);
      if (FULL || row < HD) out[row * HD + n0 + 2 * t4 + q % 2] = acc[q] + corr[q];
    }
  }
}

// ---------------------------------------------------------------------------
// The scan over chunks: checkpoints of S and G in place of dS and dG.  Each
// thread walks four elements of one (b, h)'s state; the summaries of SCAN_AHEAD
// chunks are loaded before any is overwritten, so that many loads are in
// flight at once.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float4 fma4(float a, float4 x, float4 y) {
  return make_float4(fmaf(a, x.x, y.x), fmaf(a, x.y, y.y), fmaf(a, x.z, y.z), fmaf(a, x.w, y.w));
}

// x = diag(W_c) x + d_c over the chunks c in `order` (+1 forward, -1
// backward), writing x before chunk c over d_c.  `ck` points at (b, h)'s
// chunk 0, element 4e; chunks are `sz` floats apart; `dec` at chunk 0's
// decay of the elements' row, chunks `hd` floats apart.
template <int DIR>
__device__ __forceinline__ float4 scan_walk(float* ck, const float* dec, float4 x, int nc, size_t sz, int hd) {
  for (int c0 = 0; c0 < nc; c0 += SCAN_AHEAD) {
    float4 d[SCAN_AHEAD];
    float wc[SCAN_AHEAD];
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u) {
      const int c = DIR > 0 ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        d[u] = *reinterpret_cast<const float4*>(ck + c * sz);
        wc[u] = dec[static_cast<size_t>(c) * hd];
      }
    }
#pragma unroll
    for (int u = 0; u < SCAN_AHEAD; ++u) {
      const int c = DIR > 0 ? c0 + u : nc - 1 - c0 - u;
      if (c0 + u < nc) {
        *reinterpret_cast<float4*>(ck + c * sz) = x;
        x = fma4(wc[u], x, d[u]);
      }
    }
  }
  return x;
}

__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(float* __restrict__ ck_s, float* __restrict__ ck_g, const float* __restrict__ decay,
            const float* __restrict__ state0, const float* __restrict__ dfinal, float* __restrict__ dstate,
            int n_bh, int nc, int hd) {
  const int per = hd * hd / 4;   // float4s per state
  const int idx = static_cast<int>(blockIdx.x) * SCAN_THREADS + static_cast<int>(threadIdx.x);
  if (idx >= n_bh * per) return;
  const int bh = idx / per, e = idx % per;
  const size_t sz = static_cast<size_t>(hd) * hd;
  const size_t at = static_cast<size_t>(bh) * sz + 4 * static_cast<size_t>(e);   // in a (B, H, hd, hd) state
  const size_t first = static_cast<size_t>(bh) * nc;                               // (b, h)'s chunk 0
  const float* dec = decay + first * hd + 4 * e / hd;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const float4 s0 = state0 ? *reinterpret_cast<const float4*>(state0 + at) : zero;
  scan_walk<1>(ck_s + first * sz + 4 * e, dec, s0, nc, sz, hd);
  const float4 g1 = dfinal ? *reinterpret_cast<const float4*>(dfinal + at) : zero;
  const float4 g0 = scan_walk<-1>(ck_g + first * sz + 4 * e, dec, g1, nc, sz, hd);
  if (dstate) *reinterpret_cast<float4*>(dstate + at) = g0;
}

// ---------------------------------------------------------------------------
// dr, dk, dv, dw and du's partials of one chunk.
// ---------------------------------------------------------------------------
// Pairs (c, b) of sub-blocks with c >= b + 2, numbered c = 2: b = 0; c = 3:
// b = 0, 1; ...
__host__ __device__ constexpr int pair_index(int c, int b) { return (c - 2) * (c - 1) / 2 + b; }
constexpr int NPAIR = (NSUB - 1) * (NSUB - 2) / 2;

template <int HD>
struct GradsSmem {
  static constexpr int THREADS = 8 * HD;   // 16 warps at hd 64; phase 3 gives each warp two units
  static constexpr int SR = HD + 4;        // token rows: r, k, v, w, dout, pf, pb
  static constexpr int SL = L + 4;         // pair matrices A, dA
  static constexpr int SS = HD + 4;        // S_c, G_c
  static constexpr int RS = 0, KS = RS + L * SR, VS = KS + L * SR, WS = VS + L * SR, DS = WS + L * SR;
  static constexpr int PF = DS + L * SR, PB = PF + L * SR;
  static constexpr int AM = PB + L * SR, DA = AM + L * SL;
  static constexpr int SC = DA + L * SL, GC = SC + HD * SS;
  static constexpr int FF = GC + HD * SS, US = FF + NF * NF * HD, DU = US + HD;
  // dw's per-channel sums: rowsum(S_c * G_c); per sub-block, R^ . (dout S_c^T)
  // and K^ . (v G_c^T) over its rows; per pair (c, b), R^_c . (dA_cb K^_b).
  static constexpr int RSC = DU + NSUB * HD, RQ = RSC + HD, KQ = RQ + NSUB * HD, WP = KQ + NSUB * HD;
  static constexpr size_t BYTES = static_cast<size_t>(WP + NPAIR * HD) * sizeof(float);
};

template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(GradsSmem<HD>::THREADS, 1)
grads_kernel(const TR* __restrict__ r, const TR* __restrict__ k, const TR* __restrict__ v,
             const TW* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dout,
             const float* __restrict__ ck_s, const float* __restrict__ ck_g, TR* __restrict__ dr,
             TR* __restrict__ dk, TR* __restrict__ dv, TW* __restrict__ dw, float* __restrict__ du_part,
             int t_len, int n_heads) {
  using M = GradsSmem<HD>;
  constexpr int NT = M::THREADS, WARPS = NT / 32;
  constexpr int SR = M::SR, SL = M::SL, SS = M::SS;
  constexpr bool EXV = tf32::exact_tf32<TR>();
  extern __shared__ __align__(16) float smem[];
  float* const rs = smem + M::RS;
  float* const ks = smem + M::KS;
  float* const vs = smem + M::VS;
  float* const ws = smem + M::WS;
  float* const ds = smem + M::DS;
  float* const pf = smem + M::PF;
  float* const pb = smem + M::PB;
  float* const am = smem + M::AM;
  float* const da = smem + M::DA;
  float* const sc = smem + M::SC;
  float* const gc = smem + M::GC;
  float* const ff = smem + M::FF;
  float* const us = smem + M::US;
  float* const dus = smem + M::DU;
  float* const rsc = smem + M::RSC;
  float* const rq = smem + M::RQ;
  float* const kq = smem + M::KQ;
  float* const wp = smem + M::WP;

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int nc = n_chunks(t_len);
  const int blk = static_cast<int>(blockIdx.x);
  const int bh = blk / nc, c = blk % nc;
  const int h = bh % n_heads;
  const Rows rows(bh, t_len, n_heads, HD);
  const int t0 = c * L, n = min(L, t_len - t0);

  // Phase 0: the chunk's rows, u; then S_c and G_c, a second group of
  // copies that lands while phases 1 and 2 run.
  stage<HD, SR, NT>(rs, r, rows, t0, n, tid);
  stage<HD, SR, NT>(ks, k, rows, t0, n, tid);
  stage<HD, SR, NT>(vs, v, rows, t0, n, tid);
  stage<HD, SR, NT>(ws, w, rows, t0, n, tid);
  stage<HD, SR, NT>(ds, dout, rows, t0, n, tid);
  cp_async_commit();
  {
    const float* src_s = ck_s + static_cast<size_t>(blk) * HD * HD;
    const float* src_g = ck_g + static_cast<size_t>(blk) * HD * HD;
    for (int idx = tid; idx < HD * HD / 4; idx += NT) {
      const int row = idx / (HD / 4), c4 = 4 * (idx % (HD / 4));
      cp_async16(smem_addr(sc + row * SS + c4), src_s + row * HD + c4, true);
      cp_async16(smem_addr(gc + row * SS + c4), src_g + row * HD + c4, true);
    }
  }
  for (int i = tid; i < HD; i += NT) us[i] = u[h * HD + i];
  cp_async_commit();
  tf32::cp_async_wait<1>();   // the rows
  __syncthreads();
  pad_decays<HD, SR, NT>(ws, n, tid);
  __syncthreads();

  // Phase 1: per (channel, sub-block), pf_t = P(p..t-1) forward and pb_s =
  // P(s+1..e) backward by running products; the sub-block's total T_a is
  // F[a+1][a].  Then F[a][b] = F[a][b+1] T_b, F[a][a] = 1.
  for (int item = tid; item < 2 * NSUB * HD; item += NT) {
    const int ch = item % HD;
    const int a = (item / HD) % NSUB;
    float p = 1.0f;
    if (item < NSUB * HD) {
      for (int q = 0; q < SUB; ++q) {
        const int t = a * SUB + q;
        pf[t * SR + ch] = p;
        p *= ws[t * SR + ch];
      }
      ff[((a + 1) * NF + a) * HD + ch] = p;
    } else {
      for (int q = SUB - 1; q >= 0; --q) {
        const int t = a * SUB + q;
        pb[t * SR + ch] = p;
        p *= ws[t * SR + ch];
      }
    }
  }
  __syncthreads();
  for (int ch = tid; ch < HD; ch += NT) {
    for (int a = 0; a <= NSUB; ++a) ff[(a * NF + a) * HD + ch] = 1.0f;
    for (int a = 2; a <= NSUB; ++a)
      for (int b = a - 2; b >= 0; --b)
        ff[(a * NF + b) * HD + ch] = ff[(a * NF + b + 1) * HD + ch] * ff[((b + 1) * NF + b) * HD + ch];
  }
  __syncthreads();

  // Phase 2, tensor cores: dA on the 10 sub-block pairs (a, b <= a) and A
  // on the 6 pairs a > b, (r pf F[a][b+1]) (k pb)^T; 16 x 8 tiles.
  static_assert(NSUB == 4, "the pair numbering below lists four sub-blocks");
  for (int unit = warp; unit < 32; unit += WARPS) {
    const bool is_da = unit < 20;
    const int pr = is_da ? unit / 2 : (unit - 20) / 2;
    int a, b;
    if (is_da) {
      a = pr < 1 ? 0 : pr < 3 ? 1 : pr < 6 ? 2 : 3;
      b = pr - a * (a + 1) / 2;
    } else {
      a = pr < 1 ? 1 : pr < 3 ? 2 : 3;
      b = pr - a * (a - 1) / 2;
    }
    const int m0 = SUB * a, n0 = SUB * b + 8 * (unit % 2);
    float acc[4] = {}, corr[4] = {};
    if (is_da) {
#pragma unroll 4
      for (int k0 = 0; k0 < HD; k0 += 8) {
        const float* a0 = ds + (m0 + g) * SR + k0 + t4;
        const float af[4] = {a0[0], a0[8 * SR], a0[4], a0[8 * SR + 4]};
        const float* b0 = vs + (n0 + g) * SR + k0 + t4;
        mma_split<false, EXV>(acc, corr, af, b0[0], b0[4]);
      }
    } else {
      const float* fr = ff + (a * NF + b + 1) * HD;
#pragma unroll 4
      for (int k0 = 0; k0 < HD; k0 += 8) {
        const int o0 = (m0 + g) * SR + k0 + t4;
        const float f0 = fr[k0 + t4], f1 = fr[k0 + t4 + 4];
        const float af[4] = {rs[o0] * pf[o0] * f0, rs[o0 + 8 * SR] * pf[o0 + 8 * SR] * f0,
                             rs[o0 + 4] * pf[o0 + 4] * f1, rs[o0 + 8 * SR + 4] * pf[o0 + 8 * SR + 4] * f1};
        const int o1 = (n0 + g) * SR + k0 + t4;
        mma_split<false, false>(acc, corr, af, ks[o1] * pb[o1], ks[o1 + 4] * pb[o1 + 4]);
      }
    }
    float* out = is_da ? da : am;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[(m0 + g + 8 * (q / 2)) * SL + n0 + 2 * t4 + q % 2] = acc[q] + corr[q];
  }
  // Phase 2, CUDA cores: A inside each sub-block, a warp a row t (spread
  // over the rows' positions): lane l's channels l, l + 32, ... of
  // r_t . (k_s P(s+1..t-1)) for the earlier keys s of t's sub-block, as q =
  // r_t P(s+1..t-1) runs down, the bonus r_t . (u k_t) on the diagonal and
  // zeros above it, summed over the lanes in one reduce-scatter.
  {
    constexpr int CPL = (HD + 31) / 32;   // channels per lane
    static_assert(SUB == 16, "reduce16 sums 16 keys");
    for (int idx = warp; idx < L; idx += WARPS) {
      const int t = (idx % NSUB) * SUB + idx / NSUB;
      const int lt = t % SUB, p0 = t - lt;
      float q[CPL], part[SUB];
      float bonus = 0.0f;
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc) {
        const int i = lane + 32 * cc;
        q[cc] = i < HD ? rs[t * SR + i] : 0.0f;
        if (i < HD) bonus = fmaf(q[cc] * us[i], ks[t * SR + i], bonus);
      }
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        float x = 0.0f;
        if (j < lt) {
#pragma unroll
          for (int cc = 0; cc < CPL; ++cc) {
            const int i = lane + 32 * cc;
            if (i < HD) {
              x = fmaf(q[cc], ks[(p0 + j) * SR + i], x);
              q[cc] *= ws[(p0 + j) * SR + i];
            }
          }
        }
        part[j] = j == lt ? bonus : x;
      }
      const float sum = reduce16(part, lane);
      if (lane % 2 == 0) am[t * SL + p0 + lane / 2] = sum;
    }
  }
  cp_async_wait_all();   // S_c and G_c
  __syncthreads();

  // Phase 3, tensor cores: each warp takes a (sub-block a, 8 NTW columns)
  // unit (two at hd 8) and forms its tiles of dv (written out), and of D =
  // S^a dout and E = G^a v (kept), S^a the state before sub-block a and G^a
  // its gradient after it:
  //   D = F[a][0] (dout S_c^T) + sum_{b<a} F[a][b+1] (dA_ab (k pb)_b),
  //   E = F[NSUB][a+1] (v G_c^T) + sum_{c>a} F[c][a+1] (dA_ca^T (r pf)_c),
  // each product on its own accumulators, so that dw's column sums can
  // weigh them apart.  The A fragments are split once for the unit's tiles.
  for (int ch = tid; ch < HD; ch += NT) {
    float acc = 0.0f;
    for (int j = 0; j < HD; ++j) acc = fmaf(sc[ch * SS + j], gc[ch * SS + j], acc);
    rsc[ch] = acc;
  }
  constexpr int NTW = HD >= 16 ? 2 : 1;       // 8-column tiles a unit spans
  constexpr int CG = HD / (8 * NTW);          // units across the columns
  constexpr int UPW = NSUB * CG / WARPS;      // units a warp
  static_assert(UPW * WARPS == NSUB * CG, "whole units a warp");
  // Sum over the unit's 16 rows of x times the weights wa * wb (R^ = r pf or
  // K^ = k pb), per column, into dst[col] (lanes g = 0 write).
  auto col_sum = [&](float* dst, const float (&x)[NTW][4], const float* wa, const float* wb, int m0, int n0) {
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int col = n0 + 8 * nt + 2 * t4 + hc;
        const int lo = (m0 + g) * SR + col, hi = lo + 8 * SR;
        float y = fmaf(x[nt][hc], wa[lo] * wb[lo], x[nt][hc + 2] * (wa[hi] * wb[hi]));
#pragma unroll
        for (int off = 4; off < 32; off *= 2) y += __shfl_xor_sync(0xffffffffu, y, off);
        if (g == 0) dst[col] = y;
      }
  };
  float keep_d[UPW][NTW][4], keep_e[UPW][NTW][4];
#pragma unroll
  for (int m = 0; m < UPW; ++m) {
    const int unit = warp + m * WARPS;
    const int a = unit / CG, n0 = 8 * NTW * (unit % CG);
    const int m0 = SUB * a;
    {   // dv rows s of sub-block a: A^T dout over t >= s, then (k pb F[NSUB][a+1]) G_c.
      float acc[NTW][4] = {}, corr[NTW][4] = {};
#pragma unroll 2
      for (int k0 = m0; k0 < L; k0 += 8) {
        const float* a0 = am + (k0 + t4) * SL + m0 + g;
        const Frag<false> fa({a0[0], a0[8], a0[4 * SL], a0[4 * SL + 8]});
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const float* b0 = ds + (k0 + t4) * SR + n0 + 8 * nt + g;
          mma_frag<false, false>(acc[nt], corr[nt], fa, b0[0], b0[4 * SR]);
        }
      }
      const float* fk = ff + (NSUB * NF + a + 1) * HD;
#pragma unroll 2
      for (int k0 = 0; k0 < HD; k0 += 8) {
        const int o0 = (m0 + g) * SR + k0 + t4;
        const float f0 = fk[k0 + t4], f1 = fk[k0 + t4 + 4];
        const Frag<false> fa({ks[o0] * pb[o0] * f0, ks[o0 + 8 * SR] * pb[o0 + 8 * SR] * f0,
                              ks[o0 + 4] * pb[o0 + 4] * f1, ks[o0 + 8 * SR + 4] * pb[o0 + 8 * SR + 4] * f1});
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt) {
          const float* b0 = gc + (k0 + t4) * SS + n0 + 8 * nt + g;
          mma_frag<false, false>(acc[nt], corr[nt], fa, b0[0], b0[4 * SS]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int row = m0 + g + 8 * (q / 2);
          if (row < n) store_f32(dv + rows.at(t0 + row) + n0 + 8 * nt + 2 * t4 + q % 2, acc[nt][q] + corr[nt][q]);
        }
    }
    {   // D rows t of sub-block a, each product folded in as it completes.
      float d[NTW][4];
      {
        float acc[NTW][4] = {}, corr[NTW][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float* a0 = ds + (m0 + g) * SR + k0 + t4;
          const Frag<false> fa({a0[0], a0[8 * SR], a0[4], a0[8 * SR + 4]});
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const float* b0 = sc + (n0 + 8 * nt + g) * SS + k0 + t4;
            mma_frag<false, false>(acc[nt], corr[nt], fa, b0[0], b0[4]);
          }
        }
        float x[NTW][4];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[nt][q] = acc[nt][q] + corr[nt][q];
            d[nt][q] = ff[(a * NF) * HD + n0 + 8 * nt + 2 * t4 + q % 2] * x[nt][q];
          }
        col_sum(rq + a * HD, x, rs, pf, m0, n0);
      }
#pragma unroll
      for (int b = 0; b < NSUB - 1; ++b) {
        if (b < a) {
          float acc[NTW][4] = {}, corr[NTW][4] = {};
#pragma unroll
          for (int k0 = SUB * b; k0 < SUB * (b + 1); k0 += 8) {
            const float* a0 = da + (m0 + g) * SL + k0 + t4;
            const Frag<false> fa({a0[0], a0[8 * SL], a0[4], a0[8 * SL + 4]});
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              const int o1 = (k0 + t4) * SR + n0 + 8 * nt + g;
              mma_frag<false, false>(acc[nt], corr[nt], fa, ks[o1] * pb[o1], ks[o1 + 4 * SR] * pb[o1 + 4 * SR]);
            }
          }
          float x[NTW][4];
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              x[nt][q] = acc[nt][q] + corr[nt][q];
              d[nt][q] = fmaf(ff[(a * NF + b + 1) * HD + n0 + 8 * nt + 2 * t4 + q % 2], x[nt][q], d[nt][q]);
            }
          if (b + 2 <= a) col_sum(wp + pair_index(a, b) * HD, x, rs, pf, m0, n0);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep_d[m][nt][q] = d[nt][q];
    }
    {   // E rows s of sub-block a, likewise.
      float e[NTW][4];
      {
        float acc[NTW][4] = {}, corr[NTW][4] = {};
#pragma unroll 2
        for (int k0 = 0; k0 < HD; k0 += 8) {
          const float* a0 = vs + (m0 + g) * SR + k0 + t4;
          const Frag<EXV> fa({a0[0], a0[8 * SR], a0[4], a0[8 * SR + 4]});
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            const float* b0 = gc + (n0 + 8 * nt + g) * SS + k0 + t4;
            mma_frag<EXV, false>(acc[nt], corr[nt], fa, b0[0], b0[4]);
          }
        }
        float x[NTW][4];
#pragma unroll
        for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            x[nt][q] = acc[nt][q] + corr[nt][q];
            e[nt][q] = ff[(NSUB * NF + a + 1) * HD + n0 + 8 * nt + 2 * t4 + q % 2] * x[nt][q];
          }
        col_sum(kq + a * HD, x, ks, pb, m0, n0);
      }
#pragma unroll
      for (int cc = 1; cc < NSUB; ++cc) {
        if (cc > a) {
          float acc[NTW][4] = {}, corr[NTW][4] = {};
#pragma unroll
          for (int k0 = SUB * cc; k0 < SUB * (cc + 1); k0 += 8) {
            const float* a0 = da + (k0 + t4) * SL + m0 + g;
            const Frag<false> fa({a0[0], a0[8], a0[4 * SL], a0[4 * SL + 8]});
#pragma unroll
            for (int nt = 0; nt < NTW; ++nt) {
              const int o1 = (k0 + t4) * SR + n0 + 8 * nt + g;
              mma_frag<false, false>(acc[nt], corr[nt], fa, rs[o1] * pf[o1], rs[o1 + 4 * SR] * pf[o1 + 4 * SR]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              e[nt][q] = fmaf(ff[(cc * NF + a + 1) * HD + n0 + 8 * nt + 2 * t4 + q % 2], acc[nt][q] + corr[nt][q],
                              e[nt][q]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) keep_e[m][nt][q] = e[nt][q];
    }
  }
  __syncthreads();   // dout and v are read for the last time above: D and E go there
#pragma unroll
  for (int m = 0; m < UPW; ++m) {
    const int unit = warp + m * WARPS;
    const int m0 = SUB * (unit / CG), n0 = 8 * NTW * (unit % CG);
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int o = (m0 + g + 8 * (q / 2)) * SR + n0 + 8 * nt + 2 * t4 + q % 2;
        ds[o] = keep_d[m][nt][q];
        vs[o] = keep_e[m][nt][q];
      }
  }
  __syncthreads();

  // Phase 4, CUDA cores, thread (channel, sub-block a, half), the sub-block's
  // r, k, w of the channel in registers.  Half 0: dr = pf D + the pairs
  // inside the sub-block by running products of w + the bonus, dk = pb E +
  // pairs + bonus, du's part r_t k_t (v_t . dout_t), and dw's terms through
  // S^a and G^a: pf_t pb_t rowsum(S^a * G^a) + pf_t sum_{s>t} P(t+1..s-1)
  // r_s D_s + pb_t sum_{s<t} P(s+1..t-1) k_s E_s (into A's place).  Half 1:
  // dw's pairs s < t < s' inside the sub-block, then dw out.
  {
    const int ch = tid % HD, a = (tid / HD) % NSUB;
    const bool first = tid < NSUB * HD;
    const int p0 = a * SUB;
    float rr[SUB], wv[SUB];
#pragma unroll
    for (int q = 0; q < SUB; ++q) {
      rr[q] = rs[(p0 + q) * SR + ch];
      wv[q] = ws[(p0 + q) * SR + ch];
    }
    float* const dw_part = am;
    float inner[SUB];
    if (first) {
      float kk[SUB];
#pragma unroll
      for (int q = 0; q < SUB; ++q) kk[q] = ks[(p0 + q) * SR + ch];
      const float ui = us[ch];
      float du_acc = 0.0f;
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int t = p0 + q;
        const float vd = da[t * SL + t];
        float acc_r = fmaf(ui * kk[q], vd, pf[t * SR + ch] * ds[t * SR + ch]);
        float acc_k = fmaf(rr[q] * ui, vd, pb[t * SR + ch] * vs[t * SR + ch]);
        du_acc = fmaf(rr[q] * kk[q], vd, du_acc);
        float p = 1.0f;
#pragma unroll
        for (int q2 = q - 1; q2 >= 0; --q2) {
          acc_r = fmaf(da[t * SL + p0 + q2] * kk[q2], p, acc_r);
          p *= wv[q2];
        }
        p = 1.0f;
#pragma unroll
        for (int q2 = q + 1; q2 < SUB; ++q2) {
          acc_k = fmaf(da[(p0 + q2) * SL + t] * rr[q2], p, acc_k);
          p *= wv[q2];
        }
        if (t < n) {
          store_f32(dr + rows.at(t0 + t) + ch, acc_r);
          store_f32(dk + rows.at(t0 + t) + ch, acc_k);
        }
      }
      dus[a * HD + ch] = du_acc;
      // rowsum(S^a * G^a) from its sources: S_c and the keys of earlier
      // sub-blocks, G_c and the queries of later ones.
      const float fa0 = ff[(a * NF) * HD + ch], fna = ff[(NSUB * NF + a + 1) * HD + ch];
      float rs_a = fa0 * fna * rsc[ch];
      for (int cc = a + 1; cc < NSUB; ++cc) rs_a = fmaf(fa0 * ff[(cc * NF + a + 1) * HD + ch], rq[cc * HD + ch], rs_a);
      for (int b = 0; b < a; ++b) {
        const float fab = ff[(a * NF + b + 1) * HD + ch];
        rs_a = fmaf(fna * fab, kq[b * HD + ch], rs_a);
        for (int cc = a + 1; cc < NSUB; ++cc)
          rs_a = fmaf(fab * ff[(cc * NF + a + 1) * HD + ch], wp[pair_index(cc, b) * HD + ch], rs_a);
      }
      float z = 0.0f;
#pragma unroll
      for (int q = SUB - 1; q >= 0; --q) {
        const int t = p0 + q;
        const float pft = pf[t * SR + ch];
        dw_part[t * SL + ch] = pft * fmaf(pb[t * SR + ch], rs_a, z);
        z = fmaf(wv[q], z, rr[q] * ds[t * SR + ch]);
      }
      z = 0.0f;
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int t = p0 + q;
        dw_part[t * SL + ch] = fmaf(pb[t * SR + ch], z, dw_part[t * SL + ch]);
        z = fmaf(wv[q], z, kk[q] * vs[t * SR + ch]);
      }
    } else {
      // mk[q2] = sum_{s<t} P(s+1..t-1) k_s dA[s'][s] for the later s' = p0 + q2.
      float mk[SUB] = {};
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int t = p0 + q;
        float x = 0.0f, p = 1.0f;
#pragma unroll
        for (int q2 = q + 1; q2 < SUB; ++q2) {
          x = fmaf(p * rr[q2], mk[q2], x);
          p *= wv[q2];
        }
        inner[q] = x;
        const float kt = ks[t * SR + ch];
#pragma unroll
        for (int q2 = q + 1; q2 < SUB; ++q2) mk[q2] = fmaf(wv[q], mk[q2], kt * da[(p0 + q2) * SL + t]);
      }
    }
    __syncthreads();
    if (!first) {
#pragma unroll
      for (int q = 0; q < SUB; ++q) {
        const int t = p0 + q;
        if (t < n) store_f32(dw + rows.at(t0 + t) + ch, inner[q] + dw_part[t * SL + ch]);
      }
    }
  }
  __syncthreads();
  for (int ch = tid; ch < HD; ch += NT) {
    float sum = 0.0f;
    for (int a = 0; a < NSUB; ++a) sum += dus[a * HD + ch];
    du_part[static_cast<size_t>(blk) * HD + ch] = sum;
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

struct Args {
  const void *r, *k, *v, *w;
  const float *u, *state0, *dout, *dfinal;
  void *dr, *dk, *dv, *dw;
  float *du_part, *dstate, *ckpt;
  int b, t, h;
};

template <typename TR, typename TW, int HD>
int launch(const Args& a, cudaStream_t stream) {
  // cp.async and the scan's float4 copies take 16-byte-aligned operands (the
  // wrapper checks this too).
  for (const void* ptr : {a.r, a.k, a.v, a.w, static_cast<const void*>(a.dout),
                          static_cast<const void*>(a.state0), static_cast<const void*>(a.dfinal)})
    if (reinterpret_cast<uintptr_t>(ptr) % 16) return static_cast<int>(cudaErrorMisalignedAddress);
  const TR* r = static_cast<const TR*>(a.r);
  const TR* k = static_cast<const TR*>(a.k);
  const TR* v = static_cast<const TR*>(a.v);
  const TW* w = static_cast<const TW*>(a.w);
  const int nc = (a.t + L - 1) / L;
  const int blocks = a.b * a.h * nc;
  float* const ck_s = a.ckpt;
  float* const ck_g = ck_s + static_cast<size_t>(blocks) * HD * HD;
  float* const decay = ck_g + static_cast<size_t>(blocks) * HD * HD;
  static unsigned sums_cfg = 0, grads_cfg = 0;

  cudaError_t err = allow_dynamic_smem(reinterpret_cast<const void*>(sums_kernel<TR, TW, HD>),
                                       SumsSmem<HD>::BYTES, sums_cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  sums_kernel<TR, TW, HD><<<blocks, SumsSmem<HD>::THREADS, SumsSmem<HD>::BYTES, stream>>>(
      r, k, v, w, a.dout, ck_s, ck_g, decay, a.t, a.h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int scan_items = a.b * a.h * HD * HD / 4;
  scan_kernel<<<(scan_items + SCAN_THREADS - 1) / SCAN_THREADS, SCAN_THREADS, 0, stream>>>(
      ck_s, ck_g, decay, a.state0, a.dfinal, a.dstate, a.b * a.h, nc, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = allow_dynamic_smem(reinterpret_cast<const void*>(grads_kernel<TR, TW, HD>), GradsSmem<HD>::BYTES,
                           grads_cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  grads_kernel<TR, TW, HD><<<blocks, GradsSmem<HD>::THREADS, GradsSmem<HD>::BYTES, stream>>>(
      r, k, v, w, a.u, a.dout, ck_s, ck_g, static_cast<TR*>(a.dr), static_cast<TR*>(a.dk),
      static_cast<TR*>(a.dv), static_cast<TW*>(a.dw), a.du_part, a.t, a.h);
  return static_cast<int>(cudaGetLastError());
}

template <typename TR, typename TW>
int dispatch(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<TR, TW, 8>(a, stream);
    case 16: return launch<TR, TW, 16>(a, stream);
    case 32: return launch<TR, TW, 32>(a, stream);
    case 64: return launch<TR, TW, 64>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int HD>
int smem_bytes(int kernel) {
  switch (kernel) {
    case 0: return static_cast<int>(SumsSmem<HD>::BYTES);
    case 1: return static_cast<int>(GradsSmem<HD>::BYTES);
    default: return 0;
  }
}

}  // namespace

// The gradient of wkv6 (see the note at the top).  `ckpt` is float32
// scratch of 2 b h ceil(t / L) hd^2 + b h ceil(t / L) hd floats (the
// checkpoints of S and G and the chunks' total decays); `du_part` is
// float32 (b, h, ceil(t / L), hd); `state0` and `dfinal` may be null
// (zero); `dstate` may be null (not written).  rkv_bf16 and w_bf16 pick
// bfloat16 (1) or float32 (0) for r, k, v (and dr, dk, dv) and for w (and
// dw).  Launches on `stream` without synchronising and returns the CUDA
// error of the launches (0 when they were accepted).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* state0, const void* dout, const void* dfinal,
                        void* dr, void* dk, void* dv, void* dw, void* du_part, void* dstate,
                        void* ckpt, int b, int t, int h, int hd, int rkv_bf16, int w_bf16,
                        void* stream) {
  const Args a{r, k, v, w,
               static_cast<const float*>(u), static_cast<const float*>(state0),
               static_cast<const float*>(dout), static_cast<const float*>(dfinal),
               dr, dk, dv, dw,
               static_cast<float*>(du_part), static_cast<float*>(dstate), static_cast<float*>(ckpt),
               b, t, h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rkv_bf16) {
    if (w_bf16) return dispatch<__nv_bfloat16, __nv_bfloat16>(a, hd, st);
    return dispatch<__nv_bfloat16, float>(a, hd, st);
  }
  if (w_bf16) return dispatch<float, __nv_bfloat16>(a, hd, st);
  return dispatch<float, float>(a, hd, st);
}

// Dynamic shared memory in bytes of sums_kernel (kernel 0) and grads_kernel
// (1) at head size hd (0 for an hd or kernel there is not; scan_kernel
// takes none).
extern "C" int wkv6_bwd_smem(int hd, int kernel) {
  switch (hd) {
    case 8: return smem_bytes<8>(kernel);
    case 16: return smem_bytes<16>(kernel);
    case 32: return smem_bytes<32>(kernel);
    case 64: return smem_bytes<64>(kernel);
    default: return 0;
  }
}
