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
// w's; du is written as float32 partials (B, H, hd), one per (b, h), which
// the wrapper sums over b; d(state) is float32.  hd is 8, 16, 32 or 64.
//
// Three kernels, launched in this order on one stream:
//
//  - states_kernel runs the forward recurrence from the initial state and
//    writes S at the start of every chunk of CH tokens into a float32
//    scratch (B, H, ceil(T / CH), hd, hd): the checkpoints.
//  - dv_kernel walks T in reverse with G in registers, a state column per
//    G threads (the forward kernel's layout), and writes dv: the sum over
//    i is in-thread plus two shuffles.  It needs only G, not S.
//  - drkw_kernel walks the chunks in reverse with G in registers, a state
//    row per G threads, so the sums over j (dr, dk, dw and v_t . dout_t)
//    are in-thread plus two shuffles.  For each chunk it reloads the checkpoint, runs the
//    chunk forward keeping S at the start of every sub-chunk of SUB tokens
//    in shared memory (each thread its own elements, so no barrier), then
//    walks the sub-chunks in reverse: S before each of the sub-chunk's SUB
//    tokens is rebuilt forward into registers, and the tokens are walked
//    in reverse against G.  It also writes the du partials and d(state).
//
// The traps this design keeps out:
//  - No un-decaying.  S_{t-1} is never recovered from S_t (that divides by
//    w_t, and w = 0 is legal): it is rebuilt forward from a checkpoint.
//  - dw directly, as sum_j G_t[i,j] S_{t-1}[i,j] (no d(log w) / w, no
//    difference of suffix sums), so w = 0 gives a finite dw.  Every factor
//    is a w_t in [0, 1]: S and G are carried by multiplying by w.
//  - Determinism.  No atomics: every sum is taken in a fixed order, so two
//    calls give the same bits.
//
// What bounds it.  At rwkv6-7b's train shape (B = 2, T = 2048, H = 64,
// hd = 64, float32) a call reads r, k, v, w and dout and writes dr, dk, dv
// and dw: 0.60 GB, 0.18 ms at 3.35 TB/s (the checkpoints add 0.13 GB each
// way).  The function needs 14 hd^2 operations per token and head (four
// sums of products, 2 hd^2 each; G's update and S rebuilt forward, 3 hd^2
// each): 15 GFLOP, 0.22 ms at the 67 TFLOP/s of the CUDA cores' float32
// FMA, so the bound is the operations.  This design rebuilds S twice and
// carries G twice, and its serial chain (T dependent steps per block, one
// block per (b, h): B * H = 128 blocks on 132 SMs, 8 warps an SM) keeps it
// far above the bound: 2.8 ms a call on an H100 80GB HBM3 at 700 W
// (chip_smoke.py).  The tensor-core, chunk-parallel form is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int G = 4;      // threads per state row (drkw, states) or column (dv)
constexpr int CH = 32;    // tokens per chunk: a checkpoint every CH tokens
constexpr int SUB = 4;    // tokens per sub-chunk, rebuilt into registers
static_assert(CH % SUB == 0, "a chunk is a whole number of sub-chunks");

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

__device__ constexpr int n_chunks(int t_len) { return (t_len + CH - 1) / CH; }

// Copies tokens t0 .. t0 + n - 1 of (b, h)'s rows of `src` into dst[CH][HD]
// as float32; rows n .. CH - 1 are zeroed.
template <int HD, int THREADS, typename T>
__device__ void stage(float (*dst)[HD], const T* __restrict__ src, const Rows& rows, int t0, int n) {
  for (int idx = threadIdx.x; idx < CH * HD; idx += THREADS) {
    const int t = idx / HD;
    const int c = idx % HD;
    dst[t][c] = t < n ? load_f32(src + rows.at(t0 + t) + c) : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// Checkpoints: S before tokens 0, CH, 2 CH, ... (thread (i, g) holds row i,
// columns g, g + G, ...).
// ---------------------------------------------------------------------------
template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(G * HD, 1)
states_kernel(const TR* __restrict__ k, const TR* __restrict__ v, const TW* __restrict__ w,
              const float* __restrict__ state0, float* __restrict__ ckpt, int t_len, int n_heads) {
  constexpr int THREADS = G * HD;
  constexpr int R = HD / G;
  __shared__ float k_s[CH][HD];
  __shared__ float v_s[CH][HD];
  __shared__ float w_s[CH][HD];

  const int tid = threadIdx.x;
  const int i = tid / G;
  const int g = tid % G;
  const int bh = blockIdx.x;
  const Rows rows(bh, t_len, n_heads, HD);
  const int nc = n_chunks(t_len);
  const size_t s_base = static_cast<size_t>(bh) * HD * HD + static_cast<size_t>(i) * HD + g;
  float* out = ckpt + static_cast<size_t>(bh) * nc * HD * HD + static_cast<size_t>(i) * HD + g;

  float st[R];
#pragma unroll
  for (int jj = 0; jj < R; ++jj) st[jj] = state0 ? state0[s_base + G * jj] : 0.0f;

  for (int c = 0; c < nc; ++c) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj) out[static_cast<size_t>(c) * HD * HD + G * jj] = st[jj];
    if (c == nc - 1) break;   // the last chunk's own tokens are not needed
    __syncthreads();   // the previous chunk's rows are consumed
    stage<HD, THREADS>(k_s, k, rows, c * CH, CH);
    stage<HD, THREADS>(v_s, v, rows, c * CH, CH);
    stage<HD, THREADS>(w_s, w, rows, c * CH, CH);
    __syncthreads();
    for (int t = 0; t < CH; ++t) {
      const float wi = w_s[t][i];
      const float ki = k_s[t][i];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) st[jj] = fmaf(wi, st[jj], ki * v_s[t][g + G * jj]);
    }
  }
}

// ---------------------------------------------------------------------------
// dv: G carried backward column by column (thread (j, g) holds column j,
// rows g, g + G, ...).
// ---------------------------------------------------------------------------
template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(G * HD, 1)
dv_kernel(const TR* __restrict__ r, const TR* __restrict__ k, const TW* __restrict__ w,
          const float* __restrict__ u, const float* __restrict__ dout,
          const float* __restrict__ dfinal, TR* __restrict__ dv, int t_len, int n_heads) {
  constexpr int THREADS = G * HD;
  constexpr int R = HD / G;
  __shared__ float r_s[CH][HD];
  __shared__ float k_s[CH][HD];
  __shared__ float w_s[CH][HD];
  __shared__ float d_s[CH][HD];

  const int tid = threadIdx.x;
  const int j = tid / G;
  const int g = tid % G;
  const int bh = blockIdx.x;
  const int h = bh % n_heads;
  const Rows rows(bh, t_len, n_heads, HD);
  const size_t s_base = static_cast<size_t>(bh) * HD * HD;

  float gs[R];
  float us[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    gs[ii] = dfinal ? dfinal[s_base + static_cast<size_t>(g + G * ii) * HD + j] : 0.0f;
    us[ii] = u[h * HD + g + G * ii];
  }

  for (int c = n_chunks(t_len) - 1; c >= 0; --c) {
    const int t0 = c * CH;
    const int n = min(CH, t_len - t0);
    __syncthreads();   // the previous chunk's rows are consumed
    stage<HD, THREADS>(r_s, r, rows, t0, n);
    stage<HD, THREADS>(k_s, k, rows, t0, n);
    stage<HD, THREADS>(w_s, w, rows, t0, n);
    stage<HD, THREADS>(d_s, dout, rows, t0, n);
    __syncthreads();
    for (int t = n - 1; t >= 0; --t) {
      const float dj = d_s[t][j];
      // dv_t[j] = sum_i k_t[i] (G_t[i,j] + r_t[i] u[i] dout_t[j]): the bonus
      // term folded into the column sum.
      float part = 0.0f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = g + G * ii;
        const float ri = r_s[t][i];
        part = fmaf(k_s[t][i], fmaf(ri * us[ii], dj, gs[ii]), part);   // G_t, before the update
        gs[ii] = fmaf(w_s[t][i], gs[ii], ri * dj);                     // G_{t-1}
      }
      // The G row groups of column j are neighbouring lanes of one warp.
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      if (g == 0) store_f32(dv + rows.at(t0 + t) + j, part);
    }
  }
}

// ---------------------------------------------------------------------------
// dr, dk, dw, du, d(state): G carried backward row by row (thread (i, g)
// holds row i, columns g, g + G, ...), S rebuilt forward from the
// checkpoints.
// ---------------------------------------------------------------------------
template <int HD>
struct DrkwSmem {
  static constexpr int R = HD / G;
  static constexpr int THREADS = G * HD;
  // S at each sub-chunk's start, [CH / SUB][R][THREADS]: each thread's own
  // elements, side by side across threads.
  static constexpr size_t SUB_FLOATS = static_cast<size_t>(CH / SUB) * R * THREADS;
  // r, k, v, w, dout of the chunk, [CH][HD] each.
  static constexpr size_t FLOATS = SUB_FLOATS + 5 * CH * HD;
  static constexpr size_t BYTES = FLOATS * sizeof(float);
};

template <typename TR, typename TW, int HD>
__global__ void __launch_bounds__(G * HD, 1)
drkw_kernel(const TR* __restrict__ r, const TR* __restrict__ k, const TR* __restrict__ v,
            const TW* __restrict__ w, const float* __restrict__ u, const float* __restrict__ dout,
            const float* __restrict__ dfinal, const float* __restrict__ ckpt,
            TR* __restrict__ dr, TR* __restrict__ dk, TW* __restrict__ dw,
            float* __restrict__ du_part, float* __restrict__ dstate, int t_len, int n_heads) {
  using Smem = DrkwSmem<HD>;
  constexpr int THREADS = Smem::THREADS;
  constexpr int R = Smem::R;
  extern __shared__ float smem[];
  float* sub = smem;
  float (*r_s)[HD] = reinterpret_cast<float (*)[HD]>(smem + Smem::SUB_FLOATS);
  float (*k_s)[HD] = r_s + CH;
  float (*v_s)[HD] = k_s + CH;
  float (*w_s)[HD] = v_s + CH;
  float (*d_s)[HD] = w_s + CH;

  const int tid = threadIdx.x;
  const int i = tid / G;
  const int g = tid % G;
  const int bh = blockIdx.x;
  const int h = bh % n_heads;
  const Rows rows(bh, t_len, n_heads, HD);
  const int nc = n_chunks(t_len);
  const size_t s_row = static_cast<size_t>(bh) * HD * HD + static_cast<size_t>(i) * HD + g;
  const float ui = u[h * HD + i];

  float gs[R];
#pragma unroll
  for (int jj = 0; jj < R; ++jj) gs[jj] = dfinal ? dfinal[s_row + G * jj] : 0.0f;
  float du_acc = 0.0f;

  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * CH;
    const int n = min(CH, t_len - t0);
    __syncthreads();   // the previous chunk's rows are consumed
    stage<HD, THREADS>(r_s, r, rows, t0, n);
    stage<HD, THREADS>(k_s, k, rows, t0, n);
    stage<HD, THREADS>(v_s, v, rows, t0, n);
    stage<HD, THREADS>(w_s, w, rows, t0, n);
    stage<HD, THREADS>(d_s, dout, rows, t0, n);
    float st[R];
    const float* ck = ckpt + (static_cast<size_t>(bh) * nc + c) * HD * HD +
                      static_cast<size_t>(i) * HD + g;
#pragma unroll
    for (int jj = 0; jj < R; ++jj) st[jj] = ck[G * jj];
    __syncthreads();
    // Forward through the chunk, keeping S at each sub-chunk's start.
    for (int t = 0; t < n; ++t) {
      if (t % SUB == 0) {
#pragma unroll
        for (int jj = 0; jj < R; ++jj) sub[((t / SUB) * R + jj) * THREADS + tid] = st[jj];
      }
      const float wi = w_s[t][i];
      const float ki = k_s[t][i];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) st[jj] = fmaf(wi, st[jj], ki * v_s[t][g + G * jj]);
    }

    for (int q = (n - 1) / SUB; q >= 0; --q) {
      const int s0 = q * SUB;
      // ss[s] = S before token s0 + s (rows past n are zero: harmless).
      float ss[SUB][R];
#pragma unroll
      for (int jj = 0; jj < R; ++jj) ss[0][jj] = sub[(q * R + jj) * THREADS + tid];
#pragma unroll
      for (int s = 1; s < SUB; ++s) {
        const float wi = w_s[s0 + s - 1][i];
        const float ki = k_s[s0 + s - 1][i];
#pragma unroll
        for (int jj = 0; jj < R; ++jj)
          ss[s][jj] = fmaf(wi, ss[s - 1][jj], ki * v_s[s0 + s - 1][g + G * jj]);
      }
#pragma unroll
      for (int s = SUB - 1; s >= 0; --s) {
        const int t = s0 + s;
        if (t < n) {   // uniform over the block
          const float ri = r_s[t][i];
          const float ki = k_s[t][i];
          const float wi = w_s[t][i];
          float a_r = 0.0f, a_k = 0.0f, a_w = 0.0f, vd = 0.0f;
#pragma unroll
          for (int jj = 0; jj < R; ++jj) {
            const float dj = d_s[t][g + G * jj];
            const float vj = v_s[t][g + G * jj];
            a_r = fmaf(ss[s][jj], dj, a_r);
            a_k = fmaf(gs[jj], vj, a_k);
            a_w = fmaf(gs[jj], ss[s][jj], a_w);
            vd = fmaf(vj, dj, vd);
            gs[jj] = fmaf(wi, gs[jj], ri * dj);   // G_{t-1}
          }
          // The G column groups of row i are neighbouring lanes of one warp;
          // each of them ends with the whole sums (vd = v_t . dout_t).
#pragma unroll
          for (int off = 1; off < G; off *= 2) {
            a_r += __shfl_xor_sync(0xffffffffu, a_r, off);
            a_k += __shfl_xor_sync(0xffffffffu, a_k, off);
            a_w += __shfl_xor_sync(0xffffffffu, a_w, off);
            vd += __shfl_xor_sync(0xffffffffu, vd, off);
          }
          const size_t at = rows.at(t0 + t) + i;
          if (g == 0) store_f32(dr + at, fmaf(ui * ki, vd, a_r));
          else if (g == 1) store_f32(dk + at, fmaf(ri * ui, vd, a_k));
          else if (g == 2) store_f32(dw + at, a_w);
          du_acc = fmaf(ri * ki, vd, du_acc);
        }
      }
    }
  }

  if (dstate) {
#pragma unroll
    for (int jj = 0; jj < R; ++jj) dstate[s_row + G * jj] = gs[jj];
  }
  if (g == 0) du_part[static_cast<size_t>(bh) * HD + i] = du_acc;
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
  const TR* r = static_cast<const TR*>(a.r);
  const TR* k = static_cast<const TR*>(a.k);
  const TR* v = static_cast<const TR*>(a.v);
  const TW* w = static_cast<const TW*>(a.w);
  const int blocks = a.b * a.h;
  states_kernel<TR, TW, HD><<<blocks, G * HD, 0, stream>>>(k, v, w, a.state0, a.ckpt, a.t, a.h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dv_kernel<TR, TW, HD><<<blocks, G * HD, 0, stream>>>(
      r, k, w, a.u, a.dout, a.dfinal, static_cast<TR*>(a.dv), a.t, a.h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = DrkwSmem<HD>::BYTES;
  static unsigned configured = 0;
  err = allow_dynamic_smem(reinterpret_cast<const void*>(drkw_kernel<TR, TW, HD>), smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  drkw_kernel<TR, TW, HD><<<blocks, G * HD, smem, stream>>>(
      r, k, v, w, a.u, a.dout, a.dfinal, a.ckpt, static_cast<TR*>(a.dr), static_cast<TR*>(a.dk),
      static_cast<TW*>(a.dw), a.du_part, a.dstate, a.t, a.h);
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

}  // namespace

// The gradient of wkv6 (see the note at the top).  `ckpt` is float32
// scratch of (b, h, ceil(t / CH), hd, hd); `state0` and `dfinal` may
// be null (zero); `dstate` may be null (not written).  rkv_bf16 and w_bf16
// pick bfloat16 (1) or float32 (0) for r, k, v (and dr, dk, dv) and for w
// (and dw).  Launches on `stream` without synchronising and returns the
// CUDA error of the launches (0 when they were accepted).
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

// Dynamic shared memory of drkw_kernel at head size hd, in bytes (0 for an
// hd the kernels do not take).
extern "C" int wkv6_bwd_smem(int hd) {
  switch (hd) {
    case 8: return static_cast<int>(DrkwSmem<8>::BYTES);
    case 16: return static_cast<int>(DrkwSmem<16>::BYTES);
    case 32: return static_cast<int>(DrkwSmem<32>::BYTES);
    case 64: return static_cast<int>(DrkwSmem<64>::BYTES);
    default: return 0;
  }
}
