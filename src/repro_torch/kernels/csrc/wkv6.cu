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
// float32, S[i][j] with i over k and j over v.
//
// Design.  The TPU kernel turns each chunk into (L x hd) matrix products
// through cumulative decays exp(+-sum log w), which bounds the chunk length
// by float32's range (chunk * |log w| < ~88; RWKV6's w_t = exp(-exp(.))
// gives |log w| of 1-2 per token at full width, so 128-token chunks
// overflow).  This kernel takes neither that closed form nor its pairwise
// variant: it steps the recurrence token by token, multiplying by w_t in
// (0, 1) each step, so it is stable at any length and needs no guard.  The
// recurrence is parallel over the state's columns: column j of S evolves
// with v_t[j] alone.  One block owns one (b, h) and 4*hd threads; thread
// (j, g) keeps rows g, g+4, g+8, ... of column j in registers (16 floats at
// hd = 64) and the four partial dot products r_t . S[:, j] meet through two
// warp shuffles.  The block walks T in chunks of 32 tokens: each chunk's r,
// k, v, w are staged in shared memory with coalesced loads, the bonus
// r_t . (u * k_t) of each token is reduced once per chunk, the 32 steps then
// run with no block barrier, and the chunk's outputs leave through shared
// memory as coalesced stores.
//
// What bounds it.  On the serving path (rwkv6-7b: B = 2, T = 2048, H = 64,
// hd = 64) a layer's call reads r, k, v (bfloat16) and w (float32) and
// writes out (float32): about 235 MB, 70 us at 3.35 TB/s; the recurrence
// does 5 * hd^2 operations per token and head (r^T S, k v^T, diag(w) S + kv),
// 5.4 GFLOP, 80 us at the CUDA cores' float32 rate, so the bound is the
// operations.  The sequential steps set this kernel's time instead: 2048
// dependent steps per block, one block per SM, each step some hundred cycles
// of shared-memory reads and FMAs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
    case 64: return launch<TR, TW, 64>(r, k, v, w, u, state0, out, state, b, t, h, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// out (b, t, h, hd) and the final state (b, h, hd, hd), both float32, of the
// WKV6 recurrence over r, k, v, w (b, t, h, hd, contiguous) and u (h, hd,
// float32) from state0 (b, h, hd, hd, float32; null for zero).  hd is 8,
// 16, 32 or 64; rkv_bf16 and w_bf16 pick bfloat16 (1) or float32 (0) for
// r, k, v and for w.  Launches on `stream` without synchronising and
// returns the CUDA error of the launch (0 when it was accepted).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* state0,
                    void* out, void* state, int b, int t, int h, int hd,
                    int rkv_bf16, int w_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* uf = static_cast<const float*>(u);
  const float* s0 = static_cast<const float*>(state0);
  float* of = static_cast<float*>(out);
  float* sf = static_cast<float*>(state);
  if (rkv_bf16) {
    if (w_bf16)
      return dispatch<__nv_bfloat16, __nv_bfloat16>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
    return dispatch<__nv_bfloat16, float>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
  }
  if (w_bf16)
    return dispatch<float, __nv_bfloat16>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
  return dispatch<float, float>(r, k, v, w, uf, s0, of, sf, b, t, h, hd, st);
}
