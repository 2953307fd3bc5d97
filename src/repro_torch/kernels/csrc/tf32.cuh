// TF32 tensor-core products at float32 accuracy, and cp.async copies, for
// Hopper (sm_90a): the helpers that wkv6.cu and flash_attention_bwd.cu
// share, so that the two do not drift.
//
// A float32 x that is not exact in TF32 is split into a high and a low
// TF32 operand; a product then takes hi*hi + hi*lo + lo*hi on
// mma.sync.m16n8k8 with float32 accumulators (lo*lo, below 2^-21 of the
// product, is dropped).  A bfloat16 value widened to float32 is exact in
// TF32: its lo part is 0 and its products need one mma per other part.
// flash_attention.cu includes it too.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tf32 {

// x split into a high and a low TF32 operand: hi keeps x's sign, exponent
// and top 10 mantissa bits, lo = x - hi exactly; the tensor core keeps 10
// mantissa bits of lo, so hi + lo carries 21 of x's 24 bits.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// Whether T's values are exact TF32 operands (bfloat16, widened) or are
// split (float32).
template <typename T>
__host__ __device__ constexpr bool exact_tf32() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// x as a TF32 operand: hi and lo parts, or x itself where it is exact.
template <bool EXACT>
__device__ __forceinline__ void to_tf32(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0;
  } else {
    split(x, hi, lo);
  }
}

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The largest divisor of n that is at most cap.
__host__ __device__ constexpr int divisor_upto(int n, int cap) {
  int d = cap < n ? cap : n;
  while (n % d) --d;
  return d;
}

// c += a * b, m16n8k8, TF32 operands, float32 accumulators.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b with both operands split: hi*hi into c, the corrections
// lo*hi + hi*lo into cc (two accumulators halve the chain of dependent mmas).
__device__ __forceinline__ void mma3(float (&c)[4], float (&cc)[4], const float (&a)[4], float b0,
                                     float b1) {
  uint32_t ah[4], al[4], bh0, bl0, bh1, bl1;
#pragma unroll
  for (int q = 0; q < 4; ++q) split(a[q], ah[q], al[q]);
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma(cc, al, bh0, bh1);
  mma(cc, ah, bl0, bl1);
  mma(c, ah, bh0, bh1);
}

// c += a * b where b holds bfloat16 values (exact in TF32): hi*b into c,
// lo*b into cc.
__device__ __forceinline__ void mma2(float (&c)[4], float (&cc)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0, float b1) {
  mma(cc, al, __float_as_uint(b0), __float_as_uint(b1));
  mma(c, ah, __float_as_uint(b0), __float_as_uint(b1));
}

// 16 bytes from global to shared memory, zero-filled when `in` is false
// (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 16 : 0) : "memory");
}
// The same for 4 bytes.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace tf32
