// bfloat16 wgmma on Hopper (sm_90a): the swizzled shared-memory tiles, their
// descriptors and the wgmma instructions that flash_attention.cu's forward
// and flash_attention_bwd.cu's backward share.
//
// A tile of an (S, HD) bfloat16 matrix is stored in swizzle panels
// (Panel<HD>), written by load_tile with 16-byte cp.async copies; wgmma
// reads it through a descriptor (smem_desc) as a K-major operand (HD the
// reduction: q k^T) or, with its transpose bit, as an MN-major B operand
// (the tile's rows the reduction: P v).  So one stored tile serves both.
#pragma once

#include <cuda_bf16.h>

#include <cstddef>
#include <cstdint>

namespace wgmma {

using bf16 = __nv_bfloat16;

// The swizzle panels of a tile, chosen by head_dim.  wgmma reads a tile in
// panels as wide as its swizzle, stored one after another: a panel row is
// 128 bytes (64 bfloat16 columns) when hd is a multiple of 64, else 64
// bytes (32 columns: hd 96 is three panels).  An atom is 8 rows of a panel.
// The 16-byte chunk c of a panel's row r lies at chunk c ^ (r % 8) of the
// row at 128 bytes (the byte address's bits 4-6 XOR bits 7-9: CUTLASS's
// Swizzle<3,4,3>), at chunk c ^ ((r >> 1) % 4) at 64 (bits 4-5 XOR bits 7-8:
// Swizzle<2,4,3>); load_tile writes them so.  Tiles start on an atom
// boundary, so the address bits are the tile's own.
template <int HD>
struct Panel {
  static_assert(HD % 32 == 0, "whole 32-column panels");
  static constexpr bool WIDE = HD % 64 == 0;
  static constexpr int COLS = WIDE ? 64 : 32;   // bfloat16 columns of a panel
  static constexpr int ROW = 2 * COLS;          // bytes of a panel row
  static constexpr int CHUNKS = ROW / 16;       // 16-byte chunks of a panel row
  static constexpr int ATOM = 8 * ROW;          // bytes of an 8-row atom
  static constexpr int STEPS = ROW / 32;        // k16 steps (32 bytes) in a panel row
  static constexpr uint64_t MODE = WIDE ? 1 : 2;   // descriptor bits 62-63: 128B or 64B swizzle
};

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Copies rows [row0, row0 + ROWS) of an (S, HD) bfloat16 matrix whose rows
// lie `stride` elements apart into the tile at shared address `dst`, the
// block's THREADS threads sharing the chunks: one panel of ROWS rows after
// another (Panel<HD>), each 16-byte chunk at its swizzled place in its row.  Rows at or past s_len are zero-filled
// (src-size 0; the source address then points at row 0).  The swizzle is
// written out here, not in a member of Panel: inlined from a helper, the
// XORs take their operands in another order and the SASS at hd 64, 128 and
// 256 changes.
template <int HD, int ROWS, int THREADS = 128>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, size_t stride,
                                          int row0, int s_len) {
  using P = Panel<HD>;
  constexpr int CHUNKS = HD / 8;   // 16-byte chunks per row
  static_assert(ROWS * CHUNKS % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CHUNKS / THREADS; ++it) {
    const int idx = static_cast<int>(threadIdx.x) + it * THREADS;
    const int r = idx / CHUNKS;
    const int c = idx % CHUNKS;
    const int g = row0 + r;
    const bool in = g < s_len;
    const bf16* from = src + static_cast<size_t>(in ? g : 0) * stride + c * 8;
    const uint32_t to = dst + (c / P::CHUNKS) * (ROWS * P::ROW) + r * P::ROW +
                        ((P::WIDE ? ((c % 8) ^ (r % 8)) : ((c % 4) ^ ((r >> 1) % 4))) << 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(to), "l"(from), "r"(in ? 16 : 0) : "memory");
  }
}

// wgmma's shared-memory matrix descriptor with swizzle MODE (Panel::MODE):
// start address, leading and stride byte offsets, each in 16-byte units.
template <uint64_t MODE>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         MODE << 62;
}

// Keeps the compiler from moving reads or writes of a register that an
// asynchronous wgmma owns across the wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x N, float32) = a (64 x 16) b (16 x N) [+ d when accumulate], a and
// b both K-major in shared memory; N is 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    static_assert(N == 32, "N is 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
}

// d (64 x N, float32) += a (64 x 16, bfloat16 pairs in registers) b, with b
// (16 x N) MN-major in shared memory (the transpose bit set); N is 32 or 64.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    static_assert(N == 32, "N is 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

}  // namespace wgmma
