// Shared by the flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu):
// the tile shape, the bf16 tensor-core product and the shared-memory tile
// loads.  Everything is inline device code; each .cu is its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kD = 64;        // head dim
constexpr int kBlockQ = 64;   // q rows per tile
constexpr int kBlockK = 64;   // keys per tile
constexpr int kWarps = 4;     // bf16 kernels: 16 tile rows per warp
constexpr int kThreadsBf16 = kWarps * 32;
constexpr int kLds = kD + 8;  // bf16 smem row stride: 144 B keeps 16 B
                              // alignment and makes fragment loads
                              // conflict-free
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two fp32 values to one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// c 16x8 fp32.  Fragment layouts (g = lane / 4, t = lane % 4):
//   a[0] = A[g][2t..2t+1]   a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..+9]   a[3] = A[g+8][2t+8..+9]
//   b0   = B[2t..2t+1][g]   b1   = B[2t+8..2t+9][g]
//   c[0..1] = C[g][2t..2t+1]   c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 64 rows x 64 bf16 from global (rows row0.., row stride kD) into shared
// (row stride kLds), 16 B per load; rows >= n are zero.
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               int row0, int n, int tid) {
#pragma unroll
  for (int i = 0; i < kBlockK * kD / 8 / kThreadsBf16; ++i) {
    const int c = tid + i * kThreadsBf16;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * kD + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kLds + col) = val;
  }
}

// The A fragments of the 16 tile rows r0 / r0 + 8 (r0 = 16 * warp + g) over
// the whole head dim: k-step kk covers dims 16 kk .. 16 kk + 15.
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4], const uint16_t* tile,
                                             int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint16_t* p = tile + r0 * kLds + kk * 16 + 2 * t;
    a[kk][0] = ld_u32(p);
    a[kk][1] = ld_u32(p + 8 * kLds);
    a[kk][2] = ld_u32(p + 8);
    a[kk][3] = ld_u32(p + 8 * kLds + 8);
  }
}

// c += a * X^T for the 8 tile rows row8 .. row8 + 7 of X as output columns:
// the B operand is B[d][n] = X[row8 + n][d], two adjacent dims per register,
// so each fragment register is one 32-bit shared load.
__device__ __forceinline__ void mma_rows_as_cols(float (&c)[4], const uint32_t (&a)[kD / 16][4],
                                                 const uint16_t* tile, int row8, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint16_t* p = tile + (row8 + g) * kLds + kk * 16 + 2 * t;
    mma_bf16(c, a[kk], ld_u32(p), ld_u32(p + 8));
  }
}

// c += a * X for the 16 tile rows row16 .. row16 + 15 of X as the reduction
// index and the 8 dims col8 .. col8 + 7 as output columns: B[r][n] =
// X[row16 + r][col8 + n].  Two rows make one register, so each is built
// from two 16-bit shared loads.
__device__ __forceinline__ void mma_rows_as_k(float (&c)[4], const uint32_t (&a)[4],
                                              const uint16_t* tile, int row16, int col8,
                                              int g, int t) {
  const uint16_t* p = tile + (row16 + 2 * t) * kLds + col8 + g;
  const uint32_t b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[kLds]) << 16);
  const uint32_t b1 =
      static_cast<uint32_t>(p[8 * kLds]) | (static_cast<uint32_t>(p[9 * kLds]) << 16);
  mma_bf16(c, a, b0, b1);
}

}  // namespace flash
