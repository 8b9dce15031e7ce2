// Shared by the flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu,
// attn_bias_grad.cu, fused_short_attn.cu): the tile shape, the bf16
// tensor-core product and the shared-memory tile loads.  Everything is inline
// device code; each .cu is its own library.  The head dim kD is a template
// parameter of every kernel, instantiated at 32 (Swin's heads) and 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// the head dims the kernels take
__host__ __device__ constexpr bool head_dim_ok(int d) { return d == 32 || d == 64; }

constexpr int kBlockQ = 64;   // q rows per tile
constexpr int kBlockK = 64;   // keys per tile
constexpr int kWarps = 4;     // bf16 kernels: 16 tile rows per warp
constexpr int kThreadsBf16 = kWarps * 32;
// bf16 smem row stride of a kD-wide tile: 144 B at D = 64, 80 B at D = 32
// keep 16 B alignment and make the fragment loads conflict-free
template <int kD>
constexpr int kLds = kD + 8;
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

// 64 rows x kD bf16 from global (rows row0.., row stride kD) into shared
// (row stride kLds<kD>), 16 B per load; rows >= n are zero.
template <int kD>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst, const uint16_t* src,
                                               int row0, int n, int tid) {
  constexpr int kChunks = kD / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kBlockK * kChunks / kThreadsBf16; ++i) {
    const int c = tid + i * kThreadsBf16;
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * kD + col);
    }
    *reinterpret_cast<uint4*>(dst + r * kLds<kD> + col) = val;
  }
}

// The A fragments of the 16 tile rows r0 / r0 + 8 (r0 = 16 * warp + g) over
// the whole head dim: k-step kk covers dims 16 kk .. 16 kk + 15.
template <int kD>
__device__ __forceinline__ void load_a_frags(uint32_t (&a)[kD / 16][4], const uint16_t* tile,
                                             int r0, int t) {
  constexpr int kS = kLds<kD>;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint16_t* p = tile + r0 * kS + kk * 16 + 2 * t;
    a[kk][0] = ld_u32(p);
    a[kk][1] = ld_u32(p + 8 * kS);
    a[kk][2] = ld_u32(p + 8);
    a[kk][3] = ld_u32(p + 8 * kS + 8);
  }
}

// c += a * X^T for the 8 tile rows row8 .. row8 + 7 of X as output columns:
// the B operand is B[d][n] = X[row8 + n][d], two adjacent dims per register,
// so each fragment register is one 32-bit shared load.
template <int kD>
__device__ __forceinline__ void mma_rows_as_cols(float (&c)[4], const uint32_t (&a)[kD / 16][4],
                                                 const uint16_t* tile, int row8, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint16_t* p = tile + (row8 + g) * kLds<kD> + kk * 16 + 2 * t;
    mma_bf16(c, a[kk], ld_u32(p), ld_u32(p + 8));
  }
}

}  // namespace flash
