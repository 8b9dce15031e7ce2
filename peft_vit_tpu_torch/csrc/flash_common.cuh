// Shared by the flash-attention kernels (flash_attn_fwd.cu, flash_attn_bwd.cu,
// attn_bias_grad.cu, fused_short_attn.cu): the head dims, the tile shape of
// the fp32 kernels and the bf16 packing of two fp32 values.  Everything is
// inline device code; each .cu is its own library.  The head dim kD is a
// template parameter of every kernel, instantiated at 32 (Swin's heads) and
// 64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// the head dims the kernels take
__host__ __device__ constexpr bool head_dim_ok(int d) { return d == 32 || d == 64; }

constexpr int kBlockQ = 64;   // q rows per tile
constexpr int kBlockK = 64;   // keys per tile
constexpr float kNegInf = -1e30f;

// Two fp32 values to one register of two bf16 (lo in the low half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace flash
