// Hopper (sm_90a) building blocks shared by the hand-written kernels: the
// attention mainloops (attn_fwd_sm90.cuh, attn_bwd_sm90.cuh: K1 to K5) and
// the int8 GEMM (int8_gemm.cu: K6).  Shared-memory addresses, mbarriers
// (with a trap timer on waits), the wgmma shared-memory descriptors of
// 128-byte- and 64-byte-swizzled tiles, the wgmma fence / commit / wait, and
// cuTensorMapEncodeTiled taken from the driver without linking libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Spins until the barrier's phase of parity `parity` has completed.  A copy
// that never lands (a tensor map or byte count out of step with the kernel)
// traps after about ten seconds, so the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > 20000000000ll) {
      __trap();
    }
  }
}

// Shared-memory matrix descriptor of a tile of 128-byte rows written by TMA
// with the 128-byte swizzle (1024-byte aligned, 8-row groups 1024 bytes
// apart).  The same fields serve K-major operands (Q, K, and K6's int8
// codes and weight: SBO = the 8-row group stride, LBO unused) and the
// MN-major V (the 64 d of a row are one swizzle atom wide, SBO = the 8-key
// group stride, LBO unused).  A k step of 32 bytes (16 bf16 or 32 int8)
// advances the start address by 32 bytes inside the 128-byte rows.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for a tile of 64-byte rows (32 bf16: the attention at head dim
// 32) written by TMA with the 64-byte swizzle: layout type 2, 8-row groups
// 512 bytes apart (SBO), 16-byte chunk c of row r at chunk c ^ ((r / 2) % 4).
// K-major: a k16 step advances the start address by 32 bytes inside the
// 64-byte rows.  MN-major (V, K, Q or dO as B of a register-A product): the
// 32 d of a row are one swizzle atom wide, and 16 rows further is the next
// k16 step.
__device__ __forceinline__ uint64_t sw64_desc(const void* tile) {
  return static_cast<uint64_t>((smem_addr(tile) >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// The descriptor of a tile of kRowBytes-wide rows (128: sw128_desc, 64: sw64_desc).
template <int kRowBytes>
__device__ __forceinline__ uint64_t swizzled_desc(const void* tile) {
  static_assert(kRowBytes == 128 || kRowBytes == 64, "rows of 64 or 128 bytes");
  if constexpr (kRowBytes == 128) {
    return sw128_desc(tile);
  } else {
    return sw64_desc(tile);
  }
}

// Where the 16-byte chunk c of row r of such a tile lies in the row: the
// swizzle XORs the chunk index with bits 7.. of the row's byte offset
// (c ^ (r % 8) at 128-byte rows, c ^ ((r / 2) % 4) at 64-byte rows).
template <int kRowBytes>
__device__ __forceinline__ int swizzled_chunk(int r, int c) {
  return c ^ (((r * kRowBytes) >> 7) & (kRowBytes / 16 - 1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of this thread's committed product groups are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of these registers across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// ---------------------------------------------------------------------------
// host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded (no libcuda
// link); null if the driver does not give it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
               ? reinterpret_cast<EncodeTiled>(ptr)
               : nullptr;
  }();
  return fn;
}

}  // namespace sm90
