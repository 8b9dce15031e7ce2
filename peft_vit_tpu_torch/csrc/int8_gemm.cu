// Activation quantize + s8 x s8 -> s32 GEMM + rescale in one kernel for Hopper
// (sm_90a), with a plain C interface loaded through ctypes
// (peft_vit_tpu_torch/ops/int8.py).
//
// Replaces the Pallas TPU kernel peft_vit_tpu/ops/int8.py::_prequant_kernel
// (its pallas_call is in _prequant_matmul_pallas).  Computes, for an
// activation x (M, K) in bf16 or fp32, a weight quantized ahead of time
// w_i8 (N, K) int8 (K contiguous: row n holds output channel n) and its
// per-channel scales s_w (N,) fp32,
//     dynamic:  s[m] = max(max_k |x[m, k]| / 127, 1e-8)
//               q[m, k] = round_half_even(x[m, k] / s[m])
//     static:   s[m] = s_x (one fp32 scalar read from device memory)
//               q[m, k] = clip(round_half_even(x[m, k] / s_x), -127, 127)
//     out[m, n] = (float(sum_k q[m, k] * w_i8[n, k]) * s[m]) * s_w[n]
// cast to x's dtype.  Every step is the plain version's own arithmetic:
// IEEE division (no reciprocal), round half to even, an exact int32 sum and
// the two multiplies in that order, so the result equals the plain version
// bit for bit.  The static variant is XLA ops in the JAX package; here it is
// a template parameter of the same kernel.
//
// What bounds it: at the ViT-B/16 shapes (K, N in {768, 2304, 3072}) the
// function reads x (M, K) and w_i8 (N, K), writes out (M, N) and does 2*M*K*N
// int8 operations.  At the H100's rates (3.35 TB/s, 1979 TOP/s dense int8)
// the bytes take longer than the operations at every shape of the paths: the
// weight read at M = 197 (one image), the bf16 activations at the training
// batches (M = 3152: 8 us of bytes against 7.5 us of operations for c_fc).
//
// Design.  The row scale needs the whole row before the first product, and a
// 64-row bf16 tile at K = 3072 is 384 KB, more than a block's 227 KB of
// shared memory (the TPU kernel holds that block in VMEM).  So a block owns
// 64 rows of x: it reads them twice from device memory/L2 (absmax, then
// quantize) and keeps them as int8 codes in shared memory, in
// round_up(K, 128) / 128 slabs of 64 rows x 128 bytes (8 KB, 1024-byte
// aligned) with the 128-byte swizzle: 16-byte chunk c of row r at chunk
// c ^ (r mod 8), byte for byte the layout TMA gives a bf16 tile of 64
// columns, so sw128_desc (sm90_common.cuh) describes it.  When K mod 128 is
// 64 the last slab's second half holds zero codes.  The codes are written by
// ordinary stores (the generic proxy) and read by wgmma (the async proxy):
// every thread fences the proxies before the barrier that ends the quantize.
//
// The block then walks over its share of the 128-column tiles of the output
// with two warpgroups, warpgroup w issuing wgmma m64n64k32 s8 x s8 -> s32
// for columns 64 w .. 64 w + 63, A (the codes) and B (the weight) both from
// shared memory and K-major, four k32 steps per 128-byte slab.  The weight
// streams by TMA through a 2-D tensor map over w_i8 (K bytes x N rows,
// 128-byte swizzle), in stages of 128 rows x 128 bytes (16 KB) behind full
// and empty mbarriers; rows >= N and bytes >= K fall outside the map and
// arrive as zeros.  Thread 0 issues every copy: the first stages before the
// quantize, so they land under it, then each stage again once both
// warpgroups have released it.  The products of one stage run while the
// warpgroup waits for the next (one commit group in flight).  The ring is
// as deep as fits beside the codes: ring_stages() below, 3 stages at
// K = 768 (two blocks a SM), 5 at K = 2304 and 2 at K = 3072 (one block a
// SM).  A tile's accumulators are rescaled from registers straight to device
// memory; the next tile's first product overwrites them.
//
// Where the time goes (H100, M = 3152; PERF.md, bench_int8_split.py): the
// row quantize, which this design keeps as it was, sets the pace, most of
// all at K = 768 where two blocks a SM overlap one's quantize with the
// other's products; the products are held by the weight's reads from L2,
// since every 64-row tile reads all of w_i8.  Slower on the H100, and
// dropped: the weight multicast to a cluster of two row tiles, 64-byte
// weight stages twice as deep, one block a SM with a deeper ring at K = 768
// (slower at N >= 2304), and the ring's depth as a compile-time constant.
//
// The grid is (row tiles, column shares): the launcher picks the number of
// shares that fills the SMs at the least repeated quantize work (the TPU
// grid requantizes for every column block).  Rows >= M are zero codes and
// are never written; columns >= N are never written; nothing is padded in
// device memory.
//
// Shapes taken: K a multiple of 64 up to 3072, N a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_common.cuh"
#include "wgmma_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kBM = 64;                  // rows of x per block: one wgmma M
constexpr int kBN = 128;                 // output columns per tile: 64 a warpgroup
constexpr int kThreads = 256;            // two warpgroups; all 8 warps quantize
constexpr int kSlab = 128;               // bytes of K per code slab and weight stage
constexpr int kSlabBytes = kBM * kSlab;  // 8 KB of codes
constexpr int kStageBytes = kBN * kSlab; // 16 KB of weight
constexpr int kMaxStages = 8;
constexpr int kMaxK = 3072;
constexpr int kKMultiple = 64;
// H100: shared memory a SM, the most one block may take, and the runtime's
// reserve per block
constexpr int kSmPerSm = 233472;
constexpr int kSmPerBlock = 232448;
constexpr int kSmReserved = 1024;
// beside the codes and the ring: 1024-byte alignment slack, the row scales
// and the full / empty barriers
constexpr int kSmFixed = 1024 + kBM * 4 + 2 * kMaxStages * 8;

__host__ __device__ constexpr int code_slabs(int K) { return (K + kSlab - 1) / kSlab; }

// The ring's depth: what fits beside the codes (64 x round_up(K, 128) bytes)
// and the fixed bytes, at two blocks a SM where the codes and two stages fit
// twice (K <= 1152), else at one; at most kMaxStages.
//     K = 768:  49,152 + 3 x 16,384 (+ 1,408) = 99,712 B, two blocks a SM
//     K = 2304: 147,456 + 5 x 16,384 (+ 1,408) = 230,784 B, one block
//     K = 3072: 196,608 + 2 x 16,384 (+ 1,408) = 230,784 B, one block
__host__ __device__ constexpr int ring_stages(int K) {
  const int fixed = code_slabs(K) * kSlabBytes + kSmFixed;
  const int two = kSmPerSm / 2 - kSmReserved - fixed;
  const int room = two >= 2 * kStageBytes ? two : kSmPerBlock - fixed;
  return room / kStageBytes < kMaxStages ? room / kStageBytes : kMaxStages;
}

__host__ __device__ constexpr int smem_bytes(int K) {
  return code_slabs(K) * kSlabBytes + ring_stages(K) * kStageBytes + kSmFixed;
}

static_assert(ring_stages(kMaxK) >= 2, "the ring needs two stages at the largest K");
static_assert(smem_bytes(kMaxK) <= kSmPerBlock, "a block's shared memory at the largest K");

template <typename T>
struct Io;

template <>
struct Io<float> {
  static __device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  }
};

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 is the high half of an fp32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  }
};

__device__ __forceinline__ uint32_t pack4(int q0, int q1, int q2, int q3) {
  return (static_cast<uint32_t>(q0) & 0xffu) | ((static_cast<uint32_t>(q1) & 0xffu) << 8) |
         ((static_cast<uint32_t>(q2) & 0xffu) << 16) | (static_cast<uint32_t>(q3) << 24);
}

template <bool kStatic>
__device__ __forceinline__ int quantize(float v, float scale) {
  if (kStatic) {
    return static_cast<int>(fminf(fmaxf(rintf(v / scale), -127.0f), 127.0f));
  }
  return __float2int_rn(v / scale);  // |v| <= 127 * scale: no clip needed
}

// The box of weight rows n0 .. n0 + 127, bytes k0 .. k0 + 127 into dst,
// completion on bar.
__device__ __forceinline__ void tma_load_weight(void* dst, const CUtensorMap* map, int k0, int n0,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(n0), "r"(smem_addr(bar))
      : "memory");
}

template <typename T, bool kStatic>
__global__ void __launch_bounds__(kThreads, 2)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tw, const T* __restrict__ x,
                 const float* __restrict__ s_w, const float* __restrict__ s_x,
                 T* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  const int stages = ring_stages(K);
  const int slabs = code_slabs(K);
  uint8_t* sA = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sW = sA + slabs * kSlabBytes;
  float* sScale = reinterpret_cast<float*>(sW + stages * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(sScale + kBM);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  // this block's column tiles: blockIdx.y, + gridDim.y, ...
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int total = my_tiles * slabs;  // weight stages through the ring
  const int tile_step = gridDim.y * kBN;

  // Thread 0's copies, in the order they are consumed: every slab of a
  // column tile, then the next tile.  Stage `st` takes loads st, st +
  // stages, ...; a load past the first round waits for the empty barrier's
  // previous phase.
  int pf_n0 = blockIdx.y * kBN, pf_k0 = 0, pf_stage = 0, pf_parity = 0, issued = 0;
  auto issue = [&]() {
    mbar_expect_tx(&full[pf_stage], kStageBytes);
    tma_load_weight(sW + pf_stage * kStageBytes, &tw, pf_k0, pf_n0, &full[pf_stage]);
    pf_k0 += kSlab;
    if (pf_k0 >= K) {
      pf_k0 = 0;
      pf_n0 += tile_step;
    }
    if (++pf_stage == stages) {
      pf_stage = 0;
      pf_parity ^= 1;
    }
    ++issued;
  };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first weight stages are in flight while the rows are quantized
  if (tid == 0) {
    while (issued < stages && issued < total) issue();
  }

  // ---- quantize this block's rows into the code slabs, 8 rows per warp
  float static_scale = 0.0f;
  if (kStatic) static_scale = *s_x;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    const int swz = r & 7;
    uint8_t* arow = sA + r * kSlab;  // row r of slab 0; slab s is s * kSlabBytes further
    if (row >= M) {
      // zeros need no swizzle: a row's 16-byte chunks stay inside its 128 bytes
      for (int c = lane; c < slabs * (kSlab / 16); c += 32) {
        *reinterpret_cast<uint4*>(arow + (c >> 3) * kSlabBytes + (c & 7) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
      if (lane == 0) sScale[r] = 0.0f;
      continue;
    }
    const T* xr = x + static_cast<size_t>(row) * K;
    float scale = static_scale;
    if (!kStatic) {
      float amax = 0.0f;
      for (int c = lane; c < K / 8; c += 32) {
        float v[8];
        Io<T>::load8(xr + c * 8, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(v[i]));
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
      }
      scale = fmaxf(amax / 127.0f, 1e-8f);
    }
    if (lane == 0) sScale[r] = scale;
    for (int c = lane; c < K / 8; c += 32) {
      float v[8];
      Io<T>::load8(xr + c * 8, v);
      int q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) q[i] = quantize<kStatic>(v[i], scale);
      // codes k = 8c .. 8c + 7: slab c / 16, half c % 2 of 16-byte chunk (c / 2) % 8
      *reinterpret_cast<uint2*>(arow + (c >> 4) * kSlabBytes + ((((c >> 1) & 7) ^ swz) << 4) +
                                (c & 1) * 8) =
          make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    }
    if (K % kSlab != 0 && lane < 4) {  // the last slab's second half: zero codes
      *reinterpret_cast<uint4*>(arow + (slabs - 1) * kSlabBytes + (((4 + lane) ^ swz) << 4)) =
          make_uint4(0u, 0u, 0u, 0u);
    }
  }
  // the codes were written by the generic proxy and wgmma reads them through
  // the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // ---- the products: warpgroup wg owns columns 64 wg .. 64 wg + 63 of a tile
  const int wg = tid >> 7;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = ((tid >> 5) & 3) * 16 + g;  // this thread's rows row0, row0 + 8
  const uint8_t* w_half = sW + wg * (kStageBytes / 2);
  // thread 0 refills every stage the block has released (loads 0 .. released - 1)
  auto refill = [&](int released) {
    if (tid == 0) {
      while (issued < total && issued < released + stages) {
        mbar_wait(&empty[pf_stage], pf_parity ^ 1);
        issue();
      }
    }
    __syncwarp();
  };
  int acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0;
  int stage = 0, parity = 0, last = 0, j = 0;  // j: loads consumed
  for (int n0 = blockIdx.y * kBN; n0 < N; n0 += tile_step) {
    for (int k0 = 0; k0 < K; k0 += kSlab, ++j) {
      mbar_wait(&full[stage], parity);
      const uint64_t da = sw128_desc(sA + (k0 / kSlab) * kSlabBytes);
      const uint64_t db = sw128_desc(w_half + stage * kStageBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlab / 32; ++kk) {
        // 32 bytes further along the (swizzled) rows of both; a tile's first
        // step overwrites the accumulators
        wgmma_ss_s8<64>(acc, da + 2 * kk, db + 2 * kk, (k0 > 0 || kk > 0) ? 1 : 0);
      }
      wgmma_commit();
      if (k0 > 0) {
        wgmma_wait<1>();  // the previous stage's products are done: release it
        mbar_arrive(&empty[last]);
        refill(j);
      }
      last = stage;
      if (++stage == stages) {
        stage = 0;
        parity ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[last]);
    refill(j);

    // ---- rescale and write this tile.  Accumulator 4 i + 2 h + e holds row
    // row0 + 8 h, column 8 i + 2 t + e of the warpgroup's 64.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const int row = m0 + r;
      if (row >= M) continue;
      const float sx = sScale[r];
      T* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int col = n0 + wg * 64 + 8 * i + 2 * t;
        if (col < N) {
          const float v0 = (__int2float_rn(acc[4 * i + 2 * h]) * sx) * s_w[col];
          const float v1 = (__int2float_rn(acc[4 * i + 2 * h + 1]) * sx) * s_w[col + 1];
          Io<T>::store2(orow + col, v0, v1);
        }
      }
    }
  }
}

// Column shares per row tile: the count that minimises
//   waves(row_tiles * shares) * (kQuantCost + tiles per share),
// the quantize of a row tile costing about kQuantCost column tiles' products
// and rescales.  Fitted on the H100 from the split of this kernel's time at
// the eight GEMMs of a ViT-B/16 block at M = 3152 (bench_int8_split.py): a build
// without the products against one without the quantize put a row tile's
// quantize at 3.8 to 7.0 column tiles (median 5).  At the path's shapes any
// value from 2 to 7 picks the same shares.
int pick_shares(int row_tiles, int n_tiles, int slots) {
  constexpr int kQuantCost = 5;
  int best = 1;
  long best_cost = -1;
  for (int s = 1; s <= n_tiles; ++s) {
    const long waves = (static_cast<long>(row_tiles) * s + slots - 1) / slots;
    const long cost = waves * (kQuantCost + (n_tiles + s - 1) / s);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = s;
    }
  }
  return best;
}

// A 2-D map over w_i8 (N, K) int8 as (K bytes, N rows), boxes of 128 rows x
// 128 bytes, 128-byte swizzle, zeros outside.
bool encode_weight(CUtensorMap* map, const void* w, int K, int N) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kSlab), static_cast<cuuint32_t>(kBN)};
  const cuuint32_t unit[2] = {1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, bool kStatic>
int launch(int device, const void* x, const void* w, const void* s_w, const void* s_x, void* out,
           int M, int K, int N, cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<T, kStatic>;
  const int smem = smem_bytes(K);
  // the attribute belongs to the device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  CUtensorMap tw;
  if (!encode_weight(&tw, w, K, N)) return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  const dim3 grid(row_tiles, pick_shares(row_tiles, n_tiles, sms * per_sm));
  kernel<<<grid, kThreads, smem, stream>>>(tw, static_cast<const T*>(x),
                                           static_cast<const float*>(s_w),
                                           static_cast<const float*>(s_x), static_cast<T*>(out),
                                           M, K, N);
  return static_cast<int>(cudaGetLastError());
}

bool takes(int K, int N) {
  return K > 0 && N > 0 && K % kKMultiple == 0 && K <= kMaxK && N % 64 == 0;
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
// x, out: (M, K) and (M, N) contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or
// fp32; w_i8: (N, K) int8 contiguous, 16-byte aligned; s_w: (N,) fp32; s_x:
// one fp32 on the device for the static quantize, or NULL for the dynamic
// per-row one.  K % 64 == 0, K <= 3072, N % 64 == 0.
extern "C" int int8_gemm(int device, const void* x, const void* w_i8, const void* s_w,
                         const void* s_x, void* out, int M, int K, int N, int is_bf16,
                         void* stream) {
  if (M <= 0 || !takes(K, N)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    return s_x != nullptr
               ? launch<__nv_bfloat16, true>(device, x, w_i8, s_w, s_x, out, M, K, N, s)
               : launch<__nv_bfloat16, false>(device, x, w_i8, s_w, s_x, out, M, K, N, s);
  }
  return s_x != nullptr ? launch<float, true>(device, x, w_i8, s_w, s_x, out, M, K, N, s)
                        : launch<float, false>(device, x, w_i8, s_w, s_x, out, M, K, N, s);
}

// The dynamic shared memory a block takes at this K, and the weight ring's
// depth (-1 for a K the kernel does not take).
extern "C" int int8_gemm_smem_bytes(int K) { return takes(K, 64) ? smem_bytes(K) : -1; }
extern "C" int int8_gemm_stages(int K) { return takes(K, 64) ? ring_stages(K) : -1; }

extern "C" const char* int8_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
