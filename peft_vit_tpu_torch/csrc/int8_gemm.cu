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
// quantize) and keeps them as int8 in shared memory, 64 x (K + 16) bytes
// (193 KB at K = 3072).  It then walks over its share of the 128-column
// tiles of the output, streaming w_i8 through a 3-stage cp.async ring of
// 128 x 64-byte tiles, 8 warps (2 x 4) each computing a 32 x 32 piece with
// ldmatrix + mma.sync m16n8k32 s8, and rescales from the accumulators
// straight to device memory.  The grid is (row tiles, column shares): the
// launcher picks the number of shares that fills the SMs at the least
// repeated quantize work (the TPU grid requantizes for every column block).
// Rows >= M are zero codes and are never written; columns >= N are masked,
// and nothing is padded in device memory.  wgmma and TMA are left for later.
//
// Shapes taken: K a multiple of 64 up to 3072, N a multiple of 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;        // rows of x per block
constexpr int kBN = 128;       // output columns per tile
constexpr int kBK = 64;        // bytes of K per weight stage
constexpr int kStages = 3;     // cp.async ring
constexpr int kThreads = 256;  // 8 warps: 2 over rows x 4 over columns
constexpr int kPad = 16;       // row padding: a 16 B shift per row makes the
                               // 8 rows of an ldmatrix hit distinct banks
constexpr int kWStride = kBK + kPad;
constexpr int kWStageBytes = kBN * kWStride;
constexpr int kMaxK = 3072;

__host__ __device__ constexpr int a_stride(int K) { return K + kPad; }

__host__ __device__ constexpr size_t smem_bytes(int K) {
  return static_cast<size_t>(kBM) * a_stride(K) + kStages * kWStageBytes + kBM * sizeof(float);
}

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// Four 8 x 16-byte matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives bytes 4 (l % 4) .. + 3 of row l / 4 of each: the int8
// fragment layout of mma m16n8k32.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b: a 16 x 32 int8 (row), b 32 x 8 int8 (col), c 16 x 8 int32.
// With g = lane / 4, t = lane % 4:
//   a[0] = A[g][4t..4t+3]      a[1] = A[g+8][4t..4t+3]
//   a[2] = A[g][16+4t..+3]     a[3] = A[g+8][16+4t..+3]
//   b0   = B[4t..4t+3][g]      b1   = B[16+4t..+3][g]
//   c[0..1] = C[g][2t..2t+1]   c[2..3] = C[g+8][2t..2t+1]
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

template <typename T, bool kStatic>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s_w, const float* __restrict__ s_x,
                 T* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int strideA = a_stride(K);
  uint8_t* sA = smem;
  uint8_t* sW = smem + static_cast<size_t>(kBM) * strideA;
  float* sScale = reinterpret_cast<float*>(sW + kStages * kWStageBytes);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  // this block's column tiles: blockIdx.y, + gridDim.y, ...
  const int my_tiles = (n_tiles - static_cast<int>(blockIdx.y) + gridDim.y - 1) / gridDim.y;
  const int total = my_tiles * (K / kBK);
  const int tile_step = gridDim.y * kBN;

  // The weight stages are loaded and consumed in the same order: all k chunks
  // of a column tile, then the next tile.  Both cursors advance by adds and
  // compares only.
  int pf_n0 = blockIdx.y * kBN, pf_k0 = 0, pf_stage = 0, pf_left = total;
  int ld_dst[kBN * kBK / 16 / kThreads], ld_row[kBN * kBK / 16 / kThreads];
#pragma unroll
  for (int i = 0; i < kBN * kBK / 16 / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    ld_row[i] = chunk >> 2;
    ld_dst[i] = (chunk >> 2) * kWStride + (chunk & 3) * 16;
  }
  const int ld_col = (tid & 3) * 16;
  auto load_next = [&]() {
    if (pf_left > 0) {
      uint8_t* stage = sW + pf_stage * kWStageBytes;
#pragma unroll
      for (int i = 0; i < kBN * kBK / 16 / kThreads; ++i) {
        const bool valid = pf_n0 + ld_row[i] < N;
        const int8_t* src =
            w + static_cast<size_t>(valid ? pf_n0 + ld_row[i] : 0) * K + pf_k0 + ld_col;
        cp_async16(stage + ld_dst[i], src, valid ? 16 : 0);
      }
      pf_k0 += kBK;
      if (pf_k0 == K) {
        pf_k0 = 0;
        pf_n0 += tile_step;
      }
      pf_stage = pf_stage + 1 == kStages ? 0 : pf_stage + 1;
      --pf_left;
    }
    cp_async_commit();
  };

  // the first weight stages are in flight while the rows are quantized
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  // ---- quantize this block's rows into shared memory, 8 rows per warp
  float static_scale = 0.0f;
  if (kStatic) static_scale = *s_x;
  for (int r = warp; r < kBM; r += kThreads / 32) {
    const int row = m0 + r;
    uint8_t* arow = sA + static_cast<size_t>(r) * strideA;
    if (row >= M) {
      for (int c = lane; c < K / 16; c += 32) {
        *reinterpret_cast<uint4*>(arow + c * 16) = make_uint4(0u, 0u, 0u, 0u);
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
      *reinterpret_cast<uint2*>(arow + c * 8) =
          make_uint2(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]));
    }
  }

  // ---- the product: warp (wm, wn) owns rows wm*32.. and columns wn*32.. of the tile
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  // ldmatrix row addresses of this lane (see ldmatrix_x4): for A the four
  // matrices are (rows 0-7 | 8-15) x (k 0-15 | 16-31) in the order a[0..3];
  // for W they are (n 0-7: k 0-15, k 16-31), (n 8-15: k 0-15, k 16-31), the
  // b0, b1 of two adjacent 8-column tiles.
  const int a_row = wm * 32 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int w_row = wn * 32 + (lane & 7) + (lane >> 4) * 8;
  const int w_col = ((lane >> 3) & 1) * 16;

  int acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  int n0 = blockIdx.y * kBN, k0 = 0, cur_stage = 0;
  for (int it = 0; it < total; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` has landed (and, at it = 0, the quantized rows);
                      // every warp is done with the stage the next load overwrites
    load_next();

    const uint8_t* stage = sW + cur_stage * kWStageBytes;
    cur_stage = cur_stage + 1 == kStages ? 0 : cur_stage + 1;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t a[2][4];
      uint32_t b[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        ldmatrix_x4(a[mt], sA + static_cast<size_t>(a_row + mt * 16) * strideA + k0 + ks * 32 +
                               a_col);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        ldmatrix_x4(b[np], stage + (w_row + np * 16) * kWStride + ks * 32 + w_col);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          mma_s8(acc[mt][nt], a[mt], b[nt >> 1][(nt & 1) * 2], b[nt >> 1][(nt & 1) * 2 + 1]);
        }
      }
    }

    k0 += kBK;
    if (k0 != K) continue;
    // ---- rescale and write this tile, then start the next from zero
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = wm * 32 + mt * 16 + g + half * 8;
        const int row = m0 + r;
        const float sx = sScale[r];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t;
          if (row < M && col < N) {
            const float v0 = (__int2float_rn(acc[mt][nt][half * 2]) * sx) * s_w[col];
            const float v1 = (__int2float_rn(acc[mt][nt][half * 2 + 1]) * sx) * s_w[col + 1];
            Io<T>::store2(out + static_cast<size_t>(row) * N + col, v0, v1);
          }
          acc[mt][nt][half * 2] = 0;
          acc[mt][nt][half * 2 + 1] = 0;
        }
      }
    }
    k0 = 0;
    n0 += tile_step;
  }
}

// Column shares per row tile: the count that minimises
//   waves(row_tiles * shares) * (kQuantCost + tiles per share),
// the quantize of a row tile costing about kQuantCost column tiles' products.
int pick_shares(int row_tiles, int n_tiles, int slots) {
  constexpr int kQuantCost = 2;
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

template <typename T, bool kStatic>
int launch(int device, const void* x, const void* w, const void* s_w, const void* s_x, void* out,
           int M, int K, int N, cudaStream_t stream) {
  auto kernel = int8_gemm_kernel<T, kStatic>;
  const size_t smem = smem_bytes(K);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  const int row_tiles = (M + kBM - 1) / kBM;
  const int n_tiles = (N + kBN - 1) / kBN;
  const dim3 grid(row_tiles, pick_shares(row_tiles, n_tiles, sms * per_sm));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), static_cast<const float*>(s_w),
      static_cast<const float*>(s_x), static_cast<T*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
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
  if (M <= 0 || K <= 0 || N <= 0 || K % kBK != 0 || K > kMaxK || N % 64 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

extern "C" const char* int8_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
