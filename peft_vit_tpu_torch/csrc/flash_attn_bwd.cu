// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface loaded through ctypes (peft_vit_tpu_torch/ops/attention.py).
//
// Replace the Pallas TPU kernels of peft_vit_tpu/ops/attention.py:
//   flash_attn_bwd_dq   <- _flash_bwd_dq_kernel
//   flash_attn_bwd_dkv  <- _flash_bwd_dkv_kernel
// (their pallas_calls are in _flash_attention_bwd).  For q, k, v, dO of shape
// (B, H, N, D), the forward's lse (B, H, 1, N) and delta = rowsum(dO o O)
// (B, H, 1, N), both fp32, they compute the bias-free backward
//     p  = exp(scale * q k^T - lse)
//     ds = p o (dO v^T - delta)
//     dq = scale * ds k        dk = scale * ds^T q        dv = p^T dO
// p and ds are recomputed tile by tile from the saved lse and never reach
// device memory.  p is rounded to the operand dtype before p^T dO and ds
// before its two products, as in the Pallas kernels; sums are fp32.  Nothing
// is padded in device memory (the TPU kernels pad N and D to 128): p = 0 for
// keys >= N and for q rows >= N, staged rows >= N are zero, and rows >= N
// are not written.
//
// What bounds them: at the ViT-B/16 training shapes (N = 197, D = 64, bf16)
// dq reads four tensors and writes one against 6*B*H*N^2*D flops, dk/dv read
// four and write two against 8*B*H*N^2*D, about 120 flops per byte, below
// the H100's bf16 ridge of about 295: both are memory-bound.  The design
// keeps every (N, N) intermediate in registers and writes each gradient once.
//
// bf16 (mma.sync m16n8k16, fp32 accumulators), one block of 4 warps per
// (64-row tile, head, batch), 16 tile rows per warp:
// * dq: the block owns a q tile and loops over key tiles.  s = q k^T and
//   dp = dO v^T land in the same accumulator layout, so ds is formed in
//   registers and, two 8-key tiles at a time, is already the A fragment of
//   ds k.
// * dk/dv: the block owns a key tile and loops over q tiles, so it owns its
//   dk and dv rows: no atomics, a deterministic result.  It computes the
//   transposed products s^T = k q^T and dp^T = v dO^T with the key tile as
//   the A operand, so p^T and ds^T come out as the A fragments of p^T dO and
//   ds^T q without a transpose through shared memory.  lse and delta then
//   run along the accumulator's columns and are staged in shared memory per
//   q tile.
// The tile a block owns is staged in the buffers of the streamed pair, read
// into A fragments once, and the buffers are reused: 18 KB of shared memory.
// fp32: the same tiling with two threads per owned row (each holds every
// other dim) and fp32 FMAs; the two halves of a dot product meet in one
// shuffle.  It exists so that fp32 training on the card can be held tightly
// against the CPU.
// D = 64 only.  wgmma, TMA and cp.async pipelining are left for later.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreadsF32 = 2 * kBlockQ;  // two threads per owned row
constexpr int kHalfD = kD / 2;

__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dq_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         uint16_t* __restrict__ dq, int H, int N, float scale) {
  __shared__ __align__(16) uint16_t sK[kBlockK * kLds];  // first the q tile
  __shared__ __align__(16) uint16_t sV[kBlockK * kLds];  // first the dO tile

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  load_tile_bf16(sK, q + base, q0, N, tid);
  load_tile_bf16(sV, dout + base, q0, N, tid);
  __syncthreads();

  // This thread's two rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  uint32_t qa[kD / 16][4];
  uint32_t da[kD / 16][4];
  load_a_frags(qa, sK, r0, t);
  load_a_frags(da, sV, r0, t);

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  float row_lse[2];
  float row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool valid = qrow[r] < N;
    row_lse[r] = valid ? lse[bh * N + qrow[r]] : 0.f;
    row_delta[r] = valid ? delta[bh * N + qrow[r]] : 0.f;
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }

  const int num_kt = (N + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the buffers' previous tile
    load_tile_bf16(sK, k + base, k0, N, tid);
    load_tile_bf16(sV, v + base, k0, N, tid);
    __syncthreads();

    // 16 keys at a time: s and dp for two 8-key tiles, then ds as one
    // k-step of ds k.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key8 = kk * 16 + j * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows_as_cols(s, qa, sK, key8, g, t);
        mma_rows_as_cols(dp, da, sV, key8, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int key = k0 + key8 + 2 * t + (i & 1);
          const float p = key < N ? __expf(s[i] * scale - row_lse[r]) : 0.f;
          s[i] = p * (dp[i] - row_delta[r]);
        }
        dsa[2 * j + 0] = pack_bf16(s[0], s[1]);
        dsa[2 * j + 1] = pack_bf16(s[2], s[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        mma_rows_as_k(acc[dt], dsa, sK, kk * 16, dt * 8, g, t);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= N) continue;
    uint16_t* out = dq + base + static_cast<size_t>(qrow[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_bf16(scale * acc[dt][2 * r], scale * acc[dt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreadsBf16)
flash_bwd_dkv_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                          const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                          int H, int N, float scale) {
  __shared__ __align__(16) uint16_t sQ[kBlockQ * kLds];   // first the k tile
  __shared__ __align__(16) uint16_t sDo[kBlockQ * kLds];  // first the v tile
  __shared__ float sLse[kBlockQ];
  __shared__ float sDelta[kBlockQ];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlockK;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  load_tile_bf16(sQ, k + base, k0, N, tid);
  load_tile_bf16(sDo, v + base, k0, N, tid);
  __syncthreads();

  // This thread's two keys of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  uint32_t ka[kD / 16][4];
  uint32_t va[kD / 16][4];
  load_a_frags(ka, sQ, r0, t);
  load_a_frags(va, sDo, r0, t);
  const int krow[2] = {k0 + r0, k0 + r0 + 8};

  float dk_acc[kD / 8][4];
  float dv_acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dk_acc[dt][i] = 0.f;
      dv_acc[dt][i] = 0.f;
    }
  }

  const int num_qt = (N + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // every warp is done with the buffers' previous tile
    load_tile_bf16(sQ, q + base, q0, N, tid);
    load_tile_bf16(sDo, dout + base, q0, N, tid);
    if (tid < kBlockQ) {
      const bool valid = q0 + tid < N;
      sLse[tid] = valid ? lse[bh * N + q0 + tid] : 0.f;
      sDelta[tid] = valid ? delta[bh * N + q0 + tid] : 0.f;
    }
    __syncthreads();

    // 16 q rows at a time: s^T and dp^T for two 8-row tiles, then p^T and
    // ds^T as one k-step of p^T dO and ds^T q.
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t pa[4];
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row8 = kk * 16 + j * 8;
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        float dpt[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows_as_cols(st, ka, sQ, row8, g, t);
        mma_rows_as_cols(dpt, va, sDo, row8, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = row8 + 2 * t + (i & 1);  // q row within the tile
          const bool valid = (q0 + c < N) && (krow[i >> 1] < N);
          const float p = valid ? __expf(st[i] * scale - sLse[c]) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - sDelta[c]);
        }
        pa[2 * j + 0] = pack_bf16(st[0], st[1]);
        pa[2 * j + 1] = pack_bf16(st[2], st[3]);
        dsa[2 * j + 0] = pack_bf16(dpt[0], dpt[1]);
        dsa[2 * j + 1] = pack_bf16(dpt[2], dpt[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        mma_rows_as_k(dv_acc[dt], pa, sDo, kk * 16, dt * 8, g, t);
        mma_rows_as_k(dk_acc[dt], dsa, sQ, kk * 16, dt * 8, g, t);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= N) continue;
    const size_t off = base + static_cast<size_t>(krow[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) =
          pack_bf16(scale * dk_acc[dt][2 * r], scale * dk_acc[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

// 64 rows x 64 fp32 of a and of b from global into shared (row stride kD),
// 16 B per load; rows >= n are zero.
__device__ __forceinline__ void load_tiles_f32(float* dst_a, float* dst_b, const float* a,
                                               const float* b, int row0, int n, int tid) {
  for (int c = tid; c < kBlockK * kD / 4; c += kThreadsF32) {
    const int r = c / (kD / 4);
    const int col = (c % (kD / 4)) * 4;
    float4 ax = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 bx = ax;
    if (row0 + r < n) {
      const size_t off = static_cast<size_t>(row0 + r) * kD + col;
      ax = *reinterpret_cast<const float4*>(a + off);
      bx = *reinterpret_cast<const float4*>(b + off);
    }
    *reinterpret_cast<float4*>(dst_a + r * kD + col) = ax;
    *reinterpret_cast<float4*>(dst_b + r * kD + col) = bx;
  }
}

// Thread (row, half) of an fp32 kernel holds dims 2 i + half of its row.
__device__ __forceinline__ void load_half_row_f32(float (&dst)[kHalfD], const float* src,
                                                  bool valid, int half) {
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dst[i] = valid ? src[2 * i + half] : 0.f;
}

__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int N, float scale) {
  __shared__ __align__(16) float sK[kBlockK * kD];
  __shared__ __align__(16) float sV[kBlockK * kD];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = blockIdx.x * kBlockQ + (tid >> 1);
  const bool valid = row < N;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const size_t row_off = base + static_cast<size_t>(valid ? row : 0) * kD;

  float qr[kHalfD];
  float dor[kHalfD];
  float acc[kHalfD];
  load_half_row_f32(qr, q + row_off, valid, half);
  load_half_row_f32(dor, dout + row_off, valid, half);
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) acc[i] = 0.f;
  const float row_lse = valid ? lse[bh * N + row] : 0.f;
  const float row_delta = valid ? delta[bh * N + row] : 0.f;

  const int num_kt = (N + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    load_tiles_f32(sK, sV, k + base, v + base, k0, N, tid);
    __syncthreads();
    for (int j = 0; j < kBlockK; ++j) {
      const float* kr = sK + j * kD + half;
      const float* vr = sV + j * kD + half;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        s = fmaf(qr[i], kr[2 * i], s);
        dp = fmaf(dor[i], vr[2 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (k0 + j < N) ? expf(s * scale - row_lse) : 0.f;
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(ds, kr[2 * i], acc[i]);
    }
  }

  if (!valid) return;
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dq[row_off + 2 * i + half] = scale * acc[i];
}

__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int N, float scale) {
  __shared__ __align__(16) float sQ[kBlockQ * kD];
  __shared__ __align__(16) float sDo[kBlockQ * kD];
  __shared__ float sLse[kBlockQ];
  __shared__ float sDelta[kBlockQ];

  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = blockIdx.x * kBlockK + (tid >> 1);  // this thread's key
  const bool valid = row < N;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const size_t row_off = base + static_cast<size_t>(valid ? row : 0) * kD;

  float kr[kHalfD];
  float vr[kHalfD];
  float dk_acc[kHalfD];
  float dv_acc[kHalfD];
  load_half_row_f32(kr, k + row_off, valid, half);
  load_half_row_f32(vr, v + row_off, valid, half);
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int num_qt = (N + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    load_tiles_f32(sQ, sDo, q + base, dout + base, q0, N, tid);
    if (tid < kBlockQ) {
      const bool in = q0 + tid < N;
      sLse[tid] = in ? lse[bh * N + q0 + tid] : 0.f;
      sDelta[tid] = in ? delta[bh * N + q0 + tid] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kBlockQ; ++j) {
      const float* qr = sQ + j * kD + half;
      const float* dor = sDo + j * kD + half;
      float s = 0.f;
      float dp = 0.f;
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        s = fmaf(kr[i], qr[2 * i], s);
        dp = fmaf(vr[i], dor[2 * i], dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      const float p = (valid && q0 + j < N) ? expf(s * scale - sLse[j]) : 0.f;
      const float ds = p * (dp - sDelta[j]);
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        dv_acc[i] = fmaf(p, dor[2 * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qr[2 * i], dk_acc[i]);
      }
    }
  }

  if (!valid) return;
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    dk[row_off + 2 * i + half] = scale * dk_acc[i];
    dv[row_off + 2 * i + half] = dv_acc[i];
  }
}

bool bad_shape(int B, int H, int N, int D) {
  return D != kD || B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// Both functions launch on `stream` of `device` and return cudaGetLastError()
// (0 = ok).  q, k, v, dout and the gradients: (B, H, N, D) contiguous, 16-byte
// aligned, bf16 (is_bf16 = 1) or fp32; lse, delta: (B, H, 1, N) fp32.
extern "C" int flash_attn_bwd_dq(int device, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dq, int B, int H, int N, int D, float scale,
                                 int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_bwd_dq_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<uint16_t*>(dq), H, N, scale);
  } else {
    flash_bwd_dq_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dq), H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dkv(int device, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int H, int N, int D, float scale,
                                  int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockK - 1) / kBlockK, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_bwd_dkv_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H, N, scale);
  } else {
    flash_bwd_dkv_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<float*>(dk), static_cast<float*>(dv), H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
