// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (peft_vit_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel peft_vit_tpu/ops/attention.py::_flash_fwd_kernel
// (its pallas_call is in _flash_attention_fwd).  Computes, for q, k, v of
// shape (B, H, N, D) and an optional (H, N, N) fp32 additive bias shared by
// the batch,
//     o   = softmax(scale * q k^T + bias) v        (B, H, N, D), q's dtype
//     lse = m + log(l)                              (B, H, 1, N), fp32
// with an online softmax: keys >= N are masked to -1e30, q rows >= N are
// neither computed into the result nor written, and nothing is padded in
// device memory (the TPU kernel pads N to 128 and D to 128 lanes).
//
// What bounds it: at the ViT-B/16 serving shapes (N = 197, D = 64) the
// function moves 4*B*H*N*D*2 bytes (q, k, v read, o written) against
// 4*B*H*N^2*D flops, about 100 flops per byte, below the H100's bf16 ridge
// of about 295, so it is memory-bound.  The design keeps the (N, N) scores
// out of device memory: a block stages one 64-row q tile in shared memory
// and streams 64-key K/V tiles through it, the running max and sum stay in
// registers, and o is written once.  K and V are read once per q tile (four
// times at N = 197); the re-reads come mostly from the 50 MB L2.
//
// bf16: one block of 4 warps per (64-row q tile, head, batch); each warp
// owns 16 q rows and runs mma.sync m16n8k16 bf16 x bf16 -> fp32 for both
// q k^T and p v.  p is rounded to bf16 for the second product and the sum l
// is taken over the fp32 p, as the Pallas kernel does.  The score tile goes
// from the first product's accumulators straight into the second product's
// A fragments, without shared memory.
// fp32: the same tiling with one thread per q row and fp32 FMAs (the
// tensor cores have no full-fp32 mode).
// D = 64 only.  wgmma, TMA and warp specialisation are left for later.

#include "flash_common.cuh"

namespace {

using namespace flash;

__global__ void __launch_bounds__(kThreadsBf16)
flash_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const float* __restrict__ bias,
                      uint16_t* __restrict__ o, float* __restrict__ lse,
                      int H, int N, float scale) {
  __shared__ __align__(16) uint16_t sQ[kBlockQ * kLds];
  __shared__ __align__(16) uint16_t sK[kBlockK * kLds];
  __shared__ __align__(16) uint16_t sV[kBlockK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  load_tile_bf16(sQ, q + base, q0, N, tid);
  __syncthreads();

  // This thread's two rows of the tile: r0 and r0 + 8.
  const int r0 = warp * 16 + g;
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const uint16_t* p = sQ + r0 * kLds + kk * 16 + 2 * t;
    qa[kk][0] = ld_u32(p);
    qa[kk][1] = ld_u32(p + 8 * kLds);
    qa[kk][2] = ld_u32(p + 8);
    qa[kk][3] = ld_u32(p + 8 * kLds + 8);
  }

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const float* brow[2] = {nullptr, nullptr};
  if (bias != nullptr) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qrow[r] < N) brow[r] = bias + (static_cast<size_t>(h) * N + qrow[r]) * N;
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-thread partial sums; reduced over the quad at the end

  const int num_kt = (N + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16(sK, k + base, k0, N, tid);
    load_tile_bf16(sV, v + base, k0, N, tid);
    __syncthreads();

    // s = q k^T: 16 rows x 64 keys per warp, as 8 tiles of 8 keys.
    float s[kBlockK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint16_t* kr = sK + (nt * 8 + g) * kLds + kk * 16 + 2 * t;
        mma_bf16(s[nt], qa[kk], ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // scale, bias, key mask, row max
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        float x = s[nt][i] * scale;
        if (key < N) {
          if (brow[r] != nullptr) x += brow[r][key];
        } else {
          x = kNegInf;
        }
        s[nt][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // p = exp(s - m): fp32 into the row sums, bf16 into the A fragments of
    // the p v product (key tiles 2kk and 2kk+1 make k-step kk).
    uint32_t pa[kBlockK / 16][4];
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
      const float p0 = __expf(s[nt][0] - m[0]);
      const float p1 = __expf(s[nt][1] - m[0]);
      const float p2 = __expf(s[nt][2] - m[1]);
      const float p3 = __expf(s[nt][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      const int half = nt & 1;
      pa[nt >> 1][2 * half + 0] = pack_bf16(p0, p1);
      pa[nt >> 1][2 * half + 1] = pack_bf16(p2, p3);
    }

    // acc += p v: 16 rows x 64 dims per warp, as 8 tiles of 8 dims.
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk) {
        const uint16_t* vc = sV + (kk * 16 + 2 * t) * kLds + dt * 8 + g;
        const uint32_t b0 = static_cast<uint32_t>(vc[0]) |
                            (static_cast<uint32_t>(vc[kLds]) << 16);
        const uint32_t b1 = static_cast<uint32_t>(vc[8 * kLds]) |
                            (static_cast<uint32_t>(vc[9 * kLds]) << 16);
        mma_bf16(acc[dt], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow[r];
    if (row >= N) continue;
    uint16_t* orow = o + base + static_cast<size_t>(row) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r] / l[r], acc[dt][2 * r + 1] / l[r]);
    }
    if (lse != nullptr && t == 0) lse[bh * N + row] = m[r] + logf(l[r]);
  }
}

__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse,
                     int H, int N, float scale) {
  constexpr int kChunk = 16;  // keys per online-softmax update
  __shared__ __align__(16) float sK[kBlockK * kD];
  __shared__ __align__(16) float sV[kBlockK * kD];

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int row = blockIdx.x * kBlockQ + tid;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < N) x = *reinterpret_cast<const float4*>(q + base + static_cast<size_t>(row) * kD + d);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
  }
  const float* brow =
      (bias != nullptr && row < N) ? bias + (static_cast<size_t>(h) * N + row) * N : nullptr;

  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int num_kt = (N + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int c = tid; c < kBlockK * kD / 4; c += kBlockQ) {
      const int r = c / (kD / 4);
      const int col = (c % (kD / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vx = kx;
      if (k0 + r < N) {
        const size_t off = base + static_cast<size_t>(k0 + r) * kD + col;
        kx = *reinterpret_cast<const float4*>(k + off);
        vx = *reinterpret_cast<const float4*>(v + off);
      }
      *reinterpret_cast<float4*>(sK + r * kD + col) = kx;
      *reinterpret_cast<float4*>(sV + r * kD + col) = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < kBlockK; j0 += kChunk) {
      float s[kChunk];
      float mx = kNegInf;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const int key = k0 + j0 + jj;
        const float* kr = sK + (j0 + jj) * kD;
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], kr[d], dot);
        float x = dot * scale;
        if (key < N) {
          if (brow != nullptr) x += brow[key];
        } else {
          x = kNegInf;
        }
        s[jj] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m, mx);
      const float alpha = expf(m - m_new);
      m = m_new;
      l *= alpha;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m);
        l += p;
        const float* vr = sV + (j0 + jj) * kD;
#pragma unroll
        for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
      }
    }
  }

  if (row >= N) return;
  float* orow = o + base + static_cast<size_t>(row) * kD;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(acc[d] / l, acc[d + 1] / l, acc[d + 2] / l, acc[d + 3] / l);
  }
  if (lse != nullptr) lse[bh * N + row] = m + logf(l);
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
// q, k, v, o: (B, H, N, D) contiguous, 16-byte aligned, bf16 (is_bf16 = 1) or
// fp32; bias: (H, N, N) fp32 or NULL; lse: (B, H, 1, N) fp32 or NULL.
extern "C" int flash_attn_fwd(int device, const void* q, const void* k, const void* v,
                              const void* bias, void* o, void* lse, int B, int H, int N,
                              int D, float scale, int is_bf16, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    flash_fwd_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const float*>(bias),
        static_cast<uint16_t*>(o), static_cast<float*>(lse), H, N, scale);
  } else {
    flash_fwd_f32_kernel<<<grid, kBlockQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(o), static_cast<float*>(lse), H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
