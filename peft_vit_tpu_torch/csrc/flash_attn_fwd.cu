// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (peft_vit_tpu_torch/ops/attention.py).
//
// Replaces the Pallas TPU kernel peft_vit_tpu/ops/attention.py::_flash_fwd_kernel
// (its pallas_call is in _flash_attention_fwd).  Computes, for q, k, v of
// shape (B, H, N, D) and an optional (C, H, N, N) fp32 additive bias, batch
// element b reading cell b / (B / C) (C = 1: shared by the batch; C > 1: a
// sweep round's cells, each with its own relative position table),
//     o   = softmax(scale * q k^T + bias) v        (B, H, N, D), q's dtype
//     lse = m + log(l)                              (B, H, 1, N), fp32
// with p = exp(x - m) rounded to bf16 unnormalised for the second product
// and the sum divided out at the end, as the Pallas kernel does.  Keys >= N
// give p = 0, q rows >= N are not written, and nothing is padded in device
// memory (the TPU kernel pads N to 128 and D to 128 lanes).
//
// What bounds it: at the ViT-B/16 shapes (N = 197, D = 64) the function
// moves 4 B H N D bf16 elements (q, k, v read, o written) against 4 B H N^2 D
// flops, about 100 flops a byte, below the H100's bf16 ridge of about 295:
// it is memory-bound, and the (N, N) scores must stay out of device memory.
//
// bf16: the design of attn_fwd_sm90.cuh (kNormFirst = false).  K and V are
// staged by TMA once per 128 q rows (twice per head at N = 197, not once per
// 64-row tile), behind mbarriers and with no register traffic; both products
// are wgmma; at N <= 256 a row's 200 keys (round_up(N, 8)) are one product,
// its max exact, no online rescale and no padding of keys to 256.  Longer
// sequences stream 64-key tiles through a two-stage ring with the online
// softmax.
// fp32: one thread per q row and fp32 FMAs over 64-key tiles (the tensor
// cores have no full-fp32 mode); not on the main path.
// D = 64 (the ViTs, the text tower) and D = 32 (Swin's heads: at N = 49 one
// of a block's two warpgroups has no q rows, 79 of 128 rows are padding):
// each a template instantiation of the same kernels; any other D is refused.

#include "attn_fwd_sm90.cuh"

namespace {

using namespace flash;

template <int kD>
__global__ void __launch_bounds__(kBlockQ)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     float* __restrict__ o, float* __restrict__ lse,
                     int H, int N, float scale, int bias_batch) {
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
  const size_t cell = static_cast<size_t>(b / bias_batch);
  const float* brow = (bias != nullptr && row < N)
                          ? bias + ((cell * H + h) * static_cast<size_t>(N) + row) * N
                          : nullptr;

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

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* o,
                   void* lse, int B, int H, int N, int bias_cells, float scale, int is_bf16,
                   cudaStream_t s) {
  if (is_bf16) {
    const sm90::FwdArgs args{static_cast<const float*>(bias), static_cast<uint16_t*>(o),
                             static_cast<float*>(lse), H, N, scale, B / bias_cells};
    return sm90::attn_fwd_bf16<false, kD>(q, k, v, args, B, s);
  }
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  flash_fwd_f32_kernel<kD><<<grid, kBlockQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<float*>(o), static_cast<float*>(lse), H, N, scale, B / bias_cells);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
// q, k, v, o: (B, H, N, D) contiguous, 16-byte aligned, D 32 or 64, bf16
// (is_bf16 = 1) or fp32; bias: (C, H, N, N) fp32 with C = bias_cells dividing B, or NULL;
// lse: (B, H, 1, N) fp32 or NULL.
extern "C" int flash_attn_fwd(int device, const void* q, const void* k, const void* v,
                              const void* bias, void* o, void* lse, int B, int H, int N,
                              int D, int bias_cells, float scale, int is_bf16, void* stream) {
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535 || bias_cells <= 0 ||
      B % bias_cells != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D == 32 ? launch<32>(q, k, v, bias, o, lse, B, H, N, bias_cells, scale, is_bf16, s)
              : launch<64>(q, k, v, bias, o, lse, B, H, N, bias_cells, scale, is_bf16, s));
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
