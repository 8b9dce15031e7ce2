// The attention bias's gradient (K7) for Hopper (sm_90a), with a plain C
// interface loaded through ctypes (peft_vit_tpu_torch/ops/attention.py).
//
// No Pallas kernel computes it: with a bias the JAX package leaves its flash
// kernels for the XLA VJP of attention_reference
// (peft_vit_tpu/ops/attention.py::_attention_bias_vjp_bwd), whose bias
// cotangent this kernel computes on the card.  For q, k, v, dO of shape
// (B, H, N, D), the forward's lse (B, H, 1, N) fp32 and its (C, H, N, N) fp32
// bias (batch element b reads cell b / (B / C)):
//     p  = exp(scale q k^T + bias - lse)        dp = dO v^T
//     dbias[c] = sum over the batch elements b of cell c of p o (dp - delta)
// with delta = rowsum(dO o O) read from the dq kernel (K2) where it ran, or
// computed here from O where it did not (the first block of a model whose
// relative position tables train while its q, k and v need no gradient).
// ds is summed unrounded in fp32, as the VJP sums its fp32 ds over the batch;
// the caller rounds dbias to the bias's dtype.  Keys and q rows at or beyond
// N contribute nothing and are not written.
//
// Deterministic: a block owns one 64 x 64 tile of one (cell, head) of dbias
// and walks its cell's batch elements in order, so no sum crosses blocks and
// no atomic is used: a step captured as a CUDA graph equals its eager run bit
// for bit.
//
// What bounds it: it reads q, k, v and dO (4 B H N D bf16), lse and delta
// and the bias, and writes dbias (C H N^2 fp32), against two products of
// 2 B H N^2 D flops each: at ViT-B/16 (N = 197, D = 64, B = 16) about 23 MB
// against 1.9 GFLOP, below the H100's bf16 ridge: bytes bound it, at about
// 7 us.  The design is the simplest that is right: each block stages its
// batch element's four 64-row tiles into shared memory with 16-byte loads,
// one element after another, and each warp forms its 16 rows' S and dP with
// mma.sync (the bf16 helpers of flash_common.cuh); a tile of q and dO is read
// once per key tile (4 times a head at N = 197), mostly from L2.  A
// pipelined or wgmma design is later work.
//
// fp32: 32 x 32 tiles, eight threads a q row, fp32 FMAs from shared memory;
// not on the main path (fp32 training on the card, held against the CPU).
// D = 64 only.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr float kInf = __builtin_huge_valf();

// bf16: 4 warps; warp w owns tile rows 16 w + g and 16 w + g + 8 (g = lane
// / 4) over all 64 keys, as eight m16n8 accumulators.
__global__ void __launch_bounds__(kThreadsBf16)
bias_grad_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
                      const uint16_t* __restrict__ o, const float* __restrict__ lse,
                      const float* __restrict__ delta, const float* __restrict__ bias,
                      float* __restrict__ dbias, int H, int N, int bias_batch, float scale) {
  __shared__ __align__(16) uint16_t sQ[kBlockQ * kLds];
  __shared__ __align__(16) uint16_t sDo[kBlockQ * kLds];
  __shared__ __align__(16) uint16_t sK[kBlockK * kLds];
  __shared__ __align__(16) uint16_t sV[kBlockK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int k0 = blockIdx.x * kBlockK;
  const int q0 = blockIdx.y * kBlockQ;
  const int ch = blockIdx.z;  // cell * H + head
  const int cell = ch / H;
  const int h = ch % H;
  const int r0 = 16 * warp + g;
  const int row[2] = {q0 + r0, q0 + r0 + 8};
  const size_t plane = static_cast<size_t>(ch) * N * N;

  // this thread's bias elements (the same for every batch element): key
  // k0 + 8 n + 2 t + (e & 1) of row row[e >> 1], the m16n8 C layout
  float bx[kBlockK / 8][4];
  float acc[kBlockK / 8][4];
#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      const int key = k0 + 8 * n + 2 * t + (e & 1);
      bx[n][e] = (r < N && key < N) ? bias[plane + static_cast<size_t>(r) * N + key] : 0.f;
      acc[n][e] = 0.f;
    }
  }

  for (int i = 0; i < bias_batch; ++i) {
    const size_t bh = static_cast<size_t>(cell * bias_batch + i) * H + h;
    const size_t base = bh * static_cast<size_t>(N) * kD;
    __syncthreads();  // the previous element's tiles are consumed
    load_tile_bf16(sQ, q + base, q0, N, tid);
    load_tile_bf16(sDo, dout + base, q0, N, tid);
    load_tile_bf16(sK, k + base, k0, N, tid);
    load_tile_bf16(sV, v + base, k0, N, tid);
    __syncthreads();

    // rows >= N: lse = +inf, so p = 0 there
    float row_lse[2], row_delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < N;
      row_lse[r] = in ? lse[bh * N + row[r]] : kInf;
      if (delta != nullptr) {
        row_delta[r] = in ? delta[bh * N + row[r]] : 0.f;
      } else {
        // rowsum(dO o O): this thread's 16 dims of the row, then its quad's
        float sum = 0.f;
        if (in) {
          const uint16_t* drow = sDo + (r0 + 8 * r) * kLds + 16 * t;
          const uint16_t* orow = o + base + static_cast<size_t>(row[r]) * kD + 16 * t;
#pragma unroll
          for (int d = 0; d < 16; d += 2) {
            const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(drow + d));
            const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(orow + d));
            sum = fmaf(df.x, of.x, sum);
            sum = fmaf(df.y, of.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        row_delta[r] = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
      }
    }

    uint32_t aq[kD / 16][4], ado[kD / 16][4];
    load_a_frags(aq, sQ, r0, t);
    load_a_frags(ado, sDo, r0, t);
#pragma unroll
    for (int n = 0; n < kBlockK / 8; ++n) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      float dp[4] = {0.f, 0.f, 0.f, 0.f};
      mma_rows_as_cols(s, aq, sK, 8 * n, g, t);
      mma_rows_as_cols(dp, ado, sV, 8 * n, g, t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        if (k0 + 8 * n + 2 * t + (e & 1) < N) {
          const float p = expf(s[e] * scale + bx[n][e] - row_lse[r]);
          acc[n][e] = fmaf(p, dp[e] - row_delta[r], acc[n][e]);
        }
      }
    }
  }

#pragma unroll
  for (int n = 0; n < kBlockK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row[e >> 1];
      const int key = k0 + 8 * n + 2 * t + (e & 1);
      if (r < N && key < N) dbias[plane + static_cast<size_t>(r) * N + key] = acc[n][e];
    }
  }
}

constexpr int kTileF32 = 32;
constexpr int kThreadsF32 = 256;  // eight threads a q row
constexpr int kLdsF32 = kD + 1;   // padded: a warp's key rows fall in distinct banks

__global__ void __launch_bounds__(kThreadsF32)
bias_grad_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ o, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ bias,
                     float* __restrict__ dbias, int H, int N, int bias_batch, float scale) {
  __shared__ float sQ[kTileF32 * kLdsF32];
  __shared__ float sDo[kTileF32 * kLdsF32];
  __shared__ float sK[kTileF32 * kLdsF32];
  __shared__ float sV[kTileF32 * kLdsF32];
  __shared__ float sLse[kTileF32];
  __shared__ float sDelta[kTileF32];

  const int tid = threadIdx.x;
  const int i = tid >> 3;      // this thread's q row of the tile
  const int part = tid & 7;    // and its keys part, part + 8, ...
  const int k0 = blockIdx.x * kTileF32;
  const int q0 = blockIdx.y * kTileF32;
  const int ch = blockIdx.z;
  const int cell = ch / H;
  const int h = ch % H;
  const size_t plane = static_cast<size_t>(ch) * N * N;
  constexpr int kKeys = kTileF32 / 8;

  float bx[kKeys], acc[kKeys];
#pragma unroll
  for (int m = 0; m < kKeys; ++m) {
    const int key = k0 + part + 8 * m;
    bx[m] = (q0 + i < N && key < N) ? bias[plane + static_cast<size_t>(q0 + i) * N + key] : 0.f;
    acc[m] = 0.f;
  }

  for (int b = 0; b < bias_batch; ++b) {
    const size_t bh = static_cast<size_t>(cell * bias_batch + b) * H + h;
    const size_t base = bh * static_cast<size_t>(N) * kD;
    __syncthreads();
    for (int c = tid; c < kTileF32 * kD; c += kThreadsF32) {
      const int r = c / kD;
      const int d = c % kD;
      const bool qin = q0 + r < N;
      const bool kin = k0 + r < N;
      sQ[r * kLdsF32 + d] = qin ? q[base + static_cast<size_t>(q0 + r) * kD + d] : 0.f;
      sDo[r * kLdsF32 + d] = qin ? dout[base + static_cast<size_t>(q0 + r) * kD + d] : 0.f;
      sK[r * kLdsF32 + d] = kin ? k[base + static_cast<size_t>(k0 + r) * kD + d] : 0.f;
      sV[r * kLdsF32 + d] = kin ? v[base + static_cast<size_t>(k0 + r) * kD + d] : 0.f;
    }
    if (tid < kTileF32) {
      const bool in = q0 + tid < N;
      sLse[tid] = in ? lse[bh * N + q0 + tid] : kInf;
      if (delta != nullptr) sDelta[tid] = in ? delta[bh * N + q0 + tid] : 0.f;
    }
    __syncthreads();
    if (delta == nullptr) {
      // rowsum(dO o O): eight threads a row, eight dims each, then a shuffle
      float sum = 0.f;
      if (q0 + i < N) {
        const float* orow = o + base + static_cast<size_t>(q0 + i) * kD;
#pragma unroll
        for (int d = 8 * part; d < 8 * part + 8; ++d) sum = fmaf(sDo[i * kLdsF32 + d], orow[d], sum);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      if (part == 0) sDelta[i] = sum;
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < kKeys; ++m) {
      const int kj = part + 8 * m;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < kD; ++d) {
        s = fmaf(sQ[i * kLdsF32 + d], sK[kj * kLdsF32 + d], s);
        dp = fmaf(sDo[i * kLdsF32 + d], sV[kj * kLdsF32 + d], dp);
      }
      if (k0 + kj < N) {
        const float p = expf(s * scale + bx[m] - sLse[i]);
        acc[m] = fmaf(p, dp - sDelta[i], acc[m]);
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kKeys; ++m) {
    const int key = k0 + part + 8 * m;
    if (q0 + i < N && key < N) dbias[plane + static_cast<size_t>(q0 + i) * N + key] = acc[m];
  }
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
// q, k, v, dout, o: (B, H, N, D) contiguous, 16-byte aligned, bf16 (is_bf16 =
// 1) or fp32; o may be NULL when delta is given; lse, delta: (B, H, 1, N)
// fp32, delta NULL to compute it from o; bias, dbias: (C, H, N, N) fp32 with
// C = bias_cells dividing B.
extern "C" int attn_bias_grad(int device, const void* q, const void* k, const void* v,
                              const void* dout, const void* o, const void* lse, const void* delta,
                              const void* bias, void* dbias, int B, int H, int N, int D,
                              int bias_cells, float scale, int is_bf16, void* stream) {
  if (D != kD || B <= 0 || H <= 0 || N <= 0 || bias_cells <= 0 || B % bias_cells != 0 ||
      static_cast<size_t>(bias_cells) * H > 65535 || bias == nullptr ||
      (delta == nullptr && o == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bias_batch = B / bias_cells;
  if (is_bf16) {
    const dim3 grid((N + kBlockK - 1) / kBlockK, (N + kBlockQ - 1) / kBlockQ, bias_cells * H);
    bias_grad_bf16_kernel<<<grid, kThreadsBf16, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
        static_cast<const uint16_t*>(o), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(bias),
        static_cast<float*>(dbias), H, N, bias_batch, scale);
  } else {
    const dim3 grid((N + kTileF32 - 1) / kTileF32, (N + kTileF32 - 1) / kTileF32,
                    bias_cells * H);
    bias_grad_f32_kernel<<<grid, kThreadsF32, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout),
        static_cast<const float*>(o), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<const float*>(bias),
        static_cast<float*>(dbias), H, N, bias_batch, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
