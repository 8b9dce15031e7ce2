// Flash-attention backward for Hopper (sm_90a): two kernels with a plain C
// interface loaded through ctypes (peft_vit_tpu_torch/ops/attention.py).
//
// Replace the Pallas TPU kernels of peft_vit_tpu/ops/attention.py:
//   flash_attn_bwd_dq   <- _flash_bwd_dq_kernel   (K2)
//   flash_attn_bwd_dkv  <- _flash_bwd_dkv_kernel  (K3)
// (their pallas_calls are in _flash_attention_bwd).  For q, k, v, o, dO of
// shape (B, H, N, D), the forward's lse (B, H, 1, N) fp32 and its optional
// (C, H, N, N) fp32 bias (batch element b reads cell b / (B / C)) they
// compute
//     delta = rowsum(dO o O)            (K2 computes it, writes it, K3 reads it)
//     p  = exp(scale * q k^T + bias - lse)     ds = p o (dO v^T - delta)
//     dq = scale * ds k        dk = scale * ds^T q        dv = p^T dO
// The Pallas kernels have no bias: with one the JAX package leaves them for
// the XLA VJP of its reference (_attention_bias_vjp_bwd), which this bias
// path and attn_bias_grad.cu (the bias's own gradient, K7) replace on the
// card.
// p and ds are recomputed tile by tile from the saved lse and never reach
// device memory.  p is rounded to the operand dtype before p^T dO and ds
// before its two products, as in the Pallas kernels; sums are fp32.  Nothing
// is padded in device memory (the TPU kernels pad N and D to 128): p = 0 for
// keys >= N and for q rows >= N, and rows >= N are not written.  The Pallas
// wrapper computes delta in XLA before the kernels; here K2 computes it from
// the dO tile it already holds and O, which saves the several launches and
// the two extra reads of dO and O of a separate delta pass.
//
// What bounds them: at the ViT-B/16 training shapes (N = 197, D = 64, bf16)
// K2 reads q, k, v, o, dO and lse and writes dq and delta, 6 B H N D bytes
// and 8 B H N more, against 6 B H N^2 D flops; K3 reads q, k, v, dO, lse and
// delta and writes dk and dv, 6 B H N D bytes and 8 B H N, against 8 B H N^2 D
// flops: 100 and 130 flops a byte, below the H100's bf16 ridge of about 295,
// so both are bounded by bytes, each at about 8.8 us at B = 16.  Counted with
// the padding the tiles give (64-row tiles and chunks: N = 197 computes as
// 256 x 256), the flops are 1.69 times the useful ones and bring the two
// bounds close; what the design spends is the latency of each chunk's
// products and exponentials, hidden only by the other warpgroups on the SM.
//
// bf16: attn_bwd_sm90.cuh (TMA staging through 3-D tensor maps, wgmma
// products, 64-row chunks through a two-stage ring, the last chunk cut to
// its rows).
// fp32: one block of 128 threads per (64-row tile, head, batch), two threads
// per owned row (each holds every other dim) and fp32 FMAs; the two halves of
// a dot product meet in one shuffle; the bias (kBias) read from device
// memory per element.  It exists so that fp32 training on the card can be
// held tightly against the CPU.  D = 64 only.

#include "attn_bwd_sm90.cuh"

namespace {

using namespace flash;

constexpr int kThreadsF32 = 2 * kBlockQ;  // two threads per owned row
constexpr int kHalfD = kD / 2;

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

// The bias of batch element b's cell, head h: its (N, N) matrix.
__device__ __forceinline__ const float* cell_bias(const float* bias, int b, int h, int H, int N,
                                                  int bias_batch) {
  return bias + (static_cast<size_t>(b / bias_batch) * H + h) * N * static_cast<size_t>(N);
}

template <bool kBias>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dout,
                        const float* __restrict__ o, const float* __restrict__ lse,
                        float* __restrict__ delta, float* __restrict__ dq, int H, int N,
                        float scale, const float* __restrict__ bias, int bias_batch) {
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
  // delta = rowsum(dO o O): this thread's half of the row, then the other's
  float row_delta = 0.f;
  {
    float orow[kHalfD];
    load_half_row_f32(orow, o + row_off, valid, half);
#pragma unroll
    for (int i = 0; i < kHalfD; ++i) row_delta = fmaf(dor[i], orow[i], row_delta);
  }
  row_delta += __shfl_xor_sync(0xffffffffu, row_delta, 1);
  if (valid && half == 0) delta[bh * N + row] = row_delta;
  const float* brow = kBias ? cell_bias(bias, blockIdx.z, blockIdx.y, H, N, bias_batch) +
                                  static_cast<size_t>(valid ? row : 0) * N
                            : nullptr;

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
      float p = 0.f;
      if (k0 + j < N) p = kBias ? expf(s * scale + brow[k0 + j] - row_lse) : expf(s * scale - row_lse);
      const float ds = p * (dp - row_delta);
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(ds, kr[2 * i], acc[i]);
    }
  }

  if (!valid) return;
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dq[row_off + 2 * i + half] = scale * acc[i];
}

template <bool kBias>
__global__ void __launch_bounds__(kThreadsF32)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int N, float scale, const float* __restrict__ bias,
                         int bias_batch) {
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

  // this thread's key column of its cell's bias
  const float* bcol = kBias ? cell_bias(bias, blockIdx.z, blockIdx.y, H, N, bias_batch) +
                                  (valid ? row : 0)
                            : nullptr;
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
      float p = 0.f;
      if (valid && q0 + j < N) {
        p = kBias ? expf(s * scale + bcol[static_cast<size_t>(q0 + j) * N] - sLse[j])
                  : expf(s * scale - sLse[j]);
      }
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

bool bad_shape(int B, int H, int N, int D, int bias_cells) {
  return D != kD || B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535 || bias_cells <= 0 ||
         B % bias_cells != 0;
}

}  // namespace

// Both functions launch on `stream` of `device` and return cudaGetLastError()
// (0 = ok).  q, k, v, o, dout and the gradients: (B, H, N, D) contiguous,
// 16-byte aligned, bf16 (is_bf16 = 1) or fp32; lse, delta: (B, H, 1, N) fp32;
// bias: the forward's (C, H, N, N) fp32 with C = bias_cells dividing B, or
// NULL.  flash_attn_bwd_dq writes dq and delta; flash_attn_bwd_dkv reads
// delta.
extern "C" int flash_attn_bwd_dq(int device, const void* q, const void* k, const void* v,
                                 const void* dout, const void* o, const void* lse,
                                 const void* bias, void* delta, void* dq, int B, int H, int N,
                                 int D, int bias_cells, float scale, int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D, bias_cells)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b32 = static_cast<const float*>(bias);
  if (is_bf16) {
    sm90::BwdArgs args{static_cast<const uint16_t*>(o), static_cast<const float*>(lse),
                       static_cast<float*>(delta), static_cast<uint16_t*>(dq), nullptr,
                       nullptr, H, N, scale, b32, B / bias_cells};
    return static_cast<int>(
        b32 ? sm90::attn_bwd_bf16<sm90::kRoleDq, true>(q, k, v, dout, args, B, s)
            : sm90::attn_bwd_bf16<sm90::kRoleDq>(q, k, v, dout, args, B, s));
  }
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  auto kernel = b32 ? flash_bwd_dq_f32_kernel<true> : flash_bwd_dq_f32_kernel<false>;
  kernel<<<grid, kThreadsF32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), H, N, scale, b32, B / bias_cells);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_bwd_dkv(int device, const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse, const void* delta,
                                  const void* bias, void* dk, void* dv, int B, int H, int N,
                                  int D, int bias_cells, float scale, int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D, bias_cells)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b32 = static_cast<const float*>(bias);
  if (is_bf16) {
    sm90::BwdArgs args{nullptr, static_cast<const float*>(lse),
                       const_cast<float*>(static_cast<const float*>(delta)), nullptr,
                       static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H, N, scale,
                       b32, B / bias_cells};
    return static_cast<int>(
        b32 ? sm90::attn_bwd_bf16<sm90::kRoleDkv, true>(q, k, v, dout, args, B, s)
            : sm90::attn_bwd_bf16<sm90::kRoleDkv>(q, k, v, dout, args, B, s));
  }
  const dim3 grid((N + kBlockK - 1) / kBlockK, H, B);
  auto kernel = b32 ? flash_bwd_dkv_f32_kernel<true> : flash_bwd_dkv_f32_kernel<false>;
  kernel<<<grid, kThreadsF32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), H, N, scale, b32, B / bias_cells);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a bf16 K2 or K3 block asks for (bytes).
extern "C" int flash_attn_bwd_smem_bytes() { return sm90::kBwdSmemBytes; }

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
