// Fused short-sequence attention for Hopper (sm_90a): a forward and a
// backward kernel with a plain C interface loaded through ctypes
// (peft_vit_tpu_torch/ops/attention.py).
//
// Replace the Pallas TPU kernels of peft_vit_tpu/ops/attention.py:
//   fused_short_attn_fwd  <- _short_fwd_kernel  (pallas_call in _fused_short_fwd)
//   fused_short_attn_bwd  <- _short_bwd_kernel  (pallas_call in _fused_short_bwd)
// For q, k, v of shape (B, H, N, D), bias-free, per head:
//   forward   s = scale * q k^T (fp32)    m = max s    p = exp(s - m)    l = sum p
//             o = ((p / l) -> dtype) v    lse = m + log l
//   backward  p = exp(s - lse)           dv = (p -> dtype)^T dO
//             dp = dO v^T                delta = rowsum(dO o O)  (in the kernel)
//             ds = (scale * p * (dp - delta)) -> dtype
//             dq = ds k                  dk = ds^T q
// Every product sums in fp32 and writes the operand dtype.  Two points
// separate this pair from the flash kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the probabilities are normalised BEFORE they are
// rounded to the operand dtype, and the scale is folded into ds before its
// rounding; the backward takes no delta operand.
//
// The TPU kernel runs one program per batch element holding every head and
// the whole padded sequence in VMEM.  That does not fit this card: B blocks
// are 8-32 for 132 SMs, and K and V of 12 heads at N = 1024 are 3 MB against
// 227 KB of shared memory a block.
// * forward, bf16: the design of attn_fwd_sm90.cuh (kNormFirst = true), the
//   same mainloop as the flash forward with p normalised before rounding.
//   A block of two warpgroups owns 128 q rows of a head; TMA stages K and V
//   behind mbarriers and both products are wgmma.  At N <= 256 the head's K
//   and V are resident, a row's keys are one product of width round_up(N,
//   8), and its max and sum are exact before p / l is rounded: one pass,
//   q k^T computed once.  Beyond, 64-key tiles stream through a two-stage
//   ring twice (K alone for the max and sum, then K and V): streaming keeps
//   shared memory at 49 KB for every N, where a resident K would take 128 KB
//   at N = 1,024 and leave one block a SM; the second pass's K comes from
//   L2.
// * forward, fp32: one thread per q row, two passes over 64-key tiles,
//   fp32 FMAs (the tensor cores have no full-fp32 mode).
// * backward, bf16: one launch of the Hopper backward mainloops of
//   attn_bwd_sm90.cuh (kRoleFused), no atomics, no block waiting on another,
//   a deterministic result.  Blocks of one warpgroup own 64 rows of a head:
//   the dk/dv blocks (first in the block order: the longer role) own a key
//   tile and stream the q rows and dO through a two-stage TMA ring (K3's
//   body, transposed products k q^T and v dO^T so that p^T and ds^T are the
//   A fragments of p^T dO and ds^T q); the dq blocks own a q tile and stream
//   K and V (K2's body).  Every product is wgmma; the last chunk of a head
//   is cut to round_up(rows, 8) columns.  delta is computed inside: a dq
//   block from its dO tile and O, as K2; a dk/dv block per q chunk from the
//   chunk's dO tile in the ring and its O rows, copied by cp.async a chunk
//   ahead.  The scale is folded into ds before ds is rounded, and nothing
//   is scaled after the products.
// * backward, fp32: the same two roles by block index (x < T: dq, else dk
//   and dv), two threads a row and fp32 FMAs; each block computes delta for
//   the q rows it stages from O and dO, and tiles are staged with cp.async
//   (a row at or beyond N is zero-filled in shared memory).
// No padding in device memory: a key at or beyond N gives p = 0 and a q row
// at or beyond N is not written.
//
// What bounds them: at N = 197, D = 64 the forward reads q, k, v and writes
// o (4 B H N D elements) against 4 B H N^2 D flops; the backward reads q, k,
// v, o, dO and writes dq, dk, dv (8 B H N D) against 10 B H N^2 D flops
// (five products).  Both sit near 100 flops a byte, below the H100's bf16
// ridge of about 295: memory-bound.  Counted with the 64-row padding of the
// tiles (N = 197 computes as 256 on both sides) the backward's products are
// 1.69 times the useful ones, and the bf16 backward's dk/dv blocks read O
// once per key tile; what its design spends is the latency of each chunk's
// products and exponentials, hidden by the other blocks on the SM.  D = 64
// only (kD below; the shared mainloops are built at this head dim).

#include "attn_bwd_sm90.cuh"

namespace {

using namespace flash;

constexpr int kD = 64;         // the pair's only head dim
constexpr int kThreads = 128;  // every block of both kernels
constexpr int kHalfD = kD / 2;

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 64 rows x 64 fp32 into shared (row stride kD); rows >= n are zero.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int row0, int n,
                                          int tid, int threads) {
  for (int c = tid; c < kBlockK * kD / 4; c += threads) {
    const int r = c / (kD / 4);
    const int col = (c % (kD / 4)) * 4;
    const bool valid = row0 + r < n;
    sm90::cp_async_16(dst + r * kD + col,
                      src + static_cast<size_t>(valid ? row0 + r : 0) * kD + col, valid);
  }
}

// delta = rowsum(dO o O) in fp32 for the 64 rows row0.. into sDelta (0 for
// rows >= n), two threads a row, each over half the dims; o and dout point at
// the head's (N, D) slab.  Needs all kThreads threads.
__device__ __forceinline__ void tile_delta(float* sDelta, const float* o, const float* dout,
                                           int row0, int n, int tid) {
  const int r = tid >> 1;
  const int half = tid & 1;
  float acc = 0.f;
  if (row0 + r < n) {
    const size_t off = static_cast<size_t>(row0 + r) * kD + half * kHalfD;
#pragma unroll 8
    for (int i = 0; i < kHalfD; ++i) acc = fmaf(o[off + i], dout[off + i], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) sDelta[r] = acc;
}

// ----------------------------------------------------------------------------
// forward

// fp32: one thread per q row (64 a block), the row in registers, fp32 FMAs.
__global__ void __launch_bounds__(kBlockQ)
short_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int N, float scale) {
  __shared__ __align__(16) float sK[kBlockK * kD];
  __shared__ __align__(16) float sV[kBlockK * kD];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockQ + tid;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const int num_kt = (N + kBlockK - 1) / kBlockK;

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

  // pass 1: m and l over every key, online over the key tiles
  float m = kNegInf;
  float l = 0.f;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    stage_f32(sK, k + base, k0, N, tid, kBlockQ);
    cp_async_wait_all();
    __syncthreads();
    const int keys = min(kBlockK, N - k0);
    float mx = kNegInf;
    for (int j = 0; j < keys; ++j) {
      const float* kr = sK + j * kD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], kr[d], dot);
      mx = fmaxf(mx, dot * scale);
    }
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int j = 0; j < keys; ++j) {
      const float* kr = sK + j * kD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], kr[d], dot);
      sum += expf(dot * scale - m_new);
    }
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }

  // pass 2: acc += (p / l) v
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.f;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    stage_f32(sK, k + base, k0, N, tid, kBlockQ);
    stage_f32(sV, v + base, k0, N, tid, kBlockQ);
    cp_async_wait_all();
    __syncthreads();
    const int keys = min(kBlockK, N - k0);
    for (int j = 0; j < keys; ++j) {
      const float* kr = sK + j * kD;
      const float* vr = sV + j * kD;
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < kD; ++d) dot = fmaf(qr[d], kr[d], dot);
      const float p = expf(dot * scale - m) / l;
#pragma unroll
      for (int d = 0; d < kD; ++d) acc[d] = fmaf(p, vr[d], acc[d]);
    }
  }

  if (row >= N) return;
  float* orow = o + base + static_cast<size_t>(row) * kD;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    *reinterpret_cast<float4*>(orow + d) = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
  }
  if (lse != nullptr) lse[bh * N + row] = m + logf(l);
}

// ----------------------------------------------------------------------------
// backward, fp32: two threads per owned row (each holds every other dim),
// the two halves of a dot product meet in one shuffle.

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;
  void* dq;
  void* dk;
  void* dv;
  int H;
  int N;
  float scale;
};

// Thread (row, half) of an fp32 role holds dims 2 i + half of its row.
__device__ __forceinline__ void load_half_row_f32(float (&dst)[kHalfD], const float* src,
                                                  bool valid, int half) {
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dst[i] = valid ? src[2 * i + half] : 0.f;
}

__device__ __forceinline__ void short_bwd_dq_f32(const BwdArgs& a, int q0, size_t bh,
                                                 float* sK, float* sV) {
  const float* o = static_cast<const float*>(a.o);
  const int N = a.N;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = q0 + (tid >> 1);
  const bool valid = row < N;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const size_t row_off = base + static_cast<size_t>(valid ? row : 0) * kD;

  float qr[kHalfD];
  float dor[kHalfD];
  float acc[kHalfD];
  load_half_row_f32(qr, static_cast<const float*>(a.q) + row_off, valid, half);
  load_half_row_f32(dor, static_cast<const float*>(a.dout) + row_off, valid, half);
  float delta = 0.f;
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    acc[i] = 0.f;
    if (valid) delta = fmaf(o[row_off + 2 * i + half], dor[i], delta);
  }
  delta += __shfl_xor_sync(0xffffffffu, delta, 1);
  const float row_lse = valid ? a.lse[bh * N + row] : 0.f;

  const int num_kt = (N + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    stage_f32(sK, static_cast<const float*>(a.k) + base, k0, N, tid, kThreads);
    stage_f32(sV, static_cast<const float*>(a.v) + base, k0, N, tid, kThreads);
    cp_async_wait_all();
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
      const float p = (valid && k0 + j < N) ? expf(s * scale - row_lse) : 0.f;
      const float ds = scale * p * (dp - delta);
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) acc[i] = fmaf(ds, kr[2 * i], acc[i]);
    }
  }
  if (!valid) return;
  float* dq = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) dq[row_off + 2 * i + half] = acc[i];
}

__device__ __forceinline__ void short_bwd_dkv_f32(const BwdArgs& a, int k0, size_t bh,
                                                  float* sQ, float* sDo, float* sLse,
                                                  float* sDelta) {
  const float* q = static_cast<const float*>(a.q);
  const float* o = static_cast<const float*>(a.o);
  const float* dout = static_cast<const float*>(a.dout);
  const int N = a.N;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int half = tid & 1;
  const int row = k0 + (tid >> 1);  // this thread's key
  const bool valid = row < N;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const size_t row_off = base + static_cast<size_t>(valid ? row : 0) * kD;

  float kr[kHalfD];
  float vr[kHalfD];
  float dk_acc[kHalfD];
  float dv_acc[kHalfD];
  load_half_row_f32(kr, static_cast<const float*>(a.k) + row_off, valid, half);
  load_half_row_f32(vr, static_cast<const float*>(a.v) + row_off, valid, half);
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    dk_acc[i] = 0.f;
    dv_acc[i] = 0.f;
  }

  const int num_qt = (N + kBlockQ - 1) / kBlockQ;
  for (int qt = 0; qt < num_qt; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    stage_f32(sQ, q + base, q0, N, tid, kThreads);
    stage_f32(sDo, dout + base, q0, N, tid, kThreads);
    tile_delta(sDelta, o + base, dout + base, q0, N, tid);
    if (tid < kBlockQ) sLse[tid] = q0 + tid < N ? a.lse[bh * N + q0 + tid] : 0.f;
    cp_async_wait_all();
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
      const float ds = scale * p * (dp - sDelta[j]);
#pragma unroll
      for (int i = 0; i < kHalfD; ++i) {
        dv_acc[i] = fmaf(p, dor[2 * i], dv_acc[i]);
        dk_acc[i] = fmaf(ds, qr[2 * i], dk_acc[i]);
      }
    }
  }
  if (!valid) return;
  float* dk = static_cast<float*>(a.dk);
  float* dv = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < kHalfD; ++i) {
    dk[row_off + 2 * i + half] = dk_acc[i];
    dv[row_off + 2 * i + half] = dv_acc[i];
  }
}

__global__ void __launch_bounds__(kThreads) short_bwd_f32_kernel(BwdArgs a) {
  __shared__ __align__(16) float sA[kBlockQ * kD];
  __shared__ __align__(16) float sB[kBlockQ * kD];
  __shared__ float sLse[kBlockQ];
  __shared__ float sDelta[kBlockQ];
  const int tiles = (a.N + kBlockQ - 1) / kBlockQ;
  const size_t bh = static_cast<size_t>(blockIdx.z) * a.H + blockIdx.y;
  if (static_cast<int>(blockIdx.x) < tiles) {
    short_bwd_dq_f32(a, blockIdx.x * kBlockQ, bh, sA, sB);
  } else {
    short_bwd_dkv_f32(a, (blockIdx.x - tiles) * kBlockK, bh, sA, sB, sLse, sDelta);
  }
}

bool bad_shape(int B, int H, int N, int D) {
  return D != kD || B <= 0 || H <= 0 || N <= 0 || B > 65535 || H > 65535;
}

}  // namespace

// Both functions launch on `stream` of `device` and return cudaGetLastError()
// (0 = ok).  q, k, v, o, dout and the gradients: (B, H, N, D) contiguous,
// 16-byte aligned, bf16 (is_bf16 = 1) or fp32; lse: (B, H, 1, N) fp32 (NULL
// in the forward: not written).
extern "C" int fused_short_attn_fwd(int device, const void* q, const void* k, const void* v,
                                    void* o, void* lse, int B, int H, int N, int D, float scale,
                                    int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const sm90::FwdArgs args{nullptr, static_cast<uint16_t*>(o),
                             static_cast<float*>(lse), H, N, scale};
    return static_cast<int>(sm90::attn_fwd_bf16<true, kD>(q, k, v, args, B, s));
  }
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  short_fwd_f32_kernel<<<grid, kBlockQ, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
      H, N, scale);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_short_attn_bwd(int device, const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const void* lse, void* dq,
                                    void* dk, void* dv, int B, int H, int N, int D, float scale,
                                    int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const sm90::BwdArgs args{static_cast<const uint16_t*>(o), static_cast<const float*>(lse),
                             nullptr, static_cast<uint16_t*>(dq), static_cast<uint16_t*>(dk),
                             static_cast<uint16_t*>(dv), H, N, scale};
    return static_cast<int>(
        sm90::attn_bwd_bf16<sm90::kRoleFused, false, kD>(q, k, v, dout, args, B, s));
  }
  const int tiles = (N + kBlockQ - 1) / kBlockQ;
  const dim3 grid(2 * tiles, H, B);  // q tiles (dq), then key tiles (dk, dv)
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv, H, N, scale};
  short_bwd_f32_kernel<<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a bf16 backward block asks for (bytes).
extern "C" int fused_short_attn_bwd_smem_bytes() { return sm90::kFusedBwdSmemBytes<kD>; }

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
