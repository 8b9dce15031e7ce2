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
// 227 KB of shared memory a block.  So the work is cut as the flash kernels
// cut it, and keys are streamed in 64-key tiles:
// * forward: one block of 4 warps per (64-row q tile, head, batch), 16 rows a
//   warp.  Pass 1 streams the K tiles and keeps, per thread, a running max
//   and sum over its own keys; the quad of threads that shares a row merges
//   them into m and l.  Pass 2 streams K and V again, recomputes s, forms
//   p / l with the FIRST pass's m, rounds it and accumulates (p / l) v.  No
//   row of scores is ever held whole, for any N.
// * backward: one launch with two roles chosen by block index, no atomics,
//   a deterministic result.  Blocks x < T (T = ceil(N / 64)) own a q tile and
//   loop over the key tiles (dq, as flash_attn_bwd_dq); blocks x >= T own a
//   key tile and loop over the q tiles (dk and dv, as flash_attn_bwd_dkv,
//   with the transposed products k q^T and v dO^T so that p^T and ds^T are
//   the A fragments of p^T dO and ds^T q).  Each block computes delta for
//   the q rows it stages from O and dO, two threads a row.
// Tiles are staged with cp.async; a row at or beyond N is zero-filled in
// shared memory (no padding in device memory), a key at or beyond N gives
// p = 0 and a q row at or beyond N is not written.
//
// What bounds them: at N = 197, D = 64 the forward reads q, k, v and writes
// o (4 B H N D elements) against 6 B H N^2 D flops with the recomputed
// q k^T; the backward reads q, k, v, o, dO and writes dq, dk, dv (8 B H N D)
// against about 12 B H N^2 D flops.  Both sit near 100 flops a byte, below
// the H100's bf16 ridge of about 295: memory-bound.  bf16 runs mma.sync
// m16n8k16 (fp32 accumulators); fp32 runs the same tiling with fp32 FMAs
// (the tensor cores have no full-fp32 mode).  D = 64 only.  wgmma, TMA and
// a multi-stage pipeline are left for later.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kThreads = 128;  // every block of both kernels
constexpr int kHalfD = kD / 2;

__device__ __forceinline__ float bf16_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// 16 bytes from global into shared, asynchronously; zero-filled when !valid
// (src-size 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// 64 rows x 64 bf16 (rows row0.. of src, row stride kD) into shared (row
// stride kLds); rows >= n are zero.
__device__ __forceinline__ void stage_bf16(uint16_t* dst, const uint16_t* src, int row0,
                                           int n, int tid) {
#pragma unroll
  for (int i = 0; i < kBlockK * kD / 8 / kThreads; ++i) {
    const int c = tid + i * kThreads;
    const int r = c >> 3;
    const int col = (c & 7) * 8;
    const bool valid = row0 + r < n;
    cp_async16(dst + r * kLds + col, src + static_cast<size_t>(valid ? row0 + r : 0) * kD + col,
               valid);
  }
}

// 64 rows x 64 fp32 into shared (row stride kD); rows >= n are zero.
__device__ __forceinline__ void stage_f32(float* dst, const float* src, int row0, int n,
                                          int tid, int threads) {
  for (int c = tid; c < kBlockK * kD / 4; c += threads) {
    const int r = c / (kD / 4);
    const int col = (c % (kD / 4)) * 4;
    const bool valid = row0 + r < n;
    cp_async16(dst + r * kD + col, src + static_cast<size_t>(valid ? row0 + r : 0) * kD + col,
               valid);
  }
}

// delta = rowsum(dO o O) in fp32 for the 64 rows row0.. into sDelta (0 for
// rows >= n), two threads a row, each over half the dims; o and dout point at
// the head's (N, D) slab.  Needs all kThreads threads.
template <typename T>
__device__ __forceinline__ void tile_delta(float* sDelta, const T* o, const T* dout, int row0,
                                           int n, int tid) {
  const int r = tid >> 1;
  const int half = tid & 1;
  float acc = 0.f;
  if (row0 + r < n) {
    const size_t off = static_cast<size_t>(row0 + r) * kD + half * kHalfD;
#pragma unroll 8
    for (int i = 0; i < kHalfD; ++i) {
      float a, b;
      if constexpr (sizeof(T) == 2) {
        a = bf16_to_f32(o[off + i]);
        b = bf16_to_f32(dout[off + i]);
      } else {
        a = o[off + i];
        b = dout[off + i];
      }
      acc = fmaf(a, b, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (half == 0) sDelta[r] = acc;
}

// ----------------------------------------------------------------------------
// forward

__global__ void __launch_bounds__(kThreads)
short_fwd_bf16_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                      float* __restrict__ lse, int H, int N, float scale) {
  __shared__ __align__(16) uint16_t sQ[kBlockQ * kLds];
  __shared__ __align__(16) uint16_t sK[kBlockK * kLds];
  __shared__ __align__(16) uint16_t sV[kBlockK * kLds];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = static_cast<size_t>(blockIdx.z) * H + blockIdx.y;
  const size_t base = bh * static_cast<size_t>(N) * kD;
  const int num_kt = (N + kBlockK - 1) / kBlockK;

  stage_bf16(sQ, q + base, q0, N, tid);
  cp_async_wait_all();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[kD / 16][4];
  load_a_frags(qa, sQ, r0, t);

  // pass 1: this thread's running max and sum over its own keys
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K tile
    stage_bf16(sK, k + base, k0, N, tid);
    cp_async_wait_all();
    __syncthreads();
    float s[kBlockK / 8][4];
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = 0.f;
      mma_rows_as_cols(s[nt], qa, sK, nt * 8, g, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + nt * 8 + 2 * t + (i & 1);
        s[nt][i] = key < N ? s[nt][i] * scale : kNegInf;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[nt][i]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < kBlockK / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = s[nt][2 * r + c];
          sum += x > kNegInf ? __expf(x - m_new) : 0.f;
        }
      }
      l[r] = l[r] * __expf(m[r] - m_new) + sum;
      m[r] = m_new;
    }
  }
  // merge the quad's four partial (max, sum) pairs of each row; key 0 is
  // always valid, so the row max is finite
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mr = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    mr = fmaxf(mr, __shfl_xor_sync(0xffffffffu, mr, 2));
    float lr = l[r] * __expf(m[r] - mr);
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    m[r] = mr;
    l[r] = lr;
  }

  // pass 2: acc += ((p / l) -> bf16) v with p = exp(s - m) of pass 1's m
  float acc[kD / 8][4];
#pragma unroll
  for (int dt = 0; dt < kD / 8; ++dt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[dt][i] = 0.f;
  }
  for (int kt = 0; kt < num_kt; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    stage_bf16(sK, k + base, k0, N, tid);
    stage_bf16(sV, v + base, k0, N, tid);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key8 = kk * 16 + j * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows_as_cols(s, qa, sK, key8, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int key = k0 + key8 + 2 * t + (i & 1);
          s[i] = key < N ? __expf(s[i] * scale - m[r]) / l[r] : 0.f;
        }
        pa[2 * j + 0] = pack_bf16(s[0], s[1]);
        pa[2 * j + 1] = pack_bf16(s[2], s[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        mma_rows_as_k(acc[dt], pa, sV, kk * 16, dt * 8, g, t);
      }
    }
  }

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= N) continue;
    uint16_t* orow = o + base + static_cast<size_t>(qrow[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
    if (lse != nullptr && t == 0) lse[bh * N + qrow[r]] = m[r] + logf(l[r]);
  }
}

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
// backward, bf16

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

// The dq role: this block owns the q tile q0 and loops over the key tiles.
__device__ __forceinline__ void short_bwd_dq_bf16(const BwdArgs& a, int q0, size_t bh,
                                                  uint16_t* sA, uint16_t* sB, float* sDelta) {
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* k = static_cast<const uint16_t*>(a.k);
  const uint16_t* v = static_cast<const uint16_t*>(a.v);
  const uint16_t* dout = static_cast<const uint16_t*>(a.dout);
  const int N = a.N;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  stage_bf16(sA, q + base, q0, N, tid);
  stage_bf16(sB, dout + base, q0, N, tid);
  tile_delta(sDelta, static_cast<const uint16_t*>(a.o) + base, dout + base, q0, N, tid);
  cp_async_wait_all();
  __syncthreads();

  const int r0 = warp * 16 + g;
  uint32_t qa[kD / 16][4];
  uint32_t da[kD / 16][4];
  load_a_frags(qa, sA, r0, t);
  load_a_frags(da, sB, r0, t);
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  float row_lse[2];
  float row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_lse[r] = qrow[r] < N ? a.lse[bh * N + qrow[r]] : 0.f;
    row_delta[r] = sDelta[r0 + 8 * r];
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
    stage_bf16(sA, k + base, k0, N, tid);
    stage_bf16(sB, v + base, k0, N, tid);
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key8 = kk * 16 + j * 8;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        float dp[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows_as_cols(s, qa, sA, key8, g, t);
        mma_rows_as_cols(dp, da, sB, key8, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i >> 1;
          const int key = k0 + key8 + 2 * t + (i & 1);
          const float p = (key < N && qrow[r] < N) ? __expf(s[i] * scale - row_lse[r]) : 0.f;
          s[i] = scale * p * (dp[i] - row_delta[r]);
        }
        dsa[2 * j + 0] = pack_bf16(s[0], s[1]);
        dsa[2 * j + 1] = pack_bf16(s[2], s[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        mma_rows_as_k(acc[dt], dsa, sA, kk * 16, dt * 8, g, t);
      }
    }
  }

  uint16_t* dq = static_cast<uint16_t*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= N) continue;
    uint16_t* out = dq + base + static_cast<size_t>(qrow[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_bf16(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

// The dk/dv role: this block owns the key tile k0 and loops over the q tiles.
__device__ __forceinline__ void short_bwd_dkv_bf16(const BwdArgs& a, int k0, size_t bh,
                                                   uint16_t* sA, uint16_t* sB, float* sLse,
                                                   float* sDelta) {
  const uint16_t* q = static_cast<const uint16_t*>(a.q);
  const uint16_t* o = static_cast<const uint16_t*>(a.o);
  const uint16_t* dout = static_cast<const uint16_t*>(a.dout);
  const int N = a.N;
  const float scale = a.scale;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const size_t base = bh * static_cast<size_t>(N) * kD;

  stage_bf16(sA, static_cast<const uint16_t*>(a.k) + base, k0, N, tid);
  stage_bf16(sB, static_cast<const uint16_t*>(a.v) + base, k0, N, tid);
  cp_async_wait_all();
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's keys: r0 and r0 + 8
  uint32_t ka[kD / 16][4];
  uint32_t va[kD / 16][4];
  load_a_frags(ka, sA, r0, t);
  load_a_frags(va, sB, r0, t);
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
    stage_bf16(sA, q + base, q0, N, tid);
    stage_bf16(sB, dout + base, q0, N, tid);
    tile_delta(sDelta, o + base, dout + base, q0, N, tid);
    if (tid < kBlockQ) sLse[tid] = q0 + tid < N ? a.lse[bh * N + q0 + tid] : 0.f;
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockQ / 16; ++kk) {
      uint32_t pa[4];
      uint32_t dsa[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row8 = kk * 16 + j * 8;
        float st[4] = {0.f, 0.f, 0.f, 0.f};
        float dpt[4] = {0.f, 0.f, 0.f, 0.f};
        mma_rows_as_cols(st, ka, sA, row8, g, t);
        mma_rows_as_cols(dpt, va, sB, row8, g, t);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = row8 + 2 * t + (i & 1);  // q row within the tile
          const bool valid = (q0 + c < N) && (krow[i >> 1] < N);
          const float p = valid ? __expf(st[i] * scale - sLse[c]) : 0.f;
          st[i] = p;
          dpt[i] = scale * p * (dpt[i] - sDelta[c]);
        }
        pa[2 * j + 0] = pack_bf16(st[0], st[1]);
        pa[2 * j + 1] = pack_bf16(st[2], st[3]);
        dsa[2 * j + 0] = pack_bf16(dpt[0], dpt[1]);
        dsa[2 * j + 1] = pack_bf16(dpt[2], dpt[3]);
      }
#pragma unroll
      for (int dt = 0; dt < kD / 8; ++dt) {
        mma_rows_as_k(dv_acc[dt], pa, sB, kk * 16, dt * 8, g, t);
        mma_rows_as_k(dk_acc[dt], dsa, sA, kk * 16, dt * 8, g, t);
      }
    }
  }

  uint16_t* dk = static_cast<uint16_t*>(a.dk);
  uint16_t* dv = static_cast<uint16_t*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= N) continue;
    const size_t off = base + static_cast<size_t>(krow[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(dk + off + dt * 8 + 2 * t) =
          pack_bf16(dk_acc[dt][2 * r], dk_acc[dt][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv + off + dt * 8 + 2 * t) =
          pack_bf16(dv_acc[dt][2 * r], dv_acc[dt][2 * r + 1]);
    }
  }
}

__global__ void __launch_bounds__(kThreads) short_bwd_bf16_kernel(BwdArgs a) {
  __shared__ __align__(16) uint16_t sA[kBlockQ * kLds];
  __shared__ __align__(16) uint16_t sB[kBlockQ * kLds];
  __shared__ float sLse[kBlockQ];
  __shared__ float sDelta[kBlockQ];
  const int tiles = (a.N + kBlockQ - 1) / kBlockQ;
  const size_t bh = static_cast<size_t>(blockIdx.z) * a.H + blockIdx.y;
  if (static_cast<int>(blockIdx.x) < tiles) {
    short_bwd_dq_bf16(a, blockIdx.x * kBlockQ, bh, sA, sB, sDelta);
  } else {
    short_bwd_dkv_bf16(a, (blockIdx.x - tiles) * kBlockK, bh, sA, sB, sLse, sDelta);
  }
}

// ----------------------------------------------------------------------------
// backward, fp32: two threads per owned row (each holds every other dim),
// the two halves of a dot product meet in one shuffle.

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
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, H, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    short_fwd_bf16_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
        static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), static_cast<float*>(lse),
        H, N, scale);
  } else {
    short_fwd_f32_kernel<<<grid, kBlockQ, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), static_cast<float*>(lse),
        H, N, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fused_short_attn_bwd(int device, const void* q, const void* k, const void* v,
                                    const void* o, const void* dout, const void* lse, void* dq,
                                    void* dk, void* dv, int B, int H, int N, int D, float scale,
                                    int is_bf16, void* stream) {
  if (bad_shape(B, H, N, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (N + kBlockQ - 1) / kBlockQ;
  const dim3 grid(2 * tiles, H, B);  // q tiles (dq), then key tiles (dk, dv)
  const BwdArgs a{q, k, v, o, dout, static_cast<const float*>(lse), dq, dk, dv, H, N, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    short_bwd_bf16_kernel<<<grid, kThreads, 0, s>>>(a);
  } else {
    short_bwd_f32_kernel<<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
