// The bf16 attention forward for Hopper (sm_90a) shared by K1
// (flash_attn_fwd.cu) and K4 (fused_short_attn.cu): TMA staging behind
// mbarriers, wgmma products, fp32 softmax.  For q, k, v (B, H, N, 64) bf16
// and, in K1, an optional (C, H, N, N) fp32 bias, batch element b reading
// cell b / (B / C) (C = 1: one bias shared by the batch):
//     x = scale * q k^T (+ bias)     m = max x     p = exp(x - m)    l = sum p
//     K1 (kNormFirst = false): o = ((p -> bf16) v) / l
//     K4 (kNormFirst = true):  o = ((p / l) -> bf16) v
//     lse = m + log l                                     (B, H, 1, N) fp32
// Keys >= N give p = 0; q rows >= N are computed on zeros and not written.
// The bias is a template flag (kBias, K1 only): the bias-free
// instantiations hold no bias code, and a bias instantiation reads each
// thread's elements of its two rows from device memory (L2) as it scales
// the scores.
//
// Work split: a block of two consumer warpgroups (256 threads) owns 128 q
// rows of one (batch, head); warpgroup w owns the 64-row q tile 2 x + w and
// issues both products for it with wgmma (m64nNk16, fp32 accumulators).
// Thread 0 issues every TMA copy.  Each tensor is one 3-D tensor map over
// (D = 64, N, B * H), so rows at or beyond N fall outside the map and arrive
// as zeros: a 2-D map over (B H N, D) would read the next head's rows.  A
// bf16 row of 64 is 128 bytes, and the maps use the 128-byte swizzle that
// the wgmma shared-memory descriptors below name.
//
// N <= 256 (kStream = false): the head's K (round_up(N, 8) rows) and V
// (round_up(N, 16) rows) are staged whole, once per block, K and V behind
// separate mbarriers so that S = Q K^T starts while V is still in flight.
// A row's keys fit one product of width round_up(N, 8), so its max and sum
// are exact: no online rescale, and K4 needs no second pass.  Two blocks
// share a SM (128 registers a thread up to 200 keys), so one block's copies
// run under the other's products and softmax.  A persistent block a SM with
// a producer warp and three stages was slower on the H100 (PERF.md): it
// halves the warpgroups that compute, and the products, not the copies,
// set the pace.
// N > 256 (kStream = true): 64-key K/V tiles stream through a ring of two
// stages (full and empty mbarriers; thread 0 refills a stage once both
// warpgroups have released it).  K1 keeps the online softmax; K4 streams
// the K tiles twice through the same ring, first for the row max and sum,
// then for p / l with V.
//
// Operand layouts: S = Q K^T takes A = Q and B = K from shared memory, both
// K-major (d contiguous).  O = P V takes A = P from registers: the S
// accumulator of each warp holds the m16n8 C fragments of its 16 rows,
// which are also the A fragments of the next product once rounded to bf16.
// B = V is stored key-major (d contiguous), MN-major for this product:
// the transpose bit of the instruction.

#pragma once

#include "flash_common.cuh"
#include "sm90_common.cuh"
#include "wgmma_sm90.cuh"

namespace sm90 {

using flash::kD;
using flash::kNegInf;
using flash::pack_bf16;

constexpr int kWarpgroups = 2;             // consumer warpgroups a block
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kTileRows = 64;              // q rows a warpgroup
constexpr int kBlockRows = kTileRows * kWarpgroups;
constexpr int kRowBytes = kD * 2;          // one bf16 row: 128 bytes
constexpr int kStreamKeys = 64;            // keys a stage when N > 256
constexpr int kMaxResidentKeys = 256;      // the widest single product
constexpr float kLog2e = 1.4426950408889634f;

// rows row0 .. row0 + box - 1 of head bh into dst, completion on bar.
__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, int row0, int bh,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(0), "r"(row0), "r"(bh), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct FwdArgs {
  const float* bias;  // (C, H, N, N) fp32 or null; K1 only
  uint16_t* o;        // (B, H, N, 64) bf16
  float* lse;         // (B, H, 1, N) fp32 or null
  int H;
  int N;
  float scale;
  int bias_batch;     // B / C: the batch elements that read one bias cell
};

// Key width of one stage: round_up(N, 8) keys resident, or kStreamKeys.
template <int kKeys, bool kStream>
struct FwdSmem {
  static constexpr int kStages = kStream ? 2 : 1;
  static constexpr int kVRows = (kKeys + 15) / 16 * 16;  // P V runs k16 steps
  static constexpr int kQBytes = kBlockRows * kRowBytes;
  static constexpr int kKBytes = kKeys * kRowBytes;
  static constexpr int kVBytes = kVRows * kRowBytes;
  static constexpr int kStageBytes = kKBytes + kVBytes;  // multiples of 1024
  static constexpr int kBytes = kQBytes + kStages * kStageBytes + 1024;  // + alignment slack
};

// S = Q K^T of this warpgroup's tile over one stage's kKeys keys, into s.
template <int kKeys>
__device__ __forceinline__ void qk_product(float (&s)[kKeys / 2], const uint8_t* q_tile,
                                           const uint8_t* k_tile) {
  const uint64_t dq = sw128_desc(q_tile);
  const uint64_t dk = sw128_desc(k_tile);
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    // 16 bf16 = 32 bytes further along the (swizzled) rows of both
    wgmma_ss<kKeys>(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// O (+)= P V for one stage: p holds the bf16 A fragments of every k16 step,
// V the stage's rows, 16 keys (2,048 bytes) a step.
template <int kSteps>
__device__ __forceinline__ void pv_product(float (&o)[kD / 2], const uint32_t (&p)[kSteps][4],
                                           const uint8_t* v_tile, bool accumulate) {
  const uint64_t dv = sw128_desc(v_tile);
  fence_regs(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_rs_n64_tb(o, p[kk], dv + kk * (16 * kRowBytes >> 4), accumulate || kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
}

// x = scale * s (+ bias) with keys >= N at kNegInf, in place, and the row
// maxima of this thread's two rows over the quad that shares them.
template <int kKeys, bool kBias>
__device__ __forceinline__ void scores(float (&s)[kKeys / 2], float (&mx)[2], int key0, int N,
                                       float scale, const float* const* brow, int t) {
  mx[0] = kNegInf;
  mx[1] = kNegInf;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    const bool edge = key0 + 8 * j + 8 > N;  // this 8-key chunk holds keys >= N
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      const int key = key0 + 8 * j + 2 * t + (i & 1);
      float x = s[4 * j + i] * scale;
      if constexpr (kBias) {
        if (brow[r] != nullptr && key < N) x += brow[r][key];
      }
      if (edge && key >= N) x = kNegInf;
      s[4 * j + i] = x;
      mx[r] = fmaxf(mx[r], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// p = exp(x - m) in place; returns this thread's partial row sums (fp32 p).
template <int kKeys>
__device__ __forceinline__ void exponentiate(float (&s)[kKeys / 2], const float (&m)[2],
                                             float (&sum)[2]) {
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
  sum[0] = 0.f;
  sum[1] = 0.f;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ex2(fmaf(s[4 * j + i], kLog2e, -ml[i >> 1]));
      s[4 * j + i] = p;
      sum[i >> 1] += p;
    }
  }
}

// The bf16 A fragments of P V from the S accumulator, times mul[row]:
// k16 step kk takes the 8-key chunks 2 kk and 2 kk + 1 (zero past kKeys).
template <int kKeys>
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[(kKeys + 15) / 16][4],
                                           const float (&s)[kKeys / 2], const float (&mul)[2]) {
#pragma unroll
  for (int kk = 0; kk < (kKeys + 15) / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      if (j < kKeys / 8) {
        a[kk][2 * half + 0] = pack_bf16(s[4 * j + 0] * mul[0], s[4 * j + 1] * mul[0]);
        a[kk][2 * half + 1] = pack_bf16(s[4 * j + 2] * mul[1], s[4 * j + 3] * mul[1]);
      } else {
        a[kk][2 * half + 0] = 0u;
        a[kk][2 * half + 1] = 0u;
      }
    }
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int kKeys, bool kStream, bool kNormFirst, bool kBias>
__global__ void __launch_bounds__(kThreads, (kKeys <= 200 ? 2 : 1))
attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const FwdArgs args) {
  using L = FwdSmem<kKeys, kStream>;
  constexpr int kSteps = L::kVRows / 16;
  __shared__ __align__(8) uint64_t bar_q;
  __shared__ __align__(8) uint64_t bar_k[L::kStages];
  __shared__ __align__(8) uint64_t bar_v[L::kStages];
  __shared__ __align__(8) uint64_t bar_empty[L::kStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* sQ = smem;
  auto sK = [&](int st) { return smem + L::kQBytes + st * L::kStageBytes; };
  auto sV = [&](int st) { return sK(st) + L::kKBytes; };

  const int N = args.N;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;  // within the warpgroup: rows 16 warp ..
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int h = bh % args.H;
  const int q0 = blockIdx.x * kBlockRows;
  const int active = min(kWarpgroups, (N - q0 + kTileRows - 1) / kTileRows);
  const int tiles = kStream ? (N + kKeys - 1) / kKeys : 1;
  // tiles through the ring: K4 streams the keys twice
  const int loads = (kStream && kNormFirst) ? 2 * tiles : tiles;

  // tile j into stage j % kStages; K4's first pass brings K only and
  // completes the V barrier with a bare arrive, so both barriers tick once
  // per tile
  auto load_tile = [&](int j) {
    const int st = j % L::kStages;
    const int key0 = (j % tiles) * kKeys;
    mbar_expect_tx(&bar_k[st], L::kKBytes);
    tma_load_rows(sK(st), &tk, key0, bh, &bar_k[st]);
    if (kStream && kNormFirst && j < tiles) {
      mbar_arrive(&bar_v[st]);
    } else {
      mbar_expect_tx(&bar_v[st], L::kVBytes);
      tma_load_rows(sV(st), &tv, key0, bh, &bar_v[st]);
    }
  };

  if (tid == 0) {
    mbar_init(&bar_q, 1);
#pragma unroll
    for (int st = 0; st < L::kStages; ++st) {
      mbar_init(&bar_k[st], 1);
      mbar_init(&bar_v[st], 1);
      mbar_init(&bar_empty[st], 128 * active);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_q, active * kTileRows * kRowBytes);
    for (int w = 0; w < active; ++w) {
      tma_load_rows(sQ + w * kTileRows * kRowBytes, &tq, q0 + w * kTileRows, bh, &bar_q);
    }
    for (int j = 0; j < min(L::kStages, loads); ++j) load_tile(j);
  }
  if (wg >= active) return;  // this warpgroup's q rows all lie beyond N

  const int row[2] = {q0 + wg * kTileRows + warp * 16 + g, q0 + wg * kTileRows + warp * 16 + g + 8};
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (kBias) {
    const size_t cell = (bh / args.H) / args.bias_batch;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] < N) brow[r] = args.bias + ((cell * args.H + h) * N + row[r]) * N;
    }
  }
  const uint8_t* q_tile = sQ + wg * kTileRows * kRowBytes;

  float s[kKeys / 2];
  float o[kD / 2];
  uint32_t pa[kSteps][4];
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's partial sums until reduced
  if (kStream) {  // resident: the first product overwrites o and s
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
  }
  mbar_wait(&bar_q, 0);

  for (int j = 0; j < loads; ++j) {
    const int st = j % L::kStages;
    const int parity = (j / L::kStages) & 1;
    if (kStream && tid == 0 && j >= 1 && j + L::kStages - 1 < loads) {
      // refill the stage that tile j - 1 used once both warpgroups released it
      const int jn = j + L::kStages - 1;
      mbar_wait(&bar_empty[jn % L::kStages], (jn / L::kStages - 1) & 1);
      load_tile(jn);
    }
    const int key0 = (j % tiles) * kKeys;
    mbar_wait(&bar_k[st], parity);
    qk_product<kKeys>(s, q_tile, sK(st));
    float mx[2];
    scores<kKeys, kBias>(s, mx, key0, N, args.scale, brow, t);

    if (kNormFirst && kStream && j < tiles) {
      // K4, first pass: the running row max and this thread's running sum
      float m_new[2], sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m[r], mx[r]);
      exponentiate<kKeys>(s, m_new, sum);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = l[r] * ex2((m[r] - m_new[r]) * kLog2e) + sum[r];
        m[r] = m_new[r];
      }
      if (j == tiles - 1) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
      }
    } else if (kNormFirst) {
      // K4: p / l rounded to bf16, with the exact row max and sum
      float mul[2], sum[2];
      if (!kStream) {
        m[0] = mx[0];
        m[1] = mx[1];
      }
      exponentiate<kKeys>(s, m, sum);
      if (!kStream) {
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = quad_sum(sum[r]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) mul[r] = 1.f / l[r];
      to_a_frags<kKeys>(pa, s, mul);
      mbar_wait(&bar_v[st], parity);
      pv_product<kSteps>(o, pa, sV(st), kStream);
    } else {
      // K1: exp(x - m) rounded to bf16 unnormalised, online across tiles
      float sum[2];
      const float one[2] = {1.f, 1.f};
      if (kStream) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float m_new = fmaxf(m[r], mx[r]);
          const float alpha = ex2((m[r] - m_new) * kLog2e);
          l[r] *= alpha;
          m[r] = m_new;
#pragma unroll
          for (int dt = 0; dt < kD / 8; ++dt) {
            o[4 * dt + 2 * r] *= alpha;
            o[4 * dt + 2 * r + 1] *= alpha;
          }
        }
      } else {
        m[0] = mx[0];
        m[1] = mx[1];
      }
      exponentiate<kKeys>(s, m, sum);
      l[0] += sum[0];
      l[1] += sum[1];
      to_a_frags<kKeys>(pa, s, one);
      mbar_wait(&bar_v[st], parity);
      pv_product<kSteps>(o, pa, sV(st), kStream);
    }
    if (kStream) mbar_arrive(&bar_empty[st]);
  }

  float div[2] = {1.f, 1.f};
  if (!kNormFirst) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = quad_sum(l[r]);
      div[r] = 1.f / l[r];
    }
  }
  const size_t head = static_cast<size_t>(bh) * N;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= N) continue;
    uint16_t* orow = args.o + (head + row[r]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * t) =
          pack_bf16(o[4 * dt + 2 * r] * div[r], o[4 * dt + 2 * r + 1] * div[r]);
    }
    if (args.lse != nullptr && t == 0) args.lse[head + row[r]] = m[r] + logf(l[r]);
  }
}

// ---------------------------------------------------------------------------
// host side

// A 3-D map over a (B, H, N, 64) bf16 tensor as (64, N, B H), boxes of
// `rows` full rows, 128-byte swizzle, zeros outside.
inline bool encode_rows(CUtensorMap* map, const void* base, int N, int BH, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kD), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(kRowBytes),
                                 static_cast<cuuint64_t>(N) * kRowBytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kD), static_cast<cuuint32_t>(rows), 1u};
  const cuuint32_t unit[3] = {1u, 1u, 1u};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kKeys, bool kStream, bool kNormFirst, bool kBias>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, const FwdArgs& args, int B,
                       cudaStream_t stream) {
  using L = FwdSmem<kKeys, kStream>;
  auto kernel = attn_fwd_sm90_kernel<kKeys, kStream, kNormFirst, kBias>;
  // the attribute belongs to the device, so it is set on every launch
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const int BH = B * args.H;
  CUtensorMap tq, tk, tv;
  if (!encode_rows(&tq, q, args.N, BH, kTileRows) || !encode_rows(&tk, k, args.N, BH, kKeys) ||
      !encode_rows(&tv, v, args.N, BH, L::kVRows)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((args.N + kBlockRows - 1) / kBlockRows, BH);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

// The bf16 forward: the resident design at N <= 256 with a product of
// width round_up(N, 8), the streamed one beyond.
template <bool kNormFirst, bool kBias>
cudaError_t attn_fwd_bf16_keys(const void* q, const void* k, const void* v, const FwdArgs& args,
                               int B, cudaStream_t stream) {
  if (args.N > kMaxResidentKeys) {
    return launch_fwd<kStreamKeys, true, kNormFirst, kBias>(q, k, v, args, B, stream);
  }
  switch ((args.N + 7) / 8) {
#define SM90_FWD_CASE(c) \
  case c:                \
    return launch_fwd<8 * (c), false, kNormFirst, kBias>(q, k, v, args, B, stream);
    SM90_FWD_CASE(1) SM90_FWD_CASE(2) SM90_FWD_CASE(3) SM90_FWD_CASE(4)
    SM90_FWD_CASE(5) SM90_FWD_CASE(6) SM90_FWD_CASE(7) SM90_FWD_CASE(8)
    SM90_FWD_CASE(9) SM90_FWD_CASE(10) SM90_FWD_CASE(11) SM90_FWD_CASE(12)
    SM90_FWD_CASE(13) SM90_FWD_CASE(14) SM90_FWD_CASE(15) SM90_FWD_CASE(16)
    SM90_FWD_CASE(17) SM90_FWD_CASE(18) SM90_FWD_CASE(19) SM90_FWD_CASE(20)
    SM90_FWD_CASE(21) SM90_FWD_CASE(22) SM90_FWD_CASE(23) SM90_FWD_CASE(24)
    SM90_FWD_CASE(25) SM90_FWD_CASE(26) SM90_FWD_CASE(27) SM90_FWD_CASE(28)
    SM90_FWD_CASE(29) SM90_FWD_CASE(30) SM90_FWD_CASE(31) SM90_FWD_CASE(32)
#undef SM90_FWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// K1 with or without its bias; K4 (kNormFirst) has none.
template <bool kNormFirst>
cudaError_t attn_fwd_bf16(const void* q, const void* k, const void* v, const FwdArgs& args, int B,
                          cudaStream_t stream) {
  if (static_cast<size_t>(B) * args.H > 65535) return cudaErrorInvalidValue;  // grid.y
  if constexpr (!kNormFirst) {
    if (args.bias != nullptr) return attn_fwd_bf16_keys<false, true>(q, k, v, args, B, stream);
  }
  return attn_fwd_bf16_keys<kNormFirst, false>(q, k, v, args, B, stream);
}

}  // namespace sm90
