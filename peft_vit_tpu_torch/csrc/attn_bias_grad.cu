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
// What bounds it: it reads q, k, v and dO (4 B H N D bf16), lse and delta
// (or O, a fifth B H N D) and the bias, and writes dbias (C H N^2 fp32),
// against two products of 2 B H N^2 D flops each: at ViT-B/16 (N = 197,
// D = 64, B = 16) about 23 MB against 1.9 GFLOP, and at Swin-T's stage-0
// fold (B = 64, 192 heads, N = 49, D = 32) 155 MB against 3.8 GFLOP; both
// lie below the H100's bf16 ridge, so bytes bound it (about 7 and 49 us).
//
// bf16 design.  A block is one warpgroup and owns a 64-row q chunk x a
// 64-key tile of one (cell, head) plane and a fixed chunk of that cell's
// batch elements.  For each element thread 0 copies four boxes by TMA
// through the 3-D tensor maps over (D, N, B H) of attn_fwd_sm90.cuh (Q and
// dO at the q chunk, K and V at the key tile; rows at or beyond N arrive as
// zeros; the 128-byte swizzle at D = 64, the 64-byte one at D = 32) into a
// ring of stages behind full and empty mbarriers, so that the next
// elements' copies run under this element's products: two stages of 32 KB
// at D = 64, four of 16 KB at D = 32 (three computing delta from O); three
// blocks a SM (two at D = 64 from O).  S = Q K^T and dP = dO V^T are wgmma
// products from shared memory with fp32 accumulators (K2's chunk form:
// sm90::ss_chunk, two commit groups, the exponentials under dP's product);
// ds = p o (dP - delta) is formed in registers and added to the block's
// 64 x 64 fp32 accumulator.  A block of the last key tile cuts its products
// to round_up(keys left, 8) columns (5 keys take 8 at N = 197).  The bias
// tile is the same for every element of a cell: each thread loads its
// elements of it once, times log2(e), into registers.  lse and delta come
// from their (B, H, 1, N) rows by plain loads (a row is 788 bytes at
// N = 197, not a TMA stride), the whole chunk's at once into shared memory
// while the first copies land (read one element ahead into registers
// instead, each element waited on its loads, and K7 was slower).  Without
// delta, each element's delta comes from the dO tile in the ring and O rows
// that each thread copies by cp.async as many elements ahead as the ring
// (sm90::prefetch_o_rows, as K5's dk/dv blocks).
//
// The split of the batch is deterministic: the wrapper fixes the elements a
// chunk from the per-cell batch, N and D alone (never C, H or the SM count;
// ops/attention.py::BIAS_GRAD_CHUNK, 16), so a sweep round of C cells
// computes each cell as that cell alone does, bit for bit.  A cell's batch
// of one chunk is written to dbias directly; otherwise each block writes its
// partial tile to an fp32 workspace (chunks, C, H, N, N) and a second kernel
// of the same call (bias_grad_sum_kernel) sums the partials in chunk order,
// with no floating-point atomic: the same bits on every run and under
// CUDA-graph replay.  (The last block of a tile to arrive summing them
// instead was slower on the H100 at every shape timed: PERF.md.)
//
// Where the time goes (PERF.md): at N = 49 every element is one 64 x 56
// tile a block and the reads run at about 2 TB/s, as K1-K3's do at these
// shapes; at N = 197 the 16 tiles of a head re-read its q, dO, k and v four
// times, from L2.
//
// fp32: 32 x 32 tiles, eight threads a q row, fp32 FMAs from shared memory;
// not on the main path (fp32 training on the card, held against the CPU).
// D = 64 and D = 32 (Swin's heads), each a template instantiation of both
// bodies; any other D is refused.

#include "attn_bwd_sm90.cuh"

namespace {

using namespace flash;

constexpr float kInf = __builtin_huge_valf();

// bf16: the ring's depth (three blocks a SM at every instantiation but D = 64
// from O, which holds two), the most elements a chunk, and the dynamic shared
// memory of a block: the ring; with kFromO a buffer of O rows a stage; the
// chunk's rows of log2e lse (and delta), 64 an element; the alignment slack.
template <int kD, bool kFromO>
constexpr int kStages = kD == 64 ? 2 : (kFromO ? 3 : 4);
template <int kD>
constexpr int kStageBytes = 4 * sm90::kTileBytes<kD>;  // Q, dO, K, V
constexpr int kMaxChunkElems = 16;
template <int kD, bool kFromO>
constexpr int kFixedSmemBytes =
    kStages<kD, kFromO> * (kStageBytes<kD> + (kFromO ? sm90::kTileBytes<kD> : 0)) + 1024;
template <bool kFromO>
constexpr int rows_bytes(int chunk_elems) {
  return (kFromO ? 1 : 2) * chunk_elems * sm90::kChunk * 4;
}

struct BiasGradArgs {
  const uint16_t* o;   // kFromO: (B, H, N, D)
  const float* lse;    // (B, H, 1, N)
  const float* delta;  // !kFromO: (B, H, 1, N)
  const float* bias;   // (C, H, N, N)
  float* dbias;        // (C, H, N, N)
  float* partial;      // chunks > 1: (chunks, C, H, N, N)
  int H;
  int N;
  int bias_batch;   // B / C
  int chunk_elems;  // batch elements a chunk
  int chunks;       // chunks a cell
  int tiles;        // 64-row tiles a side of a plane
  float scale;
};

struct BiasMaps {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  const CUtensorMap* dout;
};

// The block's work: the q rows from q0 and the kCols keys from k0 of plane
// (cell, head), summed over the batch elements of its chunk.
template <int kCols, bool kFromO, int kD>
__device__ __forceinline__ void bias_grad_block(const BiasMaps& maps, const BiasGradArgs& a,
                                                uint8_t* smem, uint64_t* full, uint64_t* empty,
                                                int q0, int k0, int plane, int chunk) {
  constexpr int kTile = sm90::kTileBytes<kD>;
  constexpr int kRing = kStages<kD, kFromO>;
  constexpr int kQc = sm90::kQuadChunks<kD>;
  constexpr float kLog2e = sm90::kLog2e;
  const int N = a.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r = warp * 16 + g;  // this thread's rows r and r + 8 of the tile
  const int rows[2] = {q0 + r, q0 + r + 8};
  const int cell = plane / a.H;
  const int h = plane % a.H;
  const int e0 = chunk * a.chunk_elems;
  const int count = min(a.chunk_elems, a.bias_batch - e0);
  const int first_bh = (cell * a.bias_batch + e0) * a.H + h;  // element j: first_bh + j H
  uint8_t* sO = smem + kRing * kStageBytes<kD>;  // kFromO: a buffer of O rows a stage
  // log2e lse of q row q0 + i of element j at s_lse[64 j + i], delta at s_delta[64 j + i]
  float* s_lse = reinterpret_cast<float*>(sO + (kFromO ? kRing * kTile : 0));
  float* s_delta = s_lse + a.chunk_elems * sm90::kChunk;
  auto tile = [&](int st, int which) { return smem + st * kStageBytes<kD> + which * kTile; };

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kRing; ++st) {
      sm90::mbar_init(&full[st], 1);
      sm90::mbar_init(&empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // element j into stage j % kRing: Q, dO at the q chunk, K, V at the key tile
  auto load = [&](int j) {
    const int st = j % kRing;
    const int bh = first_bh + j * a.H;
    sm90::mbar_expect_tx(&full[st], kStageBytes<kD>);
    sm90::tma_load_rows(tile(st, 0), maps.q, q0, bh, &full[st]);
    sm90::tma_load_rows(tile(st, 1), maps.dout, q0, bh, &full[st]);
    sm90::tma_load_rows(tile(st, 2), maps.k, k0, bh, &full[st]);
    sm90::tma_load_rows(tile(st, 3), maps.v, k0, bh, &full[st]);
  };
  if (tid == 0) {
    for (int j = 0; j < min(kRing, count); ++j) load(j);
  }

  // log2e bias of this thread's accumulator elements: element idx is row
  // rows[(idx >> 1) & 1], key k0 + 8 (idx >> 2) + 2 t + (idx & 1)
  const size_t plane_off = static_cast<size_t>(plane) * N * N;
  float bl2[kCols / 2];
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    const int row = rows[(idx >> 1) & 1];
    const int key = k0 + 8 * (idx >> 2) + 2 * t + (idx & 1);
    const bool in = row < N && key < N;
    bl2[idx] = in ? a.bias[plane_off + static_cast<size_t>(row) * N + key] * kLog2e : 0.f;
  }
  // The chunk's lse (and delta) rows into shared memory, all loads in
  // flight together (rows >= N: 0), while the first copies land.
  constexpr int kRowsEach = kMaxChunkElems * sm90::kChunk / 128;
  float lse_in[kRowsEach], delta_in[kRowsEach];
#pragma unroll
  for (int u = 0; u < kRowsEach; ++u) {
    const int x = tid + 128 * u;  // element x / 64, q row q0 + x % 64
    const int row = q0 + (x & 63);
    const size_t at = static_cast<size_t>(first_bh + (x >> 6) * a.H) * N + row;
    const bool in = x < count * sm90::kChunk && row < N;
    lse_in[u] = in ? a.lse[at] : 0.f;
    if constexpr (!kFromO) delta_in[u] = in ? a.delta[at] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kRowsEach; ++u) {
    const int x = tid + 128 * u;
    if (x < count * sm90::kChunk) {
      s_lse[x] = lse_in[u] * kLog2e;
      if constexpr (!kFromO) s_delta[x] = delta_in[u];
    }
  }
  // kFromO: the O rows of elements 0 .. kRing - 2, a cp.async group each
  // (empty past the chunk), so that element j's are kRing - 1 groups old
  auto prefetch_o = [&](int j) {
    if (j < count) {
      sm90::prefetch_o_rows<kD>(sO + (j % kRing) * kTile, a.o,
                                static_cast<size_t>(first_bh + j * a.H) * N, q0 / sm90::kChunk,
                                r, t, tid, N);
    } else {
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
  };
  if constexpr (kFromO) {
#pragma unroll
    for (int j = 0; j < kRing - 1; ++j) prefetch_o(j);
  }
  __syncthreads();

  const float scale_l2 = a.scale * kLog2e;
  float acc[kCols / 2];
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) acc[idx] = 0.f;

  for (int j = 0; j < count; ++j) {
    const int st = j % kRing;
    if (tid == 0) {  // refill the stage of element j - 1 once the warpgroup released it
      const int jn = j + kRing - 1;
      if (j >= 1 && jn < count) {
        sm90::mbar_wait(&empty[jn % kRing], (jn / kRing - 1) & 1);
        load(jn);
      }
    }
    const float lse_l2[2] = {s_lse[sm90::kChunk * j + r], s_lse[sm90::kChunk * j + r + 8]};
    float dl[2];
    if constexpr (!kFromO) {
      dl[0] = s_delta[sm90::kChunk * j + r];
      dl[1] = s_delta[sm90::kChunk * j + r + 8];
    }
    sm90::mbar_wait(&full[st], (j / kRing) & 1);
    if constexpr (kFromO) {
      // delta from the dO tile of the stage and this thread's O rows (its
      // own bytes of the buffer: no barrier), then the O rows of element
      // j + kRing - 1 into the buffer element j - 1 used
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 2) : "memory");
      uint4 orow[2][kQc];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int c = 0; c < kQc; ++c) {
          orow[i][c] = *reinterpret_cast<const uint4*>(sO + st * kTile +
                                                       ((kQc * i + c) * 128 + tid) * 16);
        }
      }
      sm90::rows_delta<kD>(dl, tile(st, 1), orow, r, t);
      prefetch_o(j + kRing - 1);
    }

    float s[kCols / 2], dp[kCols / 2];
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::wgmma_fence();
    sm90::ss_chunk<kCols, kD>(s, tile(st, 0), tile(st, 2));
    sm90::wgmma_commit();
    sm90::ss_chunk<kCols, kD>(dp, tile(st, 1), tile(st, 3));
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();  // S has landed; the exponentials run under dP's product
    sm90::fence_regs(s);
#pragma unroll
    for (int idx = 0; idx < kCols / 2; ++idx) {
      s[idx] = sm90::ex2(fmaf(s[idx], scale_l2, bl2[idx] - lse_l2[(idx >> 1) & 1]));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dp);
#pragma unroll
    for (int idx = 0; idx < kCols / 2; ++idx) {
      acc[idx] = fmaf(s[idx], dp[idx] - dl[(idx >> 1) & 1], acc[idx]);
    }
    if (count > kRing) sm90::mbar_arrive(&empty[st]);
  }

  // this thread's elements of the tile into dst (a (N, N) plane)
  auto store = [&](float* dst) {
#pragma unroll
    for (int idx = 0; idx < kCols / 2; ++idx) {
      const int row = rows[(idx >> 1) & 1];
      const int key = k0 + 8 * (idx >> 2) + 2 * t + (idx & 1);
      if (row < N && key < N) dst[static_cast<size_t>(row) * N + key] = acc[idx];
    }
  };
  // one chunk: dbias; else this chunk's (C, H, N, N) of the workspace
  store(a.chunks == 1 ? a.dbias + plane_off
                      : a.partial + static_cast<size_t>(chunk) * gridDim.y * N * N + plane_off);
}

// Block (blockIdx.x = (chunk, q chunk, key tile), key tile fastest;
// blockIdx.y = cell * H + head); the last key tile's products cut to
// round_up(keys left, 8) columns.
template <bool kFromO, int kD>
__global__ void __launch_bounds__(128, 3)
bias_grad_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo, const BiasGradArgs a) {
  __shared__ __align__(8) uint64_t full[kStages<kD, kFromO>];
  __shared__ __align__(8) uint64_t empty[kStages<kD, kFromO>];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const BiasMaps maps{&tq, &tk, &tv, &tdo};
  const int kt = blockIdx.x % a.tiles;
  const int qt = (blockIdx.x / a.tiles) % a.tiles;
  const int chunk = blockIdx.x / (a.tiles * a.tiles);
  const int k0 = kt * sm90::kChunk;
  const int q0 = qt * sm90::kChunk;
  switch ((min(sm90::kChunk, a.N - k0) + 7) / 8) {
#define BIAS_GRAD_COLS(w)                                                                   \
  case w:                                                                                   \
    bias_grad_block<8 * (w), kFromO, kD>(maps, a, smem, full, empty, q0, k0, blockIdx.y,    \
                                         chunk);                                            \
    break;
    BIAS_GRAD_COLS(1) BIAS_GRAD_COLS(2) BIAS_GRAD_COLS(3) BIAS_GRAD_COLS(4)
    BIAS_GRAD_COLS(5) BIAS_GRAD_COLS(6) BIAS_GRAD_COLS(7) BIAS_GRAD_COLS(8)
#undef BIAS_GRAD_COLS
  }
}

// dbias = the sum of the chunks' partials in chunk order (a split batch).
__global__ void __launch_bounds__(256)
bias_grad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dbias, size_t total,
                     int chunks) {
  const size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float sum = partial[i];
  for (int c = 1; c < chunks; ++c) sum += partial[c * total + i];
  dbias[i] = sum;
}

constexpr int kTileF32 = 32;
constexpr int kThreadsF32 = 256;  // eight threads a q row

template <int kD>
__global__ void __launch_bounds__(kThreadsF32)
bias_grad_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ o, const float* __restrict__ lse,
                     const float* __restrict__ delta, const float* __restrict__ bias,
                     float* __restrict__ dbias, int H, int N, int bias_batch, float scale) {
  constexpr int kLdsF32 = kD + 1;  // padded: a warp's key rows fall in distinct banks
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
      // rowsum(dO o O): eight threads a row, kD / 8 dims each, then a shuffle
      float sum = 0.f;
      if (q0 + i < N) {
        const float* orow = o + base + static_cast<size_t>(q0 + i) * kD;
        constexpr int kPart = kD / 8;
#pragma unroll
        for (int d = kPart * part; d < kPart * part + kPart; ++d) {
          sum = fmaf(sDo[i * kLdsF32 + d], orow[d], sum);
        }
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

template <bool kFromO, int kD>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout,
                        const BiasGradArgs& a, int B, int planes, cudaStream_t s) {
  const int smem = kFixedSmemBytes<kD, kFromO> + rows_bytes<kFromO>(a.chunk_elems);
  auto kernel = bias_grad_bf16_kernel<kFromO, kD>;
  // the attribute belongs to the device, so it is set on every launch
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int BH = B * a.H;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::encode_rows<kD>(&tq, q, a.N, BH, sm90::kChunk) ||
      !sm90::encode_rows<kD>(&tk, k, a.N, BH, sm90::kChunk) ||
      !sm90::encode_rows<kD>(&tv, v, a.N, BH, sm90::kChunk) ||
      !sm90::encode_rows<kD>(&tdo, dout, a.N, BH, sm90::kChunk)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(a.chunks * a.tiles * a.tiles, planes);
  kernel<<<grid, 128, smem, s>>>(tq, tk, tv, tdo, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.chunks == 1) return err;
  const size_t total = static_cast<size_t>(planes) * a.N * a.N;
  bias_grad_sum_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0, s>>>(
      a.partial, a.dbias, total, a.chunks);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, const void* o,
                   const void* lse, const void* delta, const void* bias, void* dbias,
                   void* partial, int B, int H, int N, int bias_cells,
                   int chunk_elems, float scale, int is_bf16, cudaStream_t s) {
  const int bias_batch = B / bias_cells;
  if (is_bf16) {
    const int chunks = (bias_batch + chunk_elems - 1) / chunk_elems;
    if (chunk_elems > kMaxChunkElems || (chunks > 1 && partial == nullptr)) {
      return cudaErrorInvalidValue;
    }
    const BiasGradArgs a{static_cast<const uint16_t*>(o), static_cast<const float*>(lse),
                         static_cast<const float*>(delta), static_cast<const float*>(bias),
                         static_cast<float*>(dbias), static_cast<float*>(partial), H, N,
                         bias_batch, chunk_elems, chunks,
                         (N + sm90::kChunk - 1) / sm90::kChunk, scale};
    return delta == nullptr ? launch_bf16<true, kD>(q, k, v, dout, a, B, bias_cells * H, s)
                            : launch_bf16<false, kD>(q, k, v, dout, a, B, bias_cells * H, s);
  }
  const dim3 grid((N + kTileF32 - 1) / kTileF32, (N + kTileF32 - 1) / kTileF32, bias_cells * H);
  bias_grad_f32_kernel<kD><<<grid, kThreadsF32, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(o), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<float*>(dbias), H, N, bias_batch, scale);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` of `device` and returns cudaGetLastError() (0 = ok).
// q, k, v, dout, o: (B, H, N, D) contiguous, 16-byte aligned, D 32 or 64,
// bf16 (is_bf16 = 1) or fp32; o may be NULL when delta is given; lse, delta:
// (B, H, 1, N) fp32, delta NULL to compute it from o; bias, dbias: (C, H, N,
// N) fp32 with C = bias_cells dividing B.  bf16 splits each cell's batch
// into chunks of chunk_elems elements (at most 16); with more than one
// chunk, partial is an fp32 workspace of (chunks, C, H, N, N), summed in
// chunk order by a second kernel.  fp32 takes no workspace and ignores
// chunk_elems.
extern "C" int attn_bias_grad(int device, const void* q, const void* k, const void* v,
                              const void* dout, const void* o, const void* lse, const void* delta,
                              const void* bias, void* dbias, void* partial, int B, int H, int N,
                              int D, int bias_cells, int chunk_elems, float scale, int is_bf16,
                              void* stream) {
  if (!head_dim_ok(D) || B <= 0 || H <= 0 || N <= 0 || bias_cells <= 0 || B % bias_cells != 0 ||
      static_cast<size_t>(bias_cells) * H > 65535 || bias == nullptr ||
      (delta == nullptr && o == nullptr) || chunk_elems <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      D == 32 ? launch<32>(q, k, v, dout, o, lse, delta, bias, dbias, partial, B, H, N,
                           bias_cells, chunk_elems, scale, is_bf16, s)
              : launch<64>(q, k, v, dout, o, lse, delta, bias, dbias, partial, B, H, N,
                           bias_cells, chunk_elems, scale, is_bf16, s));
}

// The dynamic shared memory a bf16 block asks for at head dim D, computing
// delta from O (from_o = 1) or reading it, with chunk_elems elements a chunk
// (bytes).
extern "C" int attn_bias_grad_smem_bytes(int D, int from_o, int chunk_elems) {
  const int rows = from_o ? rows_bytes<true>(chunk_elems) : rows_bytes<false>(chunk_elems);
  if (D == 32) return rows + (from_o ? kFixedSmemBytes<32, true> : kFixedSmemBytes<32, false>);
  return rows + (from_o ? kFixedSmemBytes<64, true> : kFixedSmemBytes<64, false>);
}

extern "C" const char* flash_attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
