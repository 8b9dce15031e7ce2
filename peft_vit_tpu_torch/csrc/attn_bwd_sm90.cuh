// The bf16 flash-attention backward for Hopper (sm_90a): K2 (dq, and delta)
// and K3 (dk, dv) of flash_attn_bwd.cu.  For q, k, v, o, dO (B, H, N, 64)
// bf16 and the forward's lse (B, H, 1, N) fp32:
//     delta = rowsum(dO o O)                     (K2 computes it and writes it)
//     p  = exp(scale q k^T - lse)      ds = p o (dO v^T - delta)
//     dq = scale ds k                  dk = scale ds^T q        dv = p^T dO
// p is rounded to bf16 before p^T dO and ds before its two products; every
// sum is fp32.  Keys and q rows at or beyond N contribute nothing, and rows
// at or beyond N are not written.
//
// The machinery is the forward's (attn_fwd_sm90.cuh): every bf16 operand is
// one 3-D tensor map over (64, N, B H) with the 128-byte swizzle, copied by
// TMA in boxes of 64 rows behind mbarriers (rows at or beyond N fall outside
// the map and arrive as zeros); products are wgmma with fp32 accumulators.
// A block is one warpgroup and owns 64 rows (K2: q rows; K3: keys) of one
// (batch, head); thread 0 issues every copy.  The loop runs over 64-row
// chunks of the other side (K2: keys; K3: q rows) through a ring of two
// stages refilled by thread 0 once the warpgroup has released a stage (full
// and empty barriers, as K1 streams).  Chunks of 64 rows keep S
// and dP at 32 fp32 registers a thread each: with lse known no online
// rescale is needed, so nothing is carried from chunk to chunk but the
// gradient accumulators.  The last chunk is cut to round_up(rows left, 8)
// columns and as many k16 steps as those need (at N = 197 its 5 rows take
// 8 columns and one step instead of 64 and four).
//
// The same launch at every N: four K2 blocks a SM (at most 128 registers)
// and three K3 blocks (at most 168: dk and dv beside S and dP).  Blocks of
// one warpgroup let the blocks of a SM drift apart, so that one's copies and
// softmax run under another's products; on the H100 this was faster than
// two warpgroups sharing a ring that holds the whole head at N <= 256 (the
// forward's resident design).
// At N = 197 a head is 4 tiles of which the last holds 5 rows, so a quarter
// of the blocks do almost no useful work; at B = 8 / 16 / 32 the 384 / 768 /
// 1,536 blocks fill 0.73 / 1.45 / 2.9 waves of K2 (528 slots) and 0.97 /
// 1.94 / 3.9 of K3 (396 slots).
//
// K2, per chunk of 64 keys:  S = Q K^T and dP = dO V^T (A and B from shared
// memory, both K-major, one commit group); dS = P o (dP - delta) formed in
// registers, where S and dP share the accumulator layout, and rounded to the
// bf16 A fragments of dq += dS K (B = K, MN-major with the transpose bit:
// the forward's P V form).  delta: each thread sums dO o O over its quarter
// of its two rows (dO from the swizzled tile in shared memory, O from device
// memory), a quad shuffle completes the row, and the quad's first thread
// writes it.
// K3, per chunk of 64 q rows:  S^T = K Q^T and dP^T = V dO^T (the block's own
// K and V tiles as A), so P^T and dS^T come out of the accumulators as the A
// fragments of dv += P^T dO and dk += dS^T Q (B MN-major) without a trip
// through shared memory.  lse and delta then run along the accumulator's
// columns: the block stages the chunk's 64 of each in a double buffer of
// shared memory (plain loads: a head's row of N fp32 is 788 bytes at
// N = 197, not the multiple of 16 bytes a TMA stride needs), prefetched into
// registers one chunk ahead, with one barrier a chunk.  q rows at or
// beyond N get lse = +inf, so p = exp(-inf) = 0 there with no mask.  The
// block owns its dk and dv rows: no atomics, a deterministic result.

#pragma once

#include "attn_fwd_sm90.cuh"

namespace sm90 {

constexpr int kChunk = 64;                       // rows of a tile or a chunk
constexpr int kTileBytes = kChunk * kRowBytes;   // 8 KB, a multiple of 1024
constexpr int kBwdStages = 2;                       // chunks in the ring
// dynamic shared memory: the block's own two tiles (K2: Q, dO; K3: K, V),
// the ring's two a stage (K2: K, V; K3: Q, dO), and the alignment slack
constexpr int kBwdSmemBytes = (2 + 2 * kBwdStages) * kTileBytes + 1024;

struct BwdArgs {
  const uint16_t* o;   // K2: (B, H, N, 64) bf16
  const float* lse;    // (B, H, 1, N)
  float* delta;        // K2 writes it, K3 reads it
  uint16_t* dq;        // K2
  uint16_t* dk;        // K3
  uint16_t* dv;        // K3
  int H;
  int N;
  float scale;
};

// d = A B^T over the 64 d of a 64-row tile A and the first kCols rows of a
// tile B (both K-major), issued into the current commit group.
template <int kCols>
__device__ __forceinline__ void ss_chunk(float (&d)[kCols / 2], const uint8_t* a_tile,
                                         const uint8_t* b_tile) {
  const uint64_t da = sw128_desc(a_tile);
  const uint64_t db = sw128_desc(b_tile);
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) wgmma_ss<kCols>(d, da + 2 * kk, db + 2 * kk, kk > 0);
}

// d += A B over the first 16 kSteps rows of a tile: A the bf16 fragments of
// kSteps k16 steps, B stored row-major (MN-major for this product), issued
// into the current commit group.
template <int kSteps>
__device__ __forceinline__ void rs_chunk(float (&d)[32], const uint32_t (&a)[kSteps][4],
                                         const uint8_t* b_tile) {
  const uint64_t db = sw128_desc(b_tile);
#pragma unroll
  for (int kk = 0; kk < kSteps; ++kk) {
    wgmma_rs_n64_tb(d, a[kk], db + kk * (16 * kRowBytes >> 4), 1);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Thread 0's ring: chunk j into stage j % kBwdStages, both tiles behind one
// barrier.  Refills the stage of chunk j - 1 with chunk j + kBwdStages - 1 once
// the warpgroup has released it.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint8_t* base;
  const CUtensorMap* map_a;
  const CUtensorMap* map_b;
  int bh;
  int chunks;

  __device__ uint8_t* a(int st) const { return base + st * 2 * kTileBytes; }
  __device__ uint8_t* b(int st) const { return a(st) + kTileBytes; }

  __device__ void load(int j) const {
    const int st = j % kBwdStages;
    mbar_expect_tx(&full[st], 2 * kTileBytes);
    tma_load_rows(a(st), map_a, j * kChunk, bh, &full[st]);
    tma_load_rows(b(st), map_b, j * kChunk, bh, &full[st]);
  }
  // by thread 0 at the top of iteration j
  __device__ void refill(int j) const {
    const int jn = j + kBwdStages - 1;
    if (j >= 1 && jn < chunks) {
      mbar_wait(&empty[jn % kBwdStages], (jn / kBwdStages - 1) & 1);
      load(jn);
    }
  }
  __device__ void wait(int j) const { mbar_wait(&full[j % kBwdStages], (j / kBwdStages) & 1); }
  __device__ void release(int j) const {
    if (chunks > kBwdStages) mbar_arrive(&empty[j % kBwdStages]);
  }
};

// The bf16 A fragments of a product over kCols columns of an accumulator
// (zero past kCols): k16 step kk takes the 8-column groups 2 kk and 2 kk + 1.
template <int kCols>
__device__ __forceinline__ void frags_of(uint32_t (&a)[(kCols + 15) / 16][4],
                                         const float (&x)[kCols / 2]) {
#pragma unroll
  for (int kk = 0; kk < (kCols + 15) / 16; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = 2 * kk + half;
      a[kk][2 * half + 0] = j < kCols / 8 ? pack_bf16(x[4 * j + 0], x[4 * j + 1]) : 0u;
      a[kk][2 * half + 1] = j < kCols / 8 ? pack_bf16(x[4 * j + 2], x[4 * j + 3]) : 0u;
    }
  }
}

// What a K2 chunk reads: the warpgroup's Q and dO tiles, the chunk's K and V.
struct DqChunk {
  const uint8_t* q;
  const uint8_t* dout;
  const uint8_t* k;
  const uint8_t* v;
  int key0;
  int N;
  float scale_l2;
  int t;
};

// dq += dS K over kCols keys from key0: S = Q K^T and dP = dO V^T in two
// commit groups, P formed while dP's product still runs (keys >= N get
// p = 0), dS = P o (dP - delta) in place, then its bf16 fragments times the
// chunk's K rows.
template <int kCols>
__device__ __forceinline__ void dq_chunk(float (&acc)[32], const DqChunk& c,
                                         const float (&lse_l2)[2], const float (&delta)[2]) {
  constexpr int kSteps = (kCols + 15) / 16;
  float s[kCols / 2], dp[kCols / 2];
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  ss_chunk<kCols>(s, c.q, c.k);
  wgmma_commit();
  ss_chunk<kCols>(dp, c.dout, c.v);
  wgmma_commit();
  wgmma_wait<1>();  // S has landed; the exponentials run under dP's product
  fence_regs(s);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    const int r = (idx >> 1) & 1;  // element idx % 4 of 8-column group idx / 4
    const float p = ex2(fmaf(s[idx], c.scale_l2, -lse_l2[r]));
    s[idx] = c.key0 + 8 * (idx >> 2) + 2 * c.t + (idx & 1) < c.N ? p : 0.f;
  }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) s[idx] *= dp[idx] - delta[(idx >> 1) & 1];
  uint32_t frag[kSteps][4];
  frags_of<kCols>(frag, s);
  fence_regs(acc);
  wgmma_fence();
  rs_chunk<kSteps>(acc, frag, c.k);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// What a K3 chunk reads: the warpgroup's K and V tiles, the chunk's Q and
// dO, and its log2e lse and delta in shared memory.
struct DkvChunk {
  const uint8_t* k;
  const uint8_t* v;
  const uint8_t* q;
  const uint8_t* dout;
  const float* lse_l2;
  const float* delta;
  float scale_l2;
  int t;
};

// dv += P^T dO and dk += dS^T Q over kCols q rows: S^T = K Q^T and dP^T =
// V dO^T in one commit group; column c of the accumulators is q row c of
// the chunk (rows >= N have lse = +inf, so p = 0).  Letting P^T and dv's
// product run under dP^T's, as K2 does, made ptxas serialize the wgmma for
// want of registers and spill (C7512), and K3 slower.
template <int kCols>
__device__ __forceinline__ void dkv_chunk(float (&dk)[32], float (&dv)[32], const DkvChunk& c) {
  constexpr int kSteps = (kCols + 15) / 16;
  float s[kCols / 2], dp[kCols / 2];
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  ss_chunk<kCols>(s, c.k, c.q);
  ss_chunk<kCols>(dp, c.v, c.dout);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    const int col = 8 * (idx >> 2) + 2 * c.t + (idx & 1);
    const float p = ex2(fmaf(s[idx], c.scale_l2, -c.lse_l2[col]));
    s[idx] = p;
    dp[idx] = p * (dp[idx] - c.delta[col]);
  }
  uint32_t pfrag[kSteps][4], dsfrag[kSteps][4];
  frags_of<kCols>(pfrag, s);
  frags_of<kCols>(dsfrag, dp);
  fence_regs(dv);
  fence_regs(dk);
  wgmma_fence();
  rs_chunk<kSteps>(dv, pfrag, c.dout);
  rs_chunk<kSteps>(dk, dsfrag, c.q);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
}

__global__ void __launch_bounds__(128, 4)
attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo, const BwdArgs args) {
  __shared__ __align__(8) uint64_t bar_own;
  __shared__ __align__(8) uint64_t bar_full[kBwdStages];
  __shared__ __align__(8) uint64_t bar_empty[kBwdStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int N = args.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kChunk;
  const int chunks = (N + kChunk - 1) / kChunk;
  uint8_t* sQ = smem;
  uint8_t* sDo = sQ + kTileBytes;
  const Ring ring{bar_full, bar_empty, smem + 2 * kTileBytes, &tk, &tv, bh, chunks};

  if (tid == 0) {
    mbar_init(&bar_own, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(&bar_full[st], 1);
      mbar_init(&bar_empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_own, 2 * kTileBytes);
    tma_load_rows(sQ, &tq, q0, bh, &bar_own);
    tma_load_rows(sDo, &tdo, q0, bh, &bar_own);
    for (int j = 0; j < min(kBwdStages, chunks); ++j) ring.load(j);
  }

  // This thread's rows of the tile: r and r + 8 (the accumulator layout).
  const int r = warp * 16 + g;
  const int row[2] = {q0 + r, q0 + r + 8};
  const size_t head = static_cast<size_t>(bh) * N;

  // delta: O from device memory while the tiles are in flight, dO from the
  // tile.  Row r's 16-byte chunk c lies at chunk c ^ (r % 8) of its 128 bytes
  // (the 128-byte swizzle), and r % 8 = g for both rows.
  uint4 orow[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      orow[i][c] = row[i] < N ? *reinterpret_cast<const uint4*>(args.o + (head + row[i]) * kD +
                                                                (2 * t + c) * 8)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float lse_l2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lse_l2[i] = row[i] < N ? args.lse[head + row[i]] * kLog2e : 0.f;
  mbar_wait(&bar_own, 0);
  float delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const uint4 dov = *reinterpret_cast<const uint4*>(
          sDo + (r + 8 * i) * kRowBytes + (((2 * t + c) ^ g) * 16));
      const uint32_t dw[4] = {dov.x, dov.y, dov.z, dov.w};
      const uint32_t ow[4] = {orow[i][c].x, orow[i][c].y, orow[i][c].z, orow[i][c].w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 df = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&dw[e]));
        const float2 of = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
        sum = fmaf(df.x, of.x, sum);
        sum = fmaf(df.y, of.y, sum);
      }
    }
    delta[i] = quad_sum(sum);
    if (t == 0 && row[i] < N) args.delta[head + row[i]] = delta[i];
  }

  const float scale_l2 = args.scale * kLog2e;
  float acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;

  // every chunk but the last is 64 keys wide; the last is cut to a
  // multiple of 8 (5 keys at N = 197 take 8 columns and one k16 step)
  const int tail = N - (chunks - 1) * kChunk;
  for (int j = 0; j < chunks; ++j) {
    if (tid == 0) ring.refill(j);
    ring.wait(j);
    const int st = j % kBwdStages;
    const DqChunk c{sQ, sDo, ring.a(st), ring.b(st), j * kChunk, N, scale_l2, t};
    if (j + 1 < chunks) {
      dq_chunk<kChunk>(acc, c, lse_l2, delta);
    } else {
      switch ((tail + 7) / 8) {
#define SM90_DQ_TAIL(w) \
  case w:                \
    dq_chunk<8 * (w)>(acc, c, lse_l2, delta); \
    break;
        SM90_DQ_TAIL(1) SM90_DQ_TAIL(2) SM90_DQ_TAIL(3) SM90_DQ_TAIL(4)
        SM90_DQ_TAIL(5) SM90_DQ_TAIL(6) SM90_DQ_TAIL(7) SM90_DQ_TAIL(8)
#undef SM90_DQ_TAIL
      }
    }
    ring.release(j);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= N) continue;
    uint16_t* out = args.dq + (head + row[i]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_bf16(args.scale * acc[4 * dt + 2 * i], args.scale * acc[4 * dt + 2 * i + 1]);
    }
  }
}

__global__ void __launch_bounds__(128, 3)
attn_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo, const BwdArgs args) {
  __shared__ __align__(8) uint64_t bar_own;
  __shared__ __align__(8) uint64_t bar_full[kBwdStages];
  __shared__ __align__(8) uint64_t bar_empty[kBwdStages];
  __shared__ float s_lse[2][kChunk];  // log2e lse of the chunk's q rows
  __shared__ float s_delta[2][kChunk];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));

  const int N = args.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kChunk;
  const int chunks = (N + kChunk - 1) / kChunk;
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTileBytes;
  const Ring ring{bar_full, bar_empty, smem + 2 * kTileBytes, &tq, &tdo, bh, chunks};

  if (tid == 0) {
    mbar_init(&bar_own, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(&bar_full[st], 1);
      mbar_init(&bar_empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(&bar_own, 2 * kTileBytes);
    tma_load_rows(sK, &tk, k0, bh, &bar_own);
    tma_load_rows(sV, &tv, k0, bh, &bar_own);
    for (int j = 0; j < min(kBwdStages, chunks); ++j) ring.load(j);
  }

  const size_t head = static_cast<size_t>(bh) * N;
  const float kInf = __int_as_float(0x7f800000);
  // Thread tid stages lse (tid < 64) or delta of q row tid % 64 of each
  // chunk; rows >= N get lse = +inf, delta = 0.
  auto fetch = [&](int j) {
    const int qrow = j * kChunk + (tid & 63);
    if (tid < 64) return qrow < N ? args.lse[head + qrow] * kLog2e : kInf;
    return qrow < N ? args.delta[head + qrow] : 0.f;
  };
  float next = fetch(0);
  const int tail = N - (chunks - 1) * kChunk;  // q rows of the last chunk

  const float scale_l2 = args.scale * kLog2e;
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  mbar_wait(&bar_own, 0);

  for (int j = 0; j < chunks; ++j) {
    if (tid == 0) ring.refill(j);
    const int buf = j & 1;
    (tid < 64 ? s_lse : s_delta)[buf][tid & 63] = next;
    __syncthreads();
    if (j + 1 < chunks) next = fetch(j + 1);

    ring.wait(j);
    const int st = j % kBwdStages;
    const DkvChunk c{sK, sV, ring.a(st), ring.b(st), s_lse[buf], s_delta[buf],
                     scale_l2, t};
    if (j + 1 < chunks) {
      dkv_chunk<kChunk>(dk, dv, c);
    } else {
      switch ((tail + 7) / 8) {
#define SM90_DKV_TAIL(w) \
  case w:                 \
    dkv_chunk<8 * (w)>(dk, dv, c); \
    break;
        SM90_DKV_TAIL(1) SM90_DKV_TAIL(2) SM90_DKV_TAIL(3) SM90_DKV_TAIL(4)
        SM90_DKV_TAIL(5) SM90_DKV_TAIL(6) SM90_DKV_TAIL(7) SM90_DKV_TAIL(8)
#undef SM90_DKV_TAIL
      }
    }
    ring.release(j);
  }

  const int r = warp * 16 + g;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r + 8 * i;
    if (key >= N) continue;
    const size_t off = (head + key) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(args.dk + off + dt * 8 + 2 * t) =
          pack_bf16(args.scale * dk[4 * dt + 2 * i], args.scale * dk[4 * dt + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(args.dv + off + dt * 8 + 2 * t) =
          pack_bf16(dv[4 * dt + 2 * i], dv[4 * dt + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// K2 (kDq) or K3 in bf16, at every N.  The shared-memory attribute belongs
// to the device, so it is set on every launch.
template <bool kDq>
cudaError_t attn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const BwdArgs& args, int B, cudaStream_t stream) {
  if (static_cast<size_t>(B) * args.H > 65535) return cudaErrorInvalidValue;  // grid.y
  auto kernel = kDq ? attn_bwd_dq_sm90_kernel : attn_bwd_dkv_sm90_kernel;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdSmemBytes);
  if (attr != cudaSuccess) return attr;
  const int BH = B * args.H;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(&tq, q, args.N, BH, kChunk) || !encode_rows(&tk, k, args.N, BH, kChunk) ||
      !encode_rows(&tv, v, args.N, BH, kChunk) || !encode_rows(&tdo, dout, args.N, BH, kChunk)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((args.N + kChunk - 1) / kChunk, BH);
  kernel<<<grid, 128, kBwdSmemBytes, stream>>>(tq, tk, tv, tdo, args);
  return cudaGetLastError();
}

}  // namespace sm90
