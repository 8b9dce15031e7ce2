// The bf16 attention backward for Hopper (sm_90a): K2 (dq, and delta) and
// K3 (dk, dv) of flash_attn_bwd.cu, and K5, the fused short-sequence
// backward of fused_short_attn.cu, which runs both in one launch.  For q, k,
// v, o, dO (B, H, N, 64) bf16 and the forward's lse (B, H, 1, N) fp32:
//     delta = rowsum(dO o O)                     (K2 computes it and writes it)
//     p  = exp(scale q k^T (+ bias) - lse)   ds = p o (dO v^T - delta)
//     dq = scale ds k                  dk = scale ds^T q        dv = p^T dO
// p is rounded to bf16 before p^T dO and ds before its two products; every
// sum is fp32.  K5 (kFused) folds the scale into ds before ds is rounded,
// ds = scale p o (dO v^T - delta), and scales nothing after the products;
// it takes no delta operand.  Keys and q rows at or beyond N contribute
// nothing, and rows at or beyond N are not written.
//
// The bias (K2 and K3 with kBias; K5 has none, as the Pallas pair has none):
// the forward's (C, H, N, N) fp32 bias, batch element b reading cell
// b / (B / C), added where p is recomputed.  Each thread reads the elements
// of its accumulator fragments from device memory (the bias of a head is
// 155 KB at N = 197 and stays in L2), issued before the wait on the
// products so that the loads run under them; K2 reads its rows' keys
// contiguously, K3 its keys' q rows at a stride of N.  The bias-free
// instantiations are the kernels of before, unchanged; the bias ones take a
// block fewer a SM (K2 three, K3 two) for the registers of the loaded tile.
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
//
// K5 is one launch of both bodies, chosen by blockIdx.z: the dk/dv blocks
// (z = 0, the longer role) come first in the block order and the dq blocks
// (z = 1) fill the tail; no block waits on another.  Its dq blocks are K2's
// without the delta write.  Its dk/dv blocks have no delta to read, so each
// computes the delta of a q chunk itself, as K2 does: from the chunk's dO
// tile in the ring stage and the chunk's O rows, which each thread copies
// (its own 64 bytes of them, by cp.async) into a double buffer of shared
// memory one chunk ahead, so that neither registers nor a barrier are
// spent on the prefetch.  O is then read once per key tile (4 times a head
// at N = 197), mostly from L2.  Three blocks a SM (at most 168 registers,
// 65 KB of shared memory each).  On the H100, computing this delta while
// the chunk's first products run was no faster, so its cost is not the
// arithmetic (O's bytes are the likely one), and the two roles interleaved
// head by head were slower at B <= 16 (PERF.md).

#pragma once

#include "attn_fwd_sm90.cuh"

namespace sm90 {

constexpr int kChunk = 64;                       // rows of a tile or a chunk
constexpr int kTileBytes = kChunk * kRowBytes;   // 8 KB, a multiple of 1024
constexpr int kBwdStages = 2;                       // chunks in the ring
// dynamic shared memory: the block's own two tiles (K2: Q, dO; K3: K, V),
// the ring's two a stage (K2: K, V; K3: Q, dO), and the alignment slack
constexpr int kBwdSmemBytes = (2 + 2 * kBwdStages) * kTileBytes + 1024;
// K5: and the double buffer of the dk/dv role's O rows
constexpr int kFusedBwdSmemBytes = kBwdSmemBytes + 2 * kTileBytes;

// The kernel's three roles: K2, K3, and K5 (both, by blockIdx.z).
constexpr int kRoleDq = 0;
constexpr int kRoleDkv = 1;
constexpr int kRoleFused = 2;

struct BwdArgs {
  const uint16_t* o;   // K2, K5: (B, H, N, 64) bf16
  const float* lse;    // (B, H, 1, N)
  float* delta;        // K2 writes it, K3 reads it; K5 has none
  uint16_t* dq;        // K2, K5
  uint16_t* dk;        // K3, K5
  uint16_t* dv;        // K3, K5
  int H;
  int N;
  float scale;
  const float* bias;   // K2, K3 with kBias: (C, H, N, N) fp32
  int bias_batch;      // B / C
};

// The bias of head bh's (batch b, head h) cell: its (N, N) matrix.
__device__ __forceinline__ const float* head_bias(const BwdArgs& args, int bh) {
  const size_t cell = (bh / args.H) / args.bias_batch;
  return args.bias + (cell * args.H + bh % args.H) * args.N * static_cast<size_t>(args.N);
}

// The four tensor maps of a launch.
struct BwdMaps {
  const CUtensorMap* q;
  const CUtensorMap* k;
  const CUtensorMap* v;
  const CUtensorMap* dout;
};

// A block's barriers (static shared memory).
struct BwdBars {
  uint64_t* own;
  uint64_t* full;
  uint64_t* empty;
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

// delta of this thread's two rows r and r + 8 of a 64-row tile: the thread
// sums dO o O over its quarter of each row (16-byte chunks 2 t and 2 t + 1;
// dO from the swizzled tile, where row r's chunk c lies at chunk c ^ (r % 8)
// of its 128 bytes, and r % 8 = g for both rows; orow[i][c] the same chunks
// of O), and a quad shuffle completes the row.
__device__ __forceinline__ void rows_delta(float (&delta)[2], const uint8_t* sDo,
                                           const uint4 (&orow)[2][2], int r, int g, int t) {
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
  }
}

// 16 bytes from global into shared, asynchronously; zero-filled when
// !valid (a source size of 0 reads nothing).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// K5's dk/dv role: this thread's O chunks of q chunk j (those rows_delta
// reads: rows r and r + 8, 16-byte chunks 2 t and 2 t + 1) into its own 64
// bytes of the 8 KB buffer sO, thread-major so that a warp's copies are
// contiguous; rows >= N are zeros.  Only this thread reads them back (after
// cp.async.wait_group), so no barrier guards the buffer.
__device__ __forceinline__ void prefetch_o_rows(uint8_t* sO, const uint16_t* o, size_t head,
                                                int j, int r, int t, int tid, int N) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = j * kChunk + r + 8 * i;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const bool valid = row < N;
      cp_async_16(sO + ((2 * i + c) * 128 + tid) * 16,
                  o + (head + (valid ? row : 0)) * kD + (2 * t + c) * 8, valid);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void load_o_rows(uint4 (&orow)[2][2], const uint8_t* sO, int tid) {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      orow[i][c] = *reinterpret_cast<const uint4*>(sO + ((2 * i + c) * 128 + tid) * 16);
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
  float scale;  // folded into dS (kFold)
  int t;
  const float* brow[2];  // kBias: the bias rows of this thread's two q rows (null >= N)
};

// dq += dS K over kCols keys from key0: S = Q K^T and dP = dO V^T in two
// commit groups, P formed while dP's product still runs (keys >= N get
// p = 0; kBias: the bias, loaded while S's product runs, added to the
// exponent), dS = P o (dP - delta) in place (kFold: scale P o (dP - delta)),
// then its bf16 fragments times the chunk's K rows.
template <int kCols, bool kFold, bool kBias>
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
  // log2e (bias - lse) of each element, or - log2e lse
  float off[kBias ? kCols / 2 : 1];
  if constexpr (kBias) {
#pragma unroll
    for (int idx = 0; idx < kCols / 2; ++idx) {
      const int r = (idx >> 1) & 1;
      const int key = c.key0 + 8 * (idx >> 2) + 2 * c.t + (idx & 1);
      const float b = (c.brow[r] != nullptr && key < c.N) ? c.brow[r][key] : 0.f;
      off[idx] = fmaf(b, kLog2e, -lse_l2[r]);
    }
  }
  wgmma_wait<1>();  // S has landed; the exponentials run under dP's product
  fence_regs(s);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    const int r = (idx >> 1) & 1;  // element idx % 4 of 8-column group idx / 4
    const float p = ex2(fmaf(s[idx], c.scale_l2, kBias ? off[kBias ? idx : 0] : -lse_l2[r]));
    s[idx] = c.key0 + 8 * (idx >> 2) + 2 * c.t + (idx & 1) < c.N ? p : 0.f;
  }
  wgmma_wait<0>();
  fence_regs(dp);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    if constexpr (kFold) {
      s[idx] = c.scale * s[idx] * (dp[idx] - delta[(idx >> 1) & 1]);
    } else {
      s[idx] *= dp[idx] - delta[(idx >> 1) & 1];
    }
  }
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
  float scale;  // folded into dS^T (kFold)
  int t;
  const float* bias;  // kBias: the head's (N, N) bias
  int q0;             // kBias: the chunk's first q row
  int key;            // kBias: this thread's first key (its second is key + 8)
  int N;
};

// dv += P^T dO and dk += dS^T Q over kCols q rows: S^T = K Q^T and dP^T =
// V dO^T in one commit group; column c of the accumulators is q row c of
// the chunk (rows >= N have lse = +inf, so p = 0).  Letting P^T and dv's
// product run under dP^T's, as K2 does, made ptxas serialize the wgmma for
// want of registers and spill (C7512), and K3 slower.
template <int kCols, bool kFold, bool kBias>
__device__ __forceinline__ void dkv_chunk(float (&dk)[32], float (&dv)[32], const DkvChunk& c) {
  constexpr int kSteps = (kCols + 15) / 16;
  float s[kCols / 2], dp[kCols / 2];
  fence_regs(s);
  fence_regs(dp);
  wgmma_fence();
  ss_chunk<kCols>(s, c.k, c.q);
  ss_chunk<kCols>(dp, c.v, c.dout);
  wgmma_commit();
  // kBias: log2e bias[q row][key] of each element (rows: keys, columns: q
  // rows), loaded while the products run
  float lb[kBias ? kCols / 2 : 1];
  if constexpr (kBias) {
#pragma unroll
    for (int idx = 0; idx < kCols / 2; ++idx) {
      const int qrow = c.q0 + 8 * (idx >> 2) + 2 * c.t + (idx & 1);
      const int key = c.key + 8 * ((idx >> 1) & 1);
      lb[idx] = (qrow < c.N && key < c.N)
                    ? c.bias[static_cast<size_t>(qrow) * c.N + key] * kLog2e : 0.f;
    }
  }
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
#pragma unroll
  for (int idx = 0; idx < kCols / 2; ++idx) {
    const int col = 8 * (idx >> 2) + 2 * c.t + (idx & 1);
    const float p = ex2(fmaf(s[idx], c.scale_l2,
                             kBias ? lb[kBias ? idx : 0] - c.lse_l2[col] : -c.lse_l2[col]));
    s[idx] = p;
    if constexpr (kFold) {
      dp[idx] = c.scale * p * (dp[idx] - c.delta[col]);
    } else {
      dp[idx] = p * (dp[idx] - c.delta[col]);
    }
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

// The barriers' initial state, then a block barrier.
__device__ __forceinline__ void init_bars(const BwdBars& bars, int tid) {
  if (tid == 0) {
    mbar_init(bars.own, 1);
#pragma unroll
    for (int st = 0; st < kBwdStages; ++st) {
      mbar_init(&bars.full[st], 1);
      mbar_init(&bars.empty[st], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The dq role (K2; K5's dq blocks with kFused): this block owns the 64 q
// rows from q0 of head bh and loops over the key chunks.
template <bool kFused, bool kBias>
__device__ __forceinline__ void dq_block(const BwdMaps& maps, const BwdArgs& args,
                                         const BwdBars& bars, uint8_t* smem, int q0, int bh) {
  const int N = args.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int chunks = (N + kChunk - 1) / kChunk;
  uint8_t* sQ = smem;
  uint8_t* sDo = sQ + kTileBytes;
  const Ring ring{bars.full, bars.empty, smem + 2 * kTileBytes, maps.k, maps.v, bh, chunks};

  init_bars(bars, tid);
  if (tid == 0) {
    mbar_expect_tx(bars.own, 2 * kTileBytes);
    tma_load_rows(sQ, maps.q, q0, bh, bars.own);
    tma_load_rows(sDo, maps.dout, q0, bh, bars.own);
    for (int j = 0; j < min(kBwdStages, chunks); ++j) ring.load(j);
  }

  // This thread's rows of the tile: r and r + 8 (the accumulator layout).
  const int r = warp * 16 + g;
  const int row[2] = {q0 + r, q0 + r + 8};
  const size_t head = static_cast<size_t>(bh) * N;

  // delta: O from device memory while the tiles are in flight, dO from the
  // tile.
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
  const float* brow[2] = {nullptr, nullptr};
  if constexpr (kBias) {
    const float* hb = head_bias(args, bh);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (row[i] < N) brow[i] = hb + static_cast<size_t>(row[i]) * N;
    }
  }
  mbar_wait(bars.own, 0);
  float delta[2];
  rows_delta(delta, sDo, orow, r, g, t);
  if constexpr (!kFused) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t == 0 && row[i] < N) args.delta[head + row[i]] = delta[i];
    }
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
    const DqChunk c{sQ,         sDo,        ring.a(st), ring.b(st),          j * kChunk, N,
                    scale_l2,   args.scale, t,          {brow[0], brow[1]}};
    if (j + 1 < chunks) {
      dq_chunk<kChunk, kFused, kBias>(acc, c, lse_l2, delta);
    } else {
      switch ((tail + 7) / 8) {
#define SM90_DQ_TAIL(w) \
  case w:                \
    dq_chunk<8 * (w), kFused, kBias>(acc, c, lse_l2, delta); \
    break;
        SM90_DQ_TAIL(1) SM90_DQ_TAIL(2) SM90_DQ_TAIL(3) SM90_DQ_TAIL(4)
        SM90_DQ_TAIL(5) SM90_DQ_TAIL(6) SM90_DQ_TAIL(7) SM90_DQ_TAIL(8)
#undef SM90_DQ_TAIL
      }
    }
    ring.release(j);
  }

  // K2 scales the sums here; K5 folded the scale into dS
  const float out_scale = kFused ? 1.f : args.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= N) continue;
    uint16_t* out = args.dq + (head + row[i]) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(out + dt * 8 + 2 * t) =
          pack_bf16(out_scale * acc[4 * dt + 2 * i], out_scale * acc[4 * dt + 2 * i + 1]);
    }
  }
}

// The dk/dv role (K3; K5's dk/dv blocks with kFused, which compute each q
// chunk's delta themselves): this block owns the 64 keys from k0 of head bh
// and loops over the q chunks.  s_lse and s_delta: double buffers of a
// chunk's 64 log2e lse and delta.
template <bool kFused, bool kBias>
__device__ __forceinline__ void dkv_block(const BwdMaps& maps, const BwdArgs& args,
                                          const BwdBars& bars, uint8_t* smem, int k0, int bh,
                                          float (*s_lse)[kChunk], float (*s_delta)[kChunk]) {
  const int N = args.N;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int chunks = (N + kChunk - 1) / kChunk;
  uint8_t* sK = smem;
  uint8_t* sV = sK + kTileBytes;
  const Ring ring{bars.full, bars.empty, smem + 2 * kTileBytes, maps.q, maps.dout, bh, chunks};
  // K5: the double buffer of this block's O rows, past the ring
  uint8_t* sO = smem + (2 + 2 * kBwdStages) * kTileBytes;

  init_bars(bars, tid);
  if (tid == 0) {
    mbar_expect_tx(bars.own, 2 * kTileBytes);
    tma_load_rows(sK, maps.k, k0, bh, bars.own);
    tma_load_rows(sV, maps.v, k0, bh, bars.own);
    for (int j = 0; j < min(kBwdStages, chunks); ++j) ring.load(j);
  }

  const size_t head = static_cast<size_t>(bh) * N;
  const int r = warp * 16 + g;  // this thread's rows r and r + 8 of a chunk (delta)
  if constexpr (kFused) prefetch_o_rows(sO, args.o, head, 0, r, t, tid, N);
  const float kInf = __int_as_float(0x7f800000);
  // Thread tid stages lse (tid < 64) or (K3) delta of q row tid % 64 of each
  // chunk; rows >= N get lse = +inf, delta = 0.
  auto fetch = [&](int j) {
    const int qrow = j * kChunk + (tid & 63);
    if (tid < 64) return qrow < N ? args.lse[head + qrow] * kLog2e : kInf;
    if constexpr (kFused) {
      return 0.f;
    } else {
      return qrow < N ? args.delta[head + qrow] : 0.f;
    }
  };
  float next = fetch(0);
  const int tail = N - (chunks - 1) * kChunk;  // q rows of the last chunk
  const float* bias_head = kBias ? head_bias(args, bh) : nullptr;

  const float scale_l2 = args.scale * kLog2e;
  float dk[kD / 2], dv[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  mbar_wait(bars.own, 0);

  for (int j = 0; j < chunks; ++j) {
    if (tid == 0) ring.refill(j);
    const int buf = j & 1;
    const int st = j % kBwdStages;
    if constexpr (kFused) {
      // the chunk's delta from its dO tile in the ring and its O rows
      ring.wait(j);
      uint4 orow[2][2];
      load_o_rows(orow, sO + buf * kTileBytes, tid);
      float delta[2];
      rows_delta(delta, ring.b(st), orow, r, g, t);
      if (t == 0) {
        s_delta[buf][r] = delta[0];
        s_delta[buf][r + 8] = delta[1];
      }
      if (tid < 64) s_lse[buf][tid] = next;
    } else {
      (tid < 64 ? s_lse : s_delta)[buf][tid & 63] = next;
    }
    __syncthreads();
    if (j + 1 < chunks) {
      next = fetch(j + 1);
      if constexpr (kFused) prefetch_o_rows(sO + (buf ^ 1) * kTileBytes, args.o, head, j + 1,
                                            r, t, tid, N);
    }

    if constexpr (!kFused) ring.wait(j);
    const DkvChunk c{sK,         sV,   ring.a(st), ring.b(st), s_lse[buf], s_delta[buf],
                     scale_l2,   args.scale, t,  bias_head,  j * kChunk, k0 + r,      N};
    if (j + 1 < chunks) {
      dkv_chunk<kChunk, kFused, kBias>(dk, dv, c);
    } else {
      switch ((tail + 7) / 8) {
#define SM90_DKV_TAIL(w) \
  case w:                 \
    dkv_chunk<8 * (w), kFused, kBias>(dk, dv, c); \
    break;
        SM90_DKV_TAIL(1) SM90_DKV_TAIL(2) SM90_DKV_TAIL(3) SM90_DKV_TAIL(4)
        SM90_DKV_TAIL(5) SM90_DKV_TAIL(6) SM90_DKV_TAIL(7) SM90_DKV_TAIL(8)
#undef SM90_DKV_TAIL
      }
    }
    ring.release(j);
  }

  // K3 scales dk here; K5 folded the scale into dS^T
  const float out_scale = kFused ? 1.f : args.scale;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r + 8 * i;
    if (key >= N) continue;
    const size_t off = (head + key) * kD;
#pragma unroll
    for (int dt = 0; dt < kD / 8; ++dt) {
      *reinterpret_cast<uint32_t*>(args.dk + off + dt * 8 + 2 * t) =
          pack_bf16(out_scale * dk[4 * dt + 2 * i], out_scale * dk[4 * dt + 2 * i + 1]);
      *reinterpret_cast<uint32_t*>(args.dv + off + dt * 8 + 2 * t) =
          pack_bf16(dv[4 * dt + 2 * i], dv[4 * dt + 2 * i + 1]);
    }
  }
}

// K2 (kRoleDq), K3 (kRoleDkv) or K5 (kRoleFused: blockIdx.z 0 the dk/dv
// blocks, 1 the dq blocks), with the bias for K2 and K3 (kBias).  One
// warpgroup a block, 64 rows of head blockIdx.y from row 64 blockIdx.x.
template <int kRole, bool kBias>
__global__ void __launch_bounds__(128, kRole == kRoleDq ? (kBias ? 3 : 4) : (kBias ? 2 : 3))
attn_bwd_sm90_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const BwdArgs args) {
  static_assert(!(kBias && kRole == kRoleFused), "K5 takes no bias");
  __shared__ __align__(8) uint64_t bar_own;
  __shared__ __align__(8) uint64_t bar_full[kBwdStages];
  __shared__ __align__(8) uint64_t bar_empty[kBwdStages];
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const BwdMaps maps{&tq, &tk, &tv, &tdo};
  const BwdBars bars{&bar_own, bar_full, bar_empty};
  const int row0 = blockIdx.x * kChunk;
  const int bh = blockIdx.y;
  if constexpr (kRole == kRoleDq) {
    dq_block<false, kBias>(maps, args, bars, smem, row0, bh);
  } else if constexpr (kRole == kRoleDkv) {
    __shared__ float s_lse[2][kChunk];  // log2e lse of the chunk's q rows
    __shared__ float s_delta[2][kChunk];
    dkv_block<false, kBias>(maps, args, bars, smem, row0, bh, s_lse, s_delta);
  } else {
    __shared__ float s_lse[2][kChunk];
    __shared__ float s_delta[2][kChunk];
    if (blockIdx.z == 0) {
      dkv_block<true, false>(maps, args, bars, smem, row0, bh, s_lse, s_delta);
    } else {
      dq_block<true, false>(maps, args, bars, smem, row0, bh);
    }
  }
}

// ---------------------------------------------------------------------------
// host side

// K2, K3 or K5 in bf16, at every N, K2 and K3 with or without the bias.
// The shared-memory attribute belongs to the device, so it is set on every
// launch.
template <int kRole, bool kBias = false>
cudaError_t attn_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                          const BwdArgs& args, int B, cudaStream_t stream) {
  if (static_cast<size_t>(B) * args.H > 65535) return cudaErrorInvalidValue;  // grid.y
  constexpr int smem = kRole == kRoleFused ? kFusedBwdSmemBytes : kBwdSmemBytes;
  auto kernel = attn_bwd_sm90_kernel<kRole, kBias>;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return attr;
  const int BH = B * args.H;
  CUtensorMap tq, tk, tv, tdo;
  if (!encode_rows(&tq, q, args.N, BH, kChunk) || !encode_rows(&tk, k, args.N, BH, kChunk) ||
      !encode_rows(&tv, v, args.N, BH, kChunk) || !encode_rows(&tdo, dout, args.N, BH, kChunk)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((args.N + kChunk - 1) / kChunk, BH, kRole == kRoleFused ? 2 : 1);
  kernel<<<grid, 128, smem, stream>>>(tq, tk, tv, tdo, args);
  return cudaGetLastError();
}

}  // namespace sm90
