// bv_tile: the tensor-core tile of popcount(AND) over packed 4096-bit 6-mer
// presence vectors.  bv_common.cu runs the whole tile (and stores the
// counts); gate_block.cu stages its words with load_stage, whose layout is
// wgmma's 128-byte swizzle, and contracts them with wgmma instead.
//
// A block of 256 threads computes 128 x 128 outputs with 8 warps (2 x 4),
// each warp 64 x 32 (4 x 4 tiles of 16 x 8).  Both operand tiles stream
// through shared memory in four stages of 32 words (1,024 bits) a row,
// double-buffered with cp.async (rows past n_pool or n_seed are zero-filled,
// so they stay inert).  A row's 16-byte units are XOR-swizzled by (row & 7),
// so the eight rows that one ldmatrix phase touches fall on distinct banks.
// Each staged tile is read by 4 (pool) or 2 (seed) warps, contracted by
// mma.sync m16n8k256 .b1 with .and.popc on the packed words, fragments by
// ldmatrix: 16 MMAs per 256 bits per warp.
//
// Accumulator layout (mma.sync m16n8 C fragment): with l the lane, g = l >> 2
// and tig = l & 3, acc[mt][nt][2 * half + j] holds the count of pool row
// p0 + wm * 64 + mt * 16 + half * 8 + g and seed row
// s0 + wn * 32 + nt * 8 + tig * 2 + j, where wm = warp & 1, wn = warp >> 1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bv_tile {

constexpr int kWords = 128;                 // 4096 bits
constexpr int kBM = 128;                    // pool rows a block
constexpr int kBN = 128;                    // seed rows a block
constexpr int kChunk = 32;                  // words a row a stage
constexpr int kUnits = kChunk / 4;          // 16-byte units a row a stage
constexpr int kStages = kWords / kChunk;
constexpr int kThreads = 256;
constexpr int kBufWords = (kBM + kBN) * kChunk;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// word offset of 16-byte unit u of row r in a staged tile
__device__ __forceinline__ int swz(int r, int u) {
  return (r * kUnits + (u ^ (r & 7))) * 4;
}

__device__ __forceinline__ void load_stage(uint32_t* buf, const uint32_t* pool,
                                           const uint32_t* seed, int p0,
                                           int s0, int n_pool, int n_seed,
                                           int stage) {
  for (int i = threadIdx.x; i < (kBM + kBN) * kUnits; i += kThreads) {
    const int row = i / kUnits;
    const int u = i % kUnits;
    const bool is_pool = row < kBM;
    const int src_row = is_pool ? p0 + row : s0 + row - kBM;
    const bool valid = src_row < (is_pool ? n_pool : n_seed);
    const uint32_t* base = is_pool ? pool : seed;
    const uint32_t* src =
        valid ? base + static_cast<size_t>(src_row) * kWords + stage * kChunk +
                    u * 4
              : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(buf + swz(row, u))),
                 "l"(src), "r"(valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_b1(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one staged stage, binary MMA: 4 steps of 256 bits (two units each)
__device__ __forceinline__ void compute_b1(const uint32_t* buf, int wm, int wn,
                                           int acc[4][4][4]) {
  const int l = threadIdx.x & 31;
  const int mi = l >> 3;
  const uint32_t* sa = buf;
  const uint32_t* sb = buf + kBM * kChunk;
#pragma unroll
  for (int ks = 0; ks < kUnits / 2; ++ks) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4(a[mt], sa + swz(wm * 64 + mt * 16 + (mi & 1) * 8 + (l & 7),
                                  2 * ks + (mi >> 1)));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, sb + swz(wn * 32 + np * 16 + (mi >> 1) * 8 + (l & 7),
                              2 * ks + (mi & 1)));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_b1(acc[mt][nt], a[mt], b[nt]);
  }
}

// the staged loop: acc = popcount(AND) of pool rows [p0, p0 + 128) and seed
// rows [s0, s0 + 128), 2 * kBufWords words of dynamic shared memory at smem.
// Ends in a barrier, so the caller may reuse smem or read what it staged
// before the call.
__device__ __forceinline__ void tile(uint32_t* smem, const uint32_t* pool,
                                     const uint32_t* seed, int p0, int s0,
                                     int n_pool, int n_seed,
                                     int acc[4][4][4]) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  load_stage(smem, pool, seed, p0, s0, n_pool, n_seed, 0);
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    if (s + 1 < kStages) {
      load_stage(smem + ((s + 1) & 1) * kBufWords, pool, seed, p0, s0, n_pool,
                 n_seed, s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint32_t* buf = smem + (s & 1) * kBufWords;
    compute_b1(buf, wm, wn, acc);
    __syncthreads();   // the buffer is refilled by the next stage's loads
  }
}

// bytes of dynamic shared memory tile() takes: two stages
constexpr int kTileSmem = 2 * kBufWords * 4;

}  // namespace bv_tile
