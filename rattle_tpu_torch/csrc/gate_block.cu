// gate_block: the bitvector gate of one decision wave (cluster.cpp:13-19),
// with the score cache's fold, the K-class routing and the compaction of the
// fresh gated pairs, in two passes and no host work between them.
//
// Replaces rattle_tpu/cluster/bulk.py::gate_class_block, one jitted program
// there (a bf16 dot of bit planes on the MXU, the gate's tests, a row sort,
// the compaction and a stable argsort by class).
//
// Bound: operations, A*C*4096 bit products on the tensor cores (bv_common's
// bound), against the packed words, the rows' and columns' vectors, the
// cache bytes of the passing pairs, w, the mask and the pair list.
//
// Before pass 1, gate_sides_kernel writes each column's K class (two bit
// planes, for pass 2) and each row tile's least and column tile's largest
// order, and zeroes the counts.  A tile whose rows' orders all reach its
// columns' (the lower triangle of a block wave) has no pair that can pass:
// pass 1 skips it and pass 2 ignores its mask words.
//
// Pass 1 (gate_tile_kernel) is persistent: the launch plan
// (ops/kernels.py::gate_block_plan) gives as many CTAs as fit on the card at
// once, two an SM, and no more than the tiles.  The 128 x 128 output tiles
// not skipped are dealt out in index order, the k-th to CTA k % ctas (tile t
// is row tile t % tiles_r, column tile t / tiles_r: the CTAs at work share
// column tiles, so a wide sweep streams its columns from memory once).  Its
// words stream through a ring of kBufs stages of 32 words (bv_tile.cuh's
// cp.async loads and 128-byte swizzle), kBufs - 1 stages ahead over the
// whole walk, so the next tile's first stages load while the current tile's
// epilogue runs, and its rows' and columns' vectors are fetched into
// registers during the tile before.  Each stage is contracted by wgmma
// m64n128k256 .b1 .and.popc from shared memory, a warpgroup 64 rows (the
// register-only probe csrc/mma_rate.cu ran it at 3-4x mma.sync's 1-bit
// rate).  Where the tiles are fewer than the CTAs that fit (a sweep tile
// under ~512 rows), each CTA takes one tile: splitting a tile's words across
// a thread-block cluster, its accumulators summed through distributed shared
// memory, was slower there (PERF.md).
//
// The epilogue tests each count in registers: common >= tab[max(bvc_r,
// bvc_c)] (the [4097] table read through L1; tab[0] is INT32_MAX, and all
// zero at threshold 0), order_r < order_c, group_r == group_c.  The passing
// pairs' cache bytes, cache[id_r * cache_n + id_c] (64-bit index), are then
// loaded 16 at a time: a 2 folds strand_val into w (pairs are unique, so a
// plain store of the max is race-free), a 0 makes the pair fresh.  A fresh
// pair's class is #(bounds < max(nk[id_r], nk[id_c])), the larger of its
// two reads' own classes.  The tile writes each row's mask words of fresh
// pairs and adds its fresh pairs by (class, row) into counts with integer
// atomics (so the sums do not depend on the order).  The last CTA to finish
// (an atomic ticket) scans counts, class-major, into the exclusive offsets
// and writes the class totals: the one host read follows pass 1 directly
// and sizes the pair list exactly.
//
// Pass 2 (gate_emit_kernel): a CTA a row.  A row with no fresh pair exits
// after one load of its counts; in the others each warp takes a segment of
// the row's mask words, counts its fresh pairs by class (the column planes),
// the CTA scans those counts from the row's offsets, and each warp walks its
// words again, 32 loaded at a time (a lane each), a class at a time in
// column order: each word's class-k columns are broadcast in turn, and a
// pair's rank is the class's running offset plus __popc of those below its
// lane.  So the list comes out stably sorted by class and row-major within
// a class, the order of nonzero + a stable sort, and of JAX's rc_flat,
// identical from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bv_tile.cuh"

namespace {

using bv_tile::kBM;
using bv_tile::kBN;
using bv_tile::kBufWords;
using bv_tile::kStages;
using bv_tile::kThreads;

constexpr int kMaxBounds = 3;               // at most 4 K classes
constexpr int kSide = kBM + kBN;            // a tile's rows, then columns
constexpr int kBufs = 2;                    // stages in the ring
constexpr int kMaxSideTiles = 1024;         // row + column tiles staged
constexpr int kMaxWalk = 256;               // tiles a CTA lists
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kSide, "pass 1 stages one row or column a thread");
static_assert(kBufs >= 2, "a stage loads while the one before is computed");
static_assert(bv_tile::kChunk == 32,
              "a staged row is one 128-byte swizzle row");

// shared memory of pass 1 beyond the stages: each side's read id, bvc,
// order, group and class, the walk's scan (then the last CTA's) and flag,
// the CTA's tiles, and the tiles' least row and largest column orders
constexpr int kEpilogueSmem = kSide * 8 + 4 * kSide * 4 + (kThreads + 2) * 4 +
                              kMaxWalk * 4 + kMaxSideTiles * 4;
constexpr int kSmem = kBufs * kBufWords * 4 + kEpilogueSmem;

struct Gate {
  const uint32_t* rows_w;
  const uint32_t* cols_w;
  int n_rows, n_cols;
  const int32_t* bvc_r;
  const int32_t* bvc_c;
  const int32_t* order_r;
  const int32_t* order_c;
  const int32_t* group_r;
  const int32_t* group_c;
  const int64_t* id_r;
  const int64_t* id_c;
  const int32_t* nk;
  const int32_t* tab;
  const uint8_t* cache;
  long long cache_n;
  int8_t* w;
  int strand_val;
  const int32_t* bounds;
  int n_bounds;
  uint32_t* mask;                           // [n_rows, n_words]
  int n_words;
  int32_t* counts;                          // [n_bounds + 1, n_rows], zeroed
  unsigned* ticket;                         // zeroed
  int32_t* offsets;                         // [n_bounds + 1, n_rows]
  int32_t* class_counts;                    // [n_bounds + 1]
  uint32_t* cls_lo;                         // [n_words]: bit 0 of each
  uint32_t* cls_hi;                         // column's class, then bit 1
  int32_t* row_min;                         // [tiles_r]: least row order
  int32_t* col_max;                         // [tiles_c]: largest column order
  int tiles_r, tiles_c;
};

__device__ __forceinline__ int pair_class(const int (&bnd)[kMaxBounds],
                                          int pair_nk) {
  return (bnd[0] < pair_nk) + (bnd[1] < pair_nk) + (bnd[2] < pair_nk);
}

__device__ __forceinline__ void load_bounds(int (&bnd)[kMaxBounds],
                                            const int32_t* bounds,
                                            int n_bounds) {
#pragma unroll
  for (int b = 0; b < kMaxBounds; ++b)
    bnd[b] = b < n_bounds ? bounds[b] : INT32_MAX;   // INT32_MAX < x: never
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a shared-memory matrix descriptor of wgmma: K-major rows of 128 bytes in
// 128-byte swizzle (bv_tile.cuh's staged layout: 16-byte unit u of row r at
// unit u ^ (r & 7)), 8-row groups 1,024 bytes apart; ``p`` the first row's
// k-th 32-byte slice (256 bits, one wgmma's depth)
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (uint64_t{1} << 16) | (uint64_t{1024 >> 4} << 32) |
         (uint64_t{1} << 62);
}

// d += popcount(A AND B) over 256 bits: A 64 rows, B 128 rows, both from
// shared memory; d is the m64n128 s32 fragment of the warpgroup
__device__ __forceinline__ void wgmma_b1(uint32_t (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b));
}

struct Smem {
  int64_t* id;
  int32_t* bvc;
  int32_t* order;
  int32_t* group;
  int32_t* cls;                             // the read's own K class
  int32_t* scan;                            // kThreads + 2: the last's flag
  int32_t* walk;                            // [kMaxWalk]: the CTA's tiles
  int32_t* row_min;                         // [tiles_r] least row order
  int32_t* col_max;                         // [tiles_c] largest column order
};

// one side entry of a tile (thread i: row i, or column i - 128), loaded into
// registers ahead of the tile and staged into shared memory when it starts
struct Side {
  int64_t id;
  int bvc, order, group, cls;
  bool ok;
};

__device__ __forceinline__ void fetch_side(const Gate& g, int t, Side& v) {
  const int i = threadIdx.x;
  const bool is_row = i < kBM;
  const int src = is_row ? (t % g.tiles_r) * kBM + i
                         : (t / g.tiles_r) * kBN + i - kBM;
  v.ok = src < (is_row ? g.n_rows : g.n_cols);
  v.id = 0;
  v.bvc = v.order = v.group = v.cls = 0;
  if (v.ok) {
    v.id = is_row ? g.id_r[src] : g.id_c[src];
    v.bvc = is_row ? g.bvc_r[src] : g.bvc_c[src];
    v.order = is_row ? g.order_r[src] : g.order_c[src];
    v.group = is_row ? g.group_r[src] : g.group_c[src];
  }
}

// a read's own class is #(bounds < nk); a pair's, max of its two reads' (the
// count is monotone in nk)
__device__ __forceinline__ void fetch_cls(const Gate& g, Side& v) {
  if (!v.ok) return;
  int bnd[kMaxBounds];
  load_bounds(bnd, g.bounds, g.n_bounds);
  v.cls = pair_class(bnd, g.nk[v.id]);
}

__device__ __forceinline__ void put_side(const Smem& s, const Side& v) {
  const int i = threadIdx.x;
  s.id[i] = v.id;
  s.bvc[i] = v.bvc;
  s.order[i] = v.order;
  s.group[i] = v.group;
  s.cls[i] = v.cls;
}

// The tests on the accumulators of the tile at (p0, s0).  The m64n128
// fragment: thread (warpgroup wg, warp w, lane l = 4 gr + tig) holds rows
// wg * 64 + w * 16 + gr + 8 h (h = 0, 1) at columns 8 j + 2 tig + e (j < 16,
// e = 0, 1) in d[4 j + 2 h + e].  First the tests, into a bit a pair; then,
// with a cache, the passing pairs' cache bytes loaded 16 at a time, the
// wins folded into w and the pairs known dropped; then a row's 128 columns,
// which lie on the four lanes of its group, are gathered by shuffles into
// its four mask words (lane tig writes word tig) and its count by class,
// which the lane of class tig adds to counts.
__device__ __forceinline__ void epilogue(const Gate& g, const Smem& s, int p0,
                                         int s0, const uint32_t (&d)[64]) {
  const int l = threadIdx.x & 31;
  const int gr = l >> 2;
  const int tig = l & 3;
  const int lr0 = (threadIdx.x >> 7) * 64 + ((threadIdx.x >> 5) & 3) * 16 + gr;
  int r_bvc[2], r_order[2], r_group[2];
  bool r_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lr = lr0 + 8 * h;
    r_bvc[h] = s.bvc[lr];
    r_order[h] = s.order[lr];
    r_group[h] = s.group[lr];
    r_ok[h] = p0 + lr < g.n_rows;
  }
  uint32_t pm[2] = {0, 0};                  // bit 2 j + e: the pair passes
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int lc = j * 8 + tig * 2 + e;
      const int c_bvc = s.bvc[kBM + lc], c_order = s.order[kBM + lc];
      const int c_group = s.group[kBM + lc];
      const bool c_ok = s0 + lc < g.n_cols;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (r_ok[h] && c_ok &&
            static_cast<int>(d[4 * j + 2 * h + e]) >=
                __ldg(g.tab + max(r_bvc[h], c_bvc)) &&
            r_order[h] < c_order && r_group[h] == c_group)
          pm[h] |= 1u << (2 * j + e);
    }
  if (g.cache != nullptr) {
    const int8_t sv = static_cast<int8_t>(g.strand_val);
#pragma unroll
    for (int hb = 0; hb < 4; ++hb) {        // 16 pairs' bytes in flight
      const int h = hb >> 1, i0 = (hb & 1) * 16;
      const long long row = s.id[lr0 + 8 * h] * g.cache_n;
      uint32_t cv[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k;
        cv[k] = pm[h] >> i & 1u
            ? g.cache[row + s.id[kBM + (i >> 1) * 8 + tig * 2 + (i & 1)]]
            : 0u;
      }
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = i0 + k;
        if (cv[k] == 2) {
          int8_t* p = g.w +
              static_cast<size_t>(p0 + lr0 + 8 * h) * g.n_cols + s0 +
              (i >> 1) * 8 + tig * 2 + (i & 1);
          if (*p < sv) *p = sv;
        }
        if (cv[k] != 0) pm[h] &= ~(1u << i);
      }
    }
  }
  uint32_t bits[2][4] = {}, packed[2] = {};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r_cls = s.cls[lr0 + 8 * h];
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (pm[h] >> i & 1u) {
        const int j = i >> 1, e = i & 1;
        bits[h][j >> 2] |= 1u << ((j & 3) * 8 + tig * 2 + e);
        packed[h] += 1u << (8 * max(r_cls, s.cls[kBM + j * 8 + tig * 2 + e]));
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      bits[h][m] |= __shfl_xor_sync(kFull, bits[h][m], 1);
      bits[h][m] |= __shfl_xor_sync(kFull, bits[h][m], 2);
    }
    packed[h] += __shfl_xor_sync(kFull, packed[h], 1);
    packed[h] += __shfl_xor_sync(kFull, packed[h], 2);
    if (!r_ok[h]) continue;
    const int r = p0 + lr0 + 8 * h;
    const int word = (s0 >> 5) + tig;
    const uint32_t mine = tig == 0 ? bits[h][0] : tig == 1 ? bits[h][1]
                        : tig == 2 ? bits[h][2] : bits[h][3];
    if (word < g.n_words)
      g.mask[static_cast<size_t>(r) * g.n_words + word] = mine;
    const int v = (packed[h] >> (8 * tig)) & 0xff;
    if (v) atomicAdd(g.counts + tig * g.n_rows + r, v);
  }
}

// The last CTA: counts (class-major) -> exclusive offsets and the class
// totals.  The counts go through the free stages (``buf``, kScanChunk ints)
// a chunk at a time, every thread's loads in flight at once; each warp
// scans a contiguous run of the chunk with shuffles, 32 entries a step.
constexpr int kScanChunk = kBufs * kBufWords;

__device__ void scan_counts(const Gate& g, int32_t* buf, int32_t* s_scan) {
  const int n = (g.n_bounds + 1) * g.n_rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  constexpr int kWarps = kThreads / 32;
  int carry = 0;                            // the chunks before, summed
  for (int base = 0; base < n; base += kScanChunk) {
    const int m = min(kScanChunk, n - base);
    for (int i = threadIdx.x; i < m; i += kThreads)
      buf[i] = __ldcg(g.counts + base + i);
    __syncthreads();
    const int seg = (m + kWarps * 32 - 1) / (kWarps * 32) * 32;
    const int lo = min(m, warp * seg);
    const int hi = min(m, lo + seg);
    int sum = 0;
    for (int i = lo + lane; i < hi; i += 32) sum += buf[i];
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1) sum += __shfl_xor_sync(kFull, sum, d);
    if (lane == 0) s_scan[warp] = sum;
    __syncthreads();
    int run = carry, chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) run += s_scan[w];
      chunk += s_scan[w];
    }
    for (int i0 = lo; i0 < hi; i0 += 32) {
      const int i = i0 + lane;
      const int v = i < hi ? buf[i] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += u;
      }
      if (i < hi) buf[i] = run + incl - v;
      run += __shfl_sync(kFull, incl, 31);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads)
      g.offsets[base + i] = buf[i];
    carry += chunk;
    __syncthreads();
  }
  if (static_cast<int>(threadIdx.x) <= g.n_bounds) {
    const int k = threadIdx.x;
    const int start = g.offsets[k * g.n_rows];
    const int end = k == g.n_bounds ? carry : g.offsets[(k + 1) * g.n_rows];
    g.class_counts[k] = end - start;
  }
}

// Before pass 1, a CTA of 128 threads a column tile, then a row tile: the
// column tile's largest order and its columns' classes as two bit planes (a
// warp a 32-column word: bit 0 of each class, then bit 1), or the row
// tile's least order and its rows' counts zeroed (and the ticket).  Past
// the edge, orders are INT32_MIN / INT32_MAX.
__global__ void __launch_bounds__(kBN)
gate_sides_kernel(const Gate g) {
  __shared__ int s_red[kBN / 32];
  const int b = blockIdx.x;
  const bool col = b < g.tiles_c;
  const int i = (col ? b : b - g.tiles_c) * kBN + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int v;
  if (col) {
    int cls = 0;
    v = INT32_MIN;
    if (i < g.n_cols) {
      int bnd[kMaxBounds];
      load_bounds(bnd, g.bounds, g.n_bounds);
      cls = pair_class(bnd, g.nk[g.id_c[i]]);
      v = g.order_c[i];
    }
    const uint32_t lo = __ballot_sync(kFull, cls & 1);
    const uint32_t hi = __ballot_sync(kFull, cls & 2);
    if (lane == 0 && i / 32 < g.n_words) {
      g.cls_lo[i / 32] = lo;
      g.cls_hi[i / 32] = hi;
    }
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = max(v, __shfl_xor_sync(kFull, v, m));
  } else {
    v = i < g.n_rows ? g.order_r[i] : INT32_MAX;
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v = min(v, __shfl_xor_sync(kFull, v, m));
  }
  if (!col && i < g.n_rows)                 // the counts pass 1 adds to
    for (int k = 0; k <= g.n_bounds; ++k) g.counts[k * g.n_rows + i] = 0;
  if (b == 0 && threadIdx.x == 0) *g.ticket = 0;
  if (lane == 0) s_red[threadIdx.x / 32] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r = s_red[0];
    for (int k = 1; k < kBN / 32; ++k)
      r = col ? max(r, s_red[k]) : min(r, s_red[k]);
    (col ? g.col_max : g.row_min)[col ? b : b - g.tiles_c] = r;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
gate_tile_kernel(const Gate g) {
  // the stages first: their 128-byte swizzle needs 1,024-byte alignment
  extern __shared__ __align__(1024) uint32_t smem[];
  Smem s;
  s.id = reinterpret_cast<int64_t*>(smem + kBufs * kBufWords);
  s.bvc = reinterpret_cast<int32_t*>(s.id + kSide);
  s.order = s.bvc + kSide;
  s.group = s.order + kSide;
  s.cls = s.group + kSide;
  s.scan = s.cls + kSide;
  s.walk = s.scan + kThreads + 2;
  s.row_min = s.walk + kMaxWalk;
  s.col_max = s.row_min + g.tiles_r;

  constexpr int kAhead = kBufs - 1;         // stages loading ahead
  const int slot = blockIdx.x;
  const int slots = gridDim.x;
  const int n_tiles = g.tiles_r * g.tiles_c;
  const int wg = threadIdx.x >> 7;

  // The walk.  A tile no pair of which can pass the order test (its rows'
  // orders all reach its columns': a block wave's lower triangle) is
  // skipped, and pass 2 ignores its mask words.  The tiles left are dealt
  // out in index order, the k-th to the slot k % slots, so every CTA gets
  // its share of the work left (ops/kernels.py::gate_block_walk models it).
  // The launcher takes at most kMaxWalk * slots tiles and kMaxSideTiles row
  // and column tiles, so every CTA lists its tiles.
  for (int i = threadIdx.x; i < g.tiles_r; i += kThreads)
    s.row_min[i] = g.row_min[i];
  for (int i = threadIdx.x; i < g.tiles_c; i += kThreads)
    s.col_max[i] = g.col_max[i];
  __syncthreads();
  auto may_pass = [&](int t) {
    return s.row_min[t % g.tiles_r] < s.col_max[t / g.tiles_r];
  };
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int t_lo = min(n_tiles, static_cast<int>(threadIdx.x) * per);
  const int t_hi = min(n_tiles, t_lo + per);
  int n_act = 0;
  for (int t = t_lo; t < t_hi; ++t) n_act += may_pass(t);
  s.scan[threadIdx.x] = n_act;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int k = 0; k < kThreads; ++k) {
      const int v = s.scan[k];
      s.scan[k] = run;
      run += v;
    }
    s.scan[kThreads] = run;
  }
  __syncthreads();
  const int my_n = s.scan[kThreads] > slot
      ? (s.scan[kThreads] - 1 - slot) / slots + 1 : 0;
  {
    int pos = s.scan[threadIdx.x];
    for (int t = t_lo; t < t_hi; ++t)
      if (may_pass(t)) {
        if (pos % slots == slot) s.walk[pos / slots] = t;
        ++pos;
      }
  }
  __syncthreads();
  auto tile = [&](int j) { return j < my_n ? s.walk[j] : n_tiles; };
  // stage i of the walk from tile t (then t1): its tile and 32-word stage
  auto load = [&](int t, int t1, int i, int buf) {
    if (i >= kStages) {
      t = t1;
      i -= kStages;
    }
    if (t < n_tiles && i < kStages)
      bv_tile::load_stage(smem + buf * kBufWords, g.rows_w, g.cols_w,
                          (t % g.tiles_r) * kBM, (t / g.tiles_r) * kBN,
                          g.n_rows, g.n_cols, i);
    else
      asm volatile("cp.async.commit_group;\n" ::);   // an empty group
  };

  int t = tile(0);
  int t1 = tile(1);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) load(t, t1, i, i);
  Side side;
  if (t < n_tiles) {
    fetch_side(g, t, side);
    fetch_cls(g, side);
    put_side(s, side);
  }

  uint32_t d[64];
  int q = 0;                                // stages computed, all tiles
#pragma unroll 1
  for (int j = 0; t < n_tiles; ++j) {
    const int p0 = (t % g.tiles_r) * kBM;
    const int s0 = (t / g.tiles_r) * kBN;
#pragma unroll 1
    for (int st = 0; st < kStages; ++st, ++q) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
      // cp.async wrote through the generic proxy, wgmma reads through the
      // async one; the barrier also frees the buffer computed last
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      load(t, t1, st + kAhead, (q + kAhead) % kBufs);
      if (st == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] = 0;
        if (t1 < n_tiles) fetch_side(g, t1, side);   // lands meanwhile
      }
      if (st == kStages / 2 && t1 < n_tiles) fetch_cls(g, side);
      const uint32_t* buf = smem + (q % kBufs) * kBufWords;
      const uint32_t* a = buf + wg * 64 * bv_tile::kChunk;
      const uint32_t* b = buf + kBM * bv_tile::kChunk;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < bv_tile::kChunk / 8; ++ks)
        wgmma_b1(d, sw128_desc(a + ks * 8), sw128_desc(b + ks * 8));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    }

    epilogue(g, s, p0, s0, d);
    t = t1;
    t1 = tile(j + 2);
    if (t < n_tiles) {
      __syncthreads();                      // every thread is past the sides
      put_side(s, side);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // the ticket: the last CTA to arrive sees every count and scans them
  // (the barrier orders the CTA's counts before thread 0's fence, which
  // releases them before its ticket, and acquires the others' after it)
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    s.scan[kThreads + 1] = atomicAdd(g.ticket, 1u) == gridDim.x - 1;
    if (s.scan[kThreads + 1]) __threadfence();
  }
  __syncthreads();
  if (!s.scan[kThreads + 1]) return;
  scan_counts(g, reinterpret_cast<int32_t*>(smem), s.scan);
}

// the columns of class k among a word's fresh ones, for a row of class
// r_cls: a pair's class is max(r_cls, the column's)
__device__ __forceinline__ uint32_t class_bits(uint32_t fresh, uint32_t lo,
                                               uint32_t hi, int r_cls, int k) {
  const uint32_t is_k = (k & 1 ? lo : ~lo) & (k & 2 ? hi : ~hi);
  if (k < r_cls) return 0;
  if (k > r_cls) return fresh & is_k;
  // k == r_cls: every column of class <= k
  const uint32_t above = k == 0 ? (lo | hi) : k == 1 ? hi
                       : k == 2 ? (lo & hi) : 0u;
  return fresh & ~above;
}

// A CTA a row; warp w takes the w-th of kEmitWarps segments of the row's
// mask words (each a multiple of 32 words).  It counts its fresh pairs by
// class, the CTA scans the warps' counts from the row's offsets, then each
// warp walks its words again, a class at a time in column order.
constexpr int kEmitWarps = 8;

__global__ void __launch_bounds__(kEmitWarps * 32)
gate_emit_kernel(const uint32_t* __restrict__ mask, int n_rows, int n_words,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ offsets,
                 const uint32_t* __restrict__ cls_lo,
                 const uint32_t* __restrict__ cls_hi,
                 const int32_t* __restrict__ row_min,
                 const int32_t* __restrict__ col_max,
                 const int64_t* __restrict__ id_r,
                 const int32_t* __restrict__ nk,
                 const int32_t* __restrict__ bounds, int n_bounds,
                 int64_t* __restrict__ rows_out,
                 int64_t* __restrict__ cols_out) {
  __shared__ int s_cnt[kEmitWarps][kMaxBounds + 1];
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int total = 0;
  if (lane <= n_bounds) total = counts[static_cast<size_t>(lane) * n_rows + r];
  total += __shfl_xor_sync(kFull, total, 1);
  total += __shfl_xor_sync(kFull, total, 2);
  if (__shfl_sync(kFull, total, 0) == 0) return;   // the whole CTA
  int bnd[kMaxBounds];
  load_bounds(bnd, bounds, n_bounds);
  const int r_cls = pair_class(bnd, nk[id_r[r]]);
  const uint32_t* row = mask + static_cast<size_t>(r) * n_words;
  // the words of a tile pass 1 skipped hold nothing
  const int r_min = row_min[r / kBM];
  auto word = [&](int wi) {
    return r_min >= col_max[wi / (kBN / 32)] ? 0u : row[wi];
  };
  // whole 32-word loads a warp: a short row leaves the last warps idle
  const int seg = (n_words + kEmitWarps * 32 - 1) / (kEmitWarps * 32) * 32;
  const int lo_w = min(n_words, warp * seg);
  const int hi_w = min(n_words, lo_w + seg);

  int cnt[kMaxBounds + 1] = {0, 0, 0, 0};
  for (int base = lo_w; base < hi_w; base += 32) {
    const int wi = base + lane;
    if (wi < hi_w) {
      const uint32_t f = word(wi);
      if (f) {
        const uint32_t lo = cls_lo[wi], hi = cls_hi[wi];
#pragma unroll
        for (int k = 0; k <= kMaxBounds; ++k)
          if (k >= r_cls && k <= n_bounds)
            cnt[k] += __popc(class_bits(f, lo, hi, r_cls, k));
      }
    }
  }
#pragma unroll
  for (int k = 0; k <= kMaxBounds; ++k) {
#pragma unroll
    for (int d = 16; d >= 1; d >>= 1)
      cnt[k] += __shfl_xor_sync(kFull, cnt[k], d);
  }
  if (lane == 0)
#pragma unroll
    for (int k = 0; k <= kMaxBounds; ++k) s_cnt[warp][k] = cnt[k];
  __syncthreads();
  int run[kMaxBounds + 1];
#pragma unroll
  for (int k = 0; k <= kMaxBounds; ++k) {
    run[k] = k <= n_bounds ? offsets[static_cast<size_t>(k) * n_rows + r] : 0;
    for (int v = 0; v < warp; ++v) run[k] += s_cnt[v][k];
  }
  const uint32_t below = (1u << lane) - 1;
  for (int base = lo_w; base < hi_w; base += 32) {
    const int wi = base + lane;
    uint32_t f = 0, lo = 0, hi = 0;
    if (wi < hi_w) {
      f = word(wi);
      if (f) {
        lo = cls_lo[wi];
        hi = cls_hi[wi];
      }
    }
    // a class at a time, its words in column order
#pragma unroll
    for (int k = 0; k <= kMaxBounds; ++k) {
      if (k < r_cls || k > n_bounds) continue;       // the same on each lane
      const uint32_t cm = class_bits(f, lo, hi, r_cls, k);
      uint32_t nz = __ballot_sync(kFull, cm != 0);
      while (nz) {
        const int j = __ffs(nz) - 1;
        nz &= nz - 1;
        const uint32_t b = __shfl_sync(kFull, cm, j);
        if (b >> lane & 1u) {
          const int o = run[k] + __popc(b & below);
          rows_out[o] = r;
          cols_out[o] = static_cast<long long>(base + j) * 32 + lane;
        }
        run[k] += __popc(b);
      }
    }
  }
}

// Raises pass 1's dynamic shared memory limit, once per process and device.
cudaError_t prepare() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(gate_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

}  // namespace

// Pass 1.  rows_w [n_rows, 128] / cols_w [n_cols, 128] packed words (16-byte
// aligned rows); bvc, order, group int32 and ids int64 of each side; nk int32
// by read id; tab int32 [4097]; cache uint8 [cache_n^2] or null; w int8
// [n_rows, n_cols]; bounds int32 [n_bounds], n_bounds <= 3.  scratch int32
// [2 * (n_bounds + 1) * n_rows + 1 + 2 * ceil(n_cols / 32) + ceil(n_rows /
// 128) + ceil(n_cols / 128)]: counts [n_bounds + 1, n_rows], the ticket,
// the offsets, the columns' class planes, the tiles' least row and largest
// column orders, all written here (gate_sides_kernel first: it zeroes the
// counts and the ticket).  Writes mask uint32 [n_rows, ceil(n_cols /
// 32)], every word, and class_counts int32 [n_bounds + 1].  The plan: ``ctas``
// CTAs, at most kMaxSideTiles row and column tiles and kMaxWalk tiles a
// CTA.  Returns cudaGetLastError().
extern "C" int gate_tile_launch(
    const void* rows_w, const void* cols_w, int n_rows, int n_cols,
    const void* bvc_r, const void* bvc_c, const void* order_r,
    const void* order_c, const void* group_r, const void* group_c,
    const void* id_r, const void* id_c, const void* nk, const void* tab,
    const void* cache, long long cache_n, void* w, int strand_val,
    const void* bounds, int n_bounds, void* mask, void* scratch,
    void* class_counts, int ctas, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (n_bounds < 0 || n_bounds > kMaxBounds) return cudaErrorInvalidValue;
  Gate g;
  g.rows_w = static_cast<const uint32_t*>(rows_w);
  g.cols_w = static_cast<const uint32_t*>(cols_w);
  g.n_rows = n_rows;
  g.n_cols = n_cols;
  g.bvc_r = static_cast<const int32_t*>(bvc_r);
  g.bvc_c = static_cast<const int32_t*>(bvc_c);
  g.order_r = static_cast<const int32_t*>(order_r);
  g.order_c = static_cast<const int32_t*>(order_c);
  g.group_r = static_cast<const int32_t*>(group_r);
  g.group_c = static_cast<const int32_t*>(group_c);
  g.id_r = static_cast<const int64_t*>(id_r);
  g.id_c = static_cast<const int64_t*>(id_c);
  g.nk = static_cast<const int32_t*>(nk);
  g.tab = static_cast<const int32_t*>(tab);
  g.cache = static_cast<const uint8_t*>(cache);
  g.cache_n = cache_n;
  g.w = static_cast<int8_t*>(w);
  g.strand_val = strand_val;
  g.bounds = static_cast<const int32_t*>(bounds);
  g.n_bounds = n_bounds;
  g.mask = static_cast<uint32_t*>(mask);
  g.n_words = (n_cols + 31) / 32;
  const size_t n_counts = static_cast<size_t>(n_bounds + 1) * n_rows;
  g.counts = static_cast<int32_t*>(scratch);
  g.ticket = reinterpret_cast<unsigned*>(g.counts + n_counts);
  g.offsets = g.counts + n_counts + 1;
  g.cls_lo = reinterpret_cast<uint32_t*>(g.offsets + n_counts);
  g.cls_hi = g.cls_lo + g.n_words;
  g.row_min = reinterpret_cast<int32_t*>(g.cls_hi + g.n_words);
  g.class_counts = static_cast<int32_t*>(class_counts);
  g.tiles_r = (n_rows + kBM - 1) / kBM;
  g.tiles_c = (n_cols + kBN - 1) / kBN;
  g.col_max = g.row_min + g.tiles_r;
  const long long n_tiles = static_cast<long long>(g.tiles_r) * g.tiles_c;
  if (ctas <= 0 || g.tiles_r + g.tiles_c > kMaxSideTiles ||
      n_tiles > static_cast<long long>(kMaxWalk) * ctas)
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  gate_sides_kernel<<<g.tiles_r + g.tiles_c, kBN, 0, st>>>(g);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  gate_tile_kernel<<<ctas, kThreads, kSmem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  mask and scratch as pass 1 left them; writes rows_out / cols_out
// int64 [total], total the sum of pass 1's class counts.
extern "C" int gate_emit_launch(const void* mask, int n_rows, int n_cols,
                                const void* scratch, const void* id_r,
                                const void* nk, const void* bounds,
                                int n_bounds, void* rows_out, void* cols_out,
                                void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (n_bounds < 0 || n_bounds > kMaxBounds) return cudaErrorInvalidValue;
  const int n_words = (n_cols + 31) / 32;
  const size_t n_counts = static_cast<size_t>(n_bounds + 1) * n_rows;
  const int32_t* counts = static_cast<const int32_t*>(scratch);
  const int32_t* offsets = counts + n_counts + 1;
  const uint32_t* lo = reinterpret_cast<const uint32_t*>(offsets + n_counts);
  const int32_t* row_min = reinterpret_cast<const int32_t*>(lo + 2 * n_words);
  const int tiles_r = (n_rows + kBM - 1) / kBM;
  gate_emit_kernel<<<n_rows, kEmitWarps * 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), n_rows, n_words, counts, offsets,
      lo, lo + n_words, row_min, row_min + tiles_r,
      static_cast<const int64_t*>(id_r),
      static_cast<const int32_t*>(nk), static_cast<const int32_t*>(bounds),
      n_bounds, static_cast<int64_t*>(rows_out),
      static_cast<int64_t*>(cols_out));
  return static_cast<int>(cudaGetLastError());
}
