// gate_block: the bitvector gate of one decision wave (cluster.cpp:13-19),
// with the score cache's fold, the K-class routing and the compaction of the
// fresh gated pairs, in two passes.
//
// Replaces rattle_tpu/cluster/bulk.py::gate_class_block, one jitted program
// there (a bf16 dot of bit planes on the MXU, the gate's tests, a row sort,
// the compaction and a stable argsort by class).  The port ran it as an
// eager chain: bv_common wrote the whole [A, C] int32 count matrix (64 MiB
// at 4096 x 4096), then [A, C] temporaries, nonzero, four boolean indexings
// and a sort, six host syncs.
//
// Bound: operations, A*C*4096 bit products on the tensor cores (bv_common's
// bound), against the packed words, the rows' and columns' vectors, the
// cache bytes of the passing pairs, w, the mask and the pair list.
//
// Pass 1 (gate_tile_kernel): bv_tile.cuh's loop unchanged (128 x 128 pairs
// a block, mma.sync .b1 .and.popc), then an epilogue on the accumulators in
// registers: common >= tab[max(bvc_r, bvc_c)] with the [4097] table staged
// in shared memory (16 KB), order_r < order_c, group_r == group_c.  A
// passing pair reads cache[id_r * cache_n + id_c] (64-bit index); a 2 folds
// strand_val into w (pairs are unique, so a plain store of the max is
// race-free), a 0 makes the pair fresh.  A fresh pair's class is
// #(bounds < max(nk[id_r], nk[id_c])).  The block writes, for each of its
// rows, one mask word of fresh pairs a warp (32 columns; each row's bits
// gathered from its four lanes by shuffles) and its fresh pairs' count by
// class: counts[class][row][tile], tile = the block's 128 columns (the four
// warps' counts added in shared memory, eight bits a class, packed).
//
// Between the passes (the wrapper): an exclusive scan of counts in (class,
// row, tile) order, and the one host read of the class counts, which sizes
// the pair list exactly.
//
// Pass 2 (gate_emit_kernel): a warp a (row, tile) walks the tile's four
// mask words in column order; a fresh pair's class is recomputed from nk,
// its rank within its (class, row, tile) segment is the running count of
// the segment plus __popc of the __ballot_sync of its class below its lane.
// So the list comes out stably sorted by class and row-major within a
// class, the order of nonzero + a stable sort, and of JAX's rc_flat,
// identical from run to run (an atomic cursor would not be).

#include <cuda_runtime.h>
#include <stdint.h>

#include "bv_tile.cuh"

namespace {

using bv_tile::kBM;
using bv_tile::kBN;
using bv_tile::kBufWords;
using bv_tile::kThreads;

constexpr int kMaxBounds = 3;               // at most 4 K classes
constexpr int kTab = 4097;                  // gates.min_numerator_table(4096)
constexpr int kTabPad = 4100;               // keeps what follows 16-byte aligned
constexpr int kSide = kBM + kBN;            // a block's rows, then columns
constexpr unsigned kFull = 0xffffffffu;
static_assert(kThreads == kSide, "pass 1 stages one row or column a thread");

// shared memory of pass 1 beyond the tile's stages: the table, each side's
// read id, bvc, order, group and nk, and the rows' packed class counts
constexpr int kEpilogueSmem = kTabPad * 4 + kSide * 8 + 4 * kSide * 4 + kBM * 4;

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

__global__ void __launch_bounds__(kThreads)
gate_tile_kernel(const uint32_t* __restrict__ rows_w,
                 const uint32_t* __restrict__ cols_w, int n_rows, int n_cols,
                 const int32_t* __restrict__ bvc_r,
                 const int32_t* __restrict__ bvc_c,
                 const int32_t* __restrict__ order_r,
                 const int32_t* __restrict__ order_c,
                 const int32_t* __restrict__ group_r,
                 const int32_t* __restrict__ group_c,
                 const int64_t* __restrict__ id_r,
                 const int64_t* __restrict__ id_c,
                 const int32_t* __restrict__ nk,
                 const int32_t* __restrict__ tab,
                 const uint8_t* __restrict__ cache, long long cache_n,
                 int8_t* __restrict__ w, int strand_val,
                 const int32_t* __restrict__ bounds, int n_bounds,
                 uint32_t* __restrict__ mask, int n_words,
                 int32_t* __restrict__ counts, int n_tiles) {
  extern __shared__ __align__(16) uint32_t smem[];
  int32_t* s_tab = reinterpret_cast<int32_t*>(smem + 2 * kBufWords);
  int64_t* s_id = reinterpret_cast<int64_t*>(s_tab + kTabPad);
  int32_t* s_bvc = reinterpret_cast<int32_t*>(s_id + kSide);
  int32_t* s_order = s_bvc + kSide;
  int32_t* s_group = s_order + kSide;
  int32_t* s_nk = s_group + kSide;
  uint32_t* s_cnt = reinterpret_cast<uint32_t*>(s_nk + kSide);
  const int p0 = blockIdx.y * kBM;
  const int s0 = blockIdx.x * kBN;

  // staged before the tile's first barrier, read after its last
  for (int i = threadIdx.x; i < kTab; i += kThreads) s_tab[i] = tab[i];
  {
    const int i = threadIdx.x;                  // kThreads == kSide
    const bool is_row = i < kBM;
    const int src = is_row ? p0 + i : s0 + i - kBM;
    int64_t id = 0;
    int bvc = 0, order = 0, group = 0, nkv = 0;
    if (src < (is_row ? n_rows : n_cols)) {
      id = is_row ? id_r[src] : id_c[src];
      bvc = is_row ? bvc_r[src] : bvc_c[src];
      order = is_row ? order_r[src] : order_c[src];
      group = is_row ? group_r[src] : group_c[src];
      nkv = nk[id];
    }
    s_id[i] = id;
    s_bvc[i] = bvc;
    s_order[i] = order;
    s_group[i] = group;
    s_nk[i] = nkv;
    if (is_row) s_cnt[i] = 0;
  }
  int bnd[kMaxBounds];
  load_bounds(bnd, bounds, n_bounds);

  int acc[4][4][4];
  bv_tile::tile(smem, rows_w, cols_w, p0, s0, n_rows, n_cols, acc);

  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;
  const int l = threadIdx.x & 31;
  const int g = l >> 2;
  const int tig = l & 3;
  // this thread's eight columns
  int c_bvc[8], c_order[8], c_group[8], c_nk[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int lc = kBM + wn * 32 + (q >> 1) * 8 + tig * 2 + (q & 1);
    c_bvc[q] = s_bvc[lc];
    c_order[q] = s_order[lc];
    c_group[q] = s_group[lc];
    c_nk[q] = s_nk[lc];
  }
  const int8_t sv = static_cast<int8_t>(strand_val);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int lr = wm * 64 + mt * 16 + half * 8 + g;
      const int r = p0 + lr;
      const int r_bvc = s_bvc[lr], r_order = s_order[lr];
      const int r_group = s_group[lr], r_nk = s_nk[lr];
      uint32_t bits = 0, packed = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int nt = q >> 1, j = q & 1;
        const int c = s0 + wn * 32 + nt * 8 + tig * 2 + j;
        const bool pass = r < n_rows && c < n_cols &&
                          acc[mt][nt][2 * half + j] >=
                              s_tab[max(r_bvc, c_bvc[q])] &&
                          r_order < c_order[q] && r_group == c_group[q];
        if (!pass) continue;
        if (cache != nullptr) {
          const uint8_t cv =
              cache[s_id[lr] * cache_n + s_id[kBM + c - s0]];
          if (cv == 2) {
            int8_t* p = w + static_cast<size_t>(r) * n_cols + c;
            if (*p < sv) *p = sv;
          }
          if (cv != 0) continue;
        }
        bits |= 1u << (nt * 8 + tig * 2 + j);
        packed += 1u << (8 * pair_class(bnd, max(r_nk, c_nk[q])));
      }
      // the row's 32 columns lie on the four lanes of its group
      bits |= __shfl_xor_sync(kFull, bits, 1);
      bits |= __shfl_xor_sync(kFull, bits, 2);
      packed += __shfl_xor_sync(kFull, packed, 1);
      packed += __shfl_xor_sync(kFull, packed, 2);
      if (tig == 0 && r < n_rows) {
        const int word = (s0 >> 5) + wn;
        if (word < n_words) mask[static_cast<size_t>(r) * n_words + word] = bits;
        if (packed) atomicAdd(&s_cnt[lr], packed);
      }
    }
  __syncthreads();
  if (threadIdx.x < kBM) {
    const int r = p0 + threadIdx.x;
    if (r < n_rows) {
      const uint32_t packed = s_cnt[threadIdx.x];
      for (int k = 0; k <= n_bounds; ++k)
        counts[(static_cast<size_t>(k) * n_rows + r) * n_tiles + blockIdx.x] =
            (packed >> (8 * k)) & 0xff;
    }
  }
}

__global__ void __launch_bounds__(256)
gate_emit_kernel(const uint32_t* __restrict__ mask, int n_rows, int n_words,
                 int n_tiles, const int32_t* __restrict__ offsets,
                 const int64_t* __restrict__ id_r,
                 const int64_t* __restrict__ id_c,
                 const int32_t* __restrict__ nk,
                 const int32_t* __restrict__ bounds, int n_bounds,
                 int64_t* __restrict__ rows_out,
                 int64_t* __restrict__ cols_out) {
  const int lane = threadIdx.x & 31;
  const long long seg = static_cast<long long>(blockIdx.x) * 8 +
                        (threadIdx.x >> 5);
  if (seg >= static_cast<long long>(n_rows) * n_tiles) return;  // whole warp
  const int r = static_cast<int>(seg / n_tiles);
  const int t = static_cast<int>(seg % n_tiles);
  uint32_t mine = 0;
  if (lane < 4 && t * 4 + lane < n_words)
    mine = mask[static_cast<size_t>(r) * n_words + t * 4 + lane];
  uint32_t words[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) words[j] = __shfl_sync(kFull, mine, j);
  if ((words[0] | words[1] | words[2] | words[3]) == 0) return;
  int off = 0;
  if (lane <= n_bounds)
    off = offsets[(static_cast<size_t>(lane) * n_rows + r) * n_tiles + t];
  int run[kMaxBounds + 1];
#pragma unroll
  for (int k = 0; k <= kMaxBounds; ++k) run[k] = __shfl_sync(kFull, off, k);
  int bnd[kMaxBounds];
  load_bounds(bnd, bounds, n_bounds);
  const int r_nk = nk[id_r[r]];
  const uint32_t below = (1u << lane) - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (words[j] == 0) continue;                 // the same on every lane
    const int c = t * kBN + j * 32 + lane;
    int cls = -1;
    if ((words[j] >> lane) & 1)
      cls = pair_class(bnd, max(r_nk, nk[id_c[c]]));
#pragma unroll
    for (int k = 0; k <= kMaxBounds; ++k) {
      const uint32_t b = __ballot_sync(kFull, cls == k);
      if (cls == k) {
        const int o = run[k] + __popc(b & below);
        rows_out[o] = r;
        cols_out[o] = c;
      }
      run[k] += __popc(b);
    }
  }
}

}  // namespace

// Pass 1.  rows_w [n_rows, 128] / cols_w [n_cols, 128] packed words (16-byte
// aligned rows); bvc, order, group int32 and ids int64 of each side; nk int32
// by read id; tab int32 [4097]; cache uint8 [cache_n^2] or null; w int8
// [n_rows, n_cols]; bounds int32 [n_bounds], n_bounds <= 3.  Writes mask
// uint32 [n_rows, n_words = ceil(n_cols / 32)] and counts int32
// [n_bounds + 1, n_rows, n_tiles = ceil(n_cols / 128)], every entry.  Returns
// cudaGetLastError().
extern "C" int gate_tile_launch(
    const void* rows_w, const void* cols_w, int n_rows, int n_cols,
    const void* bvc_r, const void* bvc_c, const void* order_r,
    const void* order_c, const void* group_r, const void* group_c,
    const void* id_r, const void* id_c, const void* nk, const void* tab,
    const void* cache, long long cache_n, void* w, int strand_val,
    const void* bounds, int n_bounds, void* mask, void* counts,
    void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (n_bounds < 0 || n_bounds > kMaxBounds) return cudaErrorInvalidValue;
  const int smem = bv_tile::kTileSmem + kEpilogueSmem;
  const cudaError_t e = cudaFuncSetAttribute(
      gate_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_tiles = (n_cols + kBN - 1) / kBN;
  const dim3 grid(n_tiles, (n_rows + kBM - 1) / kBM);
  gate_tile_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(rows_w), static_cast<const uint32_t*>(cols_w),
      n_rows, n_cols, static_cast<const int32_t*>(bvc_r),
      static_cast<const int32_t*>(bvc_c), static_cast<const int32_t*>(order_r),
      static_cast<const int32_t*>(order_c), static_cast<const int32_t*>(group_r),
      static_cast<const int32_t*>(group_c), static_cast<const int64_t*>(id_r),
      static_cast<const int64_t*>(id_c), static_cast<const int32_t*>(nk),
      static_cast<const int32_t*>(tab), static_cast<const uint8_t*>(cache),
      cache_n, static_cast<int8_t*>(w), strand_val,
      static_cast<const int32_t*>(bounds), n_bounds,
      static_cast<uint32_t*>(mask), (n_cols + 31) / 32,
      static_cast<int32_t*>(counts), n_tiles);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2.  mask and offsets (the exclusive scan of pass 1's counts, same
// layout) as pass 1 wrote them; writes rows_out / cols_out int64 [total].
extern "C" int gate_emit_launch(const void* mask, int n_rows, int n_cols,
                                const void* offsets, const void* id_r,
                                const void* id_c, const void* nk,
                                const void* bounds, int n_bounds,
                                void* rows_out, void* cols_out,
                                void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (n_bounds < 0 || n_bounds > kMaxBounds) return cudaErrorInvalidValue;
  const int n_tiles = (n_cols + kBN - 1) / kBN;
  const long long segs = static_cast<long long>(n_rows) * n_tiles;
  const unsigned blocks = static_cast<unsigned>((segs + 7) / 8);
  gate_emit_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(mask), n_rows, (n_cols + 31) / 32, n_tiles,
      static_cast<const int32_t*>(offsets), static_cast<const int64_t*>(id_r),
      static_cast<const int64_t*>(id_c), static_cast<const int32_t*>(nk),
      static_cast<const int32_t*>(bounds), n_bounds,
      static_cast<int64_t*>(rows_out), static_cast<int64_t*>(cols_out));
  return static_cast<int>(cudaGetLastError());
}
