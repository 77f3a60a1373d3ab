// poa_rerank: the incremental re-rank of every lane's graph after
// poa_thread, then the next step's rank-space inputs of poa_align.
//
// Replaces the end of rattle_tpu/correct/pack_engine.py::_step (a part of
// one jitted program there: the stable argsort of the keys and the rank
// assignment) and the rank-space gathers at the start of the next step; the
// eager port ran them as a torch.sort among some 260 small launches a step.
// The executable spec is ops/kernels.py::poa_rerank_plain.
//
// Per lane, with nn = n_nodes and G = n_groups after the thread:
//   order     the ids below nn in the stable order of their keys (ids from nn
//             on key as BIG and sort after them, and only the first G
//             positions are read);
//   grp_pos   grp_pos[order[i]] = i for i < G;
//   starts    the exclusive sum of the group sizes in that order;
//   node_rank starts[grp_pos[leader]] + member_idx below nn, N from nn on;
//   perm      perm[node_rank[v]] = v;
//   rank space for r < nn, v = perm[r]: letters_r = letters[v], npred_r =
//             max(npred[v], 1), pred_rows[k] = node_rank[preds[v][k]] + 1 (0
//             for an empty slot), the only rows poa_align reads.
//
// Bound and design.  A chain of block-wide steps on at most 16,384 nodes a
// lane; the bytes are small (the node arrays once), so latency and barriers
// bound it.  One CTA of 1,024 threads a lane.  The order needs no sort when
// the keys have the structure poa_thread gives them: an old leader keys
// x * SK + HALF at its old group position x, and those x are 0 .. |A| - 1
// (class A); a new group's leader keys g * SK + r, r < HALF, and these keys
// do not decrease in id order, which is path order (class C); every other
// node keys BIG.  Then C sorts before the A at x exactly when g <= x, so the
// order is a merge of two sorted runs, found by counting: the k-th C in id
// order goes to k + min(g, |A|), the A at x to x + #{C : min(g, |A|) <= x}
// (a histogram of C over the A positions and one scan).  The kernel checks
// that structure on every lane: no negative key, |A| + |C| = G, the x of A
// distinct (a bitmap in shared memory) and below |A|, the C keys not
// decreasing (a prefix maximum over ids).  A lane that fails it is ordered
// as before this design, by a bitonic sort in shared memory of 64-bit (key,
// id) words over the next power of two above max(nn, G) (the ids make every
// word distinct, so that is the stable order on any keys), and counted in
// ``sort_lanes``.  Both branches end in grp_pos, the starts and each id's
// position in shared memory, so the node ranks read no position back from
// device memory; the ranks and perm stay in shared memory for the rank-space
// rows, which four threads a rank write (a quarter of the predecessor row
// each, so a warp's loads and stores are whole 64-byte rows).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16384;
constexpr int kMaxPer = kMaxN / kThreads;  // positions a thread, rows a warp
constexpr int kIdBits = 14;                // node ids below kMaxN
constexpr int kPmax = 16;
constexpr int kSkBits = 12;                // key stride SK = 4096
constexpr int kHalf = (1 << kSkBits) - 1;
constexpr int kBig = 1 << 30;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsInFlight = 8;           // rank-space rows a thread

using u64 = unsigned long long;

// Exclusive sum of one value a thread over the block in thread order;
// ``total`` takes the sum over every thread.  ``red`` holds kWarps ints.
__device__ int block_excl_sum(int v, int* red, int& total) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (wl >= d) x += y;
  }
  __syncthreads();
  if (wl == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = red[wl];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, s, d);
      if (wl >= d) s += y;
    }
    red[wl] = s;
  }
  __syncthreads();
  total = red[kWarps - 1];
  return (warp > 0 ? red[warp - 1] : 0) + x - v;
}

// In-place scan of s[0, len) in shared memory: exclusive, or inclusive
// with kIncl; returns the sum of all.  Warp w takes the consecutive rows
// [w * rows, w * rows + rows) of 32 words (no bank conflict), rows =
// ceil(len / kThreads), in two passes over them (its total, then the scan),
// so that no row is held in registers and the loops stay short.  ``red``
// holds kWarps ints and is free on entry; two barriers, the last after
// every write.
template <bool kIncl>
__device__ int smem_scan(int* s, int len, int* red) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows = (len + kThreads - 1) / kThreads;
  const int i0 = warp * rows * 32 + wl;
  int sum = 0;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r * 32;
    sum += __reduce_add_sync(kFull, i < len ? s[i] : 0);
  }
  if (wl == 0) red[warp] = sum;
  __syncthreads();
  const int t = red[wl];
  int y = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(kFull, y, d);
    if (wl >= d) y += z;
  }
  int run = __shfl_sync(kFull, y - t, warp);
  const int total = __shfl_sync(kFull, y, 31);
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int i = i0 + r * 32;
    const int x = i < len ? s[i] : 0;
    int v = x;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int z = __shfl_up_sync(kFull, v, d);
      if (wl >= d) v += z;
    }
    if (i < len) s[i] = run + (kIncl ? v : v - x);
    run += __shfl_sync(kFull, v, 31);
  }
  __syncthreads();
  return total;
}

// The stages j = min(k / 2, 32) .. 1 of the bitonic merges of sizes k_lo ..
// k_hi inside 64-word segments of s[0, m): a warp a segment, two words a lane
// in registers, partners by shuffles.  No block barrier.
__device__ void warp_merges(u64* s, int m, int k_lo, int k_hi) {
  const int wl = threadIdx.x & 31;
  for (int base = (threadIdx.x >> 5) * 64; base < m; base += kWarps * 64) {
    const int i0 = base + wl;
    const int i1 = i0 + 32;
    u64 e0 = s[i0];
    u64 e1 = s[i1];
    for (int k = k_lo; k <= k_hi; k <<= 1) {
      for (int j = min(k >> 1, 32); j > 0; j >>= 1) {
        if (j == 32) {
          if ((e0 > e1) == ((i0 & k) == 0)) {
            const u64 t = e0;
            e0 = e1;
            e1 = t;
          }
        } else {
          const u64 y0 = __shfl_xor_sync(kFull, e0, j);
          const u64 y1 = __shfl_xor_sync(kFull, e1, j);
          const bool lower = (wl & j) == 0;
          e0 = lower == ((i0 & k) == 0) ? min(e0, y0) : max(e0, y0);
          e1 = lower == ((i1 & k) == 0) ? min(e1, y1) : max(e1, y1);
        }
      }
    }
    s[i0] = e0;
    s[i1] = e1;
  }
}

// Ascending bitonic sort of s[0, m), m a power of two: the stages of a merge
// whose pairs lie 64 words or more apart in shared memory, a block barrier
// each; the rest inside a warp's 64-word segments (warp_merges).
__device__ void bitonic_sort(u64* s, int m) {
  if (m >= 64) {
    warp_merges(s, m, 2, 64);
    __syncthreads();
  }
  for (int k = m >= 64 ? 128 : 2; k <= m; k <<= 1) {
    for (int j = k >> 1; j >= (m >= 64 ? 64 : 1); j >>= 1) {
      for (int p = threadIdx.x; p < (m >> 1); p += kThreads) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const u64 a = s[i];
        const u64 b = s[i | j];
        if ((a > b) == ((i & k) == 0)) {
          s[i] = b;
          s[i | j] = a;
        }
      }
      __syncthreads();
    }
    if (m >= 64) {
      warp_merges(s, m, k, k);
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int clampn(int x, int n) {
  return min(max(x, 0), n - 1);
}

// The order of a lane's leaders by counting (see the header), when its keys
// passed the check: ``key_s`` and ``sz_s`` hold the keys and group sizes of
// the ids below nn, ``hist`` [|A|] is zero; warp w takes the rows [w * rows,
// w * rows + rows) of 32 ids.  Writes grp_pos, the sizes in position order
// to ``starts`` [G] (the caller scans them), and over each id's key its
// position, -1 if it has none (key_s becomes the positions by id).
__device__ void count_order(int* key_s, const uint16_t* sz_s, int* hist,
                            int* starts, int32_t* gp_l, int nn, int n_a,
                            int c_before, int* red) {
  const int wl = threadIdx.x & 31;
  const unsigned below = (1u << wl) - 1;
  const int rows = (nn + kThreads - 1) / kThreads;
  const int id0 = (threadIdx.x >> 5) * rows * 32 + wl;
  // the histogram of C over min(g, |A|) below |A|: the C keys do not
  // decrease, so a row's equal bins are runs, one atomic a run
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int id = id0 + r * 32;
    const int k = id < nn ? key_s[id] : kBig;
    const bool is_c = k < kBig && (k & kHalf) != kHalf;
    const int bin = is_c && (k >> kSkBits) < n_a ? k >> kSkBits : -1;
    const unsigned in = __ballot_sync(kFull, bin >= 0);
    const unsigned lower = in & below;
    const int prev = __shfl_sync(kFull, bin, lower ? 31 - __clz(lower) : 0);
    const bool head = bin >= 0 && (lower == 0 || prev != bin);
    const unsigned heads = __ballot_sync(kFull, head);
    if (head) {
      const unsigned later = heads & ~(below | (1u << wl));
      const unsigned run =
          in & ~below & (later ? (1u << (__ffs(later) - 1)) - 1 : kFull);
      atomicAdd(hist + bin, __popc(run));
    }
  }
  __syncthreads();
  smem_scan<true>(hist, n_a, red);  // hist[x] = #{C : min(g, |A|) <= x}
  int cnt = c_before;               // C before this warp's ids
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int id = id0 + r * 32;
    const int k = id < nn ? key_s[id] : kBig;
    const bool lead = k < kBig;
    const bool is_c = lead && (k & kHalf) != kHalf;
    const int x = k >> kSkBits;
    const unsigned bc = __ballot_sync(kFull, is_c);
    const int pos = is_c   ? cnt + __popc(bc & below) + min(x, n_a)
                    : lead ? x + hist[x]
                           : -1;
    cnt += __popc(bc);
    if (id < nn) {
      if (pos >= 0) {
        gp_l[id] = pos;
        starts[pos] = sz_s[id];
      }
      key_s[id] = pos;
    }
  }
}

// The order of a lane's leaders by a stable sort of its keys (any keys;
// ``key_s`` holds those below nn): grp_pos, each id's position below nn
// over its key in ``key_s`` (-1 if it has none), and the exclusive starts
// [G] of the group sizes in that order; returns their total.  ``srt``
// [pow2 >= max(nn, G)] may overlap starts.
__device__ int sort_order(u64* srt, int* starts, int* key_s,
                          const int32_t* gs_l, int32_t* gp_l, int nn, int g,
                          int n, int* red) {
  const int tid = threadIdx.x;
  int m = 1;
  while (m < max(nn, g)) m <<= 1;
  // (key, id) words, the key's sign bit flipped so that the words compare
  // as the signed keys do
  for (int i = tid; i < m; i += kThreads) {
    const int key = i < nn ? key_s[i] : kBig;
    srt[i] = i < n ? (static_cast<u64>(static_cast<unsigned>(key) ^
                                       0x80000000u)
                      << kIdBits) |
                         static_cast<u64>(i)
                   : ~0ull;
  }
  __syncthreads();
  for (int i = tid; i < nn; i += kThreads) key_s[i] = -1;
  bitonic_sort(srt, m);

  // grp_pos and the group sizes in order: thread tid takes the consecutive
  // positions [tid * per, tid * per + per)
  const int per = m > kThreads ? m / kThreads : 1;
  const int i0 = tid * per;
  int sz[kMaxPer];
  int local = 0;
#pragma unroll
  for (int q = 0; q < kMaxPer; ++q) {
    sz[q] = 0;
    const int i = i0 + q;
    if (q < per && i < g) {
      const int id = static_cast<int>(srt[i] & ((1ull << kIdBits) - 1));
      gp_l[id] = i;
      if (id < nn) key_s[id] = i;
      sz[q] = gs_l[id];
      local += sz[q];
    }
  }
  int total;
  int run = block_excl_sum(local, red, total);  // its barriers end the reads
#pragma unroll
  for (int q = 0; q < kMaxPer; ++q) {
    const int i = i0 + q;
    if (q < per && i < g) {
      starts[i] = run;
      run += sz[q];
    }
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
poa_rerank_kernel(const int32_t* __restrict__ keys,        // [B, N + 1]
                  const int32_t* __restrict__ grp_size,    // [B, N + 1]
                  const int32_t* __restrict__ grp_leader,  // [B, N + 1]
                  const int32_t* __restrict__ member_idx,  // [B, N + 1]
                  const int32_t* __restrict__ preds,       // [B, N + 1, 16]
                  const int32_t* __restrict__ npred,       // [B, N + 1]
                  const int32_t* __restrict__ letters,     // [B, N + 1]
                  const int32_t* __restrict__ n_nodes,     // [B]
                  const int32_t* __restrict__ n_groups,    // [B]
                  int32_t* grp_pos, int32_t* perm,         // [B, N + 1]
                  int32_t* __restrict__ node_rank,         // [B, N]
                  int32_t* __restrict__ pred_rows,         // [B, N, 16]
                  int32_t* __restrict__ npred_r,           // [B, N]
                  int32_t* __restrict__ letters_r,         // [B, N]
                  int* __restrict__ sort_lanes,            // [1]
                  int n, int m_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  // [2 m_cap] words: the sort's u64 words; or [n] the bit a group position
  // of the check, then the starts, then perm, and [n] the histogram, then
  // the ranks.  Then [n] words by id: the keys, then the positions.  Then
  // [n] 16-bit group sizes by id.
  u64* srt = reinterpret_cast<u64*>(smem);
  int* starts = reinterpret_cast<int*>(smem);
  unsigned* seen = reinterpret_cast<unsigned*>(starts);
  int* perm_s = starts;
  int* hist = starts + n;
  int* rank_s = hist;
  int* key_s = starts + 2 * m_cap;
  uint16_t* sz_s = reinterpret_cast<uint16_t*>(key_s + n);
  __shared__ int red[kWarps];
  __shared__ int w_c[kWarps], w_a[kWarps], w_lastc[kWarps], w_firstc[kWarps],
      w_maxx[kWarps], w_bad[kWarps];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int wl = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << wl) - 1;
  const size_t n1 = static_cast<size_t>(n) + 1;
  const int32_t* key_l = keys + lane * n1;
  const int32_t* gs_l = grp_size + lane * n1;
  const int32_t* gl_l = grp_leader + lane * n1;
  const int32_t* mi_l = member_idx + lane * n1;
  const int32_t* pr_l = preds + lane * n1 * kPmax;
  const int32_t* np_l = npred + lane * n1;
  const int32_t* let_l = letters + lane * n1;
  int32_t* gp_l = grp_pos + lane * n1;
  int32_t* perm_l = perm + lane * n1;
  int32_t* nr_l = node_rank + static_cast<size_t>(lane) * n;

  const int nn = min(max(n_nodes[lane], 0), n);
  const int g = min(max(n_groups[lane], 0), n);

  // ---- the keys and group sizes below nn into shared memory (a leader's
  // size must fit 16 bits for the count), the bitmap and histogram zeroed
  // ----
  bool bad = false;
#pragma unroll 4
  for (int i = tid; i < nn; i += kThreads) {
    const int k = key_l[i];
    const int sz = gs_l[i];
    key_s[i] = k;
    sz_s[i] = static_cast<uint16_t>(sz);
    bad |= k >= 0 && k < kBig && (sz < 0 || sz > 0xffff);
  }
  for (int i = tid; i < (n + 31) / 32; i += kThreads) seen[i] = 0;
  for (int i = tid; i < g; i += kThreads) hist[i] = 0;
  __syncthreads();

  // ---- the check: each id below nn classed by its key, warp w taking
  // the rows [w * rows, w * rows + rows) of 32 ids ----
  const int rows = (nn + kThreads - 1) / kThreads;
  const int id0 = warp * rows * 32 + wl;
  int n_c = 0, n_a = 0, last_c = -1, first_c = kNone, max_x = -1;
#pragma unroll 1
  for (int r = 0; r < rows; ++r) {
    const int id = id0 + r * 32;
    const int k = id < nn ? key_s[id] : kBig;
    const bool lead = k >= 0 && k < kBig;
    const bool is_a = lead && (k & kHalf) == kHalf;
    const bool is_c = lead && !is_a;
    bad |= k < 0;
    if (is_a) {
      const int x = k >> kSkBits;
      max_x = max(max_x, x);
      if (x < n) {  // a larger x fails through max_x
        const unsigned bit = 1u << (x & 31);
        bad |= (atomicOr(seen + (x >> 5), bit) & bit) != 0;
      }
    }
    // C keys must not fall below the previous C key in id order
    const unsigned bc = __ballot_sync(kFull, is_c);
    const unsigned lower = bc & below;
    const int prev = __shfl_sync(kFull, k, lower ? 31 - __clz(lower) : 0);
    bad |= is_c && lower != 0 && k < prev;
    if (bc != 0) {
      const int first = __shfl_sync(kFull, k, __ffs(bc) - 1);
      bad |= first < last_c;  // the row's first C below the last before
      if (first_c == kNone) first_c = first;
      last_c = __shfl_sync(kFull, k, 31 - __clz(bc));
    }
    n_c += __popc(bc);
    n_a += __popc(__ballot_sync(kFull, is_a));
  }
  const bool warp_bad = __any_sync(kFull, bad);
  max_x = __reduce_max_sync(kFull, max_x);
  if (wl == 0) {
    w_c[warp] = n_c;
    w_a[warp] = n_a;
    w_lastc[warp] = last_c;
    w_firstc[warp] = first_c;
    w_maxx[warp] = max_x;
    w_bad[warp] = warp_bad;
  }
  __syncthreads();
  // every warp: the block's totals from the warps' (lane l reads warp l);
  // a warp's first C key must not fall below an earlier warp's last
  int c_inc = w_c[wl], lc_inc = w_lastc[wl];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int zc = __shfl_up_sync(kFull, c_inc, d);
    const int zl = __shfl_up_sync(kFull, lc_inc, d);
    if (wl >= d) {
      c_inc += zc;
      lc_inc = max(lc_inc, zl);
    }
  }
  int lc_before = __shfl_up_sync(kFull, lc_inc, 1);
  if (wl == 0) lc_before = -1;
  const int a_tot = __reduce_add_sync(kFull, w_a[wl]);
  const int x_tot = __reduce_max_sync(kFull, w_maxx[wl]);
  const int c_tot = __shfl_sync(kFull, c_inc, 31);
  const int c_before = __shfl_sync(kFull, c_inc - w_c[wl], warp);
  const bool counted =
      !__any_sync(kFull, w_bad[wl] || w_firstc[wl] < lc_before) &&
      a_tot + c_tot == g && x_tot < a_tot;

  // ---- grp_pos, each id's position (over its key) and the starts of the
  // groups in position order ----
  int total;
  if (counted) {
    count_order(key_s, sz_s, hist, starts, gp_l, nn, a_tot, c_before, red);
    __syncthreads();
    total = smem_scan<false>(starts, g, red);
  } else {
    total = sort_order(srt, starts, key_s, gs_l, gp_l, nn, g, n, red);
    if (tid == 0) atomicAdd(sort_lanes, 1);
    __syncthreads();
  }
  const int* pos_s = key_s;

  // ---- node ranks ----
#pragma unroll 4
  for (int v = tid; v < n; v += kThreads) {
    int rk = n;
    if (v < nn) {
      const int ld = clampn(gl_l[v], n);
      const int mi = mi_l[v];
      int pos = ld < nn ? pos_s[ld] : -1;
      if (pos < 0) pos = gp_l[ld];  // no position this step
      pos = clampn(pos, n);
      rk = (pos < g ? starts[pos] : total) + mi;
    }
    rank_s[v] = rk;
    nr_l[v] = rk;
  }
  __syncthreads();
  for (int v = tid; v < nn; v += kThreads) {
    const int r = rank_s[v];
    if (r >= 0 && r < n) {
      perm_l[r] = v;
      if (r < nn) perm_s[r] = v;
    }
  }
  __syncthreads();

  // ---- the next step's rank-space inputs: four threads a rank, each a
  // quarter of its node's predecessor row (16 bytes), kRowsInFlight ranks
  // in flight; the quarters 0 and 1 also move the letter and the count ----
  const int qtr = tid & 3;
  const int4* pr4 = reinterpret_cast<const int4*>(pr_l);
  int4* prw4 = reinterpret_cast<int4*>(pred_rows +
                                       static_cast<size_t>(lane) * n * kPmax);
  for (int r0 = tid >> 2; r0 < nn; r0 += kRowsInFlight * (kThreads / 4)) {
    int4 row[kRowsInFlight];
    int aux[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u * (kThreads / 4);
      const int v = clampn(r < nn ? perm_s[r] : 0, n);
      row[u] = r < nn ? pr4[static_cast<size_t>(v) * (kPmax / 4) + qtr]
                      : make_int4(0, 0, 0, 0);
      aux[u] = r >= nn ? 0 : qtr == 0 ? let_l[v] : qtr == 1 ? np_l[v] : 0;
    }
    // a rank no node took this step keeps its old node, as in device
    // memory (its slot in shared memory is stale): load it again
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u * (kThreads / 4);
      const int s = r < nn ? perm_s[r] : 0;
      if (r < nn && (s < 0 || s >= nn || rank_s[s] != r)) {
        const int v = clampn(perm_l[r], n);
        row[u] = pr4[static_cast<size_t>(v) * (kPmax / 4) + qtr];
        aux[u] = qtr == 0 ? let_l[v] : qtr == 1 ? np_l[v] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u * (kThreads / 4);
      if (r >= nn) continue;
      auto to_row = [&](int x) {
        return x >= 0 ? rank_s[min(x, n - 1)] + 1 : 0;
      };
      const int4 p = row[u];
      prw4[static_cast<size_t>(r) * (kPmax / 4) + qtr] =
          make_int4(to_row(p.x), to_row(p.y), to_row(p.z), to_row(p.w));
      const size_t at = static_cast<size_t>(lane) * n + r;
      if (qtr == 0) letters_r[at] = aux[u];
      if (qtr == 1) npred_r[at] = max(aux[u], 1);
    }
  }
}


}  // namespace

// The pack engine's state after poa_thread (ops/kernels.py::poa_rerank),
// every array contiguous int32: keys, grp_size, grp_leader, member_idx,
// npred, letters, grp_pos, perm [b, n + 1]; preds [b, n + 1, 16]; n_nodes,
// n_groups [b]; outputs node_rank [b, n], pred_rows [b, n, 16], npred_r,
// letters_r [b, n]; ``sort_lanes`` an int [1] that each lane ordered by the
// sort adds 1 to.  n <= 16384.  Launches one CTA a lane with 14 n bytes of
// dynamic shared memory (n rounded up to a power of two for the sort's 8 n)
// on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int poa_rerank_launch(
    const void* keys, const void* grp_size, const void* grp_leader,
    const void* member_idx, const void* preds, const void* npred,
    const void* letters, const void* n_nodes, const void* n_groups,
    void* grp_pos, void* perm, void* node_rank, void* pred_rows,
    void* npred_r, void* letters_r, void* sort_lanes, int b, int n,
    void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int m_cap = 1;
  while (m_cap < n) m_cap <<= 1;
  const size_t smem = static_cast<size_t>(m_cap) * sizeof(u64) +
                      static_cast<size_t>(n) * (sizeof(int) + sizeof(uint16_t));
  cudaError_t e = cudaFuncSetAttribute(
      poa_rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  poa_rerank_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(grp_size),
      static_cast<const int32_t*>(grp_leader),
      static_cast<const int32_t*>(member_idx),
      static_cast<const int32_t*>(preds), static_cast<const int32_t*>(npred),
      static_cast<const int32_t*>(letters),
      static_cast<const int32_t*>(n_nodes),
      static_cast<const int32_t*>(n_groups), static_cast<int32_t*>(grp_pos),
      static_cast<int32_t*>(perm), static_cast<int32_t*>(node_rank),
      static_cast<int32_t*>(pred_rows), static_cast<int32_t*>(npred_r),
      static_cast<int32_t*>(letters_r), static_cast<int*>(sort_lanes), n,
      m_cap);
  return static_cast<int>(cudaGetLastError());
}
