// lis_filter: the decision score of one read pair from its common-k-mer match
// list (similarity.cpp:4-97 and utils.cpp:36-55):
//   1. patience LIS over p2 with predecessor links,
//   2. backward reconstruction of the anchor chain,
//   3. forward anchor filter, accumulating bases and high-confidence bases,
//   4. f32 two-pass compensated variance of the kept gap differences.
//
// Replaces rattle_tpu/ops/pallas_kernels.py::lis_filter_pallas
// (_lis_kernel_body).  The TPU kernel ran the three scans in lockstep over a
// [M, 512] match-major tile, turning every search and every point update into
// a wide compare/select over all M levels.
//
// Bound: the bytes it must read are the valid bytes up to the batch's
// match-count bound, p2 (int32) at the valid slots and p1 (int32) at the LIS
// anchors: a few microseconds at HBM rate.  What sets its time is the chain of
// dependent steps inside one pair (one LIS step a valid match, one link a
// reconstructed anchor, one filter step an anchor): a step decided one at a
// time costs ~150-250 cycles of branch, shuffle and shared-memory latency on
// this card.  So the design keeps the chain on chip and takes up to 32 steps
// of it at once wherever the lists allow, which on read pairs is nearly
// everywhere (their match lists are close to colinear):
//   * a warp owns one pair; all of its state (p1 and p2 of the valid
//     matches, the patience tails, the level -> match index map, the
//     predecessor links, the anchor list, the kept gap differences) lives in
//     shared memory, 16 M + O(1) bytes a pair with int16 indices;
//   * the warp stages its row with coalesced loads and compacts the valid
//     slots on the way (a ballot a 32-slot chunk), so the LIS walks exactly
//     the pair's own valid matches up to ``bound``, not the chunk's largest
//     count; invalid slots change nothing in the reference, so this is exact;
//   * LIS build: the leading matches of the next 32 that each extend the LIS
//     (above the last tail, then above the match before) take levels l + 1,
//     l + 2, ... at once; the match that ends such a run takes one search
//     step: the warp counts tails < v (the reference's strict count,
//     pallas_kernels.py:148) in 32-way ballot rounds over pivots;
//   * reconstruction: runs of predecessor links to the match just below are
//     written 32 anchors at a time;
//   * filter: 32 anchors are judged at once, each against the one before it
//     as if that were kept; the leading kept ones are exact, and the anchor
//     that ends the run is dropped, judged against the last kept one;
//   * the bases and variance sums are warp reductions.
// ``bound`` is read on the device (no host sync) and truncates every scan.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kLanes = 32;  // a warp a pair
constexpr int kBlockThreads = 128;
constexpr int kStageUnroll = 4;
constexpr size_t kSmemCap = 227 * 1024;

using Warp = cg::thread_block_tile<kLanes>;

// 4-byte words of shared memory one pair of capacity m takes: p2, p1 and the
// tails (later the gap differences) as int32 [m + 32] (phase 1 reads a
// warp's width past the last match), the level -> match map (later the anchor
// list) and the predecessor links as int16 [m + 1]; every array starts on a
// 16-byte boundary.
__host__ __device__ inline int words_i32(int m) { return (m + 35) & ~3; }
__host__ __device__ inline int words_i16(int m) { return ((m + 8) & ~7) / 2; }
__host__ __device__ inline int pair_words(int m) {
  return 3 * words_i32(m) + 2 * words_i16(m);
}

template <class T>
__device__ inline T warp_sum(Warp warp, T x) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) x += warp.shfl_xor(x, o);
  return x;
}

// The number of leading set bits of a warp ballot (32 when all are set).
__device__ inline int leading_ones(unsigned bits) {
  const unsigned low0 = ~bits & (bits + 1u);  // the lowest clear bit alone
  return low0 ? __ffs(low0) - 1 : kLanes;
}

__global__ void __launch_bounds__(kBlockThreads)
lis_filter_kernel(const int32_t* __restrict__ p1, const int32_t* __restrict__ p2,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ bound_ptr, int n_pairs, int m,
                  int kmer, int hc_max_dist, int32_t* __restrict__ out_bases,
                  int32_t* __restrict__ out_hc, int32_t* __restrict__ out_ndist,
                  float* __restrict__ out_var) {
  extern __shared__ int4 smem[];
  Warp warp = cg::tiled_partition<kLanes>(cg::this_thread_block());
  const int lane = warp.thread_rank();
  const int t = threadIdx.x / kLanes;
  const int b = blockIdx.x * (blockDim.x / kLanes) + t;
  if (b >= n_pairs) return;  // the whole warp: no block-wide barrier follows

  int32_t* p2s = reinterpret_cast<int32_t*>(smem) + t * pair_words(m);
  int32_t* p1s = p2s + words_i32(m);
  int32_t* tails = p1s + words_i32(m);  // the gap differences in phase 3
  int16_t* m_idx = reinterpret_cast<int16_t*>(tails + words_i32(m));
  int16_t* anchors = m_idx;             // phase 2 on; m_idx is dead by then
  int16_t* p_pred = m_idx + 2 * words_i16(m);

  const int bound = min(max(__ldg(bound_ptr), 0), m);
  const int32_t* q1 = p1 + static_cast<size_t>(b) * m;
  const int32_t* q2 = p2 + static_cast<size_t>(b) * m;
  const uint8_t* ok = valid + static_cast<size_t>(b) * m;

  // phase 0: stage the valid matches below the bound, compacted in order
  int n = 0;
  for (int s0 = 0; s0 < bound; s0 += kLanes * kStageUnroll) {
    bool v[kStageUnroll];
    int x1[kStageUnroll], x2[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int s = s0 + u * kLanes + lane;
      v[u] = s < bound && ok[s] != 0;
      x1[u] = s < bound ? __ldg(q1 + s) : 0;
      x2[u] = s < bound ? __ldg(q2 + s) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const unsigned mask = warp.ballot(v[u]);
      if (v[u]) {
        const int r = n + __popc(mask & ((1u << lane) - 1u));
        p1s[r] = x1[u];
        p2s[r] = x2[u];
      }
      n += __popc(mask);
    }
  }
  warp.sync();

  // phase 1: patience LIS build (similarity.cpp:10-31).  Level lvl of v is
  // count(tails < v) with tails[0] = -inf: 0 for v == INT32_MIN, l + 1 when
  // v is above the last tail, else 1 + the number of tails[1..l-1] below v
  // (tails[1..l] is strictly increasing and tails[l] >= v).  The warp takes
  // 32 matches at a time: the leading ones that each extend the LIS (above
  // the last tail, then above the match before) are appended at once; the
  // match that ends the run takes one search step.
  int l = 0, top = 0, top_i = 0, m0 = 0;  // m0: m_idx[0]
  for (int i = 0; i < n;) {
    const int idx = i + lane;
    const int v = p2s[idx];  // p2s is padded by 32 slots past the matches
    const int pv = warp.shfl_up(v, 1);
    const bool ext =
        idx < n && (lane > 0 ? v > pv : v != INT32_MIN && (l == 0 || v > top));
    const int r = leading_ones(warp.ballot(ext));
    if (lane < r) {
      p_pred[idx] = static_cast<int16_t>(lane > 0 ? idx - 1
                                         : l > 0  ? top_i
                                                  : m0);
      m_idx[l + 1 + lane] = static_cast<int16_t>(idx);
      tails[l + 1 + lane] = v;
    }
    const int last = warp.shfl(v, max(r - 1, 0));
    const int brk = warp.shfl(v, min(r, kLanes - 1));
    if (r > 0) {
      l += r;
      top = last;
      top_i = i + r - 1;
    }
    i += r;
    if (r == kLanes || i >= n) continue;
    // match i ends the run: v == INT32_MIN (level 0) or v <= top with l >= 1
    int lvl = 0;
    if (brk != INT32_MIN) {
      warp.sync();  // every lane's tails and m_idx writes, for every lane
      int lo = 1, hi = l - 1;  // below lo all < v; above hi all >= v
      while (hi - lo + 1 > kLanes) {
        const int seg = (hi - lo + kLanes) / kLanes;
        const int p = lo + lane * seg + seg - 1;  // last of lane's segment
        const int c = __popc(warp.ballot(p <= hi && tails[p] < brk));
        hi = min(hi, lo + (c + 1) * seg - 2);
        lo += c * seg;
      }
      const int p = lo + lane;
      lvl = lo + __popc(warp.ballot(p <= hi && tails[p] < brk));
    }
    if (lane == 0) {
      p_pred[i] = static_cast<int16_t>(lvl == 0   ? 0
                                       : lvl == 1 ? m0
                                                  : m_idx[lvl - 1]);
      if (lvl > 0) {
        m_idx[lvl] = static_cast<int16_t>(i);
        tails[lvl] = brk;
      }
    }
    if (lvl == 0) {
      m0 = i;
    } else if (lvl == l) {
      top = brk;
      top_i = i;
    }
    ++i;
  }
  warp.sync();

  // phase 2: backward reconstruction into forward order (similarity.cpp:37-44):
  // From anchor k, lane j looks at match k - j: while every lane before it
  // links to the match just below (p_pred[k - j] == k - j - 1), the run of
  // anchors k, k - 1, ... is written at once.
  for (int w = l - 1, k = top_i; w >= 0;) {
    const int kk = k - lane;
    const int pp = kk >= 0 ? p_pred[kk] : -1;
    const int r = leading_ones(warp.ballot(pp == kk - 1));
    const int take = min(min(r + 1, kLanes), w + 1);
    if (lane < take) anchors[w - lane] = static_cast<int16_t>(kk);
    k = warp.shfl(pp, take - 1);
    w -= take;
  }
  warp.sync();

  // phase 3: forward anchor filter (similarity.cpp:52-85).  The first anchor
  // is kept.  Then the warp takes 32 anchors at a time, each judged against
  // the anchor before it as if that one were kept: the leading anchors so
  // kept are kept (their gap differences and bases computed at once); the
  // first anchor that fails is dropped, against the last kept one.
  int32_t* dist = tails;
  int lf = 0, ls = 0, prev_a2 = 0, kept = 0;
  int bases = 0, hc = 0;  // this lane's share of the sums
  if (l > 0) {
    const int k0 = anchors[0];
    lf = p1s[k0];
    ls = prev_a2 = p2s[k0];
    kept = 1;
    if (lane == 0) bases = hc = kmer;
  }
  for (int w = 1; w < l;) {
    const int ww = w + lane;
    int x1 = 0, x2 = 0;
    if (ww < l) {
      const int k = anchors[ww];
      x1 = p1s[k];
      x2 = p2s[k];
    }
    const int u1 = warp.shfl_up(x1, 1);
    const int u2 = warp.shfl_up(x2, 1);
    const int d1 = x1 - (lane > 0 ? u1 : lf);
    const int d2 = x2 - (lane > 0 ? u2 : ls);
    const bool keep = ww < l && ((d1 < kmer && d2 < kmer) ||
                                 (d1 >= kmer && d2 >= kmer));
    const int r = leading_ones(warp.ballot(keep));
    if (lane < r) {
      const int ex = kmer - (x2 - (lane > 0 ? u2 : prev_a2));
      const int add = kmer - max(ex, 0);
      const int dd = d2 - d1;
      bases += add;
      hc += dd < hc_max_dist ? add : 0;
      dist[kept - 1 + lane] = dd;
    }
    // the run, then (if any) the anchor that ended it, dropped
    const int done = min(r + 1, min(kLanes, l - w));
    const int last = max(r - 1, 0);
    const int lf_run = warp.shfl(x1, last);
    const int ls_run = warp.shfl(x2, last);
    prev_a2 = warp.shfl(x2, done - 1);
    if (r > 0) {
      lf = lf_run;
      ls = ls_run;
      kept += r;
    }
    w += done;
  }
  bases = warp_sum(warp, bases);
  hc = warp_sum(warp, hc);
  warp.sync();

  // two-pass compensated sample variance in f32 (utils.cpp:36-55);
  // n == 0 -> 0, n == 1 -> +inf (the reference's 0/0 NaN fails < t_v alike)
  const int nd = max(kept - 1, 0);
  const float nf = static_cast<float>(max(nd, 1));
  float sum = 0.f;
  for (int j = lane; j < nd; j += kLanes) sum += static_cast<float>(dist[j]);
  const float mean = warp_sum(warp, sum) / nf;
  float ss = 0.f, comp = 0.f;
  for (int j = lane; j < nd; j += kLanes) {
    const float d = static_cast<float>(dist[j]) - mean;
    ss += d * d;
    comp += d;
  }
  ss = warp_sum(warp, ss);
  comp = warp_sum(warp, comp);
  const float denom = static_cast<float>(max(nd - 1, 1));
  float var = (ss - comp * comp / nf) / denom;
  if (nd == 0) var = 0.f;
  if (nd == 1) var = INFINITY;

  if (lane == 0) {
    out_bases[b] = bases;
    out_hc[b] = hc;
    out_ndist[b] = nd;
    out_var[b] = var;
  }
}

}  // namespace

// p1, p2 [n_pairs, m] int32, valid [n_pairs, m] bytes (0/1), bound a device
// int32 scalar; outputs [n_pairs] each.  m <= 8192 (int16 match indices, one
// pair's state within a block's shared memory).  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int lis_filter_launch(const void* p1, const void* p2,
                                 const void* valid, const void* bound,
                                 int n_pairs, int m, int kmer, int hc_max_dist,
                                 void* bases, void* hc, void* ndist, void* var,
                                 void* stream) {
  if (n_pairs <= 0) return 0;
  if (m < 0 || m > 8192) return static_cast<int>(cudaErrorInvalidValue);
  // a warp a pair, up to kBlockThreads / 32 pairs a block as shared memory
  // allows
  const size_t per_pair = 4 * static_cast<size_t>(pair_words(m));
  int pairs = kBlockThreads / kLanes;
  if (kSmemCap / per_pair < static_cast<size_t>(pairs))
    pairs = static_cast<int>(kSmemCap / per_pair);
  const size_t smem = per_pair * pairs;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lis_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (n_pairs + pairs - 1) / pairs;
  lis_filter_kernel<<<grid, pairs * kLanes, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p1), static_cast<const int32_t*>(p2),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(bound),
      n_pairs, m, kmer, hc_max_dist, static_cast<int32_t*>(bases),
      static_cast<int32_t*>(hc), static_cast<int32_t*>(ndist),
      static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
