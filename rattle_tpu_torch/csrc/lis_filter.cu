// lis_filter: the decision score of one read pair from its common-k-mer match
// list (similarity.cpp:4-97 and utils.cpp:36-55):
//   1. patience LIS over p2 with predecessor links,
//   2. backward reconstruction of the anchor chain,
//   3. forward anchor filter, accumulating bases and high-confidence bases,
//   4. f32 two-pass compensated variance of the kept gap differences.
//
// Replaces rattle_tpu/ops/pallas_kernels.py::lis_filter_pallas
// (_lis_kernel_body).  The TPU kernel ran the three scans in lockstep over a
// [M, 512] match-major tile, turning every binary search and every point
// update into a wide compare/select over all M levels (O(M) work a step).
// Hopper has per-thread control flow and gathers, so this kernel runs one
// thread per pair and does the reference's own algorithm: a binary search
// over the patience tails with the same strict ``tails < v`` count
// (pallas_kernels.py:148), O(log M) a step.
//
// Bound: the bytes it must read are the valid bytes up to the batch's
// match-count bound, p2 (int32) at the valid slots and p1 (int32) only at the
// LIS anchors: a few microseconds at HBM rate.
// In practice it is latency-bound by each thread's serial chain of dependent
// loads.  Design: per-pair scratch (tails, m_idx, p_pred, a1, a2, dist) lives
// in global memory in match-major layout [M + 1, B], so the per-step writes
// of a warp (p_pred at step i) coalesce and the rest stays in L1/L2; blocks
// are one warp each so a chunk of B pairs spreads over B/32 SMs, each with
// its own L1.  ``bound`` is read from device memory (no host sync) and
// truncates all three loops exactly as the TPU kernel does.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kScratch = 6;  // tails, m_idx, p_pred, a1, a2, dist

__global__ void __launch_bounds__(kThreads)
lis_filter_kernel(const int32_t* __restrict__ p1, const int32_t* __restrict__ p2,
                  const uint8_t* __restrict__ valid,
                  const int32_t* __restrict__ bound_ptr, int n_pairs, int m,
                  int kmer, int hc_max_dist, int32_t* __restrict__ scratch,
                  int32_t* __restrict__ out_bases, int32_t* __restrict__ out_hc,
                  int32_t* __restrict__ out_ndist, float* __restrict__ out_var) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_pairs) return;
  const int bound = min(max(*bound_ptr, 0), m);
  const int32_t* q1 = p1 + static_cast<size_t>(b) * m;
  const int32_t* q2 = p2 + static_cast<size_t>(b) * m;
  const uint8_t* ok = valid + static_cast<size_t>(b) * m;

  // scratch [6, m + 1, n_pairs]: element j of pair b at j * n_pairs + b
  const size_t plane = static_cast<size_t>(m + 1) * n_pairs;
  int32_t* tails = scratch + 0 * plane + b;
  int32_t* m_idx = scratch + 1 * plane + b;
  int32_t* p_pred = scratch + 2 * plane + b;
  int32_t* a1 = scratch + 3 * plane + b;
  int32_t* a2 = scratch + 4 * plane + b;
  int32_t* dist = scratch + 5 * plane + b;
  const size_t st = static_cast<size_t>(n_pairs);

  // phase 1: patience LIS build (similarity.cpp:10-31).  tails[0] is -inf
  // and levels above l are +inf, so count(tails < v) is the lower bound of
  // v in the strictly increasing tails[1..l].  Level l + 1 <= m always holds
  // (l grows by at most one a step and i < m).
  m_idx[0] = 0;
  int l = 0;
  for (int i = 0; i < bound; ++i) {
    if (!ok[i]) {
      p_pred[i * st] = 0;
      continue;
    }
    const int v = q2[i];
    int lvl;
    if (v == INT32_MIN) {
      lvl = 0;  // nothing is < INT32_MIN, not even the -inf sentinel
    } else {
      int lo = 1, hi = l + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (tails[mid * st] < v) lo = mid + 1; else hi = mid;
      }
      lvl = lo;
    }
    p_pred[i * st] = lvl >= 1 ? m_idx[(lvl - 1) * st] : 0;
    m_idx[lvl * st] = i;
    if (lvl >= 1) tails[lvl * st] = v;
    l = max(l, lvl);
  }

  // phase 2: backward reconstruction into forward order (similarity.cpp:37-44)
  int k = m_idx[l * st];
  for (int i = 0; i < l; ++i) {
    const int w = l - 1 - i;
    a1[w * st] = q1[k];
    a2[w * st] = q2[k];
    k = p_pred[k * st];
  }

  // phase 3: forward anchor filter (similarity.cpp:52-85)
  int lf = 0, ls = 0, prev_a2 = 0, bases = 0, hc = 0, kept = 0;
  for (int i = 0; i < l; ++i) {
    const int x1 = a1[i * st];
    const int x2 = a2[i * st];
    const bool first = kept == 0;
    const int d1 = x1 - lf;
    const int d2 = x2 - ls;
    const bool keep = first || (d1 < kmer && d2 < kmer) ||
                      (d1 >= kmer && d2 >= kmer);
    const int ex = kmer - (x2 - prev_a2);
    const int add = kmer - max(ex, 0);
    const int dd = (x2 - ls) - (x1 - lf);
    if (keep) {
      bases += first ? kmer : add;
      hc += first ? kmer : (dd < hc_max_dist ? add : 0);
      if (!first) dist[(kept - 1) * st] = dd;
      ++kept;
      lf = x1;
      ls = x2;
    }
    prev_a2 = x2;
  }

  // two-pass compensated sample variance in f32 (utils.cpp:36-55);
  // n == 0 -> 0, n == 1 -> +inf (the reference's 0/0 NaN fails < t_v alike)
  const int n = max(kept - 1, 0);
  const float nf = static_cast<float>(max(n, 1));
  float sum = 0.f;
  for (int j = 0; j < n; ++j) sum += static_cast<float>(dist[j * st]);
  const float mean = sum / nf;
  float ss = 0.f, comp = 0.f;
  for (int j = 0; j < n; ++j) {
    const float d = static_cast<float>(dist[j * st]) - mean;
    ss += d * d;
    comp += d;
  }
  const float denom = static_cast<float>(max(n - 1, 1));
  float var = (ss - comp * comp / nf) / denom;
  if (n == 0) var = 0.f;
  if (n == 1) var = INFINITY;

  out_bases[b] = bases;
  out_hc[b] = hc;
  out_ndist[b] = n;
  out_var[b] = var;
}

}  // namespace

// p1, p2 [n_pairs, m] int32, valid [n_pairs, m] bytes (0/1), bound a device
// int32 scalar, scratch [6, m + 1, n_pairs] int32; outputs [n_pairs] each.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int lis_filter_launch(const void* p1, const void* p2,
                                 const void* valid, const void* bound,
                                 int n_pairs, int m, int kmer, int hc_max_dist,
                                 void* scratch, void* bases, void* hc,
                                 void* ndist, void* var, void* stream) {
  if (n_pairs <= 0) return 0;
  const int grid = (n_pairs + kThreads - 1) / kThreads;
  lis_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(p1), static_cast<const int32_t*>(p2),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(bound),
      n_pairs, m, kmer, hc_max_dist, static_cast<int32_t*>(scratch),
      static_cast<int32_t*>(bases), static_cast<int32_t*>(hc),
      static_cast<int32_t*>(ndist), static_cast<float*>(var));
  return static_cast<int>(cudaGetLastError());
}
