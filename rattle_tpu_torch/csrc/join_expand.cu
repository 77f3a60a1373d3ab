// join_expand: the common-k-mer join of one chunk of read pairs
// (kmer.cpp:45-67), reading each pair's two k-mer table rows in place.
//
// Replaces the table gathers plus rattle_tpu/ops/join_device.py::
// merge_join_expand (k <= 15) and sorted_join_expand (k = 16) as
// rattle_tpu/cluster/bulk.py::_score_body composes them.  The TPU join sorts
// the two gathered rows together (a bitonic merge) because a TPU has no
// gather unit; the eager port ran a batched searchsorted join over gathered
// [B, W] int64 copies, about 25 launches a chunk.
//
// For pair i: a = row_ids[rows[i]], b = col_ids[cols[i]] (the global read
// ids: nk), and the rows row_tab[rows[i]] of hs_a/ps_a and col_tab[cols[i]]
// of hs_b/ps_b (the tables, hash-sorted over each read's first nk entries,
// are read through their row strides).  A match is an (a entry, b entry)
// with equal hashes; the matches are numbered in b order, and within one b
// entry in a order (the order of ops/join_device.py), the first m_cap are
// kept, sorted by (p1, p2) and written compacted, p1 padded with 0 and p2
// with INT32_MAX.  ``total`` gets the true match count, ``valid`` marks the
// first min(total, m_cap) slots, and ``bound`` (a device scalar) takes the
// chunk's largest min(total, m_cap) by atomicMax.
//
// Bound: the bytes of the two table rows (hashes and positions of each
// read's nk entries, read once) plus the match lists written; the searches
// are a few thousand integer comparisons a pair.  Design, a CTA a pair:
//   * the a row's hashes are staged as uint32 in shared memory when its
//     width fits (hashes of k <= 16 are < 2^32 and are compared unsigned,
//     so a real k = 16 hash of 0xFFFFFFFF is a hash like any other; entries
//     past nk are never read), else read from device memory: no width is
//     assumed to fit;
//   * each thread takes a contiguous run of the b row; a binary search of
//     the a row gives each distinct b hash its run [lo, lo + cnt) (a b run
//     of equal hashes reuses it);
//   * a block scan of the threads' counts gives each thread its first
//     output slot and the pair's total; each thread then writes the keys
//     (p1 << 32) | p2 of its matches below m_cap into shared memory (at
//     most 8192 x 8 bytes), nothing past m_cap;
//   * a bitonic sort of the keys in shared memory, then coalesced writes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxM = 8192;
// shared memory a block may take for the keys plus a staged a row
constexpr size_t kSmemCap = 200 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct SmemRow {
  const uint32_t* h;
  __device__ __forceinline__ uint32_t operator()(int i) const { return h[i]; }
};

struct GlobalRow {
  const int64_t* h;
  __device__ __forceinline__ uint32_t operator()(int i) const {
    return static_cast<uint32_t>(__ldg(h + i));
  }
};

template <class Row>
__device__ __forceinline__ int lower_bound(const Row& a, int lo, int hi,
                                           uint32_t h) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) < h) lo = mid + 1; else hi = mid;
  }
  return lo;
}

template <class Row>
__device__ __forceinline__ int upper_bound(const Row& a, int lo, int hi,
                                           uint32_t h) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a(mid) <= h) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Walks b entries [j0, j1): for each, the run [lo, lo + cnt) of equal a
// hashes.  kEmit == false sums the counts; kEmit == true writes the keys of
// slots [slot, m_cap) and stops there.
template <bool kEmit, class Row>
__device__ __forceinline__ long long walk(const Row& a, int na,
                                          const int64_t* hb, const int32_t* pa,
                                          const int32_t* pb, int j0, int j1,
                                          long long slot, int m_cap,
                                          uint64_t* keys) {
  long long sum = 0;
  int p = 0, lo = 0, cnt = 0;
  uint32_t prev = 0;
  bool have = false;
  for (int j = j0; j < j1; ++j) {
    const uint32_t h = static_cast<uint32_t>(__ldg(hb + j));
    if (!have || h != prev) {
      lo = lower_bound(a, p, na, h);
      cnt = upper_bound(a, lo, na, h) - lo;
      p = lo;
      prev = h;
      have = true;
    }
    if (kEmit) {
      const uint64_t p2 = static_cast<uint32_t>(__ldg(pb + j));
      for (int k = 0; k < cnt && slot < m_cap; ++k, ++slot) {
        const uint64_t p1 = static_cast<uint32_t>(__ldg(pa + lo + k));
        keys[slot] = (p1 << 32) | p2;
      }
      if (slot >= m_cap) break;
    } else {
      sum += cnt;
    }
  }
  return sum;
}

template <bool kStage>
__global__ void __launch_bounds__(kThreads)
join_expand_kernel(const int64_t* __restrict__ rows,
                   const int64_t* __restrict__ cols,
                   const int64_t* __restrict__ row_ids,
                   const int64_t* __restrict__ col_ids,
                   const int64_t* __restrict__ row_tab,
                   const int64_t* __restrict__ col_tab,
                   const int64_t* __restrict__ hs_a,
                   const int32_t* __restrict__ ps_a, int sa_h, int sa_p,
                   int wa, const int64_t* __restrict__ hs_b,
                   const int32_t* __restrict__ ps_b, int sb_h, int sb_p,
                   int wb, const int32_t* __restrict__ nk, int m_cap,
                   int32_t* __restrict__ out_p1, int32_t* __restrict__ out_p2,
                   uint8_t* __restrict__ out_valid,
                   int32_t* __restrict__ out_total,
                   int32_t* __restrict__ bound) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ long long warp_tot[kWarps];
  const int keys_cap = pow2_at_least(m_cap);
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);
  uint32_t* stage = reinterpret_cast<uint32_t*>(keys + keys_cap);

  const int pair = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long r = rows[pair], c = cols[pair];
  const int na = min(nk[row_ids[r]], wa);
  const int nb = min(nk[col_ids[c]], wb);
  const int64_t* ha = hs_a + row_tab[r] * sa_h;
  const int32_t* pa = ps_a + row_tab[r] * sa_p;
  const int64_t* hb = hs_b + col_tab[c] * sb_h;
  const int32_t* pb = ps_b + col_tab[c] * sb_p;

  if (kStage) {
    for (int i = tid; i < na; i += kThreads)
      stage[i] = static_cast<uint32_t>(__ldg(ha + i));
    __syncthreads();
  }
  const int per = (nb + kThreads - 1) / kThreads;
  const int j0 = min(tid * per, nb), j1 = min(j0 + per, nb);

  long long mine;
  if (kStage)
    mine = walk<false>(SmemRow{stage}, na, hb, pa, pb, j0, j1, 0, m_cap,
                       keys);
  else
    mine = walk<false>(GlobalRow{ha}, na, hb, pa, pb, j0, j1, 0, m_cap,
                       keys);

  // block scan of the threads' counts
  long long incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < kWarps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const long long u = __shfl_up_sync(kFull, v, d);
      if (lane >= d) v += u;
    }
    __syncwarp();
    if (lane < kWarps) warp_tot[lane] = v;
  }
  __syncthreads();
  const long long off = (warp ? warp_tot[warp - 1] : 0) + incl - mine;
  const long long total = warp_tot[kWarps - 1];
  const int n = static_cast<int>(total < m_cap ? total : m_cap);
  const int np2 = pow2_at_least(n);

  for (int s = n + tid; s < np2; s += kThreads) keys[s] = ~0ull;
  if (mine > 0 && off < m_cap) {
    if (kStage)
      walk<true>(SmemRow{stage}, na, hb, pa, pb, j0, j1, off, m_cap, keys);
    else
      walk<true>(GlobalRow{ha}, na, hb, pa, pb, j0, j1, off, m_cap, keys);
  }
  __syncthreads();

  // bitonic sort of keys[0, np2)
  for (int k = 2; k <= np2; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < np2; i += kThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const uint64_t x = keys[i], y = keys[ixj];
          const bool up = (i & k) == 0;
          if ((x > y) == up) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
      }
      __syncthreads();
    }
  }

  const size_t row0 = static_cast<size_t>(pair) * m_cap;
  for (int s = tid; s < m_cap; s += kThreads) {
    const bool v = s < n;
    const uint64_t key = v ? keys[s] : 0;
    out_p1[row0 + s] = v ? static_cast<int32_t>(key >> 32) : 0;
    out_p2[row0 + s] = v ? static_cast<int32_t>(key & 0xFFFFFFFFull)
                         : 0x7FFFFFFF;
    out_valid[row0 + s] = v;
  }
  if (tid == 0) {
    out_total[pair] = static_cast<int32_t>(total);
    atomicMax(bound, n);
  }
}

template <bool kStage>
int launch(size_t smem, int n_pairs, cudaStream_t stream,
           const int64_t* rows, const int64_t* cols, const int64_t* row_ids,
           const int64_t* col_ids, const int64_t* row_tab,
           const int64_t* col_tab, const int64_t* hs_a, const int32_t* ps_a,
           int sa_h, int sa_p, int wa, const int64_t* hs_b,
           const int32_t* ps_b, int sb_h, int sb_p, int wb, const int32_t* nk,
           int m_cap, int32_t* p1, int32_t* p2, uint8_t* valid,
           int32_t* total, int32_t* bound) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        join_expand_kernel<kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  join_expand_kernel<kStage><<<n_pairs, kThreads, smem, stream>>>(
      rows, cols, row_ids, col_ids, row_tab, col_tab, hs_a, ps_a, sa_h, sa_p,
      wa, hs_b, ps_b, sb_h, sb_p, wb, nk, m_cap, p1, p2, valid, total, bound);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows, cols [n_pairs] int64 indices into row_ids/row_tab and
// col_ids/col_tab (int64); hs_a [*, wa] int64 and ps_a [*, wa] int32 with
// row strides sa_h, sa_p (elements), the same for the b side; nk int32 by
// global read id; 1 <= m_cap <= 8192.  Outputs: p1, p2 [n_pairs, m_cap]
// int32, valid [n_pairs, m_cap] bytes, total [n_pairs] int32; bound, a
// device int32 scalar, is raised by atomicMax.  Launches on ``stream`` and
// returns cudaGetLastError() (0 on success).
extern "C" int join_expand_launch(
    const void* rows, const void* cols, const void* row_ids,
    const void* col_ids, const void* row_tab, const void* col_tab,
    const void* hs_a, const void* ps_a, int sa_h, int sa_p, int wa,
    const void* hs_b, const void* ps_b, int sb_h, int sb_p, int wb,
    const void* nk, int n_pairs, int m_cap, void* p1, void* p2, void* valid,
    void* total, void* bound, void* stream) {
  if (n_pairs <= 0) return 0;
  if (m_cap < 1 || m_cap > kMaxM || wa < 1 || wb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t keys = 8 * static_cast<size_t>(pow2_at_least(m_cap));
  const size_t staged = keys + 4 * static_cast<size_t>(wa);
  const auto s = static_cast<cudaStream_t>(stream);
#define JOIN_ARGS                                                           \
  n_pairs, s, static_cast<const int64_t*>(rows),                          \
      static_cast<const int64_t*>(cols),                                  \
      static_cast<const int64_t*>(row_ids),                               \
      static_cast<const int64_t*>(col_ids),                               \
      static_cast<const int64_t*>(row_tab),                               \
      static_cast<const int64_t*>(col_tab),                               \
      static_cast<const int64_t*>(hs_a), static_cast<const int32_t*>(ps_a), \
      sa_h, sa_p, wa, static_cast<const int64_t*>(hs_b),                  \
      static_cast<const int32_t*>(ps_b), sb_h, sb_p, wb,                  \
      static_cast<const int32_t*>(nk), m_cap, static_cast<int32_t*>(p1),  \
      static_cast<int32_t*>(p2), static_cast<uint8_t*>(valid),            \
      static_cast<int32_t*>(total), static_cast<int32_t*>(bound)
  const int rc = staged <= kSmemCap ? launch<true>(staged, JOIN_ARGS)
                                    : launch<false>(keys, JOIN_ARGS);
#undef JOIN_ARGS
  return rc;
}
