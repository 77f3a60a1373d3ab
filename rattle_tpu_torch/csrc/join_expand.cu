// join_expand: the common-k-mer join of read pairs (kmer.cpp:45-67),
// reading each pair's two k-mer table rows, for as many pairs as the caller
// launches at once (a whole (class, tier) range of the engine's wave).
//
// Replaces the table gathers plus rattle_tpu/ops/join_device.py::
// merge_join_expand (k <= 15) and sorted_join_expand (k = 16) as
// rattle_tpu/cluster/bulk.py::_score_body composes them.  The TPU join sorts
// the two gathered rows together (a bitonic merge) because a TPU has no
// gather unit; here each pair's rows are read where they lie.
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
// launch's largest min(total, m_cap) by atomicMax.  Hashes of k <= 16 are
// < 2^32 and compared unsigned, so a real k = 16 hash of 0xFFFFFFFF (the
// sketch's pad value) is a hash like any other: entries are masked by nk,
// never by value.
//
// Bound: bytes, as chip_smoke.py::_join_bound counts them: the pair indices
// (16 bytes a pair); the hashes of each distinct table row the launch names,
// read once (8 bytes an entry up to the read's nk; one row read once for
// both sides when the two tables are one), with its id, table index and nk;
// the positions of the kept matches (4 bytes a side); and the match lists
// written (9 bytes a slot) with total.  The merge is na + nb comparisons a
// pair, and the sort of the kept keys is counted beside it.  A kernel that
// stages each pair's two rows on its own, as this one does, moves both rows
// for every pair (12 bytes an entry).  The pairs of a block wave share rows
// (4,096 reads, ~150 MB of hashes and positions, more than the H100's 50 MB
// L2), so that count is no bound: the L2 serves part of it, and on an H100
// this kernel ran at 106% of it on the 894,784-pair launch of
// chip_smoke.py's main path.  What the design does about the bytes and the
// walks:
//   * a group of G threads a pair, G from the class width and m_cap (64 up
//     to 1024 entries; 128 up to 2048, and up to 3072 at m_cap <= 128; 256
//     beyond), 256 / G pairs a CTA, each group with its own
//     named barrier: a narrow pair does not pay a 256-thread block's
//     barriers, and a CTA keeps several pairs' loads in flight;
//   * both rows' hashes staged in shared memory with 16-byte loads, narrowed
//     to uint32 with one pad word every 32 (walks that sit a power of two
//     apart do not share a bank), so the walks read shared memory only.  The
//     positions are read from device memory only for the matches a pair
//     keeps (at most m_cap): staging them too moved a third more bytes and
//     halved the pairs an SM holds.  A row pair wider than shared memory is
//     walked in device memory instead (one group of 256 a CTA): no width is
//     assumed to fit;
//   * a merge walk: each thread finds its start once, by a merge-path
//     binary search over (a, b) (a entries before equal b entries, so a b
//     entry's equal a run starts where the walk stands), then takes its
//     share of the merge one entry a step, the same number of steps for
//     every thread (no divergence between the a and b sides).  The end of
//     an equal-hash run is found by galloping from its start, so a run that
//     straddles two threads' shares is counted whole by each thread that
//     owns one of its b entries.  The count walk, a group scan of the
//     counts (each thread's first slot, the pair's total) and the emit walk
//     keep the b order; the emit walk covers only the b entries between a
//     thread's first and last match, and only where its first slot is below
//     m_cap (a pair of few matches re-walks almost nothing);
//   * keys (p1 << 32 | p2) of at most m_cap matches in shared memory, sorted
//     in one warp's registers with shuffles when the pair keeps <= 128 of
//     them (the M = 128 tier: no barrier), else by a bitonic sort over the
//     group's own pow2(n) keys;
//   * p1, p2 and valid written with 16-byte stores where the row length
//     allows it; the dynamic shared memory limit is raised once per process
//     and kernel variant, not per launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCta = 256;
constexpr int kMaxWarps = kCta / 32;
constexpr int kMaxM = 8192;
// lists of up to this many kept matches sort in one warp's registers
constexpr int kWarpSortN = 128;
// shared memory a block may take (H100: 227 KB opt-in)
constexpr size_t kSmemCap = 227 * 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int32_t kInt32Max = 0x7FFFFFFF;

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// index of hash entry i in a staged row: one pad word after every 32
__host__ __device__ __forceinline__ int skew(int i) { return i + (i >> 5); }

__host__ __device__ inline size_t round16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int key_slots(int m_cap) {
  const int p = pow2_at_least(m_cap);
  return p < kWarpSortN ? kWarpSortN : p;
}

// shared memory of one group: its keys and scan totals, and when staged
// both rows' hashes (skewed uint32)
struct GroupLayout {
  size_t keys, sums, ha, hb, bytes;
  __host__ __device__ GroupLayout(int wa, int wb, int m_cap, bool stage) {
    keys = 0;
    sums = keys + 8 * static_cast<size_t>(key_slots(m_cap));
    ha = hb = sums + 8 * kMaxWarps;
    bytes = ha;
    if (stage) {
      hb = ha + round16(4 * static_cast<size_t>(skew(wa) + 1));
      bytes = hb + round16(4 * static_cast<size_t>(skew(wb) + 1));
    }
  }
};

struct SmemRow {
  const uint32_t* h;
  const int32_t* p;
  __device__ __forceinline__ uint32_t hash(int i) const { return h[skew(i)]; }
  __device__ __forceinline__ uint32_t pos(int i) const {
    return static_cast<uint32_t>(__ldg(p + i));
  }
};

struct GlobalRow {
  const int64_t* h;
  const int32_t* p;
  __device__ __forceinline__ uint32_t hash(int i) const {
    return static_cast<uint32_t>(__ldg(h + i));
  }
  __device__ __forceinline__ uint32_t pos(int i) const {
    return static_cast<uint32_t>(__ldg(p + i));
  }
};

template <int G>
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(grp + 1), "n"(G) : "memory");
}

// hashes [0, n) of a row into skewed uint32 shared memory: 16-byte loads
// after at most one 8-byte head element
template <int G>
__device__ __forceinline__ void stage_hashes(const int64_t* __restrict__ src,
                                             int n, uint32_t* dst, int t) {
  const int head = min(n, (reinterpret_cast<uintptr_t>(src) & 15) ? 1 : 0);
  const int nv = (n - head) >> 1;
  const longlong2* v = reinterpret_cast<const longlong2*>(src + head);
#pragma unroll 4
  for (int k = t; k < nv; k += G) {
    const longlong2 x = __ldg(v + k);
    const int i = head + 2 * k;
    dst[skew(i)] = static_cast<uint32_t>(x.x);
    dst[skew(i + 1)] = static_cast<uint32_t>(x.y);
  }
  const int tail = head + 2 * nv;
  if (t == 0 && head) dst[0] = static_cast<uint32_t>(__ldg(src));
  if (t == G - 1 && tail < n)
    dst[skew(tail)] = static_cast<uint32_t>(__ldg(src + tail));
}

// merge-path co-rank: the number of a entries among the first d of the
// merge of a[0, na) and b[0, nb), a entry before b entry iff a < b
template <class RA, class RB>
__device__ __forceinline__ int corank(int d, const RA& a, int na,
                                      const RB& b, int nb) {
  int lo = max(0, d - nb), hi = min(d, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a.hash(mid) < b.hash(d - 1 - mid)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// the end of the run of hash h in a that starts at lo (a(lo) == h):
// galloping, then a binary search of the last stride
template <class RA>
__device__ __forceinline__ int run_end(const RA& a, int lo, int na,
                                       uint32_t h) {
  int last = lo, step = 1;
  while (lo + step < na && a.hash(lo + step) == h) {
    last = lo + step;
    step <<= 1;
  }
  int l = last + 1, hi = min(lo + step, na);
  while (l < hi) {
    const int mid = (l + hi) >> 1;
    if (a.hash(mid) == h) l = mid + 1; else hi = mid;
  }
  return l;
}

// The count walk: ``steps`` steps of the merge from (i, j), one merged
// entry a step (an a entry when a[i] < b[j], else a b entry), the same trip
// count for every thread of a warp.  A b entry's matches are the run of
// equal a hashes that starts where the walk stands (a run of equal b hashes
// reuses it).  Returns the thread's match count; [jf, jl) are its first and
// past its last b entry with a match, and i_f the walk's a position at jf.
template <class RA, class RB>
__device__ __forceinline__ long long count_walk(const RA& a, int na,
                                                const RB& b, int nb, int i,
                                                int j, int steps, int& jf,
                                                int& jl, int& i_f) {
  long long sum = 0;
  int cnt = 0;
  uint32_t prev = 0;
  bool have = false;
  jf = jl = j;
  i_f = i;
  uint32_t ai = i < na ? a.hash(i) : 0;
  uint32_t bj = j < nb ? b.hash(j) : 0;
  for (int s = 0; s < steps; ++s) {
    if (i < na && (j >= nb || ai < bj)) {
      if (++i < na) ai = a.hash(i);
    } else {
      if (!have || bj != prev) {
        cnt = (i < na && ai == bj) ? run_end(a, i, na, bj) - i : 0;
        prev = bj;
        have = true;
      }
      if (cnt) {
        if (sum == 0) {
          jf = j;
          i_f = i;
        }
        jl = j + 1;
        sum += cnt;
      }
      if (++j < nb) bj = b.hash(j);
    }
  }
  return sum;
}

// The emit walk of b entries [j0, j1) from a position i (at most the first
// a entry not below b[j0]): writes the keys of each b entry's equal a run
// into slots [slot, m_cap), in b order and a order within a b entry, and
// stops at m_cap.
template <class RA, class RB>
__device__ __forceinline__ void emit_walk(const RA& a, int na, const RB& b,
                                          int i, int j0, int j1,
                                          long long slot, int m_cap,
                                          uint64_t* keys) {
  int lo = 0, end = 0;
  uint32_t prev = 0;
  bool have = false;
  for (int j = j0; j < j1 && slot < m_cap; ++j) {
    const uint32_t h = b.hash(j);
    if (!have || h != prev) {
      while (i < na && a.hash(i) < h) ++i;
      lo = i;
      end = (i < na && a.hash(i) == h) ? run_end(a, i, na, h) : i;
      i = end;  // the next distinct b hash is larger
      prev = h;
      have = true;
    }
    if (end > lo) {
      const uint64_t p2 = b.pos(j);
      for (int k = lo; k < end && slot < m_cap; ++k, ++slot)
        keys[slot] = (static_cast<uint64_t>(a.pos(k)) << 32) | p2;
    }
  }
}

// ascending bitonic sort of 128 keys in one warp's registers, element
// lane * 4 + r in v[r]
__device__ __forceinline__ void warp_sort128(unsigned long long (&v)[4],
                                             int lane) {
#pragma unroll
  for (int k = 2; k <= 128; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = lane * 4 + r;
          const unsigned long long o = __shfl_xor_sync(kFull, v[r], j >> 2);
          const bool keep_min = ((e & j) == 0) == ((e & k) == 0);
          v[r] = keep_min ? (o < v[r] ? o : v[r]) : (o > v[r] ? o : v[r]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int p = r ^ j;
          if (p > r) {
            const bool up = ((lane * 4 + r) & k) == 0;
            const unsigned long long x = v[r], y = v[p];
            if ((x > y) == up) {
              v[r] = y;
              v[p] = x;
            }
          }
        }
      }
    }
  }
}

// The join of one pair by its group of G threads (t its thread): count
// walk, group scan, emit walk, sort, stores.
template <int G, class RA, class RB>
__device__ __forceinline__ void join_pair(
    const RA& a, int na, const RB& b, int nb, int m_cap, int grp, int t,
    uint64_t* keys, long long* sums, size_t row0, int32_t* __restrict__ p1,
    int32_t* __restrict__ p2, uint8_t* __restrict__ valid,
    int32_t* __restrict__ total_out, int32_t* __restrict__ bound) {
  constexpr int kW = G / 32;
  const int lane = t & 31, warp = t >> 5;
  const int len = na + nb;
  const int d0 = static_cast<int>(static_cast<long long>(t) * len / G);
  const int d1 = static_cast<int>(static_cast<long long>(t + 1) * len / G);
  const int i0 = corank(d0, a, na, b, nb);
  int jf, jl, i_f;
  const long long mine =
      count_walk(a, na, b, nb, i0, d0 - i0, d1 - d0, jf, jl, i_f);
  long long incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const long long v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) sums[warp] = incl;
  group_sync<G>(grp);
  long long before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const long long s = sums[w];
    total += s;
    if (w < warp) before += s;
  }
  const long long off = before + incl - mine;
  const int n = static_cast<int>(total < m_cap ? total : m_cap);

  if (mine > 0 && off < m_cap)
    emit_walk(a, na, b, i_f, jf, jl, off, m_cap, keys);
  if (n <= kWarpSortN) {
    group_sync<G>(grp);
    if (warp == 0) {
      unsigned long long v[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = lane * 4 + r;
        v[r] = e < n ? keys[e] : ~0ull;
      }
      warp_sort128(v, lane);
      ulonglong2* k2 = reinterpret_cast<ulonglong2*>(keys) + lane * 2;
      k2[0] = make_ulonglong2(v[0], v[1]);
      k2[1] = make_ulonglong2(v[2], v[3]);
    }
  } else {
    const int np2 = pow2_at_least(n);
    for (int s = n + t; s < np2; s += G) keys[s] = ~0ull;
    group_sync<G>(grp);
    for (int k = 2; k <= np2; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int q = t; q < (np2 >> 1); q += G) {
          const int i = ((q & ~(j - 1)) << 1) | (q & (j - 1));
          const int ixj = i + j;
          const uint64_t x = keys[i], y = keys[ixj];
          if ((x > y) == ((i & k) == 0)) {
            keys[i] = y;
            keys[ixj] = x;
          }
        }
        group_sync<G>(grp);
      }
    }
  }
  group_sync<G>(grp);

  if ((m_cap & 3) == 0) {
    int4* o1 = reinterpret_cast<int4*>(p1 + row0);
    int4* o2 = reinterpret_cast<int4*>(p2 + row0);
    const ulonglong2* k2 = reinterpret_cast<const ulonglong2*>(keys);
    for (int q = t; q < (m_cap >> 2); q += G) {
      const int s = 4 * q;
      unsigned long long k[4] = {0, 0, 0, 0};
      if (s < n) {
        const ulonglong2 x = k2[2 * q], y = k2[2 * q + 1];
        k[0] = x.x; k[1] = x.y; k[2] = y.x; k[3] = y.y;
      }
      int x1[4], x2[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool ok = s + u < n;
        x1[u] = ok ? static_cast<int32_t>(k[u] >> 32) : 0;
        x2[u] = ok ? static_cast<int32_t>(k[u] & 0xFFFFFFFFull) : kInt32Max;
      }
      o1[q] = make_int4(x1[0], x1[1], x1[2], x1[3]);
      o2[q] = make_int4(x2[0], x2[1], x2[2], x2[3]);
    }
  } else {
    for (int s = t; s < m_cap; s += G) {
      const bool ok = s < n;
      const uint64_t key = ok ? keys[s] : 0;
      p1[row0 + s] = ok ? static_cast<int32_t>(key >> 32) : 0;
      p2[row0 + s] = ok ? static_cast<int32_t>(key & 0xFFFFFFFFull)
                        : kInt32Max;
    }
  }
  if ((m_cap & 15) == 0) {
    uint4* ov = reinterpret_cast<uint4*>(valid + row0);
    for (int q = t; q < (m_cap >> 4); q += G) {
      unsigned w[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int nv = min(max(n - (16 * q + 4 * u), 0), 4);
        w[u] = nv == 4 ? 0x01010101u : (0x01010101u & ((1u << (8 * nv)) - 1));
      }
      ov[q] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  } else {
    for (int s = t; s < m_cap; s += G) valid[row0 + s] = s < n;
  }
  if (t == 0) {
    total_out[0] = static_cast<int32_t>(total);
    atomicMax(bound, n);
  }
}

template <int G, bool kStage>
__global__ void __launch_bounds__(kCta)
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
                   int wb, const int32_t* __restrict__ nk, int n_pairs,
                   int m_cap, int32_t* __restrict__ out_p1,
                   int32_t* __restrict__ out_p2,
                   uint8_t* __restrict__ out_valid,
                   int32_t* __restrict__ out_total,
                   int32_t* __restrict__ bound) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int grp = threadIdx.x / G;
  const int t = threadIdx.x % G;
  const int pair = blockIdx.x * (blockDim.x / G) + grp;
  if (pair >= n_pairs) return;  // the whole group: its barriers are its own

  const GroupLayout lay(wa, wb, m_cap, kStage);
  unsigned char* base = smem + grp * lay.bytes;
  uint64_t* keys = reinterpret_cast<uint64_t*>(base + lay.keys);
  long long* sums = reinterpret_cast<long long*>(base + lay.sums);

  const long long r = rows[pair], c = cols[pair];
  const int na = min(max(__ldg(nk + row_ids[r]), 0), wa);
  const int nb = min(max(__ldg(nk + col_ids[c]), 0), wb);
  const long long ra = row_tab[r], cb = col_tab[c];
  const int64_t* gha = hs_a + ra * sa_h;
  const int32_t* gpa = ps_a + ra * sa_p;
  const int64_t* ghb = hs_b + cb * sb_h;
  const int32_t* gpb = ps_b + cb * sb_p;
  const size_t row0 = static_cast<size_t>(pair) * m_cap;

  if (kStage) {
    uint32_t* sha = reinterpret_cast<uint32_t*>(base + lay.ha);
    uint32_t* shb = reinterpret_cast<uint32_t*>(base + lay.hb);
    stage_hashes<G>(gha, na, sha, t);
    stage_hashes<G>(ghb, nb, shb, t);
    group_sync<G>(grp);
    join_pair<G>(SmemRow{sha, gpa}, na, SmemRow{shb, gpb}, nb, m_cap, grp,
                 t, keys, sums, row0, out_p1, out_p2, out_valid,
                 out_total + pair, bound);
  } else {
    join_pair<G>(GlobalRow{gha, gpa}, na, GlobalRow{ghb, gpb}, nb, m_cap,
                 grp, t, keys, sums, row0, out_p1, out_p2, out_valid,
                 out_total + pair, bound);
  }
}

// A launch's shape: threads a pair, pairs a CTA, staged or not, bytes of
// dynamic shared memory a CTA.
struct Config {
  int g, p;
  bool stage;
  size_t smem;
};

Config choose(int wa, int wb, int m_cap) {
  const int w = wa > wb ? wa : wb;
  const int g = w <= 1024 ? 64 : (w <= 2048 || (w <= 3072 && m_cap <= 128))
                                     ? 128 : 256;
  const size_t per = GroupLayout(wa, wb, m_cap, true).bytes;
  int p = kCta / g;
  while (p > 1 && p * per > kSmemCap) p >>= 1;
  if (p * per <= kSmemCap) return {g, p, true, p * per};
  return {kCta, 1, false, GroupLayout(wa, wb, m_cap, false).bytes};
}

// Raises a kernel variant's dynamic shared memory limit to kSmemCap, once
// per process and device.
template <int G, bool kStage>
cudaError_t prepare() {
  static unsigned done = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 32 && (done >> dev & 1u)) return cudaSuccess;
  err = cudaFuncSetAttribute(join_expand_kernel<G, kStage>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemCap));
  if (err == cudaSuccess && dev < 32) done |= 1u << dev;
  return err;
}

template <int G, bool kStage>
int occupancy(const Config& cfg) {
  cudaError_t err = prepare<G, kStage>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, join_expand_kernel<G, kStage>, cfg.p * G, cfg.smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// rows, cols [n_pairs] int64 indices into row_ids/row_tab and
// col_ids/col_tab (int64); hs_a [*, wa] int64 and ps_a [*, wa] int32 with
// row strides sa_h, sa_p (elements), the same for the b side; nk int32 by
// global read id; 1 <= m_cap <= 8192; 0 <= n_pairs < 2^31.  Outputs: p1, p2
// [n_pairs, m_cap] int32 and valid [n_pairs, m_cap] bytes, 16-byte aligned;
// total [n_pairs] int32; bound, a device int32 scalar, is raised by
// atomicMax.  Launches on ``stream`` and returns cudaGetLastError() (0 on
// success).
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
  const Config cfg = choose(wa, wb, m_cap);
  const auto s = static_cast<cudaStream_t>(stream);
  const int grid = (n_pairs + cfg.p - 1) / cfg.p;
#define JOIN_LAUNCH(G, S)                                                    \
  do {                                                                       \
    const cudaError_t err = prepare<G, S>();                                 \
    if (err != cudaSuccess) return static_cast<int>(err);                    \
    join_expand_kernel<G, S><<<grid, cfg.p * G, cfg.smem, s>>>(              \
        static_cast<const int64_t*>(rows), static_cast<const int64_t*>(cols), \
        static_cast<const int64_t*>(row_ids),                                \
        static_cast<const int64_t*>(col_ids),                                \
        static_cast<const int64_t*>(row_tab),                                \
        static_cast<const int64_t*>(col_tab),                                \
        static_cast<const int64_t*>(hs_a), static_cast<const int32_t*>(ps_a), \
        sa_h, sa_p, wa, static_cast<const int64_t*>(hs_b),                   \
        static_cast<const int32_t*>(ps_b), sb_h, sb_p, wb,                   \
        static_cast<const int32_t*>(nk), n_pairs, m_cap,                     \
        static_cast<int32_t*>(p1), static_cast<int32_t*>(p2),                \
        static_cast<uint8_t*>(valid), static_cast<int32_t*>(total),          \
        static_cast<int32_t*>(bound));                                       \
  } while (0)
  if (!cfg.stage) JOIN_LAUNCH(256, false);
  else if (cfg.g == 64) JOIN_LAUNCH(64, true);
  else if (cfg.g == 128) JOIN_LAUNCH(128, true);
  else JOIN_LAUNCH(256, true);
#undef JOIN_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// The launch shape join_expand_launch takes at these widths and m_cap:
// out[0] threads a pair, out[1] pairs a CTA, out[2] 1 if the rows are
// staged in shared memory, out[3] dynamic shared memory bytes a CTA,
// out[4] CTAs resident an SM (the occupancy API).  Returns 0 or a CUDA
// error.
extern "C" int join_expand_config(int wa, int wb, int m_cap, int* out) {
  if (m_cap < 1 || m_cap > kMaxM || wa < 1 || wb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config cfg = choose(wa, wb, m_cap);
  int blocks;
  if (!cfg.stage) blocks = occupancy<256, false>(cfg);
  else if (cfg.g == 64) blocks = occupancy<64, true>(cfg);
  else if (cfg.g == 128) blocks = occupancy<128, true>(cfg);
  else blocks = occupancy<256, true>(cfg);
  if (blocks < 0) return -blocks;
  out[0] = cfg.g;
  out[1] = cfg.p;
  out[2] = cfg.stage ? 1 : 0;
  out[3] = static_cast<int>(cfg.smem);
  out[4] = blocks;
  return 0;
}
