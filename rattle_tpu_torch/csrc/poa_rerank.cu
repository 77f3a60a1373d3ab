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
// bound it.  One CTA of 1,024 threads a lane.  The stable sort is a bitonic
// sort in shared memory of 64-bit (key, id) words over the next power of two
// above max(nn, G): the ids make every word distinct, so the order is the
// stable sort's on any keys, not only on the keys a real graph gives (old
// leaders at distinct positions, new runs in path order), at log2(m)
// (log2(m) + 1) / 2 barriers.  node_rank is kept in shared memory for the
// pred_rows gathers; the sort's words give way to the starts once read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxN = 16384;
constexpr int kMaxPer = kMaxN / kThreads;  // sorted positions a thread
constexpr int kIdBits = 14;                // node ids below kMaxN
constexpr int kPmax = 16;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;                 // node-loop iterations in flight

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
                  int n, int m_cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  u64* srt = reinterpret_cast<u64*>(smem);                   // [m_cap]
  int* starts = reinterpret_cast<int*>(smem);                // after the sort
  int* rank_s = reinterpret_cast<int*>(srt + m_cap);         // [n]
  __shared__ int red[kWarps];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
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
  int m = 1;
  while (m < max(nn, g)) m <<= 1;

  // ---- order: (key, id) words, the key's sign bit flipped so that the
  // words compare as the signed keys do ----
  for (int i0 = tid; i0 < m; i0 += kUnroll * kThreads) {
    int key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      key[u] = i < nn ? key_l[i] : kBig;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kThreads;
      if (i < m)
        srt[i] = i < n ? (static_cast<u64>(static_cast<unsigned>(key[u]) ^
                                           0x80000000u)
                          << kIdBits) |
                             static_cast<u64>(i)
                       : ~0ull;
    }
  }
  __syncthreads();
  bitonic_sort(srt, m);

  // ---- grp_pos and the group sizes in order: thread tid takes the
  // consecutive positions [tid * per, tid * per + per) ----
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
  __syncthreads();

  // ---- node ranks (four nodes a thread at a time) ----
  for (int v0 = tid; v0 < n; v0 += kUnroll * kThreads) {
    int ld[kUnroll], mi[kUnroll], pos[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      ld[u] = v < nn ? gl_l[v] : 0;
      mi[u] = v < nn ? mi_l[v] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      pos[u] = v0 + u * kThreads < nn ? clampn(gp_l[clampn(ld[u], n)], n) : 0;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= n) continue;
      const int rk =
          v < nn ? (pos[u] < g ? starts[pos[u]] : total) + mi[u] : n;
      rank_s[v] = rk;
      nr_l[v] = rk;
    }
  }
  __syncthreads();
  for (int v = tid; v < nn; v += kThreads) {
    const int rk = rank_s[v];
    if (rk >= 0 && rk < n) perm_l[rk] = v;
  }
  __syncthreads();

  // ---- the next step's rank-space inputs: a thread a rank, its node's
  // predecessor row (64 bytes) in four loads, two ranks in flight ----
  const int4* pr4 = reinterpret_cast<const int4*>(pr_l);
  int4* prw4 = reinterpret_cast<int4*>(pred_rows +
                                       static_cast<size_t>(lane) * n * kPmax);
  for (int r0 = tid; r0 < nn; r0 += 2 * kThreads) {
    int v[2];
    int4 row[2][kPmax / 4];
#pragma unroll
    for (int u = 0; u < 2; ++u)
      v[u] = r0 + u * kThreads < nn ? clampn(perm_l[r0 + u * kThreads], n) : 0;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int c = 0; c < kPmax / 4; ++c)
        row[u][c] = pr4[static_cast<size_t>(v[u]) * (kPmax / 4) + c];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int rr = r0 + u * kThreads;
      if (rr >= nn) continue;
      letters_r[static_cast<size_t>(lane) * n + rr] = let_l[v[u]];
      npred_r[static_cast<size_t>(lane) * n + rr] = max(np_l[v[u]], 1);
#pragma unroll
      for (int c = 0; c < kPmax / 4; ++c) {
        const int4 p = row[u][c];
        auto to_row = [&](int x) {
          return x >= 0 ? rank_s[min(x, n - 1)] + 1 : 0;
        };
        prw4[static_cast<size_t>(rr) * (kPmax / 4) + c] =
            make_int4(to_row(p.x), to_row(p.y), to_row(p.z), to_row(p.w));
      }
    }
  }
}

}  // namespace

// The pack engine's state after poa_thread (ops/kernels.py::poa_rerank),
// every array contiguous int32: keys, grp_size, grp_leader, member_idx,
// npred, letters, grp_pos, perm [b, n + 1]; preds [b, n + 1, 16]; n_nodes,
// n_groups [b]; outputs node_rank [b, n], pred_rows [b, n, 16], npred_r,
// letters_r [b, n].  n <= 16384.  Launches one CTA a lane with 12 n bytes of
// dynamic shared memory (n rounded up to a power of two for the sort) on
// ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int poa_rerank_launch(
    const void* keys, const void* grp_size, const void* grp_leader,
    const void* member_idx, const void* preds, const void* npred,
    const void* letters, const void* n_nodes, const void* n_groups,
    void* grp_pos, void* perm, void* node_rank, void* pred_rows,
    void* npred_r, void* letters_r, int b, int n, void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || n > kMaxN) return static_cast<int>(cudaErrorInvalidValue);
  int m_cap = 1;
  while (m_cap < n) m_cap <<= 1;
  const size_t smem = static_cast<size_t>(m_cap) * sizeof(u64) +
                      static_cast<size_t>(n) * sizeof(int);
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
      static_cast<int32_t*>(letters_r), n, m_cap);
  return static_cast<int>(cudaGetLastError());
}
