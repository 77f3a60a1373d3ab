// poa_thread: the read of step t of every lane threaded into its graph, from
// poa_align's traceback, then the keys of the incremental re-rank.
//
// Replaces the middle of rattle_tpu/correct/pack_engine.py::_step (a part of
// one jitted program there), from poa_align_pallas's outputs to the keys of
// the stable sort; the eager port ran the whole step as some 260 small
// launches.
// The executable spec is ops/kernels.py::poa_thread_plain.
//
// Per lane, over the step's positions p < w (read base p; valid below the
// read's length):
//   decode   m_rank[p] from the traceback's moves, m_node = perm[m_rank];
//   match    the node itself if its letter is the base, else the first
//            member of its aligned group with that letter, else a new node
//            (new ids in path order: an exclusive scan);
//   thread   new nodes' letters, leaders and member slots, a joined group's
//            member list and size, an edge from the previous position's
//            node where it is missing, the path;
//   keys     old leaders at grp_pos * SK + HALF; a new group's leader at
//            gnext * SK + min(run, HALF - 1), gnext the group position of
//            the next placed position (a suffix minimum), run its index in
//            its run of new groups (a prefix maximum of placed positions).
//
// Bound and design.  A step is a chain of dependent gathers a position
// (rank -> node -> leader -> group -> members -> their letters) and a few
// block scans, on at most 4,096 positions and the lane's old nodes: latency,
// not bytes.  One CTA of 1,024 threads a lane, four consecutive positions a
// thread, so each scan is a thread-local pass and one block scan (warp
// shuffles and a row of warp totals).  Every gather reads the state as it was
// before the step's scatters, as JAX's functional code does: all gathers come
// first, then a barrier, then the scatters.  The scatters are conflict-free
// within a lane by construction (a read's path meets each group once and
// each node once), the two counters they bump are atomics, and a write the
// plain version masks into the spare slot is not made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 4096;
constexpr int kPer = kMaxW / kThreads;  // positions a thread, consecutive
constexpr int kPmax = 16;               // predecessor slots a node
constexpr int kGa = 8;                  // members a group
constexpr int kSk = 4096;               // key stride of the re-rank
constexpr int kHalf = kSk - 1;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUnroll = 4;              // node-loop iterations in flight

struct Sum {
  __device__ int operator()(int a, int b) const { return a + b; }
};
struct Min {
  __device__ int operator()(int a, int b) const { return min(a, b); }
};
struct Max {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct Or {
  __device__ int operator()(int a, int b) const { return a | b; }
};

// Exclusive scan of one value a thread over the block in thread order (kRev:
// in reverse order, a suffix scan), ``id`` the identity of ``op``; ``total``
// takes ``op`` over every thread.  ``red`` holds kWarps ints; the call starts
// with a barrier, so calls may follow each other directly.
template <bool kRev, class Op>
__device__ int block_scan(int v, int id, Op op, int* red, int& total) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = kRev ? __shfl_down_sync(kFull, x, d)
                       : __shfl_up_sync(kFull, x, d);
    if (kRev ? wl + d < 32 : wl >= d) x = op(x, y);
  }
  int ex = kRev ? __shfl_down_sync(kFull, x, 1) : __shfl_up_sync(kFull, x, 1);
  if (kRev ? wl == 31 : wl == 0) ex = id;
  __syncthreads();  // a previous call's readers are done with red
  if (kRev ? wl == 0 : wl == 31) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = red[wl];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = kRev ? __shfl_down_sync(kFull, s, d)
                         : __shfl_up_sync(kFull, s, d);
      if (kRev ? wl + d < 32 : wl >= d) s = op(s, y);
    }
    red[wl] = s;  // inclusive over warps
  }
  __syncthreads();
  total = kRev ? red[0] : red[kWarps - 1];
  const int before = kRev ? (warp + 1 < kWarps ? red[warp + 1] : id)
                          : (warp > 0 ? red[warp - 1] : id);
  return op(before, ex);
}

__device__ __forceinline__ int clampn(int x, int n) {
  return min(max(x, 0), n - 1);
}

// position flags
constexpr int kNew = 1, kPure = 2, kAdd = 4, kPlaced = 8;

__global__ void __launch_bounds__(kThreads)
poa_thread_kernel(const uint8_t* __restrict__ seqs,     // [B, R, WF]
                  const int32_t* __restrict__ lens,     // [B, R]
                  const int32_t* __restrict__ offsets,  // [B, R]
                  const int32_t* __restrict__ n_reads,  // [B]
                  int32_t* letters, int32_t* npred,     // [B, N + 1]
                  int32_t* preds,                       // [B, N + 1, 16]
                  int32_t* grp_leader, int32_t* member_idx,
                  int32_t* grp_size,                    // [B, N + 1]
                  int32_t* members,                     // [B, N + 1, 8]
                  const int32_t* __restrict__ grp_pos,  // [B, N + 1]
                  const int32_t* __restrict__ perm,     // [B, N + 1]
                  int32_t* path,                        // [B, T + 1]
                  int32_t* keys,                        // [B, N + 1]
                  int32_t* n_nodes, int32_t* n_groups, int32_t* fallback,
                  const int32_t* __restrict__ packed,   // [B, W]
                  const int32_t* __restrict__ tlen,
                  const int32_t* __restrict__ best,     // [B]
                  int r, int wf, int n, int tot, int t, int w) {
  __shared__ int m_rank_s[kMaxW];
  __shared__ int target_s[kMaxW];
  __shared__ int red[kWarps];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t n1 = static_cast<size_t>(n) + 1;
  int32_t* let_l = letters + lane * n1;
  int32_t* np_l = npred + lane * n1;
  int32_t* pr_l = preds + lane * n1 * kPmax;
  int32_t* gl_l = grp_leader + lane * n1;
  int32_t* mi_l = member_idx + lane * n1;
  int32_t* gs_l = grp_size + lane * n1;
  int32_t* mem_l = members + lane * n1 * kGa;
  const int32_t* gp_l = grp_pos + lane * n1;
  const int32_t* perm_l = perm + lane * n1;
  int32_t* key_l = keys + lane * n1;
  int32_t* path_l = path + lane * (static_cast<size_t>(tot) + 1);

  const int nn_old = n_nodes[lane];
  const int ng_old = n_groups[lane];
  const int fb = fallback[lane];
  const bool active = t < n_reads[lane] && fb == 0;

  // keys of the nodes before this step: a group's leader at its position
  // (four nodes a thread at a time, their loads in flight together)
  const int nk = min(max(nn_old, 0), n);
  for (int id0 = tid; id0 < nk; id0 += kUnroll * kThreads) {
    int gl[kUnroll], gp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int id = id0 + u * kThreads;
      gl[u] = id < nk ? gl_l[id] : -1;
      gp[u] = id < nk ? gp_l[id] : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int id = id0 + u * kThreads;
      if (id < nk)
        key_l[id] = gl[u] == id ? static_cast<int>(
                                      static_cast<unsigned>(gp[u]) * kSk +
                                      kHalf)
                                : kBig;
    }
  }
  if (!active) return;  // uniform: nothing else changes

  const size_t row = static_cast<size_t>(lane) * r + t;
  const int lim = max(0, min(lens[row], w));  // positions that take a base
  const int off = offsets[row];
  const uint8_t* seq_l = seqs + row * wf;

  // ---- decode: the moves' matched rank at each position ----
  for (int p = tid; p < w; p += kThreads) m_rank_s[p] = -1;
  __syncthreads();
  if (best[lane] > 0 && nn_old > 0) {
    const int cnt = min(tlen[lane], w);
    const int32_t* pk = packed + static_cast<size_t>(lane) * w;
    for (int k = tid; k < cnt; k += kThreads) {
      const int v = pk[k];
      const int pos = (v & 0xFFFF) - 1;
      if (pos >= 0 && pos < w) m_rank_s[pos] = (v >> 16) - 1;
    }
  }
  __syncthreads();

  // ---- gathers: every read of the state before any write ----
  const int p0 = tid * kPer;
  int base[kPer], lead[kPer], gsz[kPer], target[kPer];
  int flags[kPer];
  int n_local = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = p0 + q;
    base[q] = 0;
    lead[q] = 0;
    gsz[q] = 0;
    target[q] = -1;
    flags[q] = 0;
    if (p < lim) {
      const int c = seq_l[p];
      const int mr = m_rank_s[p];
      const int m = mr >= 0 ? clampn(perm_l[min(mr, n - 1)], n) : -1;
      const int mc = max(m, 0);
      const bool direct = m >= 0 && let_l[mc] == c;
      const int ld = gl_l[mc];
      const int lc = clampn(ld, n);
      const int g = gs_l[lc];
      int matched = direct ? m : -1;
      if (m >= 0 && !direct) {
        // the group's members (one 32-byte row), then all their letters
        const int4* mv = reinterpret_cast<const int4*>(
            mem_l + static_cast<size_t>(lc) * kGa);
        const int4 m0 = mv[0], m1 = mv[1];
        const int mem[kGa] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
        int ml[kGa];
#pragma unroll
        for (int k = 0; k < kGa; ++k)
          ml[k] = k < g && mem[k] >= 0 ? let_l[clampn(mem[k], n)] : -1;
#pragma unroll
        for (int k = kGa - 1; k >= 0; --k)
          if (ml[k] == c) matched = mem[k];  // the first such member wins
      }
      base[q] = c;
      lead[q] = ld;
      gsz[q] = g;
      target[q] = matched;
      if (matched < 0) {
        flags[q] = kNew | (m < 0 ? kPure : 0);
        ++n_local;
      }
    }
  }
  int n_new;
  int run = block_scan<false>(n_local, 0, Sum(), red, n_new);
  const bool overflow = nn_old + n_new > n;
  const bool ok = !overflow;
  int gmark[kPer], npr[kPer];
  int gmin = kBig, pmax = -1;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = p0 + q;
    gmark[q] = kBig;
    npr[q] = 0;
    if (p < lim) {
      int lead_all;
      if (flags[q] & kNew) {
        target[q] = nn_old + run++;
        lead_all = flags[q] & kPure ? target[q] : lead[q];
      } else {
        lead_all = gl_l[clampn(target[q], n)];
      }
      npr[q] = np_l[clampn(target[q], n)];
      if (ok && !(flags[q] & kPure)) {
        flags[q] |= kPlaced;
        gmark[q] = gp_l[clampn(lead_all, n)];
        gmin = min(gmin, gmark[q]);
        pmax = p;
      }
    }
    if (p < w) target_s[p] = target[q];
  }
  __syncthreads();
  int bad = 0, n_pure = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = p0 + q;
    if (!ok || p >= lim) continue;
    const int prevt = p >= 1 ? target_s[p - 1] : -1;
    if (p >= 1 && prevt >= 0 && prevt != target[q]) {
      // the target's predecessor row (64 bytes) in four loads
      const int4* tp = reinterpret_cast<const int4*>(
          pr_l + static_cast<size_t>(clampn(target[q], n)) * kPmax);
      const int np = npr[q];
      bool exists = false;
#pragma unroll
      for (int v = 0; v < kPmax / 4; ++v) {
        const int4 x = tp[v];
        const int k = 4 * v;
        exists |= (x.x == prevt && k < np) | (x.y == prevt && k + 1 < np) |
                  (x.z == prevt && k + 2 < np) | (x.w == prevt && k + 3 < np);
      }
      if (!exists) {
        flags[q] |= kAdd;
        if (npr[q] >= kPmax) bad |= 2;
      }
    }
    if ((flags[q] & (kNew | kPure)) == kNew && gsz[q] >= kGa) bad |= 4;
    if (flags[q] & kPure) ++n_pure;
  }

  // ---- the next placed group (suffix minimum) and the last placed
  // position (prefix maximum) of every position ----
  int unused;
  int gnext = block_scan<true>(gmin, kBig, Min(), red, unused);
  int lastp = block_scan<false>(pmax, -1, Max(), red, unused);
  int flags_all, pure_all;
  block_scan<false>(bad, 0, Or(), red, flags_all);
  block_scan<false>(n_pure, 0, Sum(), red, pure_all);
  int key[kPer];
#pragma unroll
  for (int q = kPer - 1; q >= 0; --q) {
    gnext = min(gnext, gmark[q]);
    key[q] = gnext;
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int p = p0 + q;
    if (flags[q] & kPlaced) lastp = p;
    const int gf = key[q] >= kBig ? ng_old : key[q];
    key[q] = static_cast<int>(static_cast<unsigned>(gf) * kSk +
                              min(max(p - lastp - 1, 0), kHalf - 1));
  }
  __syncthreads();  // every gather above is done before the first scatter

  // ---- scatters ----
  if (ok) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int p = p0 + q;
      if (p >= lim) continue;
      const int tg = target[q];
      const bool in = tg >= 0 && tg < n;
      const int f = flags[q];
      if ((f & kNew) && in) {
        const bool pure = f & kPure;
        let_l[tg] = base[q];
        gl_l[tg] = pure ? tg : lead[q];
        mi_l[tg] = pure ? 0 : gsz[q];
        key_l[tg] = pure ? key[q] : kBig;
        if (pure) {
          gs_l[tg] = 1;
          mem_l[static_cast<size_t>(tg) * kGa] = tg;
        }
      }
      if ((f & (kNew | kPure)) == kNew && lead[q] >= 0 && lead[q] < n) {
        const int g = gsz[q];
        mem_l[static_cast<size_t>(lead[q]) * kGa + min(max(g, 0), kGa - 1)] =
            g < kGa ? tg : -1;
        atomicAdd(gs_l + lead[q], 1);
      }
      if ((f & kAdd) && in) {
        const int k = npr[q];
        pr_l[static_cast<size_t>(tg) * kPmax + min(max(k, 0), kPmax - 1)] =
            k < kPmax ? target_s[p - 1] : -1;
        atomicAdd(np_l + tg, 1);
      }
      const long long at = static_cast<long long>(off) + p;
      if (at >= 0 && at < tot) path_l[at] = tg;
    }
  }
  if (tid == 0) {
    n_nodes[lane] = ok ? nn_old + n_new : nn_old;
    n_groups[lane] = ok ? ng_old + pure_all : ng_old;
    fallback[lane] = fb | (overflow ? 1 : 0) | flags_all;
  }
}

}  // namespace

// The pack engine's state (ops/kernels.py::poa_thread), every array
// contiguous int32 but seqs (uint8 [b, r, wf]): lens, offsets [b, r];
// n_reads, n_nodes, n_groups, fallback [b]; letters, npred, grp_leader,
// member_idx, grp_size, grp_pos, perm, keys [b, n + 1]; preds [b, n + 1, 16];
// members [b, n + 1, 8]; path [b, tot + 1]; poa_align's packed [b, w], tlen,
// best [b].  n <= 16384, w <= min(wf, 4096), 0 <= t < r.  Launches one CTA a
// lane on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int poa_thread_launch(
    const void* seqs, const void* lens, const void* offsets,
    const void* n_reads, void* letters, void* npred, void* preds,
    void* grp_leader, void* member_idx, void* grp_size, void* members,
    const void* grp_pos, const void* perm, void* path, void* keys,
    void* n_nodes, void* n_groups, void* fallback, const void* packed,
    const void* tlen, const void* best, int b, int r, int wf, int n, int tot,
    int t, int w, void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || n > 16384 || w < 1 || w > kMaxW || w > wf || t < 0 ||
      t >= r || tot < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  poa_thread_kernel<<<b, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seqs), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(offsets),
      static_cast<const int32_t*>(n_reads), static_cast<int32_t*>(letters),
      static_cast<int32_t*>(npred), static_cast<int32_t*>(preds),
      static_cast<int32_t*>(grp_leader), static_cast<int32_t*>(member_idx),
      static_cast<int32_t*>(grp_size), static_cast<int32_t*>(members),
      static_cast<const int32_t*>(grp_pos), static_cast<const int32_t*>(perm),
      static_cast<int32_t*>(path), static_cast<int32_t*>(keys),
      static_cast<int32_t*>(n_nodes), static_cast<int32_t*>(n_groups),
      static_cast<int32_t*>(fallback), static_cast<const int32_t*>(packed),
      static_cast<const int32_t*>(tlen), static_cast<const int32_t*>(best), r,
      wf, n, tot, t, w);
  return static_cast<int>(cudaGetLastError());
}
