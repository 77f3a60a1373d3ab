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
// not bytes.  One CTA a lane, sized to the step's width w: 256, 512 or
// 1,024 threads at w <= 1,024, 2,048 or 4,096, four consecutive positions a
// thread, so that no thread is idle at the narrow steps and more lanes share
// an SM to hide the gathers' latency.  Each scan is a thread-local pass, a
// warp pass by shuffles and one barrier, after which every warp reads all
// warps' totals: the new-node count alone, then the suffix minimum, prefix
// maximum, OR and sum of the keys and counters together in one pass.  Every
// gather reads the state as it was before the step's scatters, as JAX's
// functional code does: all gathers come first, and the last scan's barrier
// comes between them and the scatters.  The scatters are conflict-free
// within a lane by construction (a read's path meets each group once and
// each node once), the two counters they bump are atomics, and a write the
// plain version masks into the spare slot is not made.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxW = 4096;
constexpr int kPer = 4;                 // positions a thread, consecutive
constexpr int kPmax = 16;               // predecessor slots a node
constexpr int kGa = 8;                  // members a group
constexpr int kSk = 4096;               // key stride of the re-rank
constexpr int kHalf = kSk - 1;
constexpr int kBig = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int clampn(int x, int n) {
  return min(max(x, 0), n - 1);
}

// Exclusive sum of one value a thread over the block in thread order;
// ``total`` takes the sum.  ``red`` [32] is this call's alone; one barrier.
template <int kT>
__device__ int excl_sum(int v, int* red, int& total) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (wl >= d) x += y;
  }
  if (wl == 31) red[warp] = x;
  __syncthreads();
  const int t = wl < kT / 32 ? red[wl] : 0;
  int y = t;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int z = __shfl_up_sync(kFull, y, d);
    if (wl >= d) y += z;
  }
  total = __shfl_sync(kFull, y, 31);
  return __shfl_sync(kFull, y - t, warp) + x - v;
}

// One pass of four block scans in thread order: ``smin`` takes the minimum
// of ``vmin`` over the later threads (kBig if none), ``pmax`` the maximum of
// ``vmax`` over the earlier ones (-1 if none), ``all_or`` and ``all_sum``
// the OR and the sum over every thread.  ``red`` [4][32] is this call's
// alone; one barrier.
template <int kT>
__device__ void scan4(int vmin, int vmax, int vor, int vsum, int (*red)[32],
                      int& smin, int& pmax, int& all_or, int& all_sum) {
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int mn = vmin, mx = vmax, o = vor, sm = vsum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int zn = __shfl_down_sync(kFull, mn, d);
    const int zx = __shfl_up_sync(kFull, mx, d);
    if (wl + d < 32) mn = min(mn, zn);
    if (wl >= d) mx = max(mx, zx);
    o |= __shfl_xor_sync(kFull, o, d);
    sm += __shfl_xor_sync(kFull, sm, d);
  }
  int mn_after = __shfl_down_sync(kFull, mn, 1);
  int mx_before = __shfl_up_sync(kFull, mx, 1);
  if (wl == 31) mn_after = kBig;
  if (wl == 0) mx_before = -1;
  if (wl == 0) {
    red[0][warp] = mn;  // the warp's minimum
    red[2][warp] = o;
    red[3][warp] = sm;
  }
  if (wl == 31) red[1][warp] = mx;  // the warp's maximum
  __syncthreads();
  const bool in = wl < kT / 32;
  int wn = in ? red[0][wl] : kBig, wx = in ? red[1][wl] : -1;
  int wo = in ? red[2][wl] : 0, ws = in ? red[3][wl] : 0;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int zn = __shfl_down_sync(kFull, wn, d);
    const int zx = __shfl_up_sync(kFull, wx, d);
    if (wl + d < 32) wn = min(wn, zn);
    if (wl >= d) wx = max(wx, zx);
    wo |= __shfl_xor_sync(kFull, wo, d);
    ws += __shfl_xor_sync(kFull, ws, d);
  }
  int wn_after = __shfl_down_sync(kFull, wn, 1);
  int wx_before = __shfl_up_sync(kFull, wx, 1);
  if (wl == 31) wn_after = kBig;
  if (wl == 0) wx_before = -1;
  smin = min(mn_after, __shfl_sync(kFull, wn_after, warp));
  pmax = max(mx_before, __shfl_sync(kFull, wx_before, warp));
  all_or = wo;
  all_sum = ws;
}

// position flags
constexpr int kNew = 1, kPure = 2, kAdd = 4, kPlaced = 8;

template <int kT>
__global__ void __launch_bounds__(kT)
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
  constexpr int kU = 4096 / kT;  // node-loop iterations in flight
  __shared__ int m_rank_s[kT * kPer];
  __shared__ int target_s[kT * kPer];
  __shared__ int red_new[32];
  __shared__ int red4[4][32];

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
  // the step's own inputs, loaded before the old keys' loop so that their
  // latency overlaps it: the read's length and offset, the moves, the bases
  const size_t row = static_cast<size_t>(lane) * r + t;
  const int len = lens[row];
  const int off = offsets[row];
  const int moves = best[lane] > 0 ? tlen[lane] : 0;
  const int32_t* pk = packed + static_cast<size_t>(lane) * w;
  const uint8_t* seq_l = seqs + row * wf;
  const int p0 = tid * kPer;
  int mv[kPer], seq_c[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = tid + q * kT;
    mv[q] = k < w ? pk[k] : 0;
    seq_c[q] = p0 + q < w ? seq_l[p0 + q] : 0;
  }

  // keys of the nodes before this step: a group's leader at its position
  // (kU nodes a thread at a time, their loads in flight together)
  const int nk = min(max(nn_old, 0), n);
  for (int id0 = tid; id0 < nk; id0 += kU * kT) {
    int gl[kU], gp[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int id = id0 + u * kT;
      gl[u] = id < nk ? gl_l[id] : -1;
      gp[u] = id < nk ? gp_l[id] : 0;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int id = id0 + u * kT;
      if (id < nk)
        key_l[id] = gl[u] == id ? static_cast<int>(
                                      static_cast<unsigned>(gp[u]) * kSk +
                                      kHalf)
                                : kBig;
    }
  }
  if (!active) return;  // uniform: nothing else changes

  const int lim = max(0, min(len, w));  // positions that take a base

  // ---- decode: the moves' matched rank at each position ----
  for (int p = tid; p < w; p += kT) m_rank_s[p] = -1;
  __syncthreads();
  if (nn_old > 0) {
    const int cnt = min(moves, w);
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int pos = (mv[q] & 0xFFFF) - 1;
      if (tid + q * kT < cnt && pos >= 0 && pos < w)
        m_rank_s[pos] = (mv[q] >> 16) - 1;
    }
  }
  __syncthreads();

  // ---- gathers: every read of the state before any write ----
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
      const int c = seq_c[q];
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
  int run = excl_sum<kT>(n_local, red_new, n_new);
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
  // (its barrier also ends every gather: only scatters follow)
  int gnext, lastp, flags_all, pure_all;
  scan4<kT>(gmin, pmax, bad, n_pure, red4, gnext, lastp, flags_all,
            pure_all);
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
// lane of w / 4 threads, w rounded up to 1,024, 2,048 or 4,096, on
// ``stream`` and returns cudaGetLastError() (0 on success).
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
  // the CTA sized to the step's width: four positions a thread
  auto* kernel = w <= 1024   ? poa_thread_kernel<256>
                 : w <= 2048 ? poa_thread_kernel<512>
                             : poa_thread_kernel<1024>;
  const int threads = w <= 1024 ? 256 : w <= 2048 ? 512 : 1024;
  kernel<<<b, threads, 0, static_cast<cudaStream_t>(stream)>>>(
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
