// poa_align: local affine-gap alignment of one read per lane against a
// partial-order graph walked in topological-rank order, with traceback
// (correct.cpp:395-405; the executable spec is ops/poa.py::align_local).
//
// Replaces rattle_tpu/ops/poa_pallas.py::poa_align_pallas (_make_kernel).
// The TPU kernel interleaved a few lanes per program on one core, kept DP rows
// in VMEM rings flushed to HBM by DMA, translated predecessor nodes to ranks
// through a VMEM table and extracted scalars by masked reductions.  None of
// that carries over: predecessor rows arrive as row indices (the caller
// gathers them), and every lane of the batch runs at once on its own SMs.
//
// Per rank r (DP row x = r + 1; row 0 is the virtual start, H = 0, F = -inf):
//   a_h[j] = max_k H[pred_k][j]          (first maximum wins, k in edge order)
//   b_f[j] = max_k max(H[pred_k][j] + go, F[pred_k][j] + ge)
//   diag[j] = a_h[j-1] + sub(j),  A = max(diag, F, 0)
//   E[j] = ge*j + max_{j'<j}(A[j'] + go - ge*(j'+1)),  H = max(A, E)
//
// Bound and design.  A lane is a serial chain of rows, and a step of the
// pack engine lasts as long as its slowest lane, so what counts is the time
// a rank costs on that chain.  One SM issuing a row's integer work (about 32
// operations a cell) bounds a lane that it walks alone, so the rows are
// pipelined across warps and the columns spread over the SMs of a cluster:
// * A row is cut into tiles of 32 threads x C = 4 columns.  The tiles holding
//   the read's columns 0..len are split into contiguous runs, one per CTA of
//   the lane's cluster (S CTAs, one SM each: two full-width tiles a CTA, at
//   most 8, so S = 4 / 8 / 8 at W = 1024 / 2048 / 4096).  Inside a CTA of
//   K = 8 warps, warp g owns the ranks r = g (mod K) and walks its run of
//   each of those rows left to
//   right.  The E prefix maximum is a warp shuffle scan inside a tile plus a
//   carry in registers across tiles; the left column of the diagonal (a_h at
//   j0 - 1 and its predecessor) and the E-extend flag of a tile's first
//   column are carried the same way.  No block barrier remains on a row.
// * Between CTAs the same four carries of a rank travel through distributed
//   shared memory: the upstream CTA's warp writes them into one of Q slots of
//   the downstream CTA after its last tile of the rank (release, cluster
//   scope); the downstream warp waits for them before its first tile and
//   hands the slot back (an acknowledgement in the upstream CTA's memory).
// * Tiles form a wavefront: tile t of rank r starts once rank r - 1 has
//   published tile t in its CTA (a progress counter per warp in shared
//   memory, release / acquire at block scope), so every earlier rank has
//   published it too, and a rank never runs more than K ranks ahead of the
//   oldest one in flight.
// * The H and F rows of the last K ranks live in a shared-memory ring (slot
//   g for warp g's current rank, the CTA's columns only): K x (columns of a
//   CTA) x 4 bytes, dynamic shared memory.  The chain case and every
//   predecessor at most K ranks back are read from it; an older predecessor
//   row is read back from the global scratch, which keeps every row's H, F
//   and direction word (the traceback reads D).  The slot of rank r - K is
//   overwritten tile by tile by rank r, after rank r - 1, the laggard of the
//   ranks that may still read it, passed that tile.
// * The best cell is the first maximum in (row, column) order.  A thread sees
//   its cells in row-major order, so a strict `>` keeps its first maximum; a
//   reduction of (value << 32 | (0x7fffffff - row-major index)) keys over the
//   cluster picks the cell without any ordering.
// * The traceback is walked by warp 0 of CTA 0 in lockstep: the warp copies
//   into shared memory, in one round of independent loads, the direction
//   words of the next 32 rows along the path's diagonal (eight columns a row,
//   for gaps of a few bases) and those rows' predecessor lists, and walks from
//   there until the path leaves that window.
//
// Direction word (11 bits): bits 0-4 H source (0 stop, 1..16 diagonal through
// predecessor k-1, 17 F, 18 E; priority stop > diagonal > F > E), bits 5-8 the
// F predecessor index, bit 9 F-extend, bit 10 E-extend.
//
// Rows are int16 (ring and scratch): H lies in [0, 5*4095] and, at every
// column >= 1, F = max_k max(H + go, F + ge) >= go because H >= 0; column 0 of
// F is -inf (stored as -16384, which changes no decision).  Read bases are
// nonzero bytes.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPmax = 16;
constexpr int kMaxW = 4096;
constexpr int kWarps = 8;           // K: ranks in flight in a CTA
constexpr int kCols = 4;            // C: columns a thread
constexpr int kTile = 32 * kCols;   // columns a tile
constexpr int kMaxCtas = 8;
constexpr int kQ = 32;              // carry slots between two CTAs
constexpr int kNeg = -(1 << 30);
constexpr int kClamp16 = -16384;
constexpr int kTileBits = 6;        // progress = rank << 6 | tiles published
constexpr int kWindowBytes = 32 * 8 * 2 + 32 * kPmax * 4;
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct alignas(sizeof(T) * kCols) Vec {
  T v[kCols];
};

// a thread's four 16-bit values stored as one 8-byte vector
template <typename T>
__device__ __forceinline__ void store_vec(T* p, const Vec<T>& v) {
  const auto u = [&](int i) {
    return static_cast<uint32_t>(static_cast<uint16_t>(v.v[i]));
  };
  *reinterpret_cast<uint2*>(p) =
      make_uint2(u(0) | u(1) << 16, u(2) | u(3) << 16);
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the address of the same shared variable in CTA ``rank`` of the cluster
__device__ __forceinline__ uint32_t remote(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_remote(uint32_t addr, int v) {
  asm volatile("st.relaxed.cluster.shared::cluster.b32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_remote_release(uint32_t addr, int v) {
  asm volatile("st.release.cluster.shared::cluster.b32 [%0], %1;"
               :: "r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_remote64(uint32_t addr, long long v) {
  asm volatile("st.relaxed.cluster.shared::cluster.b64 [%0], %1;"
               :: "r"(addr), "l"(v) : "memory");
}

__device__ __forceinline__ int ld_acquire_cluster(const int* p) {
  int v;
  asm volatile("ld.acquire.cluster.shared::cta.b32 %0, [%1];"
               : "=r"(v) : "r"(smem_addr(p)) : "memory");
  return v;
}

// a wait that outlasts any real one (seconds) is a fault: stop the kernel
// with an error instead of spinning forever
__device__ __forceinline__ void spin_guard(unsigned& n) {
  if (++n > (1u << 28)) __trap();
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;" ::: "memory");
}

// shared memory of one CTA: keys, progress, carry slots, then the H and F
// rings (K x ``seg`` columns each) and the read; the traceback window reuses
// the rings
constexpr size_t kRing =
    (kWarps * 12 + kMaxCtas * 8 + kQ * 24 + 15) / 16 * 16;

__host__ __device__ inline size_t smem_bytes(int seg, int w) {
  const size_t rows = static_cast<size_t>(kWarps) * seg * 4 + w;
  return kRing + (rows > kWindowBytes ? rows : kWindowBytes);
}

// CTAs a lane: two tiles of a full-width row each, at most 8
__host__ __device__ inline int lane_ctas(int w) {
  return min(kMaxCtas, max(1, w / kTile / 2));
}

// columns a CTA holds: its share of a full-width row's tiles (w is a
// multiple of kTile, and a lane's ntiles <= w / kTile)
__host__ __device__ inline int seg_cols(int w, int ctas) {
  return (w / kTile + ctas - 1) / ctas * kTile;
}

__global__ void __launch_bounds__(kWarps * 32)
poa_align_kernel(const int32_t* __restrict__ pred_rows,  // [B, N, 16]
                 const int32_t* __restrict__ npred,      // [B, N]
                 const int32_t* __restrict__ letters,    // [B, N]
                 const int32_t* __restrict__ n_nodes,    // [B]
                 const uint8_t* __restrict__ seq,        // [B, W], rows seq_ld
                 const int32_t* __restrict__ seq_len,    // [B], stride len_ld
                 const int32_t* __restrict__ n_reads,    // [B]
                 const int32_t* __restrict__ fallback,   // [B]
                 int step, long long seq_ld, int len_ld, int n, int w,
                 int match, int mismatch, int go, int ge,
                 short* H, short* F, unsigned short* D,  // [B, N + 1, W]
                 int32_t* __restrict__ packed,           // [B, W]
                 int32_t* __restrict__ tlen, int32_t* __restrict__ best,
                 int ctas, long long* __restrict__ stamps) {  // [B, 3] or null
  extern __shared__ __align__(16) unsigned char smem[];
  const int seg = seg_cols(w, ctas);
  long long* sh_key = reinterpret_cast<long long*>(smem);
  long long* cl_key = sh_key + kWarps;    // [kMaxCtas], CTA 0's
  int* prog = reinterpret_cast<int*>(cl_key + kMaxCtas);
  int* cin = prog + kWarps;               // [kQ][4] carries in
  int* cin_tag = cin + 4 * kQ;            // rank + 1 when filled
  int* ack_tag = cin_tag + kQ;            // consumed, downstream
  short* ring_h = reinterpret_cast<short*>(smem + kRing);
  short* ring_f = ring_h + static_cast<size_t>(kWarps) * seg;
  uint8_t* sseq = reinterpret_cast<uint8_t*>(ring_f +
                                             static_cast<size_t>(kWarps) * seg);

  const int lane = blockIdx.x / ctas;
  const int cta = blockIdx.x % ctas;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;

  const int nn = min(n_nodes[lane], n);
  const int slen = min(seq_len[static_cast<size_t>(lane) * len_ld], w - 1);
  // the pack engine's step: the lane aligns while it has reads and has not
  // fallen back
  const bool live = step < n_reads[lane] && fallback[lane] == 0;
  if (!live || nn <= 0) {   // uniform over the cluster
    if (tid == 0 && cta == 0) {
      tlen[lane] = 0;
      best[lane] = 0;
    }
    return;
  }
  if (stamps != nullptr && tid == 0 && cta == 0)
    stamps[lane * 3] = global_ns();

  const size_t lane_rows = static_cast<size_t>(lane) * (n + 1);
  short* Hl = H + lane_rows * w;
  short* Fl = F + lane_rows * w;
  unsigned short* Dl = D + lane_rows * w;
  const int32_t* pr_l = pred_rows + static_cast<size_t>(lane) * n * kPmax;
  const int32_t* np_l = npred + static_cast<size_t>(lane) * n;
  const int32_t* let_l = letters + static_cast<size_t>(lane) * n;

  // this CTA's run of tiles [t_lo, t_hi) of the ntiles holding columns
  // 0..slen, and the CTAs with the runs left and right of it (-1: none)
  const int ntiles = slen / kTile + 1;
  auto run_lo = [&](int c) { return c * ntiles / ctas; };
  const int t_lo = run_lo(cta), t_hi = run_lo(cta + 1);
  int up = -1, down = -1;
  for (int c = 0; c < ctas; ++c) {
    if (run_lo(c) == run_lo(c + 1)) continue;
    if (c < cta) up = c;
    if (c > cta && down < 0) down = c;
  }

  // column j holds read base j - 1; 0 marks a masked column (j = 0, j > len)
  for (int j = tid; j < w; j += blockDim.x)
    sseq[j] = (j >= 1 && j <= slen) ? seq[lane * seq_ld + j - 1]
                                    : 0;
  if (tid < kWarps) prog[tid] = 0;
  for (int q = tid; q < kQ; q += blockDim.x) {
    cin_tag[q] = 0;
    ack_tag[q] = q + 1 - kQ;
  }
  cluster_sync();   // every CTA initialised before any remote store

  const int prev_slot = (warp + kWarps - 1) % kWarps;
  // this thread's first maximum and its row-major index (x * 4096 + j)
  int best_v = 0, best_i = 0;

  // a rank's scalars, one per lane: lanes 0-15 its predecessor rows, lane 16
  // its predecessor count, lane 17 its letter
  auto fetch_rank = [&](int r) -> int {
    if (r >= nn) return 0;
    if (wl < kPmax) return pr_l[static_cast<size_t>(r) * kPmax + wl];
    if (wl == kPmax) return np_l[r];
    if (wl == kPmax + 1) return let_l[r];
    return 0;
  };

  int cur = fetch_rank(warp);
  for (int r = t_lo < t_hi ? warp : nn; r < nn; r += kWarps) {
    const int nxt = fetch_rank(r + kWarps);   // ahead of this row's work
    const int np = min(max(__shfl_sync(kFull, cur, kPmax), 1), kPmax);
    const int letter = __shfl_sync(kFull, cur, kPmax + 1);
    const int x = r + 1;
    // where lane k's predecessor row lives: -1 the virtual start row, a slot
    // of the ring (< K), or K + its row in the global scratch
    int my_src = -1;
    if (wl < np && cur > 0 && cur <= r)
      my_src = x - cur <= kWarps ? (cur - 1) % kWarps : kWarps + cur;
    short* my_h = ring_h + static_cast<size_t>(warp) * seg;
    short* my_f = ring_f + static_cast<size_t>(warp) * seg;
    const int q = r % kQ;

    // carries into the run's first tile: a_h and its predecessor + 1 at the
    // column left of the tile, the max scan term left of it, and the E-extend
    // flag of its first column
    int ah_left = kNeg, argh_left = 1, e_carry = kNeg, flag_left = 0;
    if (up >= 0) {
      unsigned spins = 0;
      while (ld_acquire_cluster(cin_tag + q) != r + 1) spin_guard(spins);
      ah_left = cin[4 * q];
      argh_left = cin[4 * q + 1];
      e_carry = cin[4 * q + 2];
      flag_left = cin[4 * q + 3];
      __syncwarp();
      if (wl == 0) st_remote_release(remote(ack_tag + q, up), r + 1);
    }

    for (int t = t_lo; t < t_hi; ++t) {
      const int j0 = t * kTile + wl * kCols;
      const int lj = (t - t_lo) * kTile + wl * kCols;   // column in the ring
      if (r > 0) {   // rank r - 1 has published tile t: so has every earlier
        cuda::atomic_ref<int, cuda::thread_scope_block> p(prog[prev_slot]);
        const int need = ((r - 1) << kTileBits) + (t - t_lo) + 1;
        unsigned spins = 0;
        while (p.load(cuda::memory_order_acquire) < need) spin_guard(spins);
      }

      // a_h (first maximum), its predecessor + 1, b_f, and the F bits of the
      // direction word (predecessor << 5 | extend << 9)
      int a_h[kCols], arg1[kCols], b_f[kCols], fbits[kCols];
      for (int k = 0; k < np; ++k) {
        const int src = __shfl_sync(kFull, my_src, k);
        int hl[kCols], fl[kCols];
        if (src < 0) {   // the virtual start row
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            hl[c] = 0;
            fl[c] = kNeg;
          }
        } else {
          const short* hp;
          const short* fp;
          if (src < kWarps) {   // at most K ranks back: in the ring
            const size_t o = static_cast<size_t>(src) * seg + lj;
            hp = ring_h + o;
            fp = ring_f + o;
          } else {
            const size_t o = static_cast<size_t>(src - kWarps) * w + j0;
            hp = Hl + o;
            fp = Fl + o;
          }
          const Vec<short> hv = *reinterpret_cast<const Vec<short>*>(hp);
          const Vec<short> fv = *reinterpret_cast<const Vec<short>*>(fp);
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            hl[c] = hv.v[c];
            fl[c] = fv.v[c];
          }
        }
        if (k == 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int ho = hl[c] + go, fe = fl[c] + ge;
            a_h[c] = hl[c];
            arg1[c] = 1;
            b_f[c] = max(ho, fe);
            fbits[c] = fe >= ho ? 1 << 9 : 0;
          }
        } else {
          const int kbits = k << 5;
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const bool hgt = hl[c] > a_h[c];
            a_h[c] = hgt ? hl[c] : a_h[c];
            arg1[c] = hgt ? k + 1 : arg1[c];
            const int ho = hl[c] + go, fe = fl[c] + ge;
            const int fk = max(ho, fe);
            const bool fgt = fk > b_f[c];
            b_f[c] = fgt ? fk : b_f[c];
            const int fb = fe >= ho ? kbits | (1 << 9) : kbits;
            fbits[c] = fgt ? fb : fbits[c];
          }
        }
      }
      if (j0 == 0) b_f[0] = kNeg;   // F at column 0 is -inf

      // a_h and its argument at column j0 - 1: the left lane's last column,
      // or the carry for lane 0
      int up_h = __shfl_up_sync(kFull, a_h[kCols - 1], 1);
      int up_arg = __shfl_up_sync(kFull, arg1[kCols - 1], 1);
      if (wl == 0) {
        up_h = ah_left;
        up_arg = argh_left;
      }
      ah_left = __shfl_sync(kFull, a_h[kCols - 1], 31);
      argh_left = __shfl_sync(kFull, arg1[kCols - 1], 31);

      const Vec<uint8_t> sv = *reinterpret_cast<const Vec<uint8_t>*>(sseq + j0);
      int a[kCols], diag[kCols], l[kCols];
      int run = kNeg;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int s = sv.v[c];
        int sub = s == letter ? match : mismatch;
        sub = s == 0 ? kNeg : sub;
        diag[c] = (c == 0 ? up_h : a_h[c - 1]) + sub;
        a[c] = max(max(diag[c], b_f[c]), 0);
        run = max(run, a[c] + go - ge * (j0 + c + 1));
        l[c] = run;
      }

      // exclusive prefix maximum of the scan terms left of this thread
      int incl = run;
#pragma unroll
      for (int s = 1; s < 32; s <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, s);
        if (wl >= s) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(kFull, incl, 1);
      if (wl == 0) excl = kNeg;
      excl = max(excl, e_carry);
      e_carry = max(e_carry, __shfl_sync(kFull, incl, 31));

      int rm1[kCols + 1];   // rm1[c] = max of the scan terms at j' < j0 + c
      rm1[0] = excl;
#pragma unroll
      for (int c = 0; c < kCols; ++c) rm1[c + 1] = max(excl, l[c]);
      // E-extend: E[j] == E[j-1] + ge  <=>  the running maximum did not rise
      // at j - 1; column j0 takes it from the left lane (or the carry).  At
      // j = 0, 1 the scan makes it 0 by itself (rm1 = -inf, then a term).
      const int my_flag = rm1[kCols] == rm1[kCols - 1];
      int left_flag = __shfl_up_sync(kFull, my_flag, 1);
      if (wl == 0) left_flag = flag_left;
      flag_left = __shfl_sync(kFull, my_flag, 31);

      Vec<short> hs, fs;
      Vec<unsigned short> ds;
      int tile_v = 0, tile_j = 0;   // the tile's first maximum in this thread
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int e = ge * (j0 + c) + rm1[c];
        const int h = max(a[c], e);
        // h != 0 that is neither diag nor F is E (h = max(diag, F, 0, E))
        int dir = b_f[c] == h ? kPmax + 1 : kPmax + 2;
        dir = diag[c] == h ? (c == 0 ? up_arg : arg1[c - 1]) : dir;
        dir = h == 0 ? 0 : dir;
        const bool eext = c == 0 ? left_flag != 0 : rm1[c] == rm1[c - 1];
        ds.v[c] = static_cast<unsigned short>(dir | fbits[c] |
                                              (eext ? 1 << 10 : 0));
        const bool better = sv.v[c] != 0 && h > tile_v;   // masked columns out
        tile_v = better ? h : tile_v;
        tile_j = better ? j0 + c : tile_j;
        hs.v[c] = static_cast<short>(h);
        fs.v[c] = static_cast<short>(b_f[c]);
      }
      if (j0 == 0) fs.v[0] = kClamp16;
      const bool better = tile_v > best_v;
      best_v = better ? tile_v : best_v;
      best_i = better ? x * kMaxW + tile_j : best_i;
      store_vec(my_h + lj, hs);
      store_vec(my_f + lj, fs);
      __syncwarp();
      if (wl == 0) {
        cuda::atomic_ref<int, cuda::thread_scope_block> p(prog[warp]);
        p.store((r << kTileBits) + (t - t_lo) + 1, cuda::memory_order_release);
      }
      const size_t off = static_cast<size_t>(x) * w + j0;
      store_vec(Hl + off, hs);
      store_vec(Fl + off, fs);
      store_vec(Dl + off, ds);
    }

    if (down >= 0 && wl == 0) {   // hand this rank's carries downstream
      unsigned spins = 0;
      while (ld_acquire_cluster(ack_tag + q) != r + 1 - kQ) spin_guard(spins);
      const uint32_t dst = remote(cin + 4 * q, down);
      st_remote(dst, ah_left);
      st_remote(dst + 4, argh_left);
      st_remote(dst + 8, e_carry);
      st_remote(dst + 12, flag_left);
      st_remote_release(remote(cin_tag + q, down), r + 1);
    }
    __syncwarp();
    cur = nxt;
  }

  // first maximum in (row, column) order: largest value, then the smallest
  // row-major index
  long long key = best_v > 0 ? (static_cast<long long>(best_v) << 32) |
                                   static_cast<long long>(0x7fffffff - best_i)
                             : 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    key = max(key, __shfl_xor_sync(kFull, key, s));
  if (wl == 0) sh_key[warp] = key;
  __syncthreads();
  if (tid == 0) {
    for (int g = 1; g < kWarps; ++g) key = max(key, sh_key[g]);
    st_remote64(remote(cl_key + cta, 0), key);
  }
  // every CTA's rows (D included) and key are visible to CTA 0 after this
  cluster_sync();
  if (cta != 0) return;
  if (stamps != nullptr && tid == 0) stamps[lane * 3 + 1] = global_ns();
  if (warp != 0) return;
  key = 0;
  for (int c = 0; c < ctas; ++c) key = max(key, cl_key[c]);

  // the traceback window in shared memory (the rings are free now): row
  // r0 - i at columns jw - i - 4 .. jw - i + 3, and its predecessor rows
  unsigned short* win_d = reinterpret_cast<unsigned short*>(ring_h);  // [32][8]
  int* win_p = reinterpret_cast<int*>(ring_h + 32 * 8);              // [32][16]
  const int score = static_cast<int>(key >> 32);
  int t = 0;
  if (score > 0) {
    const int idx = 0x7fffffff - static_cast<int>(key & 0x7fffffff);
    int r = idx / kMaxW, j = idx % kMaxW;
    int state = 0;   // 0 = H, 1 = E, 2 = F, 3 = done
    int r0 = -1, jw = 0;
    while (state != 3 && r > 0) {
      int i = r0 - r;
      int o = (jw - j) - i;   // column offset from the window's diagonal
      if (r0 < 0 || i < 0 || i >= 32 || o < -3 || o > 4) {
        r0 = r;
        jw = j;
        i = 0;
        o = 0;
        const int rk = r - wl;
        __syncwarp();
        if (rk >= 1) {
          const unsigned short* drow = Dl + static_cast<size_t>(rk) * w;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const int jk = j - wl - 4 + c;
            win_d[wl * 8 + c] = (jk >= 0 && jk < w) ? drow[jk] : 0;
          }
          const int4* prow4 = reinterpret_cast<const int4*>(
              pr_l + static_cast<size_t>(rk - 1) * kPmax);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            reinterpret_cast<int4*>(win_p + wl * kPmax)[c] = prow4[c];
        }
        __syncwarp();
      }
      const int d = win_d[i * 8 + 4 - o];
      const int* prow = win_p + i * kPmax;
      if (state == 0) {
        const int dh = d & 31;
        if (dh == 0) {
          state = 3;
        } else if (dh <= kPmax) {
          if (t < w && wl == 0)
            packed[static_cast<size_t>(lane) * w + t] = (r << 16) | j;
          ++t;
          r = prow[dh - 1];
          j -= 1;
        } else {
          state = dh == kPmax + 2 ? 1 : 2;
        }
      } else if (state == 1) {
        state = (d >> 10) & 1 ? 1 : 0;
        j -= 1;
      } else {
        state = (d >> 9) & 1 ? 2 : 0;
        r = prow[(d >> 5) & 15];
      }
      r = min(max(r, 0), n);
      j = min(max(j, 0), w - 1);
    }
  }
  if (wl == 0) {
    best[lane] = score;
    tlen[lane] = min(t, w);
    if (stamps != nullptr) stamps[lane * 3 + 2] = global_ns();
  }
}

}  // namespace

// pred_rows [b, n, 16], npred, letters [b, n], n_nodes, seq_len, n_reads,
// fallback [b] int32; seq [b, w] bytes, lane l's read at seq + l * seq_ld,
// its length at seq_len[l * len_ld].  Lane l aligns when step < n_reads[l]
// and fallback[l] == 0 (the pack engine's read step ``step``).  Scratch
// H, F, D [b, n + 1, w] int16; outputs packed [b, w], tlen [b], best [b]
// int32.  w is a multiple of 128, at most 4096.
// ``stamps`` is null or [b, 3] int64 that takes the lane's start, end of the
// DP rows and end of the traceback in nanoseconds of the card's global timer
// (a probe of the DP / traceback split).  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success).
extern "C" int poa_align_launch(const void* pred_rows, const void* npred,
                                const void* letters, const void* n_nodes,
                                const void* seq, const void* seq_len,
                                const void* n_reads, const void* fallback,
                                int step, long long seq_ld, int len_ld, int b,
                                int n, int w, int match, int mismatch, int go,
                                int ge,
                                void* H, void* F, void* D, void* packed,
                                void* tlen, void* best, void* stamps,
                                void* stream) {
  if (b <= 0) return 0;
  if (w < kTile || w > kMaxW || w % kTile != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int ctas = lane_ctas(w);
  const size_t smem = smem_bytes(seg_cols(w, ctas), w);
  cudaError_t e = cudaFuncSetAttribute(
      poa_align_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(b * ctas);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(
      &cfg, poa_align_kernel, static_cast<const int32_t*>(pred_rows),
      static_cast<const int32_t*>(npred), static_cast<const int32_t*>(letters),
      static_cast<const int32_t*>(n_nodes), static_cast<const uint8_t*>(seq),
      static_cast<const int32_t*>(seq_len),
      static_cast<const int32_t*>(n_reads),
      static_cast<const int32_t*>(fallback), step, seq_ld, len_ld, n, w, match,
      mismatch, go, ge, static_cast<short*>(H),
      static_cast<short*>(F), static_cast<unsigned short*>(D),
      static_cast<int32_t*>(packed), static_cast<int32_t*>(tlen),
      static_cast<int32_t*>(best), ctas, static_cast<long long*>(stamps));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
