// greedy_owner: the exact replay of the reference's greedy absorption
// (cluster.cpp:124-166) inside one block of K <= 4096 reads in greedy order.
//
// Replaces rattle_tpu/cluster/bulk.py::greedy_owner, a lax.fori_loop over
// the block's rows in one jitted program.
//
// w [K, K] int8: 0 no, 1 reverse win, 2 forward win (row = the earlier
// read).  Rows are walked in order; a row whose read still owns itself (a
// seed) claims every later unclaimed column j < n_valid it wins.  Output:
// packed [K] int32 = (owner << 1) | rev, with owner = j and rev = 0 for a
// column nobody claimed (and every column from n_valid on).  Equivalently: a
// row is a seed when no earlier seed wins it, and a column's owner is the
// first seed that wins it.
//
// Bound: the walk is a chain of dependent steps; the bytes are few (the
// seeds' unclaimed columns), so latency is the cost.  A walk that loads each
// seed's row only once the row is known to be a seed pays a load from device
// memory and a barrier a seed, and on the main path a read's family follows
// its seed in greedy order, so no prefetch of likely seeds can run ahead of
// that chain.
//
// Design: the rows are taken 64 at a time, and everything that depends on
// the order inside a step is resolved from bit masks in shared memory.  One
// CTA of 1024 threads; thread t holds the owner and rev of the columns 4t ..
// 4t + 3 in registers and mirrors the owners in shared memory.  A step over
// rows a .. a + 63:
//   1. its 64 x 64 square of w (loaded during the previous step) becomes a
//      mask a row of the columns it wins, and of those it wins in reverse,
//      by warp ballots; a mask of the rows still owning themselves;
//   2. one thread walks the seeds: the lowest free row is a seed and frees
//      none of the rows it wins (a few instructions a seed);
//   3. each of the square's free non-seed columns goes to the first seed
//      whose mask has it;
//   4. every later unclaimed column goes to the first of the step's seeds
//      whose row wins it: each thread loads its four columns of up to eight
//      seeds' rows at once (one 4-byte load a seed when rows are aligned), so
//      the step waits for about one load from device memory, not one a seed.
// Three barriers a step; the next step's square is loaded beside step 4.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 4096;
constexpr int kPer = kMaxK / kThreads;  // consecutive columns a thread
constexpr int kStep = 64;               // rows (and square columns) a step
constexpr int kChunk = 8;               // seeds' rows loaded at once
constexpr unsigned kFull = 0xffffffffu;

using u64 = unsigned long long;

__global__ void __launch_bounds__(kThreads)
greedy_owner_kernel(const int8_t* __restrict__ w, int k, int n_valid,
                    int32_t* __restrict__ packed) {
  __shared__ int16_t owner_s[kMaxK];
  __shared__ u64 win_s[kStep];   // bit y of row x: w[a+x][a+y] > 0, y > x
  __shared__ u64 rev_s[kStep];   // bit y of row x: w[a+x][a+y] == 1
  __shared__ u64 free_s;         // the step's rows still owning themselves
  __shared__ u64 seed_s;         // the step's seeds
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int j0 = tid * kPer;
  // 4-byte loads of a thread's columns: rows start 4-byte aligned
  const bool words = k % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 4 == 0;
  int owner[kPer];
  bool rev[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    owner[q] = j0 + q;
    rev[q] = false;
    if (j0 + q < k) owner_s[j0 + q] = static_cast<int16_t>(j0 + q);
  }
  // this thread's bytes of a step's square: rows a + 2 warp (+ 1), columns
  // a + lane (+ 32); only wins of a later valid column count
  int sq[4];
  auto load_square = [&](int a) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int x = a + 2 * warp + (i >> 1);
      const int y = a + lane + 32 * (i & 1);
      sq[i] = x < n_valid && y < n_valid && y > x
                  ? w[static_cast<size_t>(x) * k + y]
                  : 0;
    }
  };
  load_square(0);
  __syncthreads();
  for (int a = 0; a < n_valid; a += kStep) {
    // ---- 1. the square as masks, and the free rows ----
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const unsigned lo = __ballot_sync(kFull, sq[2 * r] > 0);
      const unsigned hi = __ballot_sync(kFull, sq[2 * r + 1] > 0);
      const unsigned lo1 = __ballot_sync(kFull, sq[2 * r] == 1);
      const unsigned hi1 = __ballot_sync(kFull, sq[2 * r + 1] == 1);
      if (lane == 0) {
        win_s[2 * warp + r] = lo | static_cast<u64>(hi) << 32;
        rev_s[2 * warp + r] = lo1 | static_cast<u64>(hi1) << 32;
      }
    }
    if (warp == 0) {
      const int x0 = a + lane;
      const int x1 = a + 32 + lane;
      const unsigned f0 =
          __ballot_sync(kFull, x0 < n_valid && owner_s[x0] == x0);
      const unsigned f1 =
          __ballot_sync(kFull, x1 < n_valid && owner_s[x1] == x1);
      if (lane == 0) free_s = f0 | static_cast<u64>(f1) << 32;
    }
    __syncthreads();
    // ---- 2. the step's seeds ----
    if (tid == 0) {
      u64 u = free_s;
      u64 s = 0;
      while (u) {
        const int x = __ffsll(static_cast<long long>(u)) - 1;
        s |= 1ull << x;
        u &= ~(win_s[x] | (1ull << x));
      }
      seed_s = s;
    }
    __syncthreads();
    const u64 seeds = seed_s;
    const u64 freed = free_s;
    if (a + kStep < n_valid) load_square(a + kStep);
    // ---- 3. the square's free columns that are not seeds ----
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int y = j0 + q - a;
      if (y < 0 || y >= kStep || !((freed >> y) & 1) || ((seeds >> y) & 1))
        continue;
      for (u64 c = seeds & ((1ull << y) - 1); c; c &= c - 1) {
        const int x = __ffsll(static_cast<long long>(c)) - 1;
        if ((win_s[x] >> y) & 1) {
          owner[q] = a + x;
          rev[q] = (rev_s[x] >> y) & 1;
          owner_s[j0 + q] = static_cast<int16_t>(a + x);
          break;
        }
      }
    }
    // ---- 4. later columns: the first of the step's seeds that wins ----
    unsigned open = 0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = j0 + q;
      if (j >= a + kStep && j < n_valid && owner[q] == j) open |= 1u << q;
    }
    for (u64 c = seeds; c && open;) {
      int xs[kChunk];
      unsigned v[kChunk];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        xs[i] = c ? a + __ffsll(static_cast<long long>(c)) - 1 : -1;
        c &= c - 1;
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        v[i] = 0;
        if (xs[i] < 0) continue;
        const int8_t* row = w + static_cast<size_t>(xs[i]) * k + j0;
        if (words && j0 + kPer <= k) {
          v[i] = *reinterpret_cast<const unsigned*>(row);
        } else {
#pragma unroll
          for (int q = 0; q < kPer; ++q)
            if ((open >> q) & 1)
              v[i] |= static_cast<unsigned>(static_cast<uint8_t>(row[q]))
                      << (8 * q);
        }
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
#pragma unroll
        for (int q = 0; q < kPer; ++q) {
          const int8_t b = static_cast<int8_t>((v[i] >> (8 * q)) & 0xff);
          if (((open >> q) & 1) && xs[i] >= 0 && b > 0) {
            owner[q] = xs[i];
            rev[q] = b == 1;
            owner_s[j0 + q] = static_cast<int16_t>(xs[i]);
            open &= ~(1u << q);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = j0 + q;
    if (j < k) packed[j] = (owner[q] << 1) | (rev[q] ? 1 : 0);
  }
}

}  // namespace

// w [k, k] int8 (row-major), k <= 4096, 0 <= n_valid <= k; packed [k]
// int32.  Launches one CTA on ``stream`` and returns cudaGetLastError() (0 on
// success).
extern "C" int greedy_owner_launch(const void* w, int k, int n_valid,
                                   void* packed, void* stream) {
  if (k <= 0) return 0;
  if (k > kMaxK || n_valid < 0 || n_valid > k)
    return static_cast<int>(cudaErrorInvalidValue);
  greedy_owner_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), k, n_valid,
      static_cast<int32_t*>(packed));
  return static_cast<int>(cudaGetLastError());
}
