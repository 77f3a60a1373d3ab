// greedy_owner: the exact replay of the reference's greedy absorption
// (cluster.cpp:124-166) inside one block of K <= 4096 reads in greedy order.
//
// Replaces rattle_tpu/cluster/bulk.py::greedy_owner, a lax.fori_loop over
// the block's rows in one jitted program.  The eager port synced the host for
// the rows with a win and took about 6 launches a row.
//
// w [K, K] int8: 0 no, 1 reverse win, 2 forward win (row = the earlier
// read).  Rows are walked in order; a row whose read still owns itself (a
// seed) claims every later unclaimed column j < n_valid it wins.  Output:
// packed [K] int32 = (owner << 1) | rev, with owner = j and rev = 0 for a
// column nobody claimed (and every column from n_valid on).
//
// Bound: the walk is a chain of dependent steps, one a seed row, each needing
// the row's bytes and every claim before it.  Design: one CTA of 1024
// threads; each thread holds the owner and rev of the columns tid, tid +
// 1024, ... in registers and mirrors the owners in shared memory, where every
// thread reads whether row i is still a seed.  A row that is not a seed costs
// one shared-memory read and no synchronisation; a seed row costs a
// coalesced load of the columns still unclaimed after it (a byte a column)
// and one barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxK = 4096;
constexpr int kPer = kMaxK / kThreads;

__global__ void __launch_bounds__(kThreads)
greedy_owner_kernel(const int8_t* __restrict__ w, int k, int n_valid,
                    int32_t* __restrict__ packed) {
  __shared__ int32_t owner_s[kMaxK];
  const int tid = threadIdx.x;
  int owner[kPer];
  bool rev[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = tid + q * kThreads;
    owner[q] = j;
    rev[q] = false;
    if (j < k) owner_s[j] = j;
  }
  __syncthreads();
  for (int i = 0; i < n_valid; ++i) {
    if (owner_s[i] != i) continue;  // the same answer in every thread
    const int8_t* row = w + static_cast<size_t>(i) * k;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int j = tid + q * kThreads;
      if (j > i && j < n_valid && owner[q] == j) {
        const int8_t v = __ldg(row + j);
        if (v > 0) {
          owner[q] = i;
          rev[q] = v == 1;
          owner_s[j] = i;
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int j = tid + q * kThreads;
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
