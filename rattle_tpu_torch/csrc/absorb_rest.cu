// absorb_rest: the sweep's first-claim rule (cluster.cpp:141-150).  Each
// column of the win matrix w [S, C] int8 joins the EARLIEST seed row that
// wins it: out[c] = (s << 1) | (w[s, c] == 1) for the first s with
// w[s, c] > 0, or -1.
//
// Replaces rattle_tpu/cluster/bulk.py::absorb_rest, a jitted program there
// (a masked min over rows and a gather); the port ran it as four eager
// launches.
//
// Bound: bytes, the rows a column needs read up to its first win (all S
// where none wins) and the [C] int32 output.  A column with no win reads
// every row, so a wide sweep's w (268 MB at 4,096 x 65,536) is a stream.
//
// Design (absorb_panel_kernel): a thread loads 16 bytes of a row, 16
// columns, and a warp 512 columns, a panel.  The grid runs over (panel, row
// strip), sized by the plan (ops/kernels.py::absorb_rest_plan) to hold at
// least two CTAs an SM: a CTA's 8 warps take the strip's rows in turn, each
// thread four rows' loads in flight, and a thread stops once each of its
// columns has a win in its own rows (the rows go in order, so the first is
// the least) or, checked every kCheck rows, in an earlier strip.  The
// strips' first wins meet in ``out``, which the launcher sets to 0xffffffff
// (-1 as int32: no row wins) with one memset, by atomicMin on the packed
// (row << 1) | rev as unsigned: the least does not depend on the order.  A
// single strip writes ``out`` directly, with no memset.  A w whose rows are
// not 16-byte aligned (C not a multiple of 16) takes byte loads.
//
// A matrix of at most 512 rows (a sweep tile's seeds) takes the earlier
// layout instead (absorb_column_kernel): a lane a column, the CTA's 16
// warps each a strip of the rows, the first strip with a win giving the
// row.  There every 16-byte plan measured 5.4-8.4 us a launch against
// 4.4 us for it (pipeline/probe_gate.py --absorb-only, PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 16;                    // columns (bytes) a thread
constexpr int kPanel = 32 * kVec;           // columns a CTA
constexpr int kUnroll = 4;                  // rows' loads in flight a thread
constexpr int kCheck = 256;                 // rows between looks at ``out``
constexpr unsigned kNone = 0xffffffffu;
constexpr int kColStrips = 16;              // the column layout's warps

template <bool kAligned>
__device__ __forceinline__ uint4 load_row(const int8_t* w, size_t row_off,
                                          int c0, int n_cols) {
  if (kAligned && c0 + kVec <= n_cols)
    return __ldg(reinterpret_cast<const uint4*>(w + row_off + c0));
  uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (c0 + j < n_cols)
      v[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(
                       __ldg(w + row_off + c0 + j)))
                   << (8 * (j & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
absorb_panel_kernel(const int8_t* __restrict__ w, int n_rows, int n_cols,
                    int rows_per_strip, unsigned* __restrict__ out) {
  __shared__ unsigned s_first[kPanel];
  for (int i = threadIdx.x; i < kPanel; i += kThreads) s_first[i] = kNone;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kPanel + lane * kVec;
  const int lo = blockIdx.y * rows_per_strip;
  const int hi = min(n_rows, lo + rows_per_strip);
  unsigned first[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) first[j] = kNone;
  // columns of this thread still without a win: bit j for column c0 + j
  unsigned open = c0 >= n_cols ? 0u
                  : n_cols - c0 >= kVec ? 0xffffu
                                        : (1u << (n_cols - c0)) - 1u;
  int next_check = lo + kCheck;
  for (int s = lo + warp; s < hi && open; s += kWarps * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = s + kWarps * u;
      v[u] = row < hi ? load_row<kAligned>(w, static_cast<size_t>(row) *
                                                  n_cols, c0, n_cols)
                      : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {       // rows in order
      if ((v[u].x | v[u].y | v[u].z | v[u].w) == 0) continue;
      const uint32_t word[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      const unsigned row2 = static_cast<unsigned>(s + kWarps * u) << 1;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const int8_t b = static_cast<int8_t>(word[j >> 2] >> (8 * (j & 3)));
        if (b > 0 && (open >> j & 1u)) {
          first[j] = row2 | (b == 1 ? 1u : 0u);
          open &= ~(1u << j);
        }
      }
    }
    if (lo > 0 && s >= next_check && open) {   // an earlier strip's wins
      next_check = s + kCheck;
      const unsigned before = static_cast<unsigned>(lo) << 1;
      if (c0 + kVec <= n_cols) {            // 16 columns, 64 aligned bytes
        const uint4* o = reinterpret_cast<const uint4*>(out + c0);
#pragma unroll
        for (int q = 0; q < kVec / 4; ++q) {
          const uint4 x = __ldcg(o + q);
          const unsigned got[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (got[e] < before) open &= ~(1u << (4 * q + e));
        }
      } else {
        for (int j = 0; j < kVec; ++j)
          if ((open >> j & 1u) && __ldcg(out + c0 + j) < before)
            open &= ~(1u << j);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kVec; ++j)
    if (first[j] != kNone) atomicMin(&s_first[lane * kVec + j], first[j]);
  __syncthreads();
  for (int i = threadIdx.x; i < kPanel; i += kThreads) {
    const int c = blockIdx.x * kPanel + i;
    if (c >= n_cols) continue;
    if (gridDim.y == 1)                     // one strip: the answer
      out[c] = s_first[i];
    else if (s_first[i] != kNone)
      atomicMin(out + c, s_first[i]);
  }
}

// the small-matrix layout: 32 columns a CTA, a lane each, 16 warps each a
// strip of rows walked in order, four rows' loads in flight
__global__ void __launch_bounds__(32 * kColStrips)
absorb_column_kernel(const int8_t* __restrict__ w, int n_rows, int n_cols,
                     int32_t* __restrict__ out) {
  __shared__ int32_t s_first[kColStrips][32];
  const int lane = threadIdx.x & 31;
  const int strip = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const int per = (n_rows + kColStrips - 1) / kColStrips;
  const int lo = strip * per;
  const int hi = min(n_rows, lo + per);
  int first = -1;                           // (row << 1) | rev of the strip
  if (c < n_cols) {
    const int8_t* col = w + c;
    for (int s = lo; s < hi && first < 0; s += kUnroll) {
      int8_t v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        v[u] = s + u < hi ? col[static_cast<size_t>(s + u) * n_cols] : 0;
#pragma unroll
      for (int u = kUnroll - 1; u >= 0; --u)   // the lowest win stays
        if (v[u] > 0) first = ((s + u) << 1) | (v[u] == 1 ? 1 : 0);
    }
  }
  s_first[strip][lane] = first;
  __syncthreads();
  if (strip == 0 && c < n_cols) {
    int res = -1;
    for (int k = 0; k < kColStrips && res < 0; ++k) res = s_first[k][lane];
    out[c] = res;
  }
}

}  // namespace

// w [n_rows, n_cols] int8, out [n_cols] int32.  ``layout`` 0: the panel
// kernel, ``panels`` x ``strips`` CTAs, ``rows_per_strip`` rows a strip
// (panels = ceil(n_cols / 512), strips * rows_per_strip >= n_rows, strips <
// 65,536; with more than one strip, ``out`` is set to -1 first); 1: the
// column kernel (strips 1).  Returns cudaGetLastError().
extern "C" int absorb_rest_launch(const void* w, int n_rows, int n_cols,
                                  int strips, int rows_per_strip, int layout,
                                  void* out, void* stream) {
  if (n_cols <= 0) return 0;
  if (n_rows < 0 || strips <= 0 || strips >= 65536 || rows_per_strip < 0 ||
      static_cast<long long>(strips) * rows_per_strip < n_rows ||
      (layout != 0 && (layout != 1 || strips != 1)))
    return cudaErrorInvalidValue;
  const auto st = static_cast<cudaStream_t>(stream);
  if (layout == 1) {
    absorb_column_kernel<<<(n_cols + 31) / 32, 32 * kColStrips, 0, st>>>(
        static_cast<const int8_t*>(w), n_rows, n_cols,
        static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  if (strips > 1) {
    const cudaError_t e = cudaMemsetAsync(
        out, 0xff, static_cast<size_t>(n_cols) * sizeof(int32_t), st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const bool aligned = n_cols % kVec == 0 &&
                       reinterpret_cast<uintptr_t>(w) % kVec == 0;
  const dim3 grid((n_cols + kPanel - 1) / kPanel, strips);
  const auto kernel =
      aligned ? absorb_panel_kernel<true> : absorb_panel_kernel<false>;
  kernel<<<grid, kThreads, 0, st>>>(static_cast<const int8_t*>(w), n_rows,
                                    n_cols, rows_per_strip,
                                    static_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}
