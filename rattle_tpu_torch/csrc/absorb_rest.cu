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
// where none wins) and the [C] int32 output; in practice latency, since a
// column's rows are a chain of loads that stops at the first win.  So a
// block takes 32 columns, a lane a column, and its 16 warps split the rows
// into 16 strips read side by side: each lane walks its strip in order, four
// rows' loads in flight, and stops at its strip's first win (neighbouring
// lanes read neighbouring bytes of a row, so a warp's loads coalesce).  The
// first strip with a win gives the column's row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                   // columns a block, a lane each
constexpr int kStrips = 16;                 // warps a block, a row strip each
constexpr int kUnroll = 4;                  // rows' loads in flight

__global__ void __launch_bounds__(kCols * kStrips)
absorb_rest_kernel(const int8_t* __restrict__ w, int n_rows, int n_cols,
                   int32_t* __restrict__ out) {
  __shared__ int32_t s_first[kStrips][kCols];
  const int lane = threadIdx.x & 31;
  const int strip = threadIdx.x >> 5;
  const int c = blockIdx.x * kCols + lane;
  const int per = (n_rows + kStrips - 1) / kStrips;
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
    for (int k = 0; k < kStrips && res < 0; ++k) res = s_first[k][lane];
    out[c] = res;
  }
}

}  // namespace

// w [n_rows, n_cols] int8, out [n_cols] int32.  Returns cudaGetLastError().
extern "C" int absorb_rest_launch(const void* w, int n_rows, int n_cols,
                                  void* out, void* stream) {
  if (n_cols <= 0) return 0;
  absorb_rest_kernel<<<(n_cols + kCols - 1) / kCols, kCols * kStrips, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(w), n_rows, n_cols,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
