// score_decide: the decision of scored read pairs
// (cluster.cpp:24-37), from each pair's LIS score, variance and match count.
//
// The counterpart of the decision half of
// rattle_tpu/cluster/bulk.py::_score_body (after the LIS kernel): the score
// gate against the f64-exact table, the variance test with the borderline
// band that the host rescores in f64, the wins scattered into the win matrix
// and the outcomes into the score cache.  The eager port ran it as about 15
// elementwise, gather and scatter launches a chunk.
//
// Per pair i (rows/cols index the wave's row and column lists, row_ids /
// col_ids give the global read ids):
//   score_ok   = bases >= sc_tab[min(lens[a], lens[b])]
//   borderline = |var - t_v| <= var_band      (float32, as in PyTorch)
//   fits       = total <= m_cap
//   win        = score_ok & var < t_v & !borderline & fits
//   border     = score_ok & borderline & fits
//   w[row, col] = max(w[row, col], strand_val) where win
//   cache[a * cache_n + b] = win ? 2 : 1 where fits & !border
// The (row, col) pairs and the (a, b) pairs of one call are unique, so the
// scatters are plain stores.  var, t_v and var_band are float32 and the
// subtraction is rounded to nearest (__fsub_rn), so every comparison is the
// plain version's.
//
// Bound: bytes, about 50 a pair (indices, ids, the per-pair inputs, the
// length and score tables, border, and the wins' and outcomes' bytes); a
// thread a pair, neighbouring threads on neighbouring pairs, so every load
// of a per-pair input is coalesced.  Its device work is a few microseconds
// a launch, so its cost is the launch: the caller launches it once over all
// the pairs of a score-path launch (up to a whole (class, tier) range).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
score_decide_kernel(const int64_t* __restrict__ rows,
                    const int64_t* __restrict__ cols,
                    const int64_t* __restrict__ row_ids,
                    const int64_t* __restrict__ col_ids,
                    const int32_t* __restrict__ bases,
                    const float* __restrict__ var,
                    const int32_t* __restrict__ total,
                    const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ sc_tab,
                    const float* __restrict__ t_v,
                    const float* __restrict__ var_band, int strand_val,
                    int8_t* __restrict__ w, long long ldw,
                    uint8_t* __restrict__ cache, long long cache_n,
                    int n_pairs, int m_cap, uint8_t* __restrict__ border) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_pairs) return;
  const long long r = rows[i], c = cols[i];
  const long long a = row_ids[r], b = col_ids[c];
  const float v = var[i], tv = *t_v;
  const int mn = min(lens[a], lens[b]);
  const bool score_ok = bases[i] >= sc_tab[mn];
  const bool borderline = fabsf(__fsub_rn(v, tv)) <= *var_band;
  const bool fits = total[i] <= m_cap;
  const bool win = score_ok && v < tv && !borderline && fits;
  const bool bord = score_ok && borderline && fits;
  if (win) {
    int8_t* cell = w + r * ldw + c;
    if (*cell < strand_val) *cell = static_cast<int8_t>(strand_val);
  }
  if (cache != nullptr && fits && !bord)
    cache[a * cache_n + b] = win ? 2 : 1;
  border[i] = bord;
}

}  // namespace

// rows, cols [n_pairs] int64; row_ids, col_ids int64; bases [n_pairs]
// int32, var [n_pairs] float32, total [n_pairs] int32; lens and sc_tab
// int32; t_v, var_band device float32 scalars; w [*, ldw] int8; cache
// [cache_n * cache_n] uint8 or null; border [n_pairs] bytes.  Launches on
// ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int score_decide_launch(
    const void* rows, const void* cols, const void* row_ids,
    const void* col_ids, const void* bases, const void* var,
    const void* total, const void* lens, const void* sc_tab, const void* t_v,
    const void* var_band, int strand_val, void* w, long long ldw,
    void* cache, long long cache_n, int n_pairs, int m_cap, void* border,
    void* stream) {
  if (n_pairs <= 0) return 0;
  const int grid = static_cast<int>(
      (static_cast<long long>(n_pairs) + kThreads - 1) / kThreads);
  score_decide_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(rows), static_cast<const int64_t*>(cols),
      static_cast<const int64_t*>(row_ids),
      static_cast<const int64_t*>(col_ids),
      static_cast<const int32_t*>(bases), static_cast<const float*>(var),
      static_cast<const int32_t*>(total), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(sc_tab), static_cast<const float*>(t_v),
      static_cast<const float*>(var_band), strand_val,
      static_cast<int8_t*>(w), ldw, static_cast<uint8_t*>(cache), cache_n,
      n_pairs, m_cap, static_cast<uint8_t*>(border));
  return static_cast<int>(cudaGetLastError());
}
