// poa_align_batch: local affine-gap alignment of one read per lane against
// its POA graph in topological-rank order, with every traceback move
// emitted; the lockstep runner's alignment (correct/runner.py).
//
// Replaces rattle_tpu/ops/poa_device.py::poa_align_batch, a jitted XLA
// program there (a scan over ranks, then a while loop for the traceback);
// its plain PyTorch version would be some 20 launches a rank.  The
// executable spec is ops/kernels.py::poa_align_batch_plain.
//
// One CTA a lane, T = L / 4 threads (rounded up to a warp), each holding 4
// consecutive columns.  The rank loop runs inside the kernel: for rank r
// (DP row x = r + 1) every thread reads its columns (and the one to their
// left) of the H and F rows of up to 8 predecessors from the lane's global
// H/E/F scratch, forms the diagonal, F and A = max(0, F, diagonal) terms,
// takes E from a block-wide inclusive max-scan of A + go - ge (j + 1)
// (warp shuffles, then the warps' totals through shared memory), and
// stores the row.  Two barriers a row: one for the warps' totals, one so
// that the next row sees this row's stores.  Cells are stored as int16
// clamped at -16384 when L <= 3200 and as int32 above, and every later read
// (predecessor rows, traceback) sees the stored value, as in JAX.  Only rows
// below n_nodes and columns up to seq_len are computed: no output depends on
// the others (a cell past seq_len holds less than one at or before it).
// The best cell is each thread's first maximum in row-major order, reduced
// over the block keeping the lowest flat index on ties; one thread then
// walks the H/E/F traceback state machine (at most N + L moves).
//
// What bounds it on the H100: latency, not bytes or operations.  A row is
// 4 columns a thread of a few dependent loads (the predecessor numbers, then
// their rows, mostly L2 hits) and two barriers; one CTA a lane leaves most
// SMs idle when a group has few lanes, and the traceback is one thread's
// chain of dependent loads.  A later PR may split a lane over a cluster or
// run the traceback as a warp.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNeg = -(1 << 30);
constexpr int kClamp16 = -16384;
constexpr int kCols = 4;        // columns a thread
constexpr int kPmax = 8;        // predecessor slots at most
constexpr int kMaxThreads = 1024;
constexpr int kMinInt = -2147483647 - 1;

__device__ __forceinline__ int load_cell(const int16_t* p) { return *p; }
__device__ __forceinline__ int load_cell(const int32_t* p) { return *p; }

__device__ __forceinline__ int16_t put_cell(int x, int16_t*) {
  return static_cast<int16_t>(max(x, kClamp16));
}
__device__ __forceinline__ int32_t put_cell(int x, int32_t*) { return x; }

__device__ __forceinline__ int load_pred(const void* preds, int pred16,
                                         long long i) {
  return pred16 ? static_cast<int>(static_cast<const int16_t*>(preds)[i])
                : static_cast<const int32_t*>(preds)[i];
}

// (v, i) beats (w, k): larger value, or the same value at a lower index
__device__ __forceinline__ bool better(int v, long long i, int w,
                                       long long k) {
  return v > w || (v == w && i < k);
}

template <typename Cell>
__global__ void __launch_bounds__(kMaxThreads)
poa_align_batch_kernel(const uint8_t* __restrict__ letters,
                       const void* __restrict__ preds, int pred16, int pmax,
                       const int32_t* __restrict__ n_nodes,
                       const uint8_t* __restrict__ seq,
                       const int32_t* __restrict__ seq_len, int n, int l,
                       int match, int mismatch, int go, int ge, Cell* hs,
                       Cell* es, Cell* fs, int32_t* __restrict__ packed,
                       int32_t* __restrict__ length,
                       bool* __restrict__ aligned) {
  __shared__ int warp_tot[kMaxThreads / 32];
  __shared__ int red_v[kMaxThreads / 32];
  __shared__ long long red_i[kMaxThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long row_w = l + 1;
  const long long lane_off = static_cast<long long>(b) * (n + 1) * row_w;
  Cell* H = hs + lane_off;
  Cell* E = es + lane_off;
  Cell* F = fs + lane_off;
  const int neg_store = sizeof(Cell) == 2 ? kClamp16 : kNeg;
  const int nn = min(max(n_nodes[b], 0), n);
  const int sl = min(max(seq_len[b], 0), l);
  const uint8_t* sq = seq + static_cast<long long>(b) * l;
  const uint8_t* let = letters + static_cast<long long>(b) * n;
  const long long pred_base = static_cast<long long>(b) * n * pmax;

  // row 0: the virtual start, H = 0, E = F = NEG as stored
  for (int j = tid; j <= sl; j += nthreads) {
    H[j] = 0;
    E[j] = static_cast<Cell>(neg_store);
    F[j] = static_cast<Cell>(neg_store);
  }

  const int j0 = 1 + tid * kCols;       // columns j0 .. j0 + 3
  int ch[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    ch[c] = j0 + c <= sl ? sq[j0 + c - 1] : -1;
  const bool has_cols = j0 <= sl;

  int best_v = 0;            // row 0 is all zeros: its first cell is flat 0
  long long best_i = 0;

  int pc[kPmax];
#pragma unroll
  for (int k = 0; k < kPmax; ++k)
    pc[k] = (k < pmax && nn > 0) ? load_pred(preds, pred16, pred_base + k)
                                 : -1;
  int letter_c = nn > 0 ? let[0] : 0;
  __syncthreads();

  for (int r = 0; r < nn; ++r) {
    const long long x = r + 1;
    // the next rank's predecessors and letter, loaded ahead
    int pn[kPmax];
    const bool more = r + 1 < nn;
#pragma unroll
    for (int k = 0; k < kPmax; ++k)
      pn[k] = (k < pmax && more)
                  ? load_pred(preds, pred16,
                              pred_base + static_cast<long long>(r + 1) *
                                              pmax + k)
                  : -1;
    const int letter_n = more ? let[r + 1] : 0;

    // max over the predecessor slots of H at column j - 1 (the diagonal)
    // and of max(H + go, F + ge) at column j, for this thread's columns j;
    // a padding slot gives NEG for both
    int hmax[kCols];
    int fv[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      hmax[c] = kMinInt;
      fv[c] = kMinInt;
    }
    if (has_cols) {
#pragma unroll
      for (int k = 0; k < kPmax; ++k) {
        if (k >= pmax) break;
        const int p = pc[k];
        if (p < 0) {
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            hmax[c] = max(hmax[c], kNeg);
            fv[c] = max(fv[c], max(kNeg + go, kNeg + ge));
          }
          continue;
        }
        const Cell* hp = H + min(p, n) * row_w + j0 - 1;
        const Cell* fp = F + min(p, n) * row_w + j0;
        int hv[kCols + 1];      // H at columns j0 - 1 .. j0 + 3
#pragma unroll
        for (int c = 0; c <= kCols; ++c)
          hv[c] = j0 - 1 + c <= sl ? load_cell(hp + c) : kNeg;
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          hmax[c] = max(hmax[c], hv[c]);
          if (j0 + c <= sl)
            fv[c] = max(fv[c], max(hv[c + 1] + go, load_cell(fp + c) + ge));
        }
      }
    }

    // A and the scan term; column 0 adds A[0] + go - ge = go - ge
    int a[kCols];
    int shifted[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      if (j <= sl) {
        const int sub = ch[c] == letter_c ? match : mismatch;
        a[c] = max(max(0, fv[c]), hmax[c] + sub);
        shifted[c] = a[c] + go - ge * (j + 1);
      } else {
        a[c] = 0;
        shifted[c] = kMinInt;
      }
    }
    int excl[kCols];                  // max of this thread's earlier columns
    int tot = kMinInt;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      excl[c] = tot;
      tot = max(tot, shifted[c]);
    }
    int incl = tot;                   // inclusive max-scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = max(incl, o);
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    // the earlier warps' totals, reduced over the warp's lanes
    int carry = lane < warp ? warp_tot[lane] : kMinInt;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      carry = max(carry, __shfl_xor_sync(0xffffffffu, carry, off));
    const int prev = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane > 0) carry = max(carry, prev);
    carry = max(carry, go - ge);

    Cell* hrow = H + x * row_w;
    Cell* erow = E + x * row_w;
    Cell* frow = F + x * row_w;
    if (tid == 0) {
      hrow[0] = 0;
      erow[0] = put_cell(kNeg, hrow);
      frow[0] = put_cell(kNeg, hrow);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int j = j0 + c;
      if (j <= sl) {
        const int e = ge * j + max(carry, excl[c]);
        const int h = max(a[c], e);
        hrow[j] = put_cell(h, hrow);
        erow[j] = put_cell(e, hrow);
        frow[j] = put_cell(fv[c], hrow);
        if (h > best_v) {           // h >= 0: stored as it is
          best_v = h;
          best_i = x * row_w + j;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPmax; ++k) pc[k] = pn[k];
    letter_c = letter_n;
    __syncthreads();
  }

  // the first maximum over the block
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ov = __shfl_down_sync(0xffffffffu, best_v, off);
    const long long oi = __shfl_down_sync(0xffffffffu, best_i, off);
    if (better(ov, oi, best_v, best_i)) {
      best_v = ov;
      best_i = oi;
    }
  }
  if (lane == 0) {
    red_v[warp] = best_v;
    red_i[warp] = best_i;
  }
  __syncthreads();
  if (tid != 0) return;
  for (int w = 1; w < nthreads / 32; ++w)
    if (better(red_v[w], red_i[w], best_v, best_i)) {
      best_v = red_v[w];
      best_i = red_i[w];
    }

  // traceback; states 0 = H, 1 = E, 2 = F, 3 = done
  const long long tmax = static_cast<long long>(n) + l;
  int32_t* out = packed + static_cast<long long>(b) * tmax;
  int state = best_v > 0 ? 0 : 3;
  int r = static_cast<int>(best_i / row_w);
  int j = static_cast<int>(best_i % row_w);
  int out_len = 0;
  for (long long step = 0; step < tmax && state < 3; ++step) {
    const int jc = max(j, 0);
    const int jm1 = max(j - 1, 0);
    const long long rj = static_cast<long long>(r) * row_w;
    const int hrj = load_cell(H + rj + jc);
    const int erj = load_cell(E + rj + jc);
    const int frj = load_cell(F + rj + jc);
    const int rr = min(max(r - 1, 0), n - 1);
    const long long pb = pred_base + static_cast<long long>(rr) * pmax;

    const bool in_h = state == 0;
    const bool in_e = state == 1;
    const bool in_f = state == 2;
    const bool stop = in_h && (r == 0 || hrj == 0);

    int pidx0 = 0;
    bool found_diag = false;
    int diag_pred = 0;
    bool found_f = false;
    int f_pred = 0;
    bool f_is_open = false;
    if ((in_h && !stop) || in_f) {
      const int letter = let[rr];
      const int chj = sq[min(max(j - 1, 0), l - 1)];
      const int sub = chj == letter ? match : mismatch;
      for (int k = 0; k < pmax; ++k) {
        const int p = load_pred(preds, pred16, pb + k);
        const int pidx = min(max(p, 0), n);
        if (k == 0) pidx0 = pidx;
        if (p < 0) continue;
        const long long prow = static_cast<long long>(pidx) * row_w;
        if (in_h && !found_diag && j > 0 &&
            load_cell(H + prow + jm1) + sub == hrj) {
          found_diag = true;
          diag_pred = pidx;
        }
        if (in_f && !found_f) {
          const bool f_open = load_cell(H + prow + jc) + go == frj;
          const bool f_ext = load_cell(F + prow + jc) + ge == frj;
          if (f_open || f_ext) {
            found_f = true;
            f_pred = pidx;
            f_is_open = f_open && !f_ext;
          }
        }
      }
    }
    if (!found_diag) diag_pred = pidx0;
    if (!found_f) f_pred = pidx0;

    const bool any_diag = found_diag && in_h && !stop;
    const bool take_f = in_h && !stop && !any_diag && hrj == frj;
    const bool take_e = in_h && !stop && !any_diag && !take_f && hrj == erj;
    bool e_to_h = false;
    if (in_e) {
      const bool e_can_ext = erj == load_cell(E + rj + jm1) + ge;
      e_to_h = !e_can_ext && erj == load_cell(H + rj + jm1) + go;
    }

    const int emit_node = (any_diag || in_f) ? r : 0;
    const int emit_pos = (any_diag || in_e) ? j : 0;
    const bool do_emit = (any_diag || in_e || in_f);
    if (do_emit) {
      out[min(static_cast<long long>(out_len), tmax - 1)] =
          (emit_node << 16) | emit_pos;
      ++out_len;
    }

    int ns = state;
    int nr = r;
    int nj = j;
    if (stop) ns = 3;
    if (any_diag) {
      nr = diag_pred;
      nj = j - 1;
    }
    if (take_e) ns = 1;
    if (take_f) ns = 2;
    if (in_e && e_to_h) ns = 0;
    if (in_e) nj = j - 1;
    if (in_f) nr = f_pred;
    if (in_f && f_is_open) ns = 0;
    state = ns;
    r = nr;
    j = nj;
  }
  length[b] = out_len;
  aligned[b] = best_v > 0;
}

}  // namespace

extern "C" int poa_align_batch_launch(
    const void* letters, const void* preds, int pred16, int pmax,
    const void* n_nodes, const void* seq, const void* seq_len, int b, int n,
    int l, int match, int mismatch, int go, int ge, int cell_bytes,
    void* scratch, void* packed, void* length, void* aligned, void* stream) {
  if (b <= 0) return 0;
  if (n < 1 || l < 1 || l > kCols * kMaxThreads || pmax < 1 ||
      pmax > kPmax || (cell_bytes != 2 && cell_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = max(32, ((l + kCols - 1) / kCols + 31) / 32 * 32);
  const size_t plane = static_cast<size_t>(b) * (n + 1) * (l + 1);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* let = static_cast<const uint8_t*>(letters);
  const auto* nn = static_cast<const int32_t*>(n_nodes);
  const auto* sq = static_cast<const uint8_t*>(seq);
  const auto* sl = static_cast<const int32_t*>(seq_len);
  auto* pk = static_cast<int32_t*>(packed);
  auto* len = static_cast<int32_t*>(length);
  auto* al = static_cast<bool*>(aligned);
  if (cell_bytes == 2) {
    auto* s = static_cast<int16_t*>(scratch);
    poa_align_batch_kernel<int16_t><<<b, threads, 0, st>>>(
        let, preds, pred16, pmax, nn, sq, sl, n, l, match, mismatch, go, ge,
        s, s + plane, s + 2 * plane, pk, len, al);
  } else {
    auto* s = static_cast<int32_t*>(scratch);
    poa_align_batch_kernel<int32_t><<<b, threads, 0, st>>>(
        let, preds, pred16, pmax, nn, sq, sl, n, l, match, mismatch, go, ge,
        s, s + plane, s + 2 * plane, pk, len, al);
  }
  return static_cast<int>(cudaGetLastError());
}
