// poa_align: local affine-gap alignment of one read per lane against a
// partial-order graph walked in topological-rank order, with traceback
// (correct.cpp:395-405; the executable spec is ops/poa.py::align_local).
//
// Replaces rattle_tpu/ops/poa_pallas.py::poa_align_pallas (_make_kernel).
// The TPU kernel interleaved a few lanes per program on one core, kept DP rows
// in VMEM rings flushed to HBM by DMA, translated predecessor nodes to ranks
// through a VMEM table and extracted scalars by masked reductions.  None of
// that carries over: here one block owns one lane, the row's columns are
// spread four to a thread, predecessor rows arrive as row indices (the caller
// gathers them), and every lane of the batch runs at once on its own SM.
//
// Per rank r (DP row x = r + 1; row 0 is the virtual start, H = 0, F = -inf):
//   a_h[j] = max_k H[pred_k][j]          (first maximum wins, k in edge order)
//   b_f[j] = max_k max(H[pred_k][j] + go, F[pred_k][j] + ge)
//   diag[j] = a_h[j-1] + sub(j),  A = max(diag, F, 0)
//   E[j] = ge*j + max_{j'<j}(A[j'] + go - ge*(j'+1)),  H = max(A, E)
// The E prefix maximum is a block scan: four columns in registers, a warp
// shuffle scan, per-warp carries in shared memory.  The chain case (a single
// predecessor that is the previous rank) reads H of the previous row from
// shared memory and F from registers; any other predecessor row is read back
// from the global scratch.  Two __syncthreads a row.
//
// Direction word (11 bits): bits 0-4 H source (0 stop, 1..16 diagonal through
// predecessor k-1, 17 F, 18 E; priority stop > diagonal > F > E), bits 5-8 the
// F predecessor index, bit 9 F-extend, bit 10 E-extend.
//
// Scratch rows are int16: H lies in [0, 5*4095] and, at every column >= 1,
// F = max_k max(H + go, F + ge) >= go because H >= 0; column 0 of F is masked
// to -inf on every read path (f = -inf at j = 0), so clamping it at -16384 on
// store changes no decision.
//
// The best cell is the first maximum in (row, column) order: each thread
// keeps the first row of its columns' maxima, and a block reduction of
// (value, -row-major index) keys picks the cell.  Thread 0 walks the traceback
// (states H, E, F) and emits (rank+1) << 16 | (pos+1) for diagonal moves only,
// in reverse order.
//
// Bound: the inputs are a few hundred KB a lane, so the card's limit is the
// integer work, about 32 operations a cell over ranks x (read length + 1)
// cells.  In practice a lane is a serial chain of rows on one SM (two barriers
// and a shuffle scan a row) and the traceback is a chain of dependent loads,
// so the kernel is latency-bound; lanes are the parallelism.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPmax = 16;
constexpr int kCols = 4;          // columns a thread
constexpr int kMaxW = 4096;
constexpr int kNeg = -(1 << 30);
constexpr int kClamp16 = -16384;

__device__ __forceinline__ short clamp16(int v) {
  return static_cast<short>(max(v, kClamp16));
}

__global__ void __launch_bounds__(kMaxW / kCols)
poa_align_kernel(const int32_t* __restrict__ pred_rows,  // [B, N, 16]
                 const int32_t* __restrict__ npred,      // [B, N]
                 const int32_t* __restrict__ letters,    // [B, N]
                 const int32_t* __restrict__ n_nodes,    // [B]
                 const uint8_t* __restrict__ seq,        // [B, W]
                 const int32_t* __restrict__ seq_len,    // [B]
                 const int32_t* __restrict__ active,     // [B]
                 int n, int w, int match, int mismatch, int go, int ge,
                 short* H, short* F, unsigned short* D,  // [B, N + 1, W]
                 int32_t* __restrict__ packed,           // [B, W]
                 int32_t* __restrict__ tlen, int32_t* __restrict__ best) {
  __shared__ short sh_h[kMaxW + kCols];   // H of the previous row at j + 1
  __shared__ int sh_carry[32];
  __shared__ unsigned char sh_flag[kMaxW / kCols];
  __shared__ long long sh_key[32];

  const int lane = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wl = tid & 31;
  const int nwarps = blockDim.x >> 5;

  const int nn = min(n_nodes[lane], n);
  const int slen = min(seq_len[lane], w - 1);
  if (active[lane] <= 0 || nn <= 0) {   // uniform over the block
    if (tid == 0) {
      tlen[lane] = 0;
      best[lane] = 0;
    }
    return;
  }

  const int j0 = tid * kCols;
  const bool has_cols = j0 <= slen;
  const size_t lane_rows = static_cast<size_t>(lane) * (n + 1);
  short* Hl = H + lane_rows * w;
  short* Fl = F + lane_rows * w;
  unsigned short* Dl = D + lane_rows * w;
  const int32_t* pr_l = pred_rows + static_cast<size_t>(lane) * n * kPmax;
  const int32_t* np_l = npred + static_cast<size_t>(lane) * n;
  const int32_t* let_l = letters + static_cast<size_t>(lane) * n;

  // column j holds read base j - 1; -1 marks a masked column
  int sq[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int j = j0 + c;
    sq[c] = (j >= 1 && j <= slen)
                ? static_cast<int>(seq[static_cast<size_t>(lane) * w + j - 1])
                : -1;
  }

  int bv[kCols], brow[kCols], fprev[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    bv[c] = 0;
    brow[c] = 0;
    fprev[c] = kNeg;
    sh_h[j0 + c + 1] = 0;
  }
  if (tid == 0) sh_h[0] = 0;
  __syncthreads();

  int nxt_np = np_l[0], nxt_let = let_l[0], nxt_p0 = pr_l[0];
  for (int r = 0; r < nn; ++r) {
    const int x = r + 1;
    const int np = min(max(nxt_np, 1), kPmax);
    const int letter = nxt_let;
    const int p0 = nxt_p0;
    if (x < nn) {   // next rank's scalars, ahead of this row's work
      nxt_np = np_l[x];
      nxt_let = let_l[x];
      nxt_p0 = pr_l[static_cast<size_t>(x) * kPmax];
    }
    const bool chain = (np == 1) && (p0 == r);

    int a[kCols], f[kCols], diag[kCols], argd[kCols], arg_f[kCols],
        ext_f[kCols];
    int l[kCols];          // inclusive prefix of the E scan terms
    int total = kNeg;
    if (has_cols) {
      int a_h[kCols + 1], arg_h[kCols + 1], b_f[kCols];
      if (chain) {
#pragma unroll
        for (int i = 0; i <= kCols; ++i) {
          a_h[i] = sh_h[j0 + i];
          arg_h[i] = 0;
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int ho = a_h[c + 1] + go, fe = fprev[c] + ge;
          b_f[c] = max(ho, fe);
          ext_f[c] = fe >= ho;
          arg_f[c] = 0;
        }
      } else {
#pragma unroll
        for (int i = 0; i <= kCols; ++i) {
          a_h[i] = kNeg;
          arg_h[i] = 0;
        }
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          b_f[c] = kNeg;
          arg_f[c] = 0;
          ext_f[c] = 0;
        }
        for (int k = 0; k < np; ++k) {
          const int pr = k == 0 ? p0 : pr_l[static_cast<size_t>(r) * kPmax + k];
          int hl[kCols + 1], fl[kCols];
          if (pr <= 0 || pr > r) {   // the virtual start row
#pragma unroll
            for (int i = 0; i <= kCols; ++i) hl[i] = 0;
#pragma unroll
            for (int c = 0; c < kCols; ++c) fl[c] = kNeg;
          } else {
            const size_t off = static_cast<size_t>(pr) * w + j0;
            const short4 h4 = *reinterpret_cast<const short4*>(Hl + off);
            const short4 f4 = *reinterpret_cast<const short4*>(Fl + off);
            hl[0] = j0 > 0 ? static_cast<int>(Hl[off - 1]) : 0;
            hl[1] = h4.x; hl[2] = h4.y; hl[3] = h4.z; hl[4] = h4.w;
            fl[0] = f4.x; fl[1] = f4.y; fl[2] = f4.z; fl[3] = f4.w;
          }
#pragma unroll
          for (int i = 0; i <= kCols; ++i) {
            const bool hgt = hl[i] > a_h[i];
            a_h[i] = hgt ? hl[i] : a_h[i];
            arg_h[i] = hgt ? k : arg_h[i];
          }
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int ho = hl[c + 1] + go, fe = fl[c] + ge;
            const int fk = max(ho, fe);
            const bool fgt = fk > b_f[c];
            b_f[c] = fgt ? fk : b_f[c];
            arg_f[c] = fgt ? k : arg_f[c];
            ext_f[c] = fgt ? static_cast<int>(fe >= ho) : ext_f[c];
          }
        }
      }
      int run = kNeg;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c;
        const int sub = sq[c] < 0 ? kNeg
                                  : (sq[c] == letter ? match : mismatch);
        diag[c] = a_h[c] + sub;
        argd[c] = arg_h[c];
        f[c] = j >= 1 ? b_f[c] : kNeg;
        a[c] = max(max(diag[c], f[c]), 0);
        run = max(run, a[c] + go - ge * (j + 1));
        l[c] = run;
      }
      total = run;
    }

    // block-wide exclusive prefix maximum of the threads' totals
    int incl = total;
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, s);
      if (wl >= s) incl = max(incl, up);
    }
    int excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (wl == 0) excl = kNeg;
    if (wl == 31) sh_carry[warp] = incl;
    __syncthreads();

    int e_ext[kCols], dword[kCols];
    int h[kCols];
    if (has_cols) {
      int p = excl;
      for (int q = 0; q < warp; ++q) p = max(p, sh_carry[q]);
      // rm1[c] = max_{j' < j0 + c} of the scan terms
      int rm1[kCols + 1];
      rm1[0] = p;
#pragma unroll
      for (int c = 0; c < kCols; ++c) rm1[c + 1] = max(p, l[c]);
      short hs[kCols], fs[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int j = j0 + c;
        const int e = j >= 1 ? ge * j + rm1[c] : kNeg;
        h[c] = max(a[c], e);
        int dir = 0;
        if (h[c] != 0) {
          if (diag[c] == h[c]) dir = 1 + argd[c];
          else if (f[c] == h[c]) dir = kPmax + 1;
          else if (e == h[c]) dir = kPmax + 2;
        }
        // E-extend: E[j] == E[j-1] + ge  <=>  the running maximum did not
        // rise at j - 1; column j0 takes it from the left neighbour below
        e_ext[c] = c >= 1 ? static_cast<int>(rm1[c] == rm1[c - 1] && j >= 2)
                          : 0;
        dword[c] = dir | (arg_f[c] << 5) | (ext_f[c] << 9);
        if (sq[c] >= 0 && h[c] > bv[c]) {
          bv[c] = h[c];
          brow[c] = x;
        }
        fprev[c] = f[c];
        hs[c] = static_cast<short>(h[c]);
        fs[c] = clamp16(f[c]);
        sh_h[j + 1] = hs[c];
      }
      sh_flag[tid] = rm1[kCols] == rm1[kCols - 1];
      const size_t off = static_cast<size_t>(x) * w + j0;
      *reinterpret_cast<short4*>(Hl + off) = make_short4(hs[0], hs[1], hs[2],
                                                         hs[3]);
      *reinterpret_cast<short4*>(Fl + off) = make_short4(fs[0], fs[1], fs[2],
                                                         fs[3]);
    }
    __syncthreads();
    if (has_cols) {
      if (tid > 0) e_ext[0] = sh_flag[tid - 1];
      unsigned short d[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        d[c] = static_cast<unsigned short>(dword[c] | (e_ext[c] << 10));
      *reinterpret_cast<ushort4*>(Dl + static_cast<size_t>(x) * w + j0) =
          make_ushort4(d[0], d[1], d[2], d[3]);
    }
  }

  // first maximum in (row, column) order: largest value, then the smallest
  // row-major index
  long long key = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    if (bv[c] > 0) {
      const long long k =
          (static_cast<long long>(bv[c]) << 32) |
          static_cast<long long>(0x7fffffff - (brow[c] * kMaxW + j0 + c));
      key = max(key, k);
    }
  }
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    key = max(key, __shfl_xor_sync(0xffffffffu, key, s));
  if (wl == 0) sh_key[warp] = key;
  __syncthreads();   // also orders the last row's D stores before the walk
  if (tid != 0) return;
  for (int q = 1; q < nwarps; ++q) key = max(key, sh_key[q]);

  const int best_v = static_cast<int>(key >> 32);
  best[lane] = best_v;
  int t = 0;
  if (best_v > 0) {
    const int idx = 0x7fffffff - static_cast<int>(key & 0x7fffffff);
    int r = idx / kMaxW, j = idx % kMaxW;
    int state = 0;   // 0 = H, 1 = E, 2 = F, 3 = done
    while (state != 3) {
      if (r <= 0) break;
      const int d = Dl[static_cast<size_t>(r) * w + j];
      const int32_t* prow = pr_l + static_cast<size_t>(r - 1) * kPmax;
      if (state == 0) {
        const int first = prow[0];   // the usual predecessor, fetched with d
        const int dh = d & 31;
        if (dh == 0) {
          state = 3;
        } else if (dh <= kPmax) {
          if (t < w) packed[static_cast<size_t>(lane) * w + t] = (r << 16) | j;
          ++t;
          r = dh == 1 ? first : prow[dh - 1];
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
  tlen[lane] = min(t, w);
}

}  // namespace

// pred_rows [b, n, 16], npred, letters [b, n], n_nodes, seq_len, active [b]
// int32; seq [b, w] bytes; scratch H, F, D [b, n + 1, w] int16; outputs packed
// [b, w], tlen [b], best [b] int32.  w is a multiple of 128, at most 4096.
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int poa_align_launch(const void* pred_rows, const void* npred,
                                const void* letters, const void* n_nodes,
                                const void* seq, const void* seq_len,
                                const void* active, int b, int n, int w,
                                int match, int mismatch, int go, int ge,
                                void* H, void* F, void* D, void* packed,
                                void* tlen, void* best, void* stream) {
  if (b <= 0) return 0;
  if (w < 128 || w > kMaxW || w % 128 != 0 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  poa_align_kernel<<<b, w / kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(pred_rows),
      static_cast<const int32_t*>(npred),
      static_cast<const int32_t*>(letters),
      static_cast<const int32_t*>(n_nodes), static_cast<const uint8_t*>(seq),
      static_cast<const int32_t*>(seq_len),
      static_cast<const int32_t*>(active), n, w, match, mismatch, go, ge,
      static_cast<short*>(H), static_cast<short*>(F),
      static_cast<unsigned short*>(D), static_cast<int32_t*>(packed),
      static_cast<int32_t*>(tlen), static_cast<int32_t*>(best));
  return static_cast<int>(cudaGetLastError());
}
