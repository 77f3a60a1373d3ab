// bv_common: popcount(AND) of two 4096-bit 6-mer presence vectors for every
// (pool, seed) pair (the reference's bitvector gate, cluster.cpp:13-19).
//
// Replaces rattle_tpu/ops/pallas_kernels.py::bv_common_matmul (_gate_kernel,
// _unpack_bits_bf16).  The TPU kernel unpacked the packed words into bf16 bit
// planes and contracted them on the MXU.  Here device memory moves only the
// packed words (512 B a row) and the contraction runs on the tensor cores:
// out[p, s] = sum over the 4096 bits of pool[p] AND seed[s], exact in int32.
//
// Bound: operations.  P*S*4096 bit products against (P+S)*512 + P*S*4 bytes.
// The earlier kernel did them as AND + POPC on the CUDA cores and was bound
// by POPC issue (16 a clock per SM); the tensor cores are the way past it.
//
// Design: a block computes 128 x 128 outputs with 8 warps (2 x 4), each warp
// 64 x 32 (4 x 4 tiles of 16 x 8).  Both operand tiles stream through shared
// memory in four stages of 32 words (1,024 bits) a row, double-buffered with
// cp.async (rows past P or S are zero-filled, so they stay inert).  A row's
// 16-byte units are XOR-swizzled by (row & 7), so the eight rows that one
// ldmatrix phase touches fall on distinct banks.  Each staged tile is read by
// 4 (pool) or 2 (seed) warps, contracted by mma.sync m16n8k256 .b1 with
// .and.popc on the packed words, fragments by ldmatrix: 16 MMAs per 256 bits
// per warp.  (A u8 MMA on 0/1 planes unpacked in registers was measured
// 2.2-2.7x slower at the main path's shapes; PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 128;                 // 4096 bits
constexpr int kBM = 128;                    // pool rows a block
constexpr int kBN = 128;                    // seed rows a block
constexpr int kChunk = 32;                  // words a row a stage
constexpr int kUnits = kChunk / 4;          // 16-byte units a row a stage
constexpr int kStages = kWords / kChunk;
constexpr int kThreads = 256;
constexpr int kBufWords = (kBM + kBN) * kChunk;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// word offset of 16-byte unit u of row r in a staged tile
__device__ __forceinline__ int swz(int r, int u) {
  return (r * kUnits + (u ^ (r & 7))) * 4;
}

__device__ __forceinline__ void load_stage(uint32_t* buf, const uint32_t* pool,
                                           const uint32_t* seed, int p0,
                                           int s0, int n_pool, int n_seed,
                                           int stage) {
  for (int i = threadIdx.x; i < (kBM + kBN) * kUnits; i += kThreads) {
    const int row = i / kUnits;
    const int u = i % kUnits;
    const bool is_pool = row < kBM;
    const int src_row = is_pool ? p0 + row : s0 + row - kBM;
    const bool valid = src_row < (is_pool ? n_pool : n_seed);
    const uint32_t* base = is_pool ? pool : seed;
    const uint32_t* src =
        valid ? base + static_cast<size_t>(src_row) * kWords + stage * kChunk +
                    u * 4
              : base;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(buf + swz(row, u))),
                 "l"(src), "r"(valid ? 16 : 0));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const uint32_t* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_b1(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// one staged stage, binary MMA: 4 steps of 256 bits (two units each)
__device__ __forceinline__ void compute_b1(const uint32_t* buf, int wm, int wn,
                                           int acc[4][4][4]) {
  const int l = threadIdx.x & 31;
  const int mi = l >> 3;
  const uint32_t* sa = buf;
  const uint32_t* sb = buf + kBM * kChunk;
#pragma unroll
  for (int ks = 0; ks < kUnits / 2; ++ks) {
    uint32_t a[4][4], b[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
      ldmatrix_x4(a[mt], sa + swz(wm * 64 + mt * 16 + (mi & 1) * 8 + (l & 7),
                                  2 * ks + (mi >> 1)));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t r[4];
      ldmatrix_x4(r, sb + swz(wn * 32 + np * 16 + (mi >> 1) * 8 + (l & 7),
                              2 * ks + (mi & 1)));
      b[2 * np][0] = r[0];
      b[2 * np][1] = r[1];
      b[2 * np + 1][0] = r[2];
      b[2 * np + 1][1] = r[3];
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) mma_b1(acc[mt][nt], a[mt], b[nt]);
  }
}

__global__ void __launch_bounds__(kThreads)
bv_common_kernel(const uint32_t* __restrict__ pool,
                 const uint32_t* __restrict__ seed,
                 int32_t* __restrict__ out, int n_pool, int n_seed) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int p0 = blockIdx.y * kBM;
  const int s0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5;
  const int wm = warp & 1;
  const int wn = warp >> 1;

  int acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

  load_stage(smem, pool, seed, p0, s0, n_pool, n_seed, 0);
#pragma unroll 1
  for (int s = 0; s < kStages; ++s) {
    if (s + 1 < kStages) {
      load_stage(smem + ((s + 1) & 1) * kBufWords, pool, seed, p0, s0, n_pool,
                 n_seed, s + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const uint32_t* buf = smem + (s & 1) * kBufWords;
    compute_b1(buf, wm, wn, acc);
    __syncthreads();   // the buffer is refilled by the next stage's loads
  }

  const int l = threadIdx.x & 31;
  const int g = l >> 2;
  const int tig = l & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int p = p0 + wm * 64 + mt * 16 + half * 8 + g;
      if (p >= n_pool) continue;
      int32_t* row = out + static_cast<size_t>(p) * n_seed;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int s = s0 + wn * 32 + nt * 8 + tig * 2;
        if (s < n_seed) row[s] = acc[mt][nt][2 * half];
        if (s + 1 < n_seed) row[s + 1] = acc[mt][nt][2 * half + 1];
      }
    }
}

}  // namespace

// pool [n_pool, 128] and seed [n_seed, 128] packed words (int32 or uint32,
// 16-byte aligned rows), out [n_pool, n_seed] int32.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success).
extern "C" int bv_common_launch(const void* pool, const void* seed, void* out,
                                int n_pool, int n_seed, void* stream) {
  if (n_pool <= 0 || n_seed <= 0) return 0;
  const int smem = 2 * kBufWords * 4;   // 64 KB: two stages
  const cudaError_t e = cudaFuncSetAttribute(
      bv_common_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_seed + kBN - 1) / kBN, (n_pool + kBM - 1) / kBM);
  bv_common_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), static_cast<const uint32_t*>(seed),
      static_cast<int32_t*>(out), n_pool, n_seed);
  return static_cast<int>(cudaGetLastError());
}
