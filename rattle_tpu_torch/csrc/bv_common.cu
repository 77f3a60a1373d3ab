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
// Design: the tile loop of bv_tile.cuh (128 x 128 outputs a block of 8
// warps, packed words streamed by cp.async through a swizzled double buffer,
// mma.sync m16n8k256 .b1 .and.popc), each count then stored as int32.
// gate_block.cu runs the same loop and tests the counts in registers
// instead.  (A u8 MMA on 0/1 planes unpacked in registers was measured
// 2.2-2.7x slower at the main path's shapes; PERF.md.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "bv_tile.cuh"

namespace {

using bv_tile::kBM;
using bv_tile::kBN;
using bv_tile::kThreads;

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
  bv_tile::tile(smem, pool, seed, p0, s0, n_pool, n_seed, acc);

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
  const int smem = bv_tile::kTileSmem;   // 64 KB: two stages
  const cudaError_t e = cudaFuncSetAttribute(
      bv_common_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((n_seed + kBN - 1) / kBN, (n_pool + kBM - 1) / kBM);
  bv_common_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), static_cast<const uint32_t*>(seed),
      static_cast<int32_t*>(out), n_pool, n_seed);
  return static_cast<int>(cudaGetLastError());
}
