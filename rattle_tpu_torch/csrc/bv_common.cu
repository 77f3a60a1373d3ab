// bv_common: popcount(AND) of two 4096-bit 6-mer presence vectors for every
// (pool, seed) pair (the reference's bitvector gate, cluster.cpp:13-19).
//
// Replaces rattle_tpu/ops/pallas_kernels.py::bv_common_matmul (_gate_kernel,
// _unpack_bits_bf16).  The TPU kernel unpacked the packed words into bf16 bit
// planes and contracted them on the MXU; here the packed words are consumed
// directly: out[p, s] = sum_w popc(pool[p, w] & seed[s, w]) over 128 words,
// exact in 32-bit integers.
//
// Bound: integer popcount throughput, P*S*128 AND+POPC (POPC issues at a
// quarter of the integer ALU rate on sm_90).  The bytes moved, (P+S)*512 in
// and P*S*4 out, are far smaller.  Design: one 16x16 tile of outputs per
// block, one output per thread.  The tile's 16 pool rows and 16 seed rows
// (512 B each) are staged once in shared memory, so every packed word is read
// from device memory once per tile and 16 times from shared memory.  Rows are
// padded to 132 words: the 128-bit shared loads of the 16 seed rows a warp
// reads then fall on distinct banks in every quarter-warp phase.  Tensor
// cores (bf16 planes, or the binary b1 MMA with AND+POPC) would outrun this;
// that redesign is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWords = 128;       // 4096 bits
constexpr int kTile = 16;         // 16 x 16 outputs per block
constexpr int kPitch = kWords + 4;  // padded shared row, in words
constexpr int kVec = kWords / 4;  // uint4 per row

__global__ void __launch_bounds__(kTile * kTile)
bv_common_kernel(const uint32_t* __restrict__ pool,
                 const uint32_t* __restrict__ seed,
                 int32_t* __restrict__ out, int n_pool, int n_seed) {
  __shared__ __align__(16) uint32_t sp[kTile * kPitch];
  __shared__ __align__(16) uint32_t ss[kTile * kPitch];
  const int tx = threadIdx.x;             // seed column within the tile
  const int ty = threadIdx.y;             // pool row within the tile
  const int tid = ty * kTile + tx;
  const int p0 = blockIdx.y * kTile;
  const int s0 = blockIdx.x * kTile;

  // stage both tiles: 16 rows x 32 uint4 each side, zero past the edge
  const uint4* pool4 = reinterpret_cast<const uint4*>(pool);
  const uint4* seed4 = reinterpret_cast<const uint4*>(seed);
  for (int i = tid; i < kTile * kVec; i += kTile * kTile) {
    const int r = i / kVec;
    const int q = i % kVec;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    const uint4 a = (p0 + r < n_pool)
        ? pool4[static_cast<size_t>(p0 + r) * kVec + q] : zero;
    const uint4 b = (s0 + r < n_seed)
        ? seed4[static_cast<size_t>(s0 + r) * kVec + q] : zero;
    *reinterpret_cast<uint4*>(&sp[r * kPitch + 4 * q]) = a;
    *reinterpret_cast<uint4*>(&ss[r * kPitch + 4 * q]) = b;
  }
  __syncthreads();

  const uint4* a4 = reinterpret_cast<const uint4*>(&sp[ty * kPitch]);
  const uint4* b4 = reinterpret_cast<const uint4*>(&ss[tx * kPitch]);
  int acc = 0;
#pragma unroll 8
  for (int q = 0; q < kVec; ++q) {
    const uint4 a = a4[q];
    const uint4 b = b4[q];
    acc += __popc(a.x & b.x) + __popc(a.y & b.y) +
           __popc(a.z & b.z) + __popc(a.w & b.w);
  }
  const int p = p0 + ty;
  const int s = s0 + tx;
  if (p < n_pool && s < n_seed) out[static_cast<size_t>(p) * n_seed + s] = acc;
}

}  // namespace

// pool [n_pool, 128] and seed [n_seed, 128] packed words (int32 or uint32,
// 16-byte aligned rows), out [n_pool, n_seed] int32.  Launches on ``stream``
// and returns cudaGetLastError() (0 on success).
extern "C" int bv_common_launch(const void* pool, const void* seed, void* out,
                                int n_pool, int n_seed, void* stream) {
  if (n_pool <= 0 || n_seed <= 0) return 0;
  const dim3 block(kTile, kTile);
  const dim3 grid((n_seed + kTile - 1) / kTile, (n_pool + kTile - 1) / kTile);
  bv_common_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pool), static_cast<const uint32_t*>(seed),
      static_cast<int32_t*>(out), n_pool, n_seed);
  return static_cast<int>(cudaGetLastError());
}
