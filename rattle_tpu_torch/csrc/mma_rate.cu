// mma_rate: a probe, not a kernel of any path.  It measures the rate at which
// the tensor cores run mma.sync from registers alone (no memory traffic in
// the loop), for 1-bit operands (m16n8k256 .b1 .and.popc, bv_common's
// instruction) and for 8-bit ones (m16n8k32 .s8).  NVIDIA publishes no 1-bit
// rate for the H100, so bv_common's bound scales the published int8 peak by
// the measured ratio of the two (chip_smoke.py phase 2).
//
// Every warp runs kChains independent accumulator chains of ``iters`` MMAs
// each; the sums are written out so that nothing is dead code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChains = 8;
constexpr int kThreads = 256;

template <int kKind>
__device__ __forceinline__ void mma(int* c, const uint32_t* a,
                                    const uint32_t* b) {
  if constexpr (kKind == 0)
    asm volatile(
        "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int kKind>
__global__ void __launch_bounds__(kThreads)
mma_rate_kernel(int iters, int32_t* __restrict__ out) {
  const uint32_t t = threadIdx.x * 0x9e3779b9u + blockIdx.x;
  const uint32_t a[4] = {t, t ^ 0x5a5a5a5au, t * 3u, ~t};
  const uint32_t b[2] = {t >> 3, t ^ 0x0f0f0f0fu};
  int acc[kChains][4] = {};
#pragma unroll 1
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < kChains; ++c) mma<kKind>(acc[c], a, b);
  int sum = 0;
#pragma unroll
  for (int c = 0; c < kChains; ++c)
    sum += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// ``kind`` 0 the .b1 MMA, 1 the .s8 MMA; ``blocks`` CTAs of 256 threads, each
// warp issuing kChains x ``iters`` MMAs; ``out`` int32 [blocks * 256].
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mma_rate_launch(int kind, int iters, int blocks, void* out,
                               void* stream) {
  if (blocks <= 0 || iters <= 0 || (kind != 0 && kind != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = kind == 0 ? mma_rate_kernel<0> : mma_rate_kernel<1>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
