// mma_rate: a probe, not a kernel of any path.  It measures the rate at which
// the tensor cores run mma.sync from registers alone (no memory traffic in
// the loop), for 1-bit operands (m16n8k256 .b1 .and.popc, bv_common's
// instruction) and for 8-bit ones (m16n8k32 .s8).  NVIDIA publishes no 1-bit
// rate for the H100, so bv_common's bound scales the published int8 peak by
// the measured ratio of the two (chip_smoke.py phase 2).  A third kind runs
// Hopper's warpgroup MMA on 1-bit operands, wgmma m64n128k256 .b1
// .and.popc with both operands read from shared memory, the instruction a
// wgmma version of the gate's tile would use.
//
// Every warp runs kChains independent accumulator chains of ``iters`` MMAs
// each (the wgmma kind: each warpgroup one accumulator, kWgBatch wgmmas a
// committed group, one group left in flight); the sums are written out so
// that nothing is dead code.

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

constexpr int kWgBatch = 4;                  // wgmmas a committed group
constexpr int kWgSmem = 16384;               // A and B tiles of both groups

// a shared-memory matrix descriptor without swizzle: start address, leading
// dimension byte offset 128 and stride byte offset 256 (each >> 4); the
// probe's operands are arbitrary bits, so only the rate matters
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
  const uint64_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(p)) & 0x3FFFF;
  return (addr >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_b1(uint32_t (&d)[64], uint64_t a,
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k256.s32.b1.b1.and.popc "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b));
}

__global__ void __launch_bounds__(kThreads)
wgmma_rate_kernel(int iters, int32_t* __restrict__ out) {
  __shared__ __align__(128) uint32_t s[kWgSmem / 4];
  for (int i = threadIdx.x; i < kWgSmem / 4; i += kThreads)
    s[i] = (i * 0x9e3779b9u) ^ blockIdx.x;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x >> 7;
  // each warpgroup: A 64 x 256 bits (2 KB), B 128 x 256 bits (4 KB)
  const uint64_t da = wg_desc(s + wg * 2048);
  const uint64_t db = wg_desc(s + wg * 2048 + 512);
  uint32_t d[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0;
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int k = 0; k < kWgBatch; ++k) wgmma_b1(d, da, db);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int sum = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) sum += static_cast<int>(d[i]);
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

}  // namespace

// ``kind`` 0 the .b1 MMA, 1 the .s8 MMA, each warp issuing kChains x
// ``iters`` MMAs; 2 wgmma .b1, each warpgroup issuing kWgBatch x ``iters``
// wgmmas of 64 x 128 x 256; ``blocks`` CTAs of 256 threads; ``out`` int32
// [blocks * 256].
// Launches on ``stream`` and returns cudaGetLastError() (0 on success).
extern "C" int mma_rate_launch(int kind, int iters, int blocks, void* out,
                               void* stream) {
  if (blocks <= 0 || iters <= 0 || kind < 0 || kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == 2) {
    wgmma_rate_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        iters, static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  }
  const auto kernel = kind == 0 ? mma_rate_kernel<0> : mma_rate_kernel<1>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      iters, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
