// PSI tag PRF (Hopper port of repro/kernels/psi_prf/kernel.py::prf_tags_pallas,
// whose body is repro/kernels/psi_prf/ref.py::prf_tags).
//
// One thread per id.  The batch is a (rows, n) int64 id array: every side of
// every pair of an alignment round, each row with its own session seed.  A
// thread splits its 64-bit id into two uint32 lanes, whitens them with the
// row's seed words (hi ^ seed0, lo ^ seed1), runs the 5-round Feistel network
// with the murmur3 fmix32 round function natively in uint32, masks tag_hi to
// 30 bits and stores the 62-bit tag as int64.
//
// Bound: bytes.  Each id is read once (8 B) and each tag written once (8 B);
// the ~40 integer operations per id are far below the card's integer rate, so
// the kernel is a streaming pass and its design is simply coalesced 8-byte
// loads and stores, one per thread.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__global__ void prf_kernel(const int64_t* __restrict__ ids,
                           const uint32_t* __restrict__ seeds,
                           int64_t* __restrict__ tags, int64_t n,
                           int64_t total) {
  const uint32_t keys[5] = {0x9E3779B9u, 0xBB67AE85u, 0x3C6EF372u,
                            0xA54FF53Au, 0x510E527Fu};
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t row = i / n;
  uint64_t id = (uint64_t)ids[i];
  uint32_t hi = (uint32_t)(id >> 32) ^ seeds[2 * row];
  uint32_t lo = (uint32_t)id ^ seeds[2 * row + 1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    uint32_t t = lo;
    lo = hi ^ fmix32(lo + keys[r]);
    hi = t;
  }
  hi &= 0x3FFFFFFFu;
  tags[i] = (int64_t)(((uint64_t)hi << 32) | lo);
}

}  // namespace

// ids, tags: (rows, n) int64 contiguous; seeds: (rows, 2) uint32 contiguous.
extern "C" int psi_prf_launch(const void* ids, const void* seeds, void* tags,
                              long long rows, long long n, void* stream) {
  int64_t total = (int64_t)rows * n;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  prf_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)ids, (const uint32_t*)seeds, (int64_t*)tags, n, total);
  return (int)cudaGetLastError();
}
