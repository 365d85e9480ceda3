// Sorted intersect (Hopper port of
// repro/kernels/sorted_intersect/kernel.py::sorted_intersect_pallas, whose
// body is repro/kernels/sorted_intersect/ref.py::sorted_intersect, and of
// ::sorted_intersect_tiled, the reference's multi-pass schedule of the same
// merge for P > 2^18, which exists only because a TPU core's 16 MB VMEM
// cannot hold the single-pass block there; this kernel has no such bound).
//
// Inputs per pair: A (receiver) and B (sender) keys, each (P,) ascending as
// unsigned 64-bit, key = (tag << 1) | origin, padded with the sentinels
// PAD_A = 0xFFFF_FFFF_FFFF_FFFF / PAD_B = 0xFFFF_FFFF_FFFF_FFFE.  Output per
// pair: the merged (2P,) keys, rank = cumsum(origin) and sel = "receiver slot
// whose predecessor is the same tag from the sender, with a valid key".
//
// The TPU ran a bitonic merge network in VMEM.  Here the merge is a merge
// path: one thread per merged output slot j.  A binary search on the
// cross-diagonal gives the co-rank i(j), the number of A keys among merged
// slots 0..j-1; the merged value at j is min(A[i], B[j-i]) and the value at
// j-1 is max(A[i-1], B[j-i-1]).  Every A key has origin bit 1 (PAD_A too) and
// every B key bit 0, so rank[j] = i(j) + (merged[j] & 1): no scan.  Keys are
// unique within a side apart from the identical pads, and the two sentinels
// differ, so the merged sequence of values is unique and the outputs equal
// the reference's bit for bit.  All comparisons are unsigned: the sentinels
// have the top bit set.
//
// Bound: bytes.  The function reads 2P keys and writes 2P keys plus two int32
// per slot (32 B per input key); the binary search re-reads ~log2(P) keys per
// thread.  Measured with chip_smoke.py on an H100 80GB HBM3 at 700 W: 9.1 us
// at P = 2^17 (bound 1.9 us), 31.7 us at P = 2^19 (bound 7.5 us), 64.3 us at
// 2^20 (bound 15.0 us), and 252 us for nine pairs at 2^19 (72 MB of keys,
// past the 50 MB L2; bound 67.6 us), i.e. 28 us a pair: the re-reads did not
// cost more once the keys overflowed L2.  torch.sort of the same 2P keys
// took 0.28, 0.43 and 1.89 ms.  A CTA-level merge path (co-rank once per
// tile, then a shared-memory merge) is the known next step.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// number of A keys among the first t merged slots (A first on ties)
__device__ __forceinline__ int64_t co_rank(const uint64_t* __restrict__ a,
                                           const uint64_t* __restrict__ b,
                                           int64_t t, int64_t p) {
  int64_t lo = t > p ? t - p : 0;
  int64_t hi = t < p ? t : p;
  while (lo < hi) {
    int64_t i = (lo + hi) >> 1;
    if (a[i] <= b[t - i - 1]) {
      lo = i + 1;
    } else {
      hi = i;
    }
  }
  return lo;
}

__global__ void merge_kernel(const uint64_t* __restrict__ a_all,
                             const uint64_t* __restrict__ b_all,
                             int32_t* __restrict__ sel,
                             int32_t* __restrict__ rank,
                             uint64_t* __restrict__ merged, int64_t p,
                             int64_t total) {
  int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int64_t two_p = 2 * p;
  const int64_t pair = g / two_p;
  const int64_t j = g - pair * two_p;
  const uint64_t* a = a_all + pair * p;
  const uint64_t* b = b_all + pair * p;

  const int64_t i = co_rank(a, b, j, p);  // A keys among slots 0..j-1
  const int64_t k = j - i;                // B keys among slots 0..j-1
  uint64_t cur;
  if (i >= p) {
    cur = b[k];
  } else if (k >= p) {
    cur = a[i];
  } else {
    cur = a[i] <= b[k] ? a[i] : b[k];
  }
  const int32_t origin = (int32_t)(cur & 1ull);
  int32_t s = 0;
  if (j > 0 && origin) {
    uint64_t prev;
    if (i == 0) {
      prev = b[k - 1];
    } else if (k == 0) {
      prev = a[i - 1];
    } else {
      prev = a[i - 1] >= b[k - 1] ? a[i - 1] : b[k - 1];
    }
    // origin bit set, so key - 1 == key ^ 1 (no borrow)
    s = (prev == (cur ^ 1ull)) && (cur < 0x8000000000000000ull);
  }
  sel[g] = s;
  rank[g] = (int32_t)i + origin;
  merged[g] = cur;
}

}  // namespace

// a, b: (pairs, p) int64 keys (read as uint64); sel, rank: (pairs, 2p) int32;
// merged: (pairs, 2p) int64.
extern "C" int sorted_intersect_launch(const void* a, const void* b, void* sel,
                                       void* rank, void* merged,
                                       long long pairs, long long p,
                                       void* stream) {
  int64_t total = (int64_t)pairs * 2 * p;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  merge_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)a, (const uint64_t*)b, (int32_t*)sel, (int32_t*)rank,
      (uint64_t*)merged, p, total);
  return (int)cudaGetLastError();
}
