// Sorted intersect (Hopper port of
// repro/kernels/sorted_intersect/kernel.py::sorted_intersect_pallas, K7,
// whose body is repro/kernels/sorted_intersect/ref.py::sorted_intersect,
// and of ::sorted_intersect_tiled, K8, the reference's multi-pass schedule
// of the same merge for P > 2^18, which exists only because a TPU core's
// 16 MB VMEM cannot hold the single-pass block there; this kernel has no
// such bound and serves both, counted apart by P in kernel.py).
//
// Inputs per pair: A (receiver) and B (sender) keys, each (P,) ascending as
// unsigned 64-bit, key = (tag << 1) | origin, padded with the sentinels
// PAD_A = 0xFFFF_FFFF_FFFF_FFFF / PAD_B = 0xFFFF_FFFF_FFFF_FFFE.  Output per
// pair: the merged (2P,) keys, rank = cumsum(origin) and sel = "receiver slot
// whose predecessor is the same tag from the sender, with a valid key".
//
// The TPU ran a bitonic merge network in VMEM.  Here the merge is a merge
// path, one CTA a tile of TILE = THREADS * ITEMS consecutive merged slots of
// one pair (grid: tiles a pair, pairs), in one launch a call:
//
// 1. Partition.  The co-rank i(j) of merged slot j is the number of A keys
//    among slots 0..j-1 (A first on ties).  Warp 0 finds it for the tile's
//    first slot d0, warp 1 for the next tile's d1, in device memory: the 32
//    lanes probe 32 evenly spaced points of the diagonal's range and a
//    __ballot_sync finds the crossing, so each round cuts the range 32-fold
//    (4 rounds at P = 2^19, where a binary search takes 19 dependent ones).
// 2. Windows.  The tile's slots are exactly A[i0, i1) and B[k0, k1), k = d -
//    i: the CTA loads them into one shared buffer, A's window then B's,
//    each at the offset (0 or 1 key) that keeps every key at its place in
//    a 16-byte word, so both bodies move as aligned, coalesced 16-byte
//    words (a window starts at any key; an odd head or tail moves as one
//    key), and the one merged key before the tile, max(A[i0-1], B[k0-1])
//    of those that exist, the halo.
// 3. Merge.  Thread t takes the slots [t*ITEMS, (t+1)*ITEMS) of the tile:
//    a binary search in shared memory (log2(TILE) steps) gives its local
//    co-rank, then it merges ITEMS slots serially, A first on ties, and
//    keeps its running i, so rank = i0 + i + origin with no scan.  sel
//    needs the previous merged key: the thread's own last one, the window
//    key before its first slot, or the halo.
// 4. Stores.  The results (in registers while the windows are read) are
//    staged in shared memory over the windows, blocked (a thread's ITEMS
//    slots together) in 16-byte words with one word of padding after
//    every 8, so that neither the blocked writes nor the striped reads
//    conflict on a bank; the CTA then writes merged, rank and sel in
//    coalesced 16-byte stores (scalar stores for a ragged last tile or a
//    tile that does not start on 16 bytes, where 2P is not a multiple of 4).
//
// Every index inside a pair is 32-bit (the wrapper refuses 2P >= 2^31); a
// pair's offset is 64-bit, and pairs past the grid's 65,535 rows loop.
//
// Why the outputs are bitwise the reference's.  Every A key has origin bit
// 1 (PAD_A too) and every B key bit 0, so no A key equals a B key and the
// merged order of values is unique: any merge that is right gives the
// reference's keys.  Slot j took an A key exactly where its origin is 1, so
// rank[j] = i(j) + (merged[j] & 1) = the A keys among slots 0..j.  sel
// compares each slot with its predecessor in the merged order, as the
// reference does.  All comparisons are unsigned: the sentinels have the top
// bit set.
//
// Bound: bytes.  The function reads 2P keys and writes 2P keys plus two
// int32 a slot: 48 B a P.  This design reads each key once from device
// memory for the windows, plus the probes: about 4 rounds of 32 key pairs a
// boundary, two boundaries a tile.  kernel.py's merge_geometry takes the
// largest tile (512 or 2,048 slots) that still gives two CTAs an SM.
// Measured with chip_merge.py on NVIDIA H100 80GB HBM3, 700.00 W, device us
// a launch, median of 6 readings, in turns with the first design (one
// thread a merged slot, each running its own binary search of ~log2(P)
// dependent loads, a 64-bit division a slot, and scattered loads for the
// previous slot) and with this design's windows loaded as 8-byte keys;
// bound, first design and 8-byte loads in parentheses:
//   P = 2^17, 1 pair (the HI rounds, 512-slot tiles)   4.576 (1.878; 9.211; 4.794)
//   P = 2^19, 1 pair (the YP rounds, 2,048-slot tiles) 9.794 (7.512; 31.38; 9.975)
//   P = 2^20, 1 pair                                   24.24 (15.02; 64.12; 24.36)
//   P = 2^19, 9 pairs (a delta probe's batch)          95.05 (67.61; 265.4; 96.50)
//   P = 2^21, 1 pair                                   46.50 (30.05; 130.2; 46.74)
// By phase (chip_merge.py --phases, the same call): the windows' loads,
// staging and stores alone take 3.23 us at 2^17, 7.67 at 2^19 and 18.75 at
// 2^20 (8-byte loads: 3.50, 8.56, 21.21); the co-rank searches add 0.55 us
// at 2^17 and 4.4 at 2^20, the merge in shared memory 0.7 and 1.1.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

// slots a thread merges; kernel.py's ITEMS.  The instances' THREADS are
// kernel.py's THREADS.
constexpr int ITEMS = 8;
constexpr uint64_t TOP_BIT = 0x8000000000000000ull;

// a staged 16-byte word's place: one word of padding after every 8
__host__ __device__ constexpr int padded(int w) { return w + (w >> 3); }

// co-rank of diagonal d (the A keys among the first d merged slots, A first
// on ties) by one warp: each round the 32 lanes probe 32 evenly spaced
// points of [lo, hi); the probes that hold a[x] <= b[d-x-1] are a prefix,
// and the crossing lies after the last of them, before the next
__device__ __forceinline__ int warp_co_rank(const uint64_t* __restrict__ a,
                                            const uint64_t* __restrict__ b,
                                            int d, int p, int lane) {
  int lo = d > p ? d - p : 0;
  int hi = d < p ? d : p;
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int x = lo + lane * step;
    const bool before = x < hi && a[x] <= b[d - x - 1];
    const int c = __popc(__ballot_sync(0xffffffffu, before));
    if (c == 0) {
      hi = lo;
    } else {
      const int last = lo + (c - 1) * step;
      hi = min(last + step, hi);
      lo = last + 1;
    }
  }
  return lo;
}

// a CTA's shared memory in 16-byte words (kernel.py's merge_smem_bytes):
// the windows (TILE keys), then, after a barrier, the staged outputs over
// them (merged 2 a word, rank and sel 4 a word, padded)
template <int THREADS>
struct Smem {
  static constexpr int TILE = THREADS * ITEMS;
  static constexpr int MERGED_WORDS = padded(TILE / 2);
  static constexpr int INT_WORDS = padded(TILE / 4);
  static constexpr int STAGE_WORDS = MERGED_WORDS + 2 * INT_WORDS;
  static constexpr int WINDOW_WORDS = TILE / 2 + 1;  // + each offset
  static constexpr int WORDS =
      STAGE_WORDS > WINDOW_WORDS ? STAGE_WORDS : WINDOW_WORDS;
};

template <int THREADS>
__global__ void __launch_bounds__(THREADS)
    merge_path_kernel(const uint64_t* __restrict__ a_all,
                      const uint64_t* __restrict__ b_all,
                      int32_t* __restrict__ sel_all,
                      int32_t* __restrict__ rank_all,
                      uint64_t* __restrict__ merged_all, int p,
                      long long pairs) {
  using S = Smem<THREADS>;
  constexpr int TILE = S::TILE;
  __shared__ ulonglong2 smem[S::WORDS];
  __shared__ int bounds[2];
  __shared__ uint64_t halo;

  const int tid = threadIdx.x;
  const int two_p = 2 * p;
  const int d0 = blockIdx.x * TILE;
  const int n = min(TILE, two_p - d0);       // the tile's slots
  const int d1 = d0 + n;
  uint64_t* win = reinterpret_cast<uint64_t*>(smem);
  ulonglong2* st_merged = reinterpret_cast<ulonglong2*>(smem);
  int4* st_rank = reinterpret_cast<int4*>(smem + S::MERGED_WORDS);
  int4* st_sel = st_rank + S::INT_WORDS;

  for (long long pair = blockIdx.y; pair < pairs; pair += gridDim.y) {
    const uint64_t* a = a_all + pair * p;
    const uint64_t* b = b_all + pair * p;

    // 1. the co-ranks of the tile's first slot and the next tile's
    if (tid < 64) {
      const int d = tid < 32 ? d0 : d1;
      const int i = warp_co_rank(a, b, d, p, tid & 31);
      if ((tid & 31) == 0) bounds[tid >> 5] = i;
    }
    __syncthreads();
    const int i0 = bounds[0];
    const int la = bounds[1] - i0;             // A keys in the tile
    const int lb = n - la;                     // B keys in the tile
    const int k0 = d0 - i0;

    // 2. the windows and the halo.  Each window keeps its key's place in
    // a 16-byte word (A[i0] at win[aoff], B[k0] at win[boff], each offset
    // the parity of its key's address), so the bodies of both windows
    // move as aligned 16-byte words, global to shared; a window's odd
    // head and tail move as single keys
    const uint64_t* ga = a + i0;
    const uint64_t* gb = b + k0;
    const int aoff = (int)(reinterpret_cast<uintptr_t>(ga) >> 3) & 1;
    const int bpar = (int)(reinterpret_cast<uintptr_t>(gb) >> 3) & 1;
    const int boff = aoff + la + ((aoff + la + bpar) & 1);
    const int ha = min(aoff, la), hb = min(bpar, lb);
    const int wa_words = (la - ha) >> 1;       // A's body, 16-byte words
    const int w_words = wa_words + ((lb - hb) >> 1);
    ulonglong2 words[ITEMS / 2];
#pragma unroll
    for (int r = 0; r < ITEMS / 2; ++r) {      // w_words <= TILE / 2
      const int w = r * THREADS + tid;
      if (w < wa_words) {
        words[r] = reinterpret_cast<const ulonglong2*>(ga + ha)[w];
      } else if (w < w_words) {
        words[r] = reinterpret_cast<const ulonglong2*>(gb + hb)[w - wa_words];
      }
    }
    // thread 0-3: A's head, A's tail, B's head, B's tail (where odd)
    uint64_t single = 0;
    int single_at = -1;
    if (tid == 0 && ha) {
      single = ga[0], single_at = aoff;
    } else if (tid == 1 && ((la - ha) & 1)) {
      single = ga[la - 1], single_at = aoff + la - 1;
    } else if (tid == 2 && hb) {
      single = gb[0], single_at = boff;
    } else if (tid == 3 && ((lb - hb) & 1)) {
      single = gb[lb - 1], single_at = boff + lb - 1;
    }
    if (tid == 4 && d0 > 0) {
      const uint64_t pa = i0 > 0 ? a[i0 - 1] : 0;
      const uint64_t pb = k0 > 0 ? b[k0 - 1] : 0;
      halo = pa > pb ? pa : pb;
    }
#pragma unroll
    for (int r = 0; r < ITEMS / 2; ++r) {
      const int w = r * THREADS + tid;
      if (w < wa_words) {
        smem[((aoff + ha) >> 1) + w] = words[r];
      } else if (w < w_words) {
        smem[((boff + hb) >> 1) + w - wa_words] = words[r];
      }
    }
    if (single_at >= 0) win[single_at] = single;
    __syncthreads();

    // 3. this thread's ITEMS slots
    const uint64_t* wa = win + aoff;
    const uint64_t* wb = win + boff;
    const int dl = tid * ITEMS;
    uint64_t merged[ITEMS];
    int rank[ITEMS];
    unsigned sel = 0;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      merged[it] = 0;
      rank[it] = 0;
    }
    if (dl < n) {
      int lo = dl > lb ? dl - lb : 0;
      int hi = dl < la ? dl : la;
      while (lo < hi) {
        const int m = (lo + hi) >> 1;
        if (wa[m] <= wb[dl - m - 1]) {
          lo = m + 1;
        } else {
          hi = m;
        }
      }
      int i = lo, k = dl - lo;
      uint64_t prev;
      if (dl == 0) {
        prev = halo;
      } else if (i == 0) {
        prev = wb[k - 1];
      } else if (k == 0) {
        prev = wa[i - 1];
      } else {
        prev = wa[i - 1] > wb[k - 1] ? wa[i - 1] : wb[k - 1];
      }
      bool has_prev = d0 + dl > 0;
      uint64_t va = i < la ? wa[i] : 0;
      uint64_t vb = k < lb ? wb[k] : 0;
#pragma unroll
      for (int it = 0; it < ITEMS; ++it) {
        if (dl + it < n) {
          const bool take_a = k >= lb || (i < la && va <= vb);
          const uint64_t key = take_a ? va : vb;
          if (take_a) {
            ++i;
            va = i < la ? wa[i] : 0;
          } else {
            ++k;
            vb = k < lb ? wb[k] : 0;
          }
          // origin bit set, so key - 1 == key ^ 1 (no borrow)
          const bool s = take_a && has_prev && prev == (key ^ 1ull) &&
                         key < TOP_BIT;
          sel |= (unsigned)s << it;
          rank[it] = i0 + i;                   // A keys among slots 0..j
          merged[it] = key;
          prev = key;
          has_prev = true;
        }
      }
    }
    __syncthreads();                           // the windows are read

    // 4. staged blocked, stored striped in 16-byte words
#pragma unroll
    for (int q = 0; q < ITEMS / 2; ++q) {
      st_merged[padded(tid * (ITEMS / 2) + q)] =
          make_ulonglong2(merged[2 * q], merged[2 * q + 1]);
    }
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int w = padded(tid * (ITEMS / 4) + q);
      st_rank[w] = make_int4(rank[4 * q], rank[4 * q + 1], rank[4 * q + 2],
                             rank[4 * q + 3]);
      st_sel[w] = make_int4((sel >> (4 * q)) & 1, (sel >> (4 * q + 1)) & 1,
                            (sel >> (4 * q + 2)) & 1,
                            (sel >> (4 * q + 3)) & 1);
    }
    __syncthreads();
    const long long g0 = pair * two_p + d0;
    uint64_t* out_merged = merged_all + g0;
    int32_t* out_rank = rank_all + g0;
    int32_t* out_sel = sel_all + g0;
    if (n == TILE && (g0 & 3) == 0) {
#pragma unroll
      for (int r = 0; r < ITEMS / 2; ++r) {
        const int w = r * THREADS + tid;
        reinterpret_cast<ulonglong2*>(out_merged)[w] = st_merged[padded(w)];
      }
#pragma unroll
      for (int r = 0; r < ITEMS / 4; ++r) {
        const int w = r * THREADS + tid;
        reinterpret_cast<int4*>(out_rank)[w] = st_rank[padded(w)];
        reinterpret_cast<int4*>(out_sel)[w] = st_sel[padded(w)];
      }
    } else {
      const uint64_t* flat_merged = reinterpret_cast<const uint64_t*>(st_merged);
      const int32_t* flat_rank = reinterpret_cast<const int32_t*>(st_rank);
      const int32_t* flat_sel = reinterpret_cast<const int32_t*>(st_sel);
      for (int e = tid; e < n; e += THREADS) {
        out_merged[e] = flat_merged[2 * padded(e >> 1) + (e & 1)];
        out_rank[e] = flat_rank[4 * padded(e >> 2) + (e & 3)];
        out_sel[e] = flat_sel[4 * padded(e >> 2) + (e & 3)];
      }
    }
    // the next pair's bounds and windows wait for every thread at the
    // barrier after its co-ranks, past these reads
  }
}

template <int THREADS>
cudaError_t launch(const void* a, const void* b, void* sel, void* rank,
                   void* merged, long long pairs, long long p,
                   cudaStream_t stream) {
  constexpr long long TILE = THREADS * ITEMS;
  const dim3 grid((unsigned)((2 * p + TILE - 1) / TILE),
                  (unsigned)(pairs < 65535 ? pairs : 65535));
  merge_path_kernel<THREADS><<<grid, THREADS, 0, stream>>>(
      (const uint64_t*)a, (const uint64_t*)b, (int32_t*)sel, (int32_t*)rank,
      (uint64_t*)merged, (int)p, pairs);
  return cudaGetLastError();
}

}  // namespace

// a, b: (pairs, p) int64 keys (read as uint64); sel, rank: (pairs, 2p) int32;
// merged: (pairs, 2p) int64; threads: a CTA's, one of kernel.py's THREADS
// (kernel.py's merge_geometry picks it), so a tile is threads * ITEMS slots.
extern "C" int sorted_intersect_launch(const void* a, const void* b, void* sel,
                                       void* rank, void* merged,
                                       long long pairs, long long p,
                                       long long threads, void* stream) {
  if (pairs == 0 || p == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (threads) {
    case 64:
      return (int)launch<64>(a, b, sel, rank, merged, pairs, p, s);
    case 256:
      return (int)launch<256>(a, b, sel, rank, merged, pairs, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
