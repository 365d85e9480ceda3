// Fused k-means Lloyd step, batched over M clients, in one launch: the
// Hopper port of repro/kernels/kmeans_update/kernel.py:94
// (kmeans_update_pallas, K3, body _tile_update) and :164
// (kmeans_update_gather_pallas, K4, the minibatch step of the Sculley fit
// over the rows points[idx], gathered inside the kernel).
//
// What binds it on the H100.  K3 is bound by bytes: it must read the N×d
// points once and write 8 B a row (7.65 MB, 2.28 us at the HI coreset fit,
// M=3, N=49,000, d=11, K=14; 90 MB, 28.6 us at the YP fit, N=249,900,
// d=30, K=12).  Its M·N·K·(2d+4) f32 flops are under that time at the
// CUDA cores' rate, but one thread a row (below) must read every centroid
// from shared memory for every row, so shared-memory loads, not flops,
// bind the distances.  K4 at a YP minibatch step (B=1,024 rows of
// N=357,000, d=30, K=12) moves ~135 KB, a bound of 0.04 us: latency sets
// its time, the chain indices -> gathered rows -> distances -> sums ->
// reduce.  The first design (a CTA a 128-row tile, the tile rescanned once
// per (cluster, column) output, then a second launch of M CTAs adding the
// tiles' partials one after another) lost its time to the rescan, to a
// reduce on 3 of 132 SMs, to 8 warps an SM, and to a runtime width that
// kept each row in shared memory.  What this design does about each:
//
// - One launch a call; the reduce across CTAs is fused and in a fixed
//   order.  Each CTA publishes its partial (K·d sums, K counts), and takes
//   a ticket (release/acquire through a fence and an atomic) on its group
//   of 16 CTAs' counter; the group's last CTA stages the group's partials
//   in shared memory with 16-byte cp.async.cg and adds them in CTA order,
//   then takes a ticket on the client's counter, whose last taker adds the
//   groups' sums in group order and writes sums and counts.  Each last
//   taker sets its counter back to 0 for the next call (the wrapper zeroes
//   the counters once a device and stream).
// - Every SM busy.  The grid (rows a tile, tiles a CTA, CTAs a client) is
//   kernel.py's geometry() of (M, rows, K, d): as many CTAs as the card
//   holds at once (8 an SM, 64 registers a thread, fewer where shared
//   memory binds), each walking a contiguous ascending range of 128-row
//   tiles and carrying its sums in shared memory.  The next tile is staged
//   while the current one computes: K3's contiguous tile with 16-byte
//   cp.async, K4's gathered rows with 4-byte ones, its indices loaded two
//   tiles ahead.  A minibatch of up to 16 tiles is one tile a CTA in one
//   group: one level of reduce.
// - Rows in registers.  The kernel has an instance for each width d <= 32
//   (and one that reads d at run time): kmeans::nearest, unchanged, then
//   runs with d known, so a row's d values stay in registers across the K
//   centroids and only the centroids come from shared memory (8-byte loads
//   where d is even).
// - No rescan.  After the assignment the CTA sorts its tile's rows by
//   cluster (stable: __match_any_sync counts a cluster's rows in each
//   warp, then an exclusive scan over (cluster, warp)); a thread takes up
//   to 4 adjacent columns of one cluster and adds only that cluster's rows,
//   in row order, into tile sums that it adds to the CTA's running sums.
//
// The assignment and distance of a row are K5's (kmeans_assign.cu) bit for
// bit: kmeans::nearest runs a row's whole FMA chain in one thread, as there.
// No tensor cores: K3 is bound by bytes, and TF32 distances would move near
// ties.
//
// K3 and K4 are one template with one geometry for the same row count: the
// gathered tile is the tile K3 would stage from the pre-gathered rows, so K4
// is bitwise K3 on points[idx], sums and counts too.  A duplicated index
// counts each time it appears.  An index outside [0, N) never faults: its
// row gets assign -1 and sqd NaN and counts for no cluster.
//
// Deterministic: no float atomics, and the order of every sum (rows in row
// order within a tile, tiles in order within a CTA, CTAs in order within a
// group, groups in order) is fixed by the geometry, never by the order in
// which CTAs run or take tickets.  Counts are exact integers in f32.  Zero
// rows that the caller padded into the (M, N, d) stack are real rows here,
// counted as the reference counts them; core/kmeans.py corrects their count.
#include <array>
#include <cstdint>
#include <utility>

#include "kmeans_common.cuh"

namespace {

constexpr int THREADS = 128;       // a CTA; tiles hold 32, 64 or 128 rows
constexpr int MIN_CTAS_PER_SM = 8; // caps registers at 64: 32 warps an SM
constexpr int GROUP = 16;          // CTAs whose partials one CTA adds first
constexpr int RED_STAGE = 16;      // partial rows the stage holds, if it fits
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a CTA may use
constexpr int D_FIXED = 32;        // widths with an instance of their own
constexpr int SUM_COLS = 4;        // columns of a cluster a thread adds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 16 bytes through L2 only: also right for data that other CTAs wrote
// during this launch (after the fence and ticket of arrive_last)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// After this CTA's stores: true in the CTA that takes the last of n
// tickets of counter, which then sees every other taker's stores.
__device__ __forceinline__ bool arrive_last(int* counter, int n,
                                            int* flag_s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *flag_s = atomicAdd(counter, 1) == n - 1;
  __syncthreads();
  const bool last = *flag_s;
  if (last) __threadfence();
  return last;
}

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// Floats of a tile buffer: the rows, contiguous, after up to 3 floats that
// put the tile's first float at its global address's offset mod 16 B.
__host__ __device__ constexpr int tile_floats(int tile, int d) {
  return round4(tile * d + 3);
}

// The stage at the start of shared memory: two tile buffers, and at least
// `rows` partial rows of round4(K·d + K) floats for the reduce.
__host__ __device__ constexpr int stage_floats(int tile, int k, int d,
                                               int rows) {
  return 2 * tile_floats(tile, d) > rows * round4(k * d + k)
             ? 2 * tile_floats(tile, d) : rows * round4(k * d + k);
}

// Shared memory of one CTA, in 4-byte words, in the kernel's order, with a
// stage of `rows` partial rows.
__host__ __device__ constexpr size_t smem_words(int tile, int k, int d,
                                                int rows) {
  return (size_t)stage_floats(tile, k, d, rows) + 2 * k * d + 2 * k
         + 3 * (size_t)tile + (size_t)k * (tile / 32) + 2;
}

// The stage's partial rows: RED_STAGE where that fits, else one (a wide
// K·d + K); kernel.py's smem_bytes() keeps a copy of this choice.
__host__ __device__ constexpr int stage_rows(int tile, int k, int d) {
  return 4 * smem_words(tile, k, d, RED_STAGE) <= SMEM_MAX ? RED_STAGE : 1;
}

// acc_s[e] = Σ_r src[r·wp + e] for e < width, the rows r added in
// ascending order, staged chunk by chunk through the stage with 16-byte
// copies; then out(e, acc_s[e]).  acc_s[e] is thread e % THREADS's alone.
template <typename Out>
__device__ __forceinline__ void add_rows(const float* src, int rows,
                                         int width, int wp, float* stage,
                                         int chunk, float* acc_s, Out out) {
  const int t = threadIdx.x;
  for (int e = t; e < width; e += THREADS) acc_s[e] = 0.f;
  for (int r0 = 0; r0 < rows; r0 += chunk) {
    const int nr = min(chunk, rows - r0);
    __syncthreads();  // the stage is free
    for (int c = t; c < nr * wp / 4; c += THREADS)
      cp_async16(stage + 4 * c, src + (int64_t)r0 * wp + 4 * c);
    cp_async_wait_all();
    __syncthreads();
    for (int e = t; e < width; e += THREADS) {
      float tot = acc_s[e];
      for (int r = 0; r < nr; ++r) tot += stage[r * wp + e];
      acc_s[e] = tot;
    }
  }
  for (int e = t; e < width; e += THREADS) out(e, acc_s[e]);
}

// D > 0: the kernel for rows of exactly D columns, where every loop over
// the columns is unrolled and kmeans::nearest keeps the row's D values in
// registers across the K centroids; D = 0 reads d at run time.
template <bool GATHER, int D>
__global__ void __launch_bounds__(THREADS, MIN_CTAS_PER_SM)
kmeans_update_kernel(
    const int32_t* __restrict__ idx, const float* __restrict__ points,
    const float* __restrict__ cents, int32_t* __restrict__ assign,
    float* __restrict__ sqd, float* __restrict__ partials,
    int* __restrict__ tickets, float* __restrict__ sums,
    float* __restrict__ counts, int64_t n, int64_t b, int k, int k_real,
    int d_run, int tile, int tiles_per_cta, int n_tiles) {
  extern __shared__ __align__(16) float smem[];
  const int d = D > 0 ? D : d_run;
  const int nw = tile / 32;          // warps that hold rows
  const int width = k * d + k;
  const int wp = round4(width);      // a partial row's stride
  const int tf = tile_floats(tile, d);
  // the sums: `cols` adjacent columns a thread, `col_blocks` a cluster
  const int cols = min(SUM_COLS, max(1, (k * d + THREADS - 1) / THREADS));
  const int col_blocks = (d + cols - 1) / cols;
  float* stage_s = smem;             // two tiles of rows; the reduce's rows
  const int stage_n = stage_floats(tile, k, d, stage_rows(tile, k, d));
  float* c_s = stage_s + stage_n;
  float* c2_s = c_s + k * d;
  float* acc_s = c2_s + k;           // the CTA's sums, then counts
  int32_t* src_s = (int32_t*)(acc_s + width);  // K4: two tiles' sources
  int32_t* order_s = src_s + 2 * tile;  // the tile's rows by cluster
  int32_t* base_s = order_s + tile;     // (cluster, warp) counts -> offsets
  int32_t* last_s = base_s + k * nw + 1;

  const int m = blockIdx.y, cta = blockIdx.x, ctas = gridDim.x;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int first = cta * tiles_per_cta;
  const int end = min(first + tiles_per_cta, n_tiles);
  const float* pts = points + (int64_t)m * n * d;
  const int32_t* ix = GATHER ? idx + (int64_t)m * b : nullptr;

  auto rows_of = [&](int i) {
    return (int)max((int64_t)0, min((int64_t)tile, b - (int64_t)i * tile));
  };
  // K3: tile i's first float in global memory, and its rows in buffer s
  // (at the same offset mod 16 B, so that 16-byte copies line up)
  auto tile_src = [&](int i) { return pts + (int64_t)i * tile * d; };
  auto tile_rows = [&](int i, int s) {
    const int off =
        GATHER ? 0 : (int)((reinterpret_cast<uintptr_t>(tile_src(i)) >> 2) & 3);
    return stage_s + s * tf + off;
  };
  // K4: row t's index in tile i, read raw (checked when it is used)
  auto load_idx = [&](int i) -> int32_t {
    return (GATHER && i < end && t < rows_of(i))
               ? ix[(int64_t)i * tile + t] : -1;
  };
  auto checked = [&](int32_t v) -> int32_t {
    return (v >= 0 && (int64_t)v < n) ? v : -1;
  };
  // tile i's rows into buffer s.  K3: the tile is contiguous, so 16-byte
  // copies with 4-byte ones at its two ends.  K4: element e = r·d + j of
  // the tile from row src_s[r], threads walking e in steps of THREADS.
  auto stage = [&](int i, int s) {
    const int rows = rows_of(i);
    float* dst = tile_rows(i, s);
    if (!GATHER) {
      const float* g = tile_src(i);
      const int cnt = rows * d;
      const int head = min(cnt, (4 - (int)((dst - stage_s) & 3)) & 3);
      const int n16 = (cnt - head) / 4;
      const int tail = head + 4 * n16;
      if (t < head) cp_async4(dst + t, g + t);
      for (int c = t; c < n16; c += THREADS)
        cp_async16(dst + head + 4 * c, g + head + 4 * c);
      if (t < cnt - tail) cp_async4(dst + tail + t, g + tail + t);
      return;
    }
    const int dr = THREADS / d, dj = THREADS - dr * d;
    int r = t / d, j = t - r * d;
    for (int e = t; e < rows * d; e += THREADS) {
      const int32_t src = src_s[s * tile + r];
      if (src >= 0) cp_async4(dst + e, pts + (int64_t)src * d + j);
      else dst[e] = 0.f;
      r += dr;
      j += dj;
      if (j >= d) {
        j -= d;
        ++r;
      }
    }
  };

  // the first tile's rows (K4: its indices) load while the centroids stage
  int32_t next_idx = load_idx(first);
  if (!GATHER) stage(first, 0);
  kmeans::stage_centroids(cents + (int64_t)m * k * d, c_s, c2_s, k, d);
  for (int e = t; e < width; e += THREADS) acc_s[e] = 0.f;
  if (GATHER) {
    if (t < tile) src_s[t] = checked(next_idx);
    next_idx = load_idx(first + 1);
    __syncthreads();
    stage(first, 0);
  }

  for (int i = first; i < end; ++i) {
    const int s = (i - first) & 1;
    if (GATHER && i + 1 < end && t < tile) {
      src_s[(s ^ 1) * tile + t] = checked(next_idx);
      next_idx = load_idx(i + 2);
    }
    cp_async_wait_all();
    __syncthreads();  // tile i is in; tile i - 1's buffers are free
    if (i + 1 < end) stage(i + 1, s ^ 1);
    for (int e = t; e < k * nw; e += THREADS) base_s[e] = 0;

    const int rows = rows_of(i);
    const int64_t r0 = (int64_t)i * tile;
    const float* p = tile_rows(i, s);
    int32_t q = -1;
    if (t < rows) {
      float dist = __int_as_float(0x7fc00000);  // NaN
      if (!GATHER || src_s[s * tile + t] >= 0)
        kmeans::nearest(p + t * d, c_s, c2_s, k, k_real, d, &q, &dist);
      assign[(int64_t)m * b + r0 + t] = q;
      sqd[(int64_t)m * b + r0 + t] = dist;
    }
    __syncthreads();

    // stable counting sort of the tile's rows by cluster: a warp's rows of
    // cluster q, then their rank among them
    int rank = 0;
    if (w < nw) {
      const unsigned peers = __match_any_sync(FULL, q);
      rank = __popc(peers & ((1u << lane) - 1));
      if (q >= 0 && rank == 0) base_s[q * nw + w] = __popc(peers);
    }
    __syncthreads();
    if (w == 0) {  // exclusive scan over (cluster, warp); the total last
      int carry = 0;
      for (int e0 = 0; e0 < k * nw; e0 += 32) {
        const int e = e0 + lane;
        const int v = e < k * nw ? base_s[e] : 0;
        int incl = v;
        for (int o = 1; o < 32; o <<= 1) {
          const int u = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += u;
        }
        if (e < k * nw) base_s[e] = carry + incl - v;
        carry += __shfl_sync(FULL, incl, 31);
      }
      if (lane == 0) base_s[k * nw] = carry;
    }
    __syncthreads();
    if (q >= 0) order_s[base_s[q * nw + w] + rank] = t;
    __syncthreads();

    // cluster q's sums: a thread takes up to SUM_COLS adjacent columns j of
    // one cluster and adds the cluster's rows to each in row order
    for (int blk = t; blk < k * col_blocks; blk += THREADS) {
      const int qe = blk / col_blocks, j0 = (blk - qe * col_blocks) * cols;
      const int nc = min(cols, d - j0);
      float acc[SUM_COLS] = {};
      for (int r = base_s[qe * nw]; r < base_s[(qe + 1) * nw]; ++r) {
        const float* row = p + order_s[r] * d + j0;
#pragma unroll
        for (int c = 0; c < SUM_COLS; ++c)
          if (c < nc) acc[c] += row[c];
      }
#pragma unroll
      for (int c = 0; c < SUM_COLS; ++c)
        if (c < nc) acc_s[qe * d + j0 + c] += acc[c];
    }
    for (int qe = t; qe < k; qe += THREADS)
      acc_s[k * d + qe] += (float)(base_s[(qe + 1) * nw] - base_s[qe * nw]);
  }

  // publish the partial; the last CTA of each group of GROUP CTAs adds
  // the group's partials in CTA order, and the last of those the groups'
  // sums in group order (one group: its sum is the result)
  const int n_groups = (ctas + GROUP - 1) / GROUP;
  const int g = cta / GROUP;
  const int g_size = min(GROUP, ctas - g * GROUP);
  const int chunk = stage_n / wp;
  float* part = partials + (int64_t)m * (ctas + n_groups) * wp;
  int* tick = tickets + (int64_t)m * (1 + n_groups);
  auto result = [&](int e, float v) {
    if (e < k * d) sums[(int64_t)m * k * d + e] = v;
    else counts[(int64_t)m * k + (e - k * d)] = v;
  };
  __syncthreads();  // acc_s[e] was added by another thread than e's
  for (int e = t; e < width; e += THREADS)
    part[(int64_t)cta * wp + e] = acc_s[e];
  if (!arrive_last(tick + 1 + g, g_size, last_s)) return;
  if (t == 0) tick[1 + g] = 0;
  if (n_groups == 1) {
    add_rows(part, ctas, width, wp, stage_s, chunk, acc_s, result);
    return;
  }
  add_rows(part + (int64_t)g * GROUP * wp, g_size, width, wp, stage_s,
           chunk, acc_s, [&](int e, float v) {
             part[(int64_t)(ctas + g) * wp + e] = v;
           });
  if (!arrive_last(tick, n_groups, last_s)) return;
  if (t == 0) tick[0] = 0;
  add_rows(part + (int64_t)ctas * wp, n_groups, width, wp, stage_s, chunk,
           acc_s, result);
}

template <bool GATHER, int... Ds>
auto kernel_table(std::integer_sequence<int, Ds...>) {
  return std::array<decltype(&kmeans_update_kernel<GATHER, 0>),
                    sizeof...(Ds)>{&kmeans_update_kernel<GATHER, Ds>...};
}

template <bool GATHER>
int launch(const void* idx, const void* points, const void* cents,
           void* assign, void* sqd, void* partials, void* tickets, void* sums,
           void* counts, long long m, long long n, long long b, long long k,
           long long k_real, long long d, long long tile,
           long long tiles_per_cta, long long ctas, void* stream) {
  if (m == 0 || k == 0) return 0;
  const long long n_tiles = b > 0 ? (b + tile - 1) / tile : 1;
  // the geometry must give every tile to one CTA and every CTA a tile
  if (tile < 32 || tile > THREADS || tile % 32 || d < 1 ||
      tiles_per_cta < 1 || (ctas - 1) * tiles_per_cta >= n_tiles ||
      ctas * tiles_per_cta < n_tiles)
    return (int)cudaErrorInvalidValue;
  static const auto table =
      kernel_table<GATHER>(std::make_integer_sequence<int, D_FIXED + 1>{});
  const auto kernel = table[d <= D_FIXED ? d : 0];
  const size_t smem =
      4 * smem_words((int)tile, (int)k, (int)d,
                     stage_rows((int)tile, (int)k, (int)d));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)ctas, (unsigned)m);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const float*)points, (const float*)cents,
      (int32_t*)assign, (float*)sqd, (float*)partials, (int*)tickets,
      (float*)sums, (float*)counts, n, b, (int)k, (int)k_real, (int)d,
      (int)tile, (int)tiles_per_cta, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// K3. points (m, n, d), cents (m, k, d) f32; assign (m, n) i32, sqd (m, n)
// f32; partials (m, ctas + groups, round4(k*d + k)) f32 scratch, groups =
// ceil(ctas / 16); tickets (>= m · (1 + groups)) i32, zero before the first
// call and left zero by every call; sums (m, k, d), counts (m, k).  tile,
// tiles_per_cta, ctas: kernel.py's geometry(m, n, k, d).
extern "C" int kmeans_update_launch(
    const void* points, const void* cents, void* assign, void* sqd,
    void* partials, void* tickets, void* sums, void* counts, long long m,
    long long n, long long k, long long k_real, long long d, long long tile,
    long long tiles_per_cta, long long ctas, void* stream) {
  return launch<false>(nullptr, points, cents, assign, sqd, partials, tickets,
                       sums, counts, m, n, n, k, k_real, d, tile,
                       tiles_per_cta, ctas, stream);
}

// K4. idx (m, b) i32, points (m, n, d), cents (m, k, d) f32; assign (m, b)
// i32, sqd (m, b) f32 over the rows points[i, idx[i]]; partials, tickets,
// sums and counts as K3's; the geometry is kernel.py's geometry(m, b, k, d).
extern "C" int kmeans_update_gather_launch(
    const void* idx, const void* points, const void* cents, void* assign,
    void* sqd, void* partials, void* tickets, void* sums, void* counts,
    long long m, long long n, long long b, long long k, long long k_real,
    long long d, long long tile, long long tiles_per_cta, long long ctas,
    void* stream) {
  return launch<true>(idx, points, cents, assign, sqd, partials, tickets,
                      sums, counts, m, n, b, k, k_real, d, tile,
                      tiles_per_cta, ctas, stream);
}
