// k-means assign step, batched over M clients, in one launch: the Hopper
// port of repro/kernels/kmeans_assign/kernel.py:39 (kmeans_assign_pallas,
// K5, body _assign_kernel at :22).  For each row: d² = ‖p‖² − 2p·c + ‖c‖²
// against every centroid, clamped at 0, centroids q >= k_real masked, the
// first minimum.
//
// What binds it on the H100.  Its bound is bytes: it reads the N×d points
// once and writes 8 B a row (7.65 MB, 2.28 us at the HI coreset fit, M=3,
// N=49,000, d=11, K=14; 96 MB, 28.65 us at the YP fit, N=249,900, d=30,
// K=12; 45.7 MB, 13.64 us at a YP minibatch build's end, M=1, N=357,000,
// d=30).  Its M·N·K·(2d+4) f32 flops take about a third of that at the CUDA
// cores' rate, but every centroid value reaches the FMAs through a
// shared-memory broadcast, which the phase timings (PERF.md §6) put near
// one f32 a cycle an SM whatever the load's width: so R rows a thread, each
// value feeding R FMAs.  The first design (a CTA a 128-row tile, the
// centroids staged again for every tile, the tile loaded and then computed,
// one thread a row at a run-time width) took 5× the bound.  What this
// design does about it:
//
// - Every SM busy, the centroids staged once a CTA.  The grid is kernel.py's
//   geometry() of (M, N, K, d): as many CTAs as the card holds at once,
//   each taking an equal contiguous range of rows, which it walks in
//   ascending tiles of THREADS·R rows (fewer where the CTA would overflow
//   shared memory).  A CTA stages its client's centroids once, at a row
//   stride of round4(d) floats with zero pads, and their norms.
// - Tiles streamed.  One tile buffer, refilled with the next tile as soon
//   as the rows are in registers, so the next tile loads while this one
//   computes.  A tile is one run of rows·d floats: its 16-byte-aligned body
//   moves as one bulk copy (cp.async.bulk under an mbarrier), a head and a
//   tail of up to 3 floats as 4-byte cp.async, into the buffer at the same
//   offset mod 16 B.  (2 and 3 buffers, and 16-byte cp.async in place of
//   the bulk copy, were slower: chip_assign.py --variants.)
// - Rows in registers.  An instance for each width D <= 32 with R = 4 rows
//   a thread, and one (D = 0, R = 1) that reads d at run time and each
//   row from shared memory.  Thread t holds rows t + r·THREADS, r < R
//   (8-byte loads where d and the buffer's offset are even): each 16-byte
//   centroid load (a broadcast ld.shared.v4) feeds R rows' FMAs, whose
//   columns are unrolled; pad lanes are never multiplied.
// - Stores: a warp writes 32 consecutive rows, whole 128-byte lines (a
//   thread's rows are 128 apart, so 16-byte stores would need a transpose
//   through shared memory for 6% of the bytes at d = 30).
//
// What binds it now (PERF.md §6, the L2 flushed before each launch): at
// YP and a minibatch build's end the copies alone run at 87-89% of the
// byte rate, and the kernel takes 4-6 us more, as each CTA's last tile
// computes with no copy left to overlap; at HI each CTA has one tile, so
// its copy and its distances run one after the other.
//
// Bits: a row's whole chain runs in one thread in kmeans::nearest's order
// (‖p‖² and each cross term by fmaf over j ascending, then kmeans::dist2, a
// strict < from INFINITY over q ascending), so K3's assignment and
// distance are K5's bit for bit.  No tensor cores: TF32 products would
// move near ties.
#include <array>
#include <cstdint>
#include <utility>

#include "kmeans_common.cuh"

namespace {

constexpr int THREADS = 128;     // a CTA
constexpr int D_FIXED = 32;      // widths with an instance of their own
constexpr int SMEM_MAX = 232448; // bytes of shared memory a CTA may use

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

// R, the rows a thread holds in registers: 4 at a width with an instance
// (D > 0), 1 where rows stay in shared memory (D = 0); kernel.py's
// rows_per_thread
__host__ __device__ constexpr int rows_per_thread(int D) {
  return D > 0 ? 4 : 1;
}

// CTAs an SM holds at the register cap of an instance of R rows a thread
// (kernel.py's CTAS_PER_SM)
__host__ __device__ constexpr int min_ctas(int r) { return r == 1 ? 8 : 3; }

// Floats of the tile buffer: the rows, contiguous, after up to 3 floats
// that put the tile's first float at its global address's offset mod 16 B.
__host__ __device__ constexpr int tile_floats(int tile, int d) {
  return round4(tile * d + 3);
}

// Shared memory of one CTA, in the kernel's order: the tile buffer, the
// padded centroids, their norms, the buffer's mbarrier (kernel.py's
// smem_bytes).
__host__ __device__ constexpr size_t smem_bytes(int tile, int k, int d) {
  return 4 * ((size_t)tile_floats(tile, d) + (size_t)k * round4(d) +
              round4(k)) + 8;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)), "l"(src)
               : "memory");
}

// until this thread's cp.async copies have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// one arrival that expects `bytes` of bulk copies before the phase ends
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar))
      : "memory");
}

// The rows t + r·THREADS (r < R) below `rows` of the tile at p: assign and
// sqd of each.  D > 0: the rows' D values in registers, each centroid read
// as 16-byte words; D = 0: kmeans::nearest on the row in shared memory.
// release() (every thread calls it) runs once the tile's buffer is no
// longer read: D > 0 as soon as the rows are in registers.
template <int D, int R, typename Release>
__device__ __forceinline__ void assign_rows(const float* p, int rows,
                                            const float* c_s,
                                            const float* c2_s, int k,
                                            int k_real, int d,
                                            int32_t* assign, float* sqd,
                                            Release release) {
  const int t = threadIdx.x;
  if constexpr (D == 0) {
    for (int r = 0; r < R; ++r) {
      const int row = r * THREADS + t;
      if (row < rows)
        kmeans::nearest(p + row * d, c_s, round4(d), c2_s, k, k_real, d,
                        assign + row, sqd + row);
    }
    release();
  } else {
    constexpr int DP = round4(D);
    float x[R][D], p2[R], best[R];
    int32_t bq[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * THREADS + t;
      if (D % 2 == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) {
        // 8-byte loads: a half-warp's rows fall in distinct banks
        const float2* v = reinterpret_cast<const float2*>(p + row * D);
#pragma unroll
        for (int j = 0; j < D / 2; ++j) {
          const float2 e = row < rows ? v[j] : make_float2(0.f, 0.f);
          x[r][2 * j] = e.x;
          x[r][2 * j + 1] = e.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < D; ++j)
          x[r][j] = row < rows ? p[row * D + j] : 0.f;
      }
      p2[r] = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) p2[r] = fmaf(x[r][j], x[r][j], p2[r]);
      best[r] = INFINITY;
      bq[r] = 0;
    }
    release();
#pragma unroll 2
    for (int q = 0; q < k; ++q) {
      const float4* cq = reinterpret_cast<const float4*>(c_s + q * DP);
      float cross[R];
#pragma unroll
      for (int r = 0; r < R; ++r) cross[r] = 0.f;
#pragma unroll
      for (int j4 = 0; j4 < DP / 4; ++j4) {
        const float4 c4 = cq[j4];
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (4 * j4 + u < D) {
#pragma unroll
            for (int r = 0; r < R; ++r)
              cross[r] = fmaf(x[r][4 * j4 + u], cv[u], cross[r]);
          }
        }
      }
      const float c2 = c2_s[q];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d2 = kmeans::dist2(p2[r], cross[r], c2, q, k_real);
        if (d2 < best[r]) {
          best[r] = d2;
          bq[r] = q;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * THREADS + t;
      if (row < rows) {
        assign[row] = bq[r];
        sqd[row] = best[r];
      }
    }
  }
}

template <int D, int R>
__global__ void __launch_bounds__(THREADS, min_ctas(R))
assign_kernel(const float* __restrict__ points,
              const float* __restrict__ cents, int32_t* __restrict__ assign,
              float* __restrict__ sqd, int64_t n, int k, int k_real,
              int d_run, int tile, int rows_per_cta) {
  extern __shared__ __align__(16) float smem[];
  const int d = D > 0 ? D : d_run;
  const int dp = round4(d);
  const int tf = tile_floats(tile, d);
  float* c_s = smem + tf;     // the tile buffer, then the centroids
  float* c2_s = c_s + k * dp;
  uint64_t* bar = reinterpret_cast<uint64_t*>(c2_s + round4(k));

  const int m = blockIdx.y, t = threadIdx.x;
  // the CTA's rows [row0, row0 + rows), cut into tiles of `tile` rows
  const int64_t row0 = (int64_t)m * n + (int64_t)blockIdx.x * rows_per_cta;
  const int rows = (int)min((int64_t)rows_per_cta,
                            n - (int64_t)blockIdx.x * rows_per_cta);
  const int n_tiles = (rows + tile - 1) / tile;
  const float* pts = points + row0 * d;
  // tile·d floats are a multiple of 16 B, so every tile of the CTA starts
  // at the CTA's offset mod 16 B
  const int off = (int)((reinterpret_cast<uintptr_t>(pts) >> 2) & 3);
  float* buf = smem + off;
  auto rows_of = [&](int i) { return min(tile, rows - i * tile); };
  // tile i's rows into the buffer: the 16-byte-aligned body in one bulk
  // copy, a head and a tail of up to 3 floats as 4-byte cp.async
  auto stage = [&](int i) {
    const float* g = pts + (int64_t)i * tile * d;
    const int cnt = rows_of(i) * d;
    const int head = min(cnt, (4 - off) & 3);
    const int n16 = (cnt - head) / 4;
    const int tail = head + 4 * n16;
    if (t < head) cp_async4(buf + t, g + t);
    if (t < cnt - tail) cp_async4(buf + tail + t, g + tail + t);
    if (t == 0) {
      // the buffer was last read through the generic proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_expect_tx(bar, 16u * n16);
      if (n16 > 0) bulk_copy(buf + head, g + head, 16u * n16, bar);
    }
  };

  if (t == 0) {
    mbar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  stage(0);  // the first tile loads while the centroids stage
  const float* c = cents + (int64_t)m * k * d;
  for (int e = t; e < k * dp; e += THREADS) {
    const int q = e / dp, j = e - q * dp;
    c_s[e] = j < d ? c[q * d + j] : 0.f;
  }
  __syncthreads();
  for (int q = t; q < k; q += THREADS) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_s[q * dp + j], c_s[q * dp + j], s);
    c2_s[q] = s;
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait_all();   // this thread's head and tail of tile i
    mbar_wait(bar, i & 1); // its body: the barrier's phase i
    __syncthreads();       // tile i is in
    const int64_t r0 = row0 + (int64_t)i * tile;
    // once every thread has read its rows, the buffer takes tile i + 1
    assign_rows<D, R>(buf, rows_of(i), c_s, c2_s, k, k_real, d, assign + r0,
                      sqd + r0, [&] {
                        __syncthreads();
                        if (i + 1 < n_tiles) stage(i + 1);
                      });
  }
}

// assign_kernel<D, rows_per_thread(D)> for each width D in Ds
template <int... Ds>
auto kernel_table(std::integer_sequence<int, Ds...>) {
  return std::array<decltype(&assign_kernel<0, 1>), sizeof...(Ds)>{
      &assign_kernel<Ds, rows_per_thread(Ds)>...};
}

}  // namespace

// points (m, n, d), cents (m, k, d) f32; assign (m, n) i32, sqd (m, n) f32.
// r (rows a thread: 4 at d <= D_FIXED, else 1), tile, rows_per_cta, ctas:
// kernel.py's geometry(m, n, k, d).
extern "C" int kmeans_assign_launch(const void* points, const void* cents,
                                    void* assign, void* sqd, long long m,
                                    long long n, long long k, long long k_real,
                                    long long d, long long r, long long tile,
                                    long long rows_per_cta, long long ctas,
                                    void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  // the geometry must give every row to one CTA and every CTA a row, in
  // tiles whose floats are a multiple of 16 B
  if (d < 1 || tile < 1 || tile % 4 || tile > THREADS * r ||
      rows_per_cta < 1 || rows_per_cta > INT32_MAX || ctas < 1 ||
      (ctas - 1) * rows_per_cta >= n || ctas * rows_per_cta < n)
    return (int)cudaErrorInvalidValue;
  using Widths = std::make_integer_sequence<int, D_FIXED + 1>;
  static const auto table = kernel_table(Widths{});
  const int w = d <= D_FIXED ? (int)d : 0;
  const auto kernel = r == rows_per_thread(w) ? table[w] : nullptr;
  const size_t smem = smem_bytes((int)tile, (int)k, (int)d);
  if (kernel == nullptr || smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)ctas, (unsigned)m);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)cents, (int32_t*)assign,
      (float*)sqd, n, (int)k, (int)k_real, (int)d, (int)tile,
      (int)rows_per_cta);
  return (int)cudaGetLastError();
}
