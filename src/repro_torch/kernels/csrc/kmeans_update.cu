// Fused k-means Lloyd step, batched over M clients: the Hopper port of
// repro/kernels/kmeans_update/kernel.py::kmeans_update_pallas (K3, body
// _tile_update) and ::kmeans_update_gather_pallas (K4, the minibatch step of
// the Sculley fit over the rows points[idx], gathered inside the kernel).
//
// Kernel 1, grid (row blocks, M): each CTA stages its client's K centroids
// and their squared norms, and a tile of BLOCK_ROWS point rows, in shared
// memory: rows r0.. (K3) or rows idx[m, r0..] (K4, the CTA first stages its
// tile's indices, in place of the TPU's scalar prefetch).  Each thread takes
// one row: d² = ‖p‖² − 2 p·c + ‖c‖² in f32 FMA, clamp at 0, mask q >= k_real,
// first-minimum argmin; it writes assign and sqd.  The CTA then sums its rows
// per cluster in row order (one thread per (cluster, column) output and per
// cluster count) and writes the partial sums/counts of its block to a
// (M, blocks, K*d + K) buffer.
// Kernel 2, grid (M): adds the partials of the blocks in block order.
//
// K3 and K4 are one template: the gathered tile is the same shared-memory
// tile the dense kernel would stage from the pre-gathered rows, cut into the
// same blocks, so K4 is bitwise K3 on points[idx] (sums and counts too).  A
// duplicated index counts each time it appears, as gathering first would.
// An index outside [0, N) never faults: its row gets assign -1 and sqd NaN
// and counts for no cluster.
//
// The TPU kernel carried the sums in a VMEM block across its sequential grid;
// CTAs run in no order, so the cross-block sum is a second pass.  There are no
// float atomics: two runs give the same bits.  Counts are exact integers in
// f32.  Rows past the tile's end count for nothing; zero rows that the caller
// padded into the (M, N, d) stack are real rows here, counted exactly as the
// reference counts them, and core/kmeans.py corrects their count.
//
// Bound: bytes.  K3 must read the N×d points once and write 8 B per row; the
// distance work is M·N·K·(2d+4) flops, ~54 MFLOP at the HI coreset fit's
// shapes (M=3, N=49,000, d=11, K=14), below the memory time at the f32 rate.
// K4 at a YP minibatch step (B=1,024 of N=357,000 rows, d=30, K=12) reads
// ~135 KB, a bound of 0.04 us; its 8 CTAs leave the card almost idle, so
// latency sets its time (21.8 us of device time with chip_smoke.py on an
// H100 80GB HBM3 at 700 W).  The second pass is one CTA per client adding
// the block partials in order: at the YP coreset fit (N=249,900, 1,953
// blocks) it takes ~0.4 ms a call, twice the first pass, the largest kernel
// cost of that run; a later PR can fuse or widen the reduction.
#include "kmeans_common.cuh"

namespace {

using kmeans::BLOCK_ROWS;

template <bool GATHER>
__global__ void update_kernel(const int32_t* __restrict__ idx,
                              const float* __restrict__ points,
                              const float* __restrict__ cents,
                              int32_t* __restrict__ assign,
                              float* __restrict__ sqd,
                              float* __restrict__ partials, int64_t n,
                              int64_t b, int k, int k_real, int d) {
  extern __shared__ float smem[];
  float* c_s = smem;
  float* c2_s = c_s + k * d;
  float* p_s = c2_s + k;
  int32_t* a_s = (int32_t*)(p_s + BLOCK_ROWS * d);

  const int m = blockIdx.y;
  const int64_t blk = blockIdx.x;
  const int64_t nb = gridDim.x;
  const int64_t r0 = blk * BLOCK_ROWS;
  const int rows = (int)min((int64_t)BLOCK_ROWS, b - r0);
  const float* pts = points + (int64_t)m * n * d;

  kmeans::stage_centroids(cents + (int64_t)m * k * d, c_s, c2_s, k, d);
  if (GATHER) {
    // the tile's source rows, -1 for an index outside [0, n)
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const int64_t src = idx[(int64_t)m * b + r0 + r];
      a_s[r] = (src >= 0 && src < n) ? (int32_t)src : -1;
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * d; e += blockDim.x) {
      const int r = e / d;
      const int32_t src = a_s[r];
      p_s[e] = src >= 0 ? pts[(int64_t)src * d + (e - r * d)] : 0.f;
    }
  } else {
    kmeans::stage_points(pts, p_s, r0, rows, d);
  }
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    int32_t q = -1;
    float dist = __int_as_float(0x7fc00000);   // NaN
    if (!GATHER || a_s[t] >= 0)
      kmeans::nearest(p_s + t * d, c_s, c2_s, k, k_real, d, &q, &dist);
    assign[(int64_t)m * b + r0 + t] = q;
    sqd[(int64_t)m * b + r0 + t] = dist;
    a_s[t] = q;
  } else {
    a_s[t] = -1;
  }
  __syncthreads();

  const int width = k * d + k;
  float* out = partials + ((int64_t)m * nb + blk) * width;
  for (int e = t; e < width; e += blockDim.x) {
    float acc = 0.f;
    if (e < k * d) {
      const int q = e / d, j = e - (e / d) * d;
      for (int r = 0; r < rows; ++r)
        if (a_s[r] == q) acc += p_s[r * d + j];
    } else {
      const int q = e - k * d;
      for (int r = 0; r < rows; ++r)
        if (a_s[r] == q) acc += 1.f;
    }
    out[e] = acc;
  }
}

__global__ void reduce_kernel(const float* __restrict__ partials,
                              float* __restrict__ sums,
                              float* __restrict__ counts, int64_t nb, int k,
                              int d) {
  const int m = blockIdx.x;
  const int width = k * d + k;
  const float* src = partials + (int64_t)m * nb * width;
  for (int e = threadIdx.x; e < width; e += blockDim.x) {
    float acc = 0.f;
    for (int64_t b = 0; b < nb; ++b) acc += src[b * width + e];
    if (e < k * d) {
      sums[(int64_t)m * k * d + e] = acc;
    } else {
      counts[(int64_t)m * k + (e - k * d)] = acc;
    }
  }
}

template <bool GATHER>
int launch(const void* idx, const void* points, const void* cents,
           void* assign, void* sqd, void* partials, void* sums, void* counts,
           long long m, long long n, long long b, long long k,
           long long k_real, long long d, void* stream) {
  if (m == 0 || k == 0) return 0;
  const long long nb = (b + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const size_t smem = kmeans::tile_smem_bytes((int)k, (int)d);
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel<GATHER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 0) {
    dim3 grid((unsigned)nb, (unsigned)m);
    update_kernel<GATHER><<<grid, BLOCK_ROWS, smem, s>>>(
        (const int32_t*)idx, (const float*)points, (const float*)cents,
        (int32_t*)assign, (float*)sqd, (float*)partials, n, b, (int)k,
        (int)k_real, (int)d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_kernel<<<(unsigned)m, 256, 0, s>>>((const float*)partials,
                                            (float*)sums, (float*)counts, nb,
                                            (int)k, (int)d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long long kmeans_update_blocks(long long n) {
  return (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
}

// K3. points (m, n, d), cents (m, k, d) f32; assign (m, n) i32, sqd (m, n)
// f32; partials (m, blocks(n), k*d + k) f32 scratch; sums (m, k, d), counts
// (m, k).
extern "C" int kmeans_update_launch(const void* points, const void* cents,
                                    void* assign, void* sqd, void* partials,
                                    void* sums, void* counts, long long m,
                                    long long n, long long k, long long k_real,
                                    long long d, void* stream) {
  return launch<false>(nullptr, points, cents, assign, sqd, partials, sums,
                       counts, m, n, n, k, k_real, d, stream);
}

// K4. idx (m, b) i32, points (m, n, d), cents (m, k, d) f32; assign (m, b)
// i32, sqd (m, b) f32 over the rows points[i, idx[i]]; partials (m,
// blocks(b), k*d + k) f32 scratch; sums (m, k, d), counts (m, k).
extern "C" int kmeans_update_gather_launch(
    const void* idx, const void* points, const void* cents, void* assign,
    void* sqd, void* partials, void* sums, void* counts, long long m,
    long long n, long long b, long long k, long long k_real, long long d,
    void* stream) {
  return launch<true>(idx, points, cents, assign, sqd, partials, sums, counts,
                      m, n, b, k, k_real, d, stream);
}
