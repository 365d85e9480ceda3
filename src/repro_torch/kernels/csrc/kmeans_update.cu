// Fused k-means Lloyd step (Hopper port of
// repro/kernels/kmeans_update/kernel.py::kmeans_update_pallas, body
// _tile_update), batched over M clients.
//
// Kernel 1, grid (row blocks, M): each CTA stages its client's K centroids
// and their squared norms, and a tile of BLOCK_ROWS point rows, in shared
// memory.  Each thread takes one row: d² = ‖p‖² − 2 p·c + ‖c‖² in f32 FMA,
// clamp at 0, mask q >= k_real, first-minimum argmin; it writes assign and
// sqd.  The CTA then sums its rows per cluster in row order (one thread per
// (cluster, column) output and per cluster count) and writes the partial
// sums/counts of its block to a (M, blocks, K*d + K) buffer.
// Kernel 2, grid (M): adds the partials of the blocks in block order.
//
// The TPU kernel carried the sums in a VMEM block across its sequential grid;
// CTAs run in no order, so the cross-block sum is a second pass.  There are no
// float atomics: two runs give the same bits.  Counts are exact integers in
// f32.  Rows past N (the CTA tile's tail) count for nothing; zero rows that the
// caller padded into the (M, N, d) stack are real rows here, counted exactly
// as the reference counts them, and core/kmeans.py corrects their count.
//
// Bound: bytes.  The step must read the N×d points once and write 8 B per row;
// the distance work is M·N·K·(2d+4) flops, ~54 MFLOP at the slice's shapes
// (M=3, N=49,000, d=11, K=14), below the memory time at the f32 rate.  At
// ~8 MB the whole step is a few microseconds of work, so launch latency and
// the two-pass structure dominate; a later PR can fuse the reduction.
#include "kmeans_common.cuh"

namespace {

using kmeans::BLOCK_ROWS;

__global__ void update_kernel(const float* __restrict__ points,
                              const float* __restrict__ cents,
                              int32_t* __restrict__ assign,
                              float* __restrict__ sqd,
                              float* __restrict__ partials, int64_t n, int k,
                              int k_real, int d) {
  extern __shared__ float smem[];
  float* c_s = smem;
  float* c2_s = c_s + k * d;
  float* p_s = c2_s + k;
  int32_t* a_s = (int32_t*)(p_s + BLOCK_ROWS * d);

  const int m = blockIdx.y;
  const int64_t blk = blockIdx.x;
  const int64_t nb = gridDim.x;
  const int64_t r0 = blk * BLOCK_ROWS;
  const int rows = (int)min((int64_t)BLOCK_ROWS, n - r0);

  kmeans::stage_centroids(cents + (int64_t)m * k * d, c_s, c2_s, k, d);
  kmeans::stage_points(points + (int64_t)m * n * d, p_s, r0, rows, d);
  __syncthreads();

  const int t = threadIdx.x;
  if (t < rows) {
    int32_t q;
    float dist;
    kmeans::nearest(p_s + t * d, c_s, c2_s, k, k_real, d, &q, &dist);
    assign[(int64_t)m * n + r0 + t] = q;
    sqd[(int64_t)m * n + r0 + t] = dist;
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

}  // namespace

extern "C" long long kmeans_update_blocks(long long n) {
  return (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
}

// points (m, n, d), cents (m, k, d) f32; assign (m, n) i32, sqd (m, n) f32;
// partials (m, blocks, k*d + k) f32 scratch; sums (m, k, d), counts (m, k).
extern "C" int kmeans_update_launch(const void* points, const void* cents,
                                    void* assign, void* sqd, void* partials,
                                    void* sums, void* counts, long long m,
                                    long long n, long long k, long long k_real,
                                    long long d, void* stream) {
  if (m == 0 || k == 0) return 0;
  const long long nb = kmeans_update_blocks(n);
  const size_t smem = kmeans::tile_smem_bytes((int)k, (int)d);
  cudaError_t err = cudaFuncSetAttribute(
      update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (nb > 0) {
    dim3 grid((unsigned)nb, (unsigned)m);
    update_kernel<<<grid, BLOCK_ROWS, smem, s>>>(
        (const float*)points, (const float*)cents, (int32_t*)assign,
        (float*)sqd, (float*)partials, n, (int)k, (int)k_real, (int)d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_kernel<<<(unsigned)m, 256, 0, s>>>((const float*)partials,
                                            (float*)sums, (float*)counts, nb,
                                            (int)k, (int)d);
  return (int)cudaGetLastError();
}
