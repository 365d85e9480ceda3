// k-means assign step (Hopper port of
// repro/kernels/kmeans_assign/kernel.py::kmeans_assign_pallas), batched over
// M clients: the distance, clamp, mask and first-minimum argmin of
// kmeans_update.cu (shared in kmeans_common.cuh), with no accumulation.
//
// Grid (row blocks, M); each CTA stages its client's centroids, their squared
// norms and a tile of BLOCK_ROWS rows in shared memory; one thread per row.
//
// Bound: bytes (read N×d points once, write 8 B per row); the M·N·K·(2d+4)
// flops are below the memory time at the f32 rate.
#include "kmeans_common.cuh"

namespace {

using kmeans::BLOCK_ROWS;

__global__ void assign_kernel(const float* __restrict__ points,
                              const float* __restrict__ cents,
                              int32_t* __restrict__ assign,
                              float* __restrict__ sqd, int64_t n, int k,
                              int k_real, int d) {
  extern __shared__ float smem[];
  float* c_s = smem;
  float* c2_s = c_s + k * d;
  float* p_s = c2_s + k;

  const int m = blockIdx.y;
  const int64_t r0 = (int64_t)blockIdx.x * BLOCK_ROWS;
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
  }
}

}  // namespace

// points (m, n, d), cents (m, k, d) f32; assign (m, n) i32, sqd (m, n) f32.
extern "C" int kmeans_assign_launch(const void* points, const void* cents,
                                    void* assign, void* sqd, long long m,
                                    long long n, long long k, long long k_real,
                                    long long d, void* stream) {
  if (m == 0 || n == 0 || k == 0) return 0;
  const long long nb = (n + BLOCK_ROWS - 1) / BLOCK_ROWS;
  const size_t smem = kmeans::tile_smem_bytes((int)k, (int)d);
  cudaError_t err = cudaFuncSetAttribute(
      assign_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)nb, (unsigned)m);
  assign_kernel<<<grid, BLOCK_ROWS, smem, (cudaStream_t)stream>>>(
      (const float*)points, (const float*)cents, (int32_t*)assign, (float*)sqd,
      n, (int)k, (int)k_real, (int)d);
  return (int)cudaGetLastError();
}
