// Shared distance/argmin step of the two k-means kernels (kmeans_update.cu,
// kmeans_assign.cu), so that their tie-breaks cannot diverge.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace kmeans {

constexpr int BLOCK_ROWS = 128;         // rows (threads) per CTA
constexpr float MASK_LARGE = 3.4e38f;   // stand-in for +inf, as the reference

// Stage one client's K centroids and their squared norms in shared memory.
__device__ __forceinline__ void stage_centroids(const float* __restrict__ c,
                                                float* c_s, float* c2_s, int k,
                                                int d) {
  for (int e = threadIdx.x; e < k * d; e += blockDim.x) c_s[e] = c[e];
  __syncthreads();
  for (int q = threadIdx.x; q < k; q += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < d; ++j) s = fmaf(c_s[q * d + j], c_s[q * d + j], s);
    c2_s[q] = s;
  }
}

// Stage the CTA's tile of point rows [r0, r0 + rows) in shared memory
// (coalesced: consecutive threads read consecutive floats).
__device__ __forceinline__ void stage_points(const float* __restrict__ pts,
                                             float* p_s, int64_t r0, int rows,
                                             int d) {
  const float* src = pts + r0 * d;
  for (int e = threadIdx.x; e < rows * d; e += blockDim.x) p_s[e] = src[e];
}

// d² = ‖p‖² − 2 p·c + ‖c‖² for every centroid, clamped at 0, centroids
// q >= k_real masked to MASK_LARGE, first-minimum argmin.
__device__ __forceinline__ void nearest(const float* p, const float* c_s,
                                        const float* c2_s, int k, int k_real,
                                        int d, int32_t* best_q,
                                        float* best_d) {
  float p2 = 0.f;
  for (int j = 0; j < d; ++j) p2 = fmaf(p[j], p[j], p2);
  float best = INFINITY;
  int32_t bq = 0;
  for (int q = 0; q < k; ++q) {
    float cross = 0.f;
    for (int j = 0; j < d; ++j) cross = fmaf(p[j], c_s[q * d + j], cross);
    float d2 = p2 - 2.0f * cross + c2_s[q];
    d2 = q < k_real ? fmaxf(d2, 0.f) : MASK_LARGE;
    if (d2 < best) {
      best = d2;
      bq = q;
    }
  }
  *best_q = bq;
  *best_d = best;
}

inline size_t tile_smem_bytes(int k, int d) {
  return sizeof(float) * ((size_t)k * d + k + (size_t)BLOCK_ROWS * d) +
         sizeof(int32_t) * BLOCK_ROWS;
}

}  // namespace kmeans
