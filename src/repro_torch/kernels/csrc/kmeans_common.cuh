// Shared distance/argmin step of the two k-means kernels (kmeans_update.cu,
// kmeans_assign.cu), so that their tie-breaks cannot diverge.
#pragma once
#include <cstdint>
#include <cuda_runtime.h>

namespace kmeans {

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

// d² of a row against centroid q from ‖p‖², the cross term p·c and ‖c‖²,
// clamped at 0; centroids q >= k_real masked to MASK_LARGE.  Every distance
// of both kernels is taken here, so their roundings cannot part.
__device__ __forceinline__ float dist2(float p2, float cross, float c2, int q,
                                       int k_real) {
  const float d2 = p2 - 2.0f * cross + c2;
  return q < k_real ? fmaxf(d2, 0.f) : MASK_LARGE;
}

// dist2 for every centroid (centroid q at c_s + q·stride), first-minimum
// argmin; each sum is an fmaf chain over j ascending.
__device__ __forceinline__ void nearest(const float* p, const float* c_s,
                                        int stride, const float* c2_s, int k,
                                        int k_real, int d, int32_t* best_q,
                                        float* best_d) {
  float p2 = 0.f;
  for (int j = 0; j < d; ++j) p2 = fmaf(p[j], p[j], p2);
  float best = INFINITY;
  int32_t bq = 0;
  for (int q = 0; q < k; ++q) {
    float cross = 0.f;
    for (int j = 0; j < d; ++j) cross = fmaf(p[j], c_s[q * stride + j], cross);
    const float d2 = dist2(p2, cross, c2_s[q], q, k_real);
    if (d2 < best) {
      best = d2;
      bq = q;
    }
  }
  *best_q = bq;
  *best_d = best;
}

// The same over centroids stored back to back (a stride of d).
__device__ __forceinline__ void nearest(const float* p, const float* c_s,
                                        const float* c2_s, int k, int k_real,
                                        int d, int32_t* best_q,
                                        float* best_d) {
  nearest(p, c_s, d, c2_s, k, k_real, d, best_q, best_d);
}

}  // namespace kmeans
