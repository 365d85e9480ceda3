// Backward of the GQA flash attention kernel K11 (flash_attention.cu).  The
// reference has no backward kernel: it differentiates its full attention with
// XLA (repro/models/attention.py, train/steps.py).  The plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd.
//
// q/o/do (B, Sq, H, Dh), k/v (B, Sk, KV, Dh), f32 or bf16, in the framework
// layout; dq (B, Sq, H, Dh), dk/dv (B, Sk, KV, Dh) in the operands' type.  The
// mask is the forward's: query row r at position Sk - Sq + r, visible iff
// causal `col <= pos`, window `(pos - col) < window` OR `col < prefix`, col <
// Sk; scores s = (q·k)·scale, softcapped `tanh(s / cap) * cap` where cap > 0.
// All math in f32 (bf16 operands are widened as they are staged), one
// rounding to the output type at the end.
//
// Two launches, one after the other on the caller's stream:
//   1. flash_attention_bwd_dq_kernel, one CTA per (batch, head, tile of BM
//      query rows): D = rowsum(do·o); a first pass over the key tiles
//      recomputes the row statistics (max m and l = Σ exp(s - m), an online
//      update a tile at a time), written to `stats` (B, H, Sq, 3) = (m, l, D);
//      a second pass forms p = exp(s - m) / l, dp = do·vᵀ and
//      ds = p∘(dp - D)·(1 - tanh²) and accumulates dq = scale·ds·k.
//   2. flash_attention_bwd_dkdv_kernel, one CTA per (batch, kv head, tile of
//      BN keys): loops over the G query heads of the kv head and, for each,
//      over the query tiles, reads the statistics, re-forms p and ds and
//      accumulates dv = pᵀ·do and dk = scale·dsᵀ·q for its keys.
// Every output element is summed by one thread in a fixed order (heads, then
// query tiles, then rows, in dkdv; key tiles, then keys, in dq): no atomics,
// so two runs give the same bits.  Tiles outside the mask of every row of the
// pair of tiles (the forward's block-skip test) are not visited.
//
// Products on the CUDA cores: 256 threads a CTA as a 16 × 16 grid (ty, tx);
// a thread owns rows ty + 16·i and columns tx + 16·j of each product's
// output.  Operands are staged in shared memory as f32, row-major with an odd
// row stride (DP + 1, BN + 1), so a half-warp's 16 column reads fall on 16
// banks and its row reads are one broadcast.  DP = 32, 64, 128, 160, 256 is
// Dh rounded up (zeros past Dh); BM × BN = 64 × 64 up to DP 128, 64 × 32 at
// 160 and 32 × 32 at 256, so shared memory stays within 227 KB:
//   dq:   (2·BM + 2·BN)·(DP + 1) + BM·(BN + 1) floats
//   dkdv: (2·BM + 2·BN)·(DP + 1) + 2·BM·(BN + 1) + 3·BM floats
// (100.6 KB for dkdv at DP 64; 165 KB at DP 128).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int TY = 16;
constexpr int TX = 16;
constexpr int THREADS = TY * TX;

__device__ __forceinline__ bool tile_skipped(int c0, int c1, int rlo, int rhi,
                                             int sk, int causal, int window,
                                             int prefix) {
  return c0 >= sk || (causal && c0 > rhi) ||
         (window > 0 && rlo - c1 >= window && c0 >= prefix);
}

__device__ __forceinline__ bool visible(int col, int pos, int sk, int causal,
                                        int window, int prefix) {
  return col < sk && (!causal || col <= pos) &&
         (window <= 0 || pos - col < window || col < prefix);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int DP>
struct Tiles {
  static constexpr int BM = DP <= 160 ? 64 : 32;  // query rows a tile
  static constexpr int BN = DP <= 128 ? 64 : 32;  // keys a tile
  static constexpr int LD = DP + 1;               // staged row stride
  static constexpr int LDP = BN + 1;              // p / ds row stride
  static constexpr int MI = BM / TY;              // rows a thread
  static constexpr int NJ = BN / TX;              // keys a thread
  static constexpr int CI = BN / TY;              // dk/dv rows a thread
  static constexpr int DJ = DP / TX;              // head dims a thread
  static constexpr int DQ_FLOATS = (2 * BM + 2 * BN) * LD + BM * LDP;
  static constexpr int DKDV_FLOATS =
      (2 * BM + 2 * BN) * LD + 2 * BM * LDP + 3 * BM;
};

// Rows [r0, r0 + n) of head `hd` of a (B, S, heads, Dh) tensor, batch `b`,
// into dst[n][DP + 1] as f32; zeros past S and past Dh.
template <int DP, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int r0, int n, int s, int heads,
                                      int hd, int dh) {
  for (int i = threadIdx.x; i < n * DP; i += THREADS) {
    const int r = i / DP;
    const int d = i % DP;
    float x = 0.f;
    if (r0 + r < s && d < dh)
      x = to_f32(src[(((int64_t)b * s + r0 + r) * heads + hd) * dh + d]);
    dst[r * (DP + 1) + d] = x;
  }
}

// acc[i][j] = Σ_d A[ty + 16i][d] · B[tx + 16j][d]: a score-shaped tile (rows
// of A against rows of B, both staged [n][DP + 1]).
template <int DP, int MI, int NJ>
__device__ __forceinline__ void rows_dot_rows(float (&acc)[MI][NJ],
                                              const float* A, const float* B,
                                              int ty, int tx) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[MI], bb[NJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + TY * i) * (DP + 1) + d];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bb[j] = B[(tx + TX * j) * (DP + 1) + d];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_r A[r][ty + 16i] · B[r][tx + 16j], r < nr: dv = pᵀ·do and
// dk = dsᵀ·q (A staged [BM][lda], B [BM][DP + 1]).
template <int DP, int CI, int DJ>
__device__ __forceinline__ void cols_dot(float (&acc)[CI][DJ], const float* A,
                                         int lda, const float* B, int nr,
                                         int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < nr; ++r) {
    float a[CI], bb[DJ];
#pragma unroll
    for (int i = 0; i < CI; ++i) a[i] = A[r * lda + ty + TY * i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) bb[j] = B[r * (DP + 1) + tx + TX * j];
#pragma unroll
    for (int i = 0; i < CI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_c A[ty + 16i][c] · B[c][tx + 16j], c < nc: dq = ds·k (A
// staged [BM][lda], B [BN][DP + 1]).
template <int DP, int MI, int DJ>
__device__ __forceinline__ void rows_dot_cols(float (&acc)[MI][DJ],
                                              const float* A, int lda,
                                              const float* B, int nc, int ty,
                                              int tx) {
#pragma unroll 4
  for (int c = 0; c < nc; ++c) {
    float a[MI], bb[DJ];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = A[(ty + TY * i) * lda + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) bb[j] = B[c * (DP + 1) + tx + TX * j];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// Reductions over the 16 lanes of a half-warp (the threads of one ty).
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The score of one (row, key) pair from its raw product: s (or NEG_INF where
// hidden) and the softcap's slope 1 - tanh².
__device__ __forceinline__ float score(float dot, float scale, float cap,
                                       bool vis, float* slope) {
  float s = dot * scale;
  *slope = 1.f;
  if (cap > 0.f) {
    const float t = tanhf(s / cap);
    s = t * cap;
    *slope = 1.f - t * t;
  }
  return vis ? s : NEG_INF;
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dq_kernel(const T* __restrict__ q,
                                  const T* __restrict__ k,
                                  const T* __restrict__ v,
                                  const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  T* __restrict__ dq, float* __restrict__ stats,
                                  int sq, int sk, int h, int kvh, int dh,
                                  int causal, int window, int prefix,
                                  float scale, float cap) {
  using C = Tiles<DP>;
  constexpr int BM = C::BM, BN = C::BN, MI = C::MI, NJ = C::NJ, DJ = C::DJ;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + BM * C::LD;
  float* k_s = do_s + BM * C::LD;
  float* v_s = k_s + BN * C::LD;
  float* ds_s = v_s + BN * C::LD;

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hd = blockIdx.y;
  const int b = blockIdx.z;
  const int kv = hd / (h / kvh);
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int r0 = tile * BM;
  const int rlo = sk - sq + r0;
  const int rhi = rlo + BM - 1;

  stage<DP>(q_s, q, b, r0, BM, sq, h, hd, dh);
  stage<DP>(do_s, dout, b, r0, BM, sq, h, hd, dh);
  __syncthreads();

  // D = rowsum(do·o) for this thread's rows, each half-warp one row
  float drow[MI], m[MI], l[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = ty + TY * i;
    float part = 0.f;
    if (r0 + r < sq)
      for (int d = tx; d < dh; d += TX)
        part = fmaf(do_s[r * C::LD + d],
                    to_f32(o[(((int64_t)b * sq + r0 + r) * h + hd) * dh + d]),
                    part);
    drow[i] = half_warp_sum(part);
    m[i] = NEG_INF;
    l[i] = 0.f;
  }

  // pass 1: the row statistics
  for (int c0 = 0; c0 < sk; c0 += BN) {
    if (tile_skipped(c0, c0 + BN - 1, rlo, rhi, sk, causal, window, prefix))
      continue;
    __syncthreads();
    stage<DP>(k_s, k, b, c0, BN, sk, kvh, kv, dh);
    __syncthreads();
    float acc[MI][NJ];
    rows_dot_rows<DP, MI, NJ>(acc, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int pos = rlo + ty + TY * i;
      float s[NJ], slope, mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j] = score(acc[i][j], scale, cap,
                     visible(c0 + tx + TX * j, pos, sk, causal, window,
                             prefix),
                     &slope);
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (s[j] > NEG_INF) sum += expf(s[j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_warp_sum(sum);
      m[i] = m_new;
    }
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + ty + TY * i;
    if (tx == 0 && r < sq) {
      float* st = stats + (((int64_t)b * h + hd) * sq + r) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = drow[i];
    }
  }

  // pass 2: ds and dq
  float acc_q[MI][DJ];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_q[i][j] = 0.f;
  float inv_l[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) inv_l[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  for (int c0 = 0; c0 < sk; c0 += BN) {
    if (tile_skipped(c0, c0 + BN - 1, rlo, rhi, sk, causal, window, prefix))
      continue;
    __syncthreads();
    stage<DP>(k_s, k, b, c0, BN, sk, kvh, kv, dh);
    stage<DP>(v_s, v, b, c0, BN, sk, kvh, kv, dh);
    __syncthreads();
    float acc_s[MI][NJ], acc_p[MI][NJ];
    rows_dot_rows<DP, MI, NJ>(acc_s, q_s, k_s, ty, tx);
    rows_dot_rows<DP, MI, NJ>(acc_p, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const int pos = rlo + ty + TY * i;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float slope;
        const float s = score(acc_s[i][j], scale, cap,
                              visible(c0 + tx + TX * j, pos, sk, causal,
                                      window, prefix),
                              &slope);
        const float p = s > NEG_INF ? expf(s - m[i]) * inv_l[i] : 0.f;
        ds_s[(ty + TY * i) * C::LDP + tx + TX * j] =
            p * (acc_p[i][j] - drow[i]) * slope;
      }
    }
    __syncthreads();
    rows_dot_cols<DP, MI, DJ>(acc_q, ds_s, C::LDP, k_s, BN, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    const int r = r0 + ty + TY * i;
    if (r >= sq) continue;
    T* dst = dq + (((int64_t)b * sq + r) * h + hd) * dh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + TX * j;
      if (d < dh) dst[d] = from_f32<T>(acc_q[i][j] * scale);
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
    flash_attention_bwd_dkdv_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const T* __restrict__ v,
                                    const T* __restrict__ dout,
                                    const float* __restrict__ stats,
                                    T* __restrict__ dk, T* __restrict__ dv,
                                    int sq, int sk, int h, int kvh, int dh,
                                    int causal, int window, int prefix,
                                    float scale, float cap) {
  using C = Tiles<DP>;
  constexpr int BM = C::BM, BN = C::BN, MI = C::MI, NJ = C::NJ, CI = C::CI,
                DJ = C::DJ;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + BN * C::LD;
  float* q_s = v_s + BN * C::LD;
  float* do_s = q_s + BM * C::LD;
  float* p_s = do_s + BM * C::LD;
  float* ds_s = p_s + BM * C::LDP;
  float* st_s = ds_s + BM * C::LDP;  // [3][BM]: m, 1/l, D

  const int c0 = blockIdx.x * BN;
  const int kv = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / kvh;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;

  stage<DP>(k_s, k, b, c0, BN, sk, kvh, kv, dh);
  stage<DP>(v_s, v, b, c0, BN, sk, kvh, kv, dh);

  float acc_k[CI][DJ], acc_v[CI][DJ];
#pragma unroll
  for (int i = 0; i < CI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const int hd = kv * g + gi;
    for (int r0 = 0; r0 < sq; r0 += BM) {
      const int rlo = sk - sq + r0;
      if (tile_skipped(c0, c0 + BN - 1, rlo, rlo + BM - 1, sk, causal,
                       window, prefix))
        continue;
      __syncthreads();
      stage<DP>(q_s, q, b, r0, BM, sq, h, hd, dh);
      stage<DP>(do_s, dout, b, r0, BM, sq, h, hd, dh);
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        float mm = NEG_INF, il = 0.f, dd = 0.f;
        if (r0 + r < sq) {
          const float* st = stats + (((int64_t)b * h + hd) * sq + r0 + r) * 3;
          mm = st[0];
          il = st[1] > 0.f ? 1.f / st[1] : 0.f;
          dd = st[2];
        }
        st_s[r] = mm;
        st_s[BM + r] = il;
        st_s[2 * BM + r] = dd;
      }
      __syncthreads();
      float acc_s[MI][NJ], acc_p[MI][NJ];
      rows_dot_rows<DP, MI, NJ>(acc_s, q_s, k_s, ty, tx);
      rows_dot_rows<DP, MI, NJ>(acc_p, do_s, v_s, ty, tx);
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = ty + TY * i;
        const int pos = rlo + r;
        const bool row_ok = r0 + r < sq;
        const float mm = st_s[r], il = st_s[BM + r], dd = st_s[2 * BM + r];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          float slope;
          const float s = score(acc_s[i][j], scale, cap,
                                row_ok && visible(c0 + tx + TX * j, pos, sk,
                                                  causal, window, prefix),
                                &slope);
          const float p = s > NEG_INF ? expf(s - mm) * il : 0.f;
          p_s[r * C::LDP + tx + TX * j] = p;
          ds_s[r * C::LDP + tx + TX * j] = p * (acc_p[i][j] - dd) * slope;
        }
      }
      __syncthreads();
      cols_dot<DP, CI, DJ>(acc_v, p_s, C::LDP, do_s, BM, ty, tx);
      cols_dot<DP, CI, DJ>(acc_k, ds_s, C::LDP, q_s, BM, ty, tx);
    }
  }
#pragma unroll
  for (int i = 0; i < CI; ++i) {
    const int c = c0 + ty + TY * i;
    if (c >= sk) continue;
    const int64_t base = (((int64_t)b * sk + c) * kvh + kv) * dh;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + TX * j;
      if (d < dh) {
        dk[base + d] = from_f32<T>(acc_k[i][j] * scale);
        dv[base + d] = from_f32<T>(acc_v[i][j]);
      }
    }
  }
}

template <typename T, int DP>
int launch_dp(const T* q, const T* k, const T* v, const T* o, const T* dout,
              T* dq, T* dk, T* dv, float* stats, long long b, long long sq,
              long long sk, long long h, long long kvh, long long dh,
              long long causal, long long window, long long prefix,
              float scale, float cap, cudaStream_t stream) {
  using C = Tiles<DP>;
  const size_t dq_bytes = C::DQ_FLOATS * sizeof(float);
  const size_t dkdv_bytes = C::DKDV_FLOATS * sizeof(float);
  static bool ready = false;  // one attribute call per instance
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bwd_dq_kernel<T, DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(flash_attention_bwd_dkdv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dkdv_bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid_q((unsigned)((sq + C::BM - 1) / C::BM), (unsigned)h,
                    (unsigned)b);
  flash_attention_bwd_dq_kernel<T, DP><<<grid_q, THREADS, dq_bytes, stream>>>(
      q, k, v, o, dout, dq, stats, (int)sq, (int)sk, (int)h, (int)kvh,
      (int)dh, (int)causal, (int)window, (int)prefix, scale, cap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_kv((unsigned)((sk + C::BN - 1) / C::BN), (unsigned)kvh,
                     (unsigned)b);
  flash_attention_bwd_dkdv_kernel<T, DP>
      <<<grid_kv, THREADS, dkdv_bytes, stream>>>(
          q, k, v, dout, stats, dk, dv, (int)sq, (int)sk, (int)h, (int)kvh,
          (int)dh, (int)causal, (int)window, (int)prefix, scale, cap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, void* dq, void* dk, void* dv, float* stats,
                 long long b, long long sq, long long sk, long long h,
                 long long kvh, long long dh, long long causal,
                 long long window, long long prefix, float scale, float cap,
                 cudaStream_t stream) {
#define FA_BWD(DP)                                                           \
  return launch_dp<T, DP>((const T*)q, (const T*)k, (const T*)v,             \
                          (const T*)o, (const T*)dout, (T*)dq, (T*)dk,       \
                          (T*)dv, stats, b, sq, sk, h, kvh, dh, causal,      \
                          window, prefix, scale, cap, stream)
  if (dh <= 32) FA_BWD(32);
  if (dh <= 64) FA_BWD(64);
  if (dh <= 128) FA_BWD(128);
  if (dh <= 160) FA_BWD(160);
  FA_BWD(256);
#undef FA_BWD
}

}  // namespace

extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, long long b,
    long long sq, long long sk, long long h, long long kvh, long long dh,
    long long causal, long long window, long long prefix, long long bf16,
    double scale, double cap, void* stream) {
  if (b == 0 || sq == 0 || sk == 0 || h == 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_typed<__nv_bfloat16>(
        q, k, v, o, dout, dq, dk, dv, (float*)stats, b, sq, sk, h, kvh, dh,
        causal, window, prefix, (float)scale, (float)cap,
        (cudaStream_t)stream);
  return launch_typed<float>(q, k, v, o, dout, dq, dk, dv, (float*)stats, b,
                             sq, sk, h, kvh, dh, causal, window, prefix,
                             (float)scale, (float)cap, (cudaStream_t)stream);
}
