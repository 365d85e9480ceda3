// GQA flash attention forward with online softmax (Hopper port of
// repro/kernels/flash_attention/kernel.py::flash_attention_pallas).
//
// q (B, Sq, H, Dh), k/v (B, Sk, KV, Dh), f32 or bf16, in the framework
// layout (no padding, no GQA fold in device memory); out (B, Sq, H, Dh) in
// q's type.  Query row r sits at absolute position Sk - Sq + r (suffix
// alignment).  Visible iff causal `col <= row`, window `(row - col) < window`
// OR `col < prefix`; optional tanh softcap `tanh(s / cap) * cap` on the scaled
// scores; masked scores -1e30 (finite, as the reference: a row whose first
// tile is fully masked gets p = 1 there, wiped by corr = exp(-1e30 - m) = 0
// at its first visible tile, where -inf would give NaN); divisor max(l, 1e-30).
// All math in f32, one rounding to the output type at the end.
//
// Design: one CTA per (batch, kv head, tile of BQ query rows), holding all
// G = H / KV query heads of that kv head, one thread per (head, row):
// G·BQ <= 128 threads.  A thread keeps its q row and its (m, l, acc) in
// registers.  K and V tiles of BK keys are staged in shared memory as f32
// (BK = 8192 / (2·DP) keys, 32 KB), every thread reads the same key at once
// (a broadcast), and the softmax is updated every 16 keys.  Tiles past the
// tile's last causal column, and tiles outside every row's window and the
// prefix (the reference's block-skip test, kernel.py:52-57), are never
// loaded, so causal attention does about half the work.  Dh is padded in
// registers to DP = 32, 64, 128 or 256 (zeros contribute nothing).
//
// Bound: operations.  At the tinyllama prefill (B=2, S=2048, H=32, KV=4,
// Dh=64, causal) the 4·B·H·Dh·S(S+1)/2 f32 FLOPs take ~0.5 ms at 67 TFLOP/s,
// the 2 MB of bf16 q/k/v/out ~1 µs at 3.35 TB/s.  This first design runs the
// products as FMAs out of shared memory (no tensor cores, no wgmma), so it
// sits at the f32 CUDA-core rate or below; bf16 mma/wgmma tiles are a later
// PR's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int MAX_ROWS = 128;      // threads (query rows × heads) a CTA
constexpr int TILE_FLOATS = 4096;  // floats in each of the K and V tiles
constexpr int SUB = 16;            // keys per online-softmax update

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float x, float* p) { *p = x; }
__device__ __forceinline__ void store_f32(float x, __nv_bfloat16* p) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(MAX_ROWS)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int sq, int sk, int h, int kvh, int dh, int bq,
                           int causal, int window, int prefix, float scale,
                           float cap) {
  constexpr int BK = TILE_FLOATS / DP;
  __shared__ __align__(16) float k_s[BK][DP];
  __shared__ __align__(16) float v_s[BK][DP];

  const int g = h / kvh;
  const int b = blockIdx.z;
  const int kv = blockIdx.y;
  const int t = threadIdx.x;
  const int nthreads = blockDim.x;
  const int gi = t / bq;
  const int r = t % bq;
  const int row = blockIdx.x * bq + r;
  const bool active = row < sq;
  const int head = kv * g + gi;
  const int qpos = sk - sq + row;
  const int q_start = sk - sq + blockIdx.x * bq;
  const int q_last = q_start + bq - 1;

  float qr[DP], acc[DP];
  const T* qp = q + (((int64_t)b * sq + row) * h + head) * dh;
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    qr[d] = (active && d < dh) ? load_f32(qp + d) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  const int k_end = causal ? min(sk, q_last + 1) : sk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    // block-level skip: the tile is outside every row's window and the
    // prefix (uniform across the CTA)
    if (window > 0 && !((q_start - (k0 + BK - 1)) < window || k0 < prefix))
      continue;
    const int nj = min(BK, k_end - k0);
    __syncthreads();
    for (int i = t; i < BK * DP; i += nthreads) {
      const int j = i / DP;
      const int d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (j < nj && d < dh) {
        const int64_t idx = (((int64_t)b * sk + k0 + j) * kvh + kv) * dh + d;
        kx = load_f32(k + idx);
        vx = load_f32(v + idx);
      }
      k_s[j][d] = kx;
      v_s[j][d] = vx;
    }
    __syncthreads();

    for (int j0 = 0; j0 < nj; j0 += SUB) {
      float s[SUB];
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        float sc = NEG_INF;
        if (j < nj) {
          const float4* kr = reinterpret_cast<const float4*>(k_s[j]);
          float dot = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < DP / 4; ++d4) {
            const float4 kk = kr[d4];
            dot = fmaf(qr[4 * d4], kk.x, dot);
            dot = fmaf(qr[4 * d4 + 1], kk.y, dot);
            dot = fmaf(qr[4 * d4 + 2], kk.z, dot);
            dot = fmaf(qr[4 * d4 + 3], kk.w, dot);
          }
          sc = dot * scale;
          if (cap > 0.f) sc = tanhf(sc / cap) * cap;
          const int col = k0 + j;
          bool ok = !causal || col <= qpos;
          if (window > 0) ok = ok && ((qpos - col) < window || col < prefix);
          if (!ok) sc = NEG_INF;
        }
        s[jj] = sc;
        mx = fmaxf(mx, sc);
      }
      const float corr = expf(m - mx);
      l *= corr;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc[d] *= corr;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        if (j < nj) {
          const float p = expf(s[jj] - mx);
          l += p;
          const float4* vr = reinterpret_cast<const float4*>(v_s[j]);
#pragma unroll
          for (int d4 = 0; d4 < DP / 4; ++d4) {
            const float4 vv = vr[d4];
            acc[4 * d4] = fmaf(p, vv.x, acc[4 * d4]);
            acc[4 * d4 + 1] = fmaf(p, vv.y, acc[4 * d4 + 1]);
            acc[4 * d4 + 2] = fmaf(p, vv.z, acc[4 * d4 + 2]);
            acc[4 * d4 + 3] = fmaf(p, vv.w, acc[4 * d4 + 3]);
          }
        }
      }
      m = mx;
    }
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = out + (((int64_t)b * sq + row) * h + head) * dh;
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < dh) store_f32(acc[d] / denom, op + d);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, void* out,
                 long long b, long long sq, long long sk, long long h,
                 long long kvh, long long dh, long long causal,
                 long long window, long long prefix, float scale, float cap,
                 cudaStream_t stream) {
  const int g = (int)(h / kvh);
  const int bq = g >= MAX_ROWS ? 1 : MAX_ROWS / g;
  dim3 grid((unsigned)((sq + bq - 1) / bq), (unsigned)kvh, (unsigned)b);
  const int threads = g * bq;
#define FA_LAUNCH(DP)                                                       \
  flash_attention_kernel<T, DP><<<grid, threads, 0, stream>>>(              \
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (int)sq, (int)sk,     \
      (int)h, (int)kvh, (int)dh, bq, (int)causal, (int)window, (int)prefix, \
      scale, cap)
  if (dh <= 32)
    FA_LAUNCH(32);
  else if (dh <= 64)
    FA_LAUNCH(64);
  else if (dh <= 128)
    FA_LAUNCH(128);
  else
    FA_LAUNCH(256);
#undef FA_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, sq, h, dh), k/v (b, sk, kvh, dh), out like q; all f32 (bf16 = 0) or
// all bf16 (bf16 = 1).  The wrapper checks h % kvh == 0, h / kvh <= 128 and
// dh <= 256.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, long long b,
                                      long long sq, long long sk, long long h,
                                      long long kvh, long long dh,
                                      long long causal, long long window,
                                      long long prefix, long long bf16,
                                      double scale, double cap, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || h / kvh > MAX_ROWS || dh <= 0 || dh > 256)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_typed<__nv_bfloat16>(q, k, v, out, b, sq, sk, h, kvh, dh,
                                       causal, window, prefix, (float)scale,
                                       (float)cap, (cudaStream_t)stream);
  return launch_typed<float>(q, k, v, out, b, sq, sk, h, kvh, dh, causal,
                             window, prefix, (float)scale, (float)cap,
                             (cudaStream_t)stream);
}
