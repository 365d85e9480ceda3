// Mamba2 SSD chunked scan (Hopper port of
// repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas).
//
// x (B, S, H, P), dt (B, S, H) (softplus'ed), A (H,) negative, Bm/Cm
// (B, S, N), all f32, in the framework layout; y (B, S, H, P) and the final
// state (B, H, P, N).  Per (b, h) the chunks of L rows run in order, carrying
// the (P, N) state; per chunk:
//   cum   = cumsum(dt·A)
//   y     = ((C Bᵀ) ∘ tril(exp(cum_i − cum_j))) · (dt·x) + (C · stateᵀ) ∘ exp(cum)
//   state = exp(cum_L)·state + Σ_l exp(cum_L − cum_l)·(dt·x)_l ⊗ B_l
// Rows past S read as zeros with dt = 0, the reference wrapper's padding: an
// exact no-op (decay exp(0) = 1, every contribution scales with dt).  The
// decay is selected before the exp, so exp of a positive difference above the
// diagonal (which can be inf, and inf·0 = NaN) is never formed.
//
// Design: the TPU kernel's sequential chunk grid axis becomes a loop inside
// one CTA per (b, h), 256 threads.  Shared memory holds the state, dt·x, B
// and C of the chunk (rows padded to N+1 floats: threads that walk rows read
// distinct banks), a 16-row block of the decayed C Bᵀ and the cumulative
// decays: ~202 KB at P = 64, N = 128, L = 128, above the 48 KB default, so the
// launcher raises the kernel's dynamic shared memory limit.  The products are
// register tiles (2 rows × 4 columns of C Bᵀ, 2 × 2 of y, 8 × 4 of the state
// a thread), so a shared-memory read feeds 1.3–2.7 FMAs; blocks right of the
// diagonal are skipped.  The first design, one output a thread with two reads
// an FMA, took 5.5× its plain version's time (PERF.md).
//
// Bound: operations.  At the mamba2-1.3b prefill (B = 2, S = 2048, H = 64,
// P = 64, N = 128, L = 128) the lower-triangle C Bᵀ, its product with dt·x,
// the state feed and the state update are ~13 GFLOP, ~0.2 ms at 67 TFLOP/s;
// the 75 MB of x, B, C, dt, y and state ~22 µs at 3.35 TB/s.  Only B·H CTAs
// run (128 on 132 SMs at B = 2), one per SM for the shared memory, and every
// product is a scalar FMA out of shared memory: chunk states in parallel,
// then a short scan, and tensor-core tiles are later PRs' work.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int RB = 16;          // rows of the decayed C Bᵀ block
constexpr int P_MAX = 64;       // P, N, L limits of the register tiles
constexpr int N_MAX = 128;
constexpr int L_MAX = 128;

__global__ void __launch_bounds__(THREADS)
    ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    const float* __restrict__ Cm, float* __restrict__ y,
                    float* __restrict__ fs, int s, int h, int p, int n,
                    int l) {
  extern __shared__ float smem[];
  const int ns = n + 1;          // padded row stride of B, C and the state
  float* st = smem;              // (p, ns)
  float* xd = st + p * ns;       // (l, p)   dt·x
  float* bs = xd + l * p;        // (l, ns)
  float* cs = bs + l * ns;       // (l, ns)
  float* w = cs + l * ns;        // (RB, l)  decayed C Bᵀ rows
  float* cum = w + RB * l;       // (l,)
  float* dte = cum + l;          // (l,)     exp(cum_L − cum_l)

  const int hh = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const float a = A[hh];
  // register tiles: a warp owns 2 rows (i) of a block or 8 rows (p) of the
  // state; its lanes walk columns 32 apart, so a row-strided (ns = n + 1)
  // read hits 32 distinct banks
  const int wp = t / 32;
  const int lane = t % 32;

  for (int i = t; i < p * ns; i += THREADS) st[i] = 0.f;

  const int nc = (s + l - 1) / l;
  for (int c = 0; c < nc; ++c) {
    const int c0 = c * l;
    // ---- stage the chunk: dt·x, B, C, dt·A
    for (int i = t; i < l * p; i += THREADS) {
      const int li = i / p, pi = i % p;
      const int row = c0 + li;
      float v = 0.f;
      if (row < s) {
        const int64_t rh = ((int64_t)b * s + row) * h + hh;
        v = x[rh * p + pi] * dt[rh];
      }
      xd[i] = v;
    }
    for (int i = t; i < l * n; i += THREADS) {
      const int li = i / n, ni = i % n;
      const int row = c0 + li;
      float bv = 0.f, cv = 0.f;
      if (row < s) {
        const int64_t off = ((int64_t)b * s + row) * n + ni;
        bv = Bm[off];
        cv = Cm[off];
      }
      bs[li * ns + ni] = bv;
      cs[li * ns + ni] = cv;
    }
    for (int i = t; i < l; i += THREADS) {
      const int row = c0 + i;
      cum[i] = row < s ? dt[((int64_t)b * s + row) * h + hh] * a : 0.f;
    }
    __syncthreads();
    if (t == 0) {
      float run = 0.f;
      for (int i = 0; i < l; ++i) {
        run += cum[i];
        cum[i] = run;
      }
    }
    __syncthreads();
    const float total = cum[l - 1];
    for (int i = t; i < l; i += THREADS) dte[i] = expf(total - cum[i]);

    // ---- outputs, RB rows at a time
    for (int i0 = 0; i0 < l; i0 += RB) {
      // decayed C Bᵀ: rows i0 + 2·wp + {0, 1}, columns lane + 32·q; column
      // groups right of the block's last row are all zero and skipped
      const int q_hi = min(L_MAX / 32, (min(l, i0 + RB) - 1) / 32 + 1);
      const int r0 = i0 + 2 * wp;
      {
        float acc[2][L_MAX / 32] = {};
        const float* c0r = cs + min(r0, l - 1) * ns;
        const float* c1r = cs + min(r0 + 1, l - 1) * ns;
        const float* bq[L_MAX / 32];
#pragma unroll
        for (int q = 0; q < L_MAX / 32; ++q)
          bq[q] = bs + min(lane + 32 * q, l - 1) * ns;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float cv0 = c0r[k], cv1 = c1r[k];
#pragma unroll
          for (int q = 0; q < L_MAX / 32; ++q) {
            if (q < q_hi) {
              const float bv = bq[q][k];
              acc[0][q] = fmaf(cv0, bv, acc[0][q]);
              acc[1][q] = fmaf(cv1, bv, acc[1][q]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r0 + r;
#pragma unroll
          for (int q = 0; q < L_MAX / 32; ++q) {
            const int j = lane + 32 * q;
            if (q < q_hi && j < l) {
              // select before the exp: j > i never forms exp(positive)
              w[(2 * wp + r) * l + j] =
                  (i < l && j <= i) ? acc[r][q] * expf(cum[i] - cum[j]) : 0.f;
            }
          }
        }
      }
      __syncthreads();
      // y rows r0 + {0, 1}, columns lane and lane + 32
      {
        const int j_end = min(l, i0 + RB);
        const int pc0 = min(lane, p - 1), pc1 = min(lane + 32, p - 1);
        const float* w0 = w + (2 * wp) * l;
        const float* w1 = w0 + l;
        float yd[2][2] = {}, fd[2][2] = {};
        for (int j = 0; j < j_end; ++j) {
          const float wa = w0[j], wb = w1[j];
          const float xa = xd[j * p + pc0], xb = xd[j * p + pc1];
          yd[0][0] = fmaf(wa, xa, yd[0][0]);
          yd[0][1] = fmaf(wa, xb, yd[0][1]);
          yd[1][0] = fmaf(wb, xa, yd[1][0]);
          yd[1][1] = fmaf(wb, xb, yd[1][1]);
        }
        const float* c0r = cs + min(r0, l - 1) * ns;
        const float* c1r = cs + min(r0 + 1, l - 1) * ns;
        const float* s0 = st + pc0 * ns;
        const float* s1 = st + pc1 * ns;
#pragma unroll 4
        for (int k = 0; k < n; ++k) {
          const float ca = c0r[k], cb = c1r[k];
          const float sa = s0[k], sb = s1[k];
          fd[0][0] = fmaf(ca, sa, fd[0][0]);
          fd[0][1] = fmaf(ca, sb, fd[0][1]);
          fd[1][0] = fmaf(cb, sa, fd[1][0]);
          fd[1][1] = fmaf(cb, sb, fd[1][1]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r0 + r;
          if (i >= l || c0 + i >= s) continue;
          float* yr = y + (((int64_t)b * s + c0 + i) * h + hh) * p;
          const float ec = expf(cum[i]);
          if (lane < p) yr[lane] = yd[r][0] + fd[r][0] * ec;
          if (lane + 32 < p) yr[lane + 32] = yd[r][1] + fd[r][1] * ec;
        }
      }
      __syncthreads();
    }

    // ---- state update (every read of the old state is done): rows
    // wp + 8·r of P, columns lane + 32·q of N
    {
      float upd[P_MAX / 8][N_MAX / 32] = {};
      for (int li = 0; li < l; ++li) {
        const float dl = dte[li];
        const float* xl = xd + li * p;
        const float* bl = bs + li * ns;
        float xv[P_MAX / 8], bv[N_MAX / 32];
#pragma unroll
        for (int r = 0; r < P_MAX / 8; ++r)
          xv[r] = dl * xl[min(wp + 8 * r, p - 1)];
#pragma unroll
        for (int q = 0; q < N_MAX / 32; ++q) bv[q] = bl[min(lane + 32 * q, n - 1)];
#pragma unroll
        for (int r = 0; r < P_MAX / 8; ++r)
#pragma unroll
          for (int q = 0; q < N_MAX / 32; ++q)
            upd[r][q] = fmaf(xv[r], bv[q], upd[r][q]);
      }
      const float keep = expf(total);
#pragma unroll
      for (int r = 0; r < P_MAX / 8; ++r) {
        const int pi = wp + 8 * r;
#pragma unroll
        for (int q = 0; q < N_MAX / 32; ++q) {
          const int ni = lane + 32 * q;
          if (pi < p && ni < n) {
            float* sv = st + pi * ns + ni;
            *sv = keep * *sv + upd[r][q];
          }
        }
      }
    }
    __syncthreads();
  }

  float* out = fs + ((int64_t)b * h + hh) * p * n;
  for (int e = t; e < p * n; e += THREADS)
    out[e] = st[(e / n) * ns + e % n];
}

// Dynamic shared memory the kernel needs at (p, n, l): at most 207,104 B.
long long smem_bytes(long long p, long long n, long long l) {
  return 4 * (p * (n + 1) + l * p + 2 * l * (n + 1) + RB * l + 2 * l);
}

}  // namespace

// x (b, s, h, p), dt (b, s, h), A (h,), Bm/Cm (b, s, n) f32; y like x, fs
// (b, h, p, n).  The wrapper checks p <= 64, n <= 128, l <= 128.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* fs, long long b, long long s,
                               long long h, long long p, long long n,
                               long long l, void* stream) {
  if (b == 0 || h == 0) return 0;
  if (l <= 0 || l > L_MAX || p <= 0 || p > P_MAX || n <= 0 || n > N_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)smem_bytes(p, n, l);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)h, (unsigned)b);
  ssd_scan_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)dt, (const float*)A, (const float*)Bm,
      (const float*)Cm, (float*)y, (float*)fs, (int)s, (int)h, (int)p,
      (int)n, (int)l);
  return (int)cudaGetLastError();
}
