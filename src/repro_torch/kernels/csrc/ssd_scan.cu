// Mamba2 SSD chunked scan, K12: the Hopper port of
// repro/kernels/ssd_scan/kernel.py::ssd_scan_pallas.
//
// x (B, S, H, P), dt (B, S, H) (softplus'ed), A (H,) negative, Bm/Cm
// (B, S, N), all f32, in the framework layout; y (B, S, H, P) and the final
// state (B, H, P, N).  Per chunk c of L rows, with cum = cumsum(dt·A):
//   y_c      = ((C Bᵀ) ∘ tril(exp(cum_i − cum_j)))·(dt·x) + exp(cum_i)·(C·prev_cᵀ)
//   state_c  = Σ_l exp(cum_L − cum_l)·(dt·x)_l ⊗ B_l
//   prev_c+1 = exp(cum_L)·prev_c + state_c,   prev_0 = 0
// Rows past S read as zeros with dt = 0, the reference wrapper's padding: an
// exact no-op (decay exp(0) = 1, every contribution scales with dt).  The
// decay is selected before the exp and never factored as
// exp(cum_i)·exp(−cum_j) (|cum| reaches ~10^3 in the model, where that
// overflows), so exp of a positive difference is never formed.
//
// Design: the TPU kernel's sequential grid over chunks becomes the
// chunk-parallel decomposition of the plain version (models/ssm.py
// ssd_chunked), in two launches on the caller's stream:
//   ssd_scan_cb_kernel     C_c B_cᵀ once per (b, chunk), the blocks on and
//                          left of the diagonal: B and C have no head axis.
//                          It writes C Bᵀ and C transposed (the chunk
//                          kernel's operands for 16-byte loads down k).
//   ssd_scan_chunk_kernel  one CTA per (b, chunk, h), 2,048 at the
//                          mamba2-1.3b prefill (B = 2, S = 2,048, H = 64)
//                          where the first design ran B·H = 128: the chunk's
//                          state; then the in-order state pass, fused: it
//                          waits for chunk c − 1 of its (b, h) to publish
//                          prev_c (a flag per chunk, CTAs in ticket order,
//                          so a CTA only waits on one that already runs)
//                          and publishes prev_c+1; then y.
// The (B, nc, H, N, P) f32 state buffer (67 MB at the mamba2 prefill) is
// written once and read once by the next chunk, mostly from L2.  Operands
// are staged with cp.async; ragged P, N and L tiles are zero-filled.
// 104 KB of shared memory a chunk CTA, two an SM.
//
// Products: f32 FMA chains on the CUDA cores, each output summed over k in
// ascending order from zero, the order of cuBLAS's f32 GEMMs in the plain
// version, with the elementwise steps rounded as the plain version rounds
// them (no contraction).  A thread holds 32 outputs (4 × 8 or 8 × 4), fed
// by three 16-byte shared loads a k.  The output rows pair blocks w and
// 15 − w of 8, so every warp does the same lower-triangle work.
// Tensor cores were tried and not kept: one TF32 pass keeps 11 of the 24
// significand bits and misses the 1e-5·(1 + max|y|) kernel gate by far;
// 3xTF32 (big = rna(a), small = rna(a − big), small·big + big·small +
// big·big) meets it, but its summation order, as every other one tried, put
// the random 48-layer f32 mamba2 model's logits outside its end-to-end
// gate at the prefill and over decode steps, 4- and 6-pass products too
// (PERF.md).
//
// Bound at the mamba2 prefill: 10.82 GFLOP of products (the decayed
// triangle times dt·x, the state feed and update per head, C Bᵀ per
// (b, chunk)) in three TF32 passes at 495 TFLOP/s, with the elementwise
// work at 67: 66.3 µs; the function's 143.6 MB at 3.35 TB/s: 42.9 µs.
// The FMAs this design does take 162.3 µs at the CUDA cores' 67 TFLOP/s.
// The design moves 602 MB more (x staged twice; B, Cᵀ and (C Bᵀ)ᵀ staged
// by every head; the state buffer written and read once), most of it from
// L2.  Measured: 6.1× the bound (PERF.md); the staging, the exps of the
// decay and the C Bᵀ launch are what two CTAs an SM do not hide.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;    // 8 warps
constexpr int P_MAX = 64;       // P, N, L limits of the tiles
constexpr int N_MAX = 128;
constexpr int L_MAX = 128;
constexpr int RS = 132;         // row stride of the 128-wide tiles (floats)
constexpr int XS = P_MAX + 8;   // 72: row stride of the P-wide tiles

// Stage `cols` floats of the first `rows` rows from global (row stride
// gstride) into shared (row stride sstride) with cp.async, zero-filling up
// to `cols_pad` columns and `rows_pad` rows.  A row has at most C4 float4
// slots, a compile-time count: each thread keeps one slot column and steps
// its pointers down the rows.  16-byte copies where `vec` (cols % 4 == 0
// and 16-byte aligned rows), else 4-byte.
template <int C4>
__device__ __forceinline__ void stage(float* dst, int sstride,
                                      const float* src, int64_t gstride,
                                      int rows, int rows_pad, int cols,
                                      int cols_pad, bool vec) {
  constexpr int RSTEP = THREADS / C4;
  const int q = 4 * (threadIdx.x % C4), r0 = threadIdx.x / C4;
  if (q >= cols_pad) return;
  const float* sp = src + r0 * gstride + q;
  float* dp = dst + r0 * sstride + q;
  if (vec) {
    const bool in = q < cols;
    for (int r = r0; r < rows_pad;
         r += RSTEP, sp += RSTEP * gstride, dp += RSTEP * sstride) {
      if (in && r < rows) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                         (uint32_t)__cvta_generic_to_shared(dp)),
                     "l"(sp));
      } else {
        *reinterpret_cast<float4*>(dp) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int r = r0; r < rows_pad;
         r += RSTEP, sp += RSTEP * gstride, dp += RSTEP * sstride) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (q + e < cols && r < rows) {
          asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                           (uint32_t)__cvta_generic_to_shared(dp + e)),
                       "l"(sp + e));
        } else {
          dp[e] = 0.f;
        }
      }
    }
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__device__ __forceinline__ int up(int v, int m) { return (v + m - 1) / m * m; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[R0 + r][0..3] += a[r] · b[0..3] for r < 4, one rounding each (FMA)
template <int R0>
__device__ __forceinline__ void fma4(float (&acc)[8][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    acc[R0 + r][0] = fmaf(av[r], b.x, acc[R0 + r][0]);
    acc[R0 + r][1] = fmaf(av[r], b.y, acc[R0 + r][1]);
    acc[R0 + r][2] = fmaf(av[r], b.z, acc[R0 + r][2]);
    acc[R0 + r][3] = fmaf(av[r], b.w, acc[R0 + r][3]);
  }
}

// Store 4 consecutive floats of a row (those below `cols`), as a float4
// where the row allows it.
__device__ __forceinline__ void store4(float* o, const float (&v)[4], int c0,
                                       int cols, bool vec) {
  if (vec && c0 + 3 < cols) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < cols) o[e] = v[e];
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v));
}

// ---- C Bᵀ per (b, chunk), one CTA per block of 16 rows i: columns j up to
// the block's end (the diagonal block included), stored transposed
// (cbt[j][i]); also C transposed (ct[n][i]) for the chunk kernel.  Thread:
// row i0 + t / 16, columns t % 16 + 16·q, k four at a time in 16-byte
// loads (in order).  The first block's CTA, which has the least C Bᵀ work,
// also clears the chunk kernel's flags and ticket and writes dt (0 past S)
// and cum = cumsum(dt·A) of every head, (row, head): a thread a head, in
// row order, as torch.cumsum sums along a non-innermost dimension: the
// plain version's bits.
__global__ void __launch_bounds__(THREADS, 2)
    ssd_scan_cb_kernel(const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm, float* __restrict__ cbuf,
                       int* __restrict__ flags, int s, int h, int n, int l,
                       int lp, bool vec) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;               // (16, RS)  C rows i0..i0+15
  float* bs = cs + 16 * RS;       // (i0 + 16, RS)  B rows
  const int i0 = 16 * blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t = threadIdx.x;
  const int c0 = c * l;
  const int np = up(n, 8);
  const int rows = min(l, s - c0);   // rows of the chunk before S
  const int64_t off = ((int64_t)b * s + c0) * n;
  float* cbt = cbuf + ((int64_t)b * nc + c) * (lp + n + 2 * h) * lp;
  float* ct = cbt + (int64_t)lp * lp;
  if (i0 == 0) {
    for (int i = t; i < h; i += THREADS)
      flags[((int64_t)b * nc + c) * h + i] = 0;
    if (c == 0 && b == 0 && t == 0) flags[(int64_t)gridDim.z * nc * h] = 0;
    float* hdt = ct + (int64_t)n * lp;        // (lp, h) dt
    float* hcum = hdt + (int64_t)lp * h;      // (lp, h) cum
    constexpr int BATCH = 16;      // rows whose dt loads go out together
    for (int hh = t; hh < h; hh += THREADS) {
      const float a = A[hh];
      float run = 0.f;
      for (int r0 = 0; r0 < lp; r0 += BATCH) {
        float v[BATCH];
#pragma unroll
        for (int r = 0; r < BATCH; ++r)
          v[r] = r0 + r < rows ? dt[((int64_t)b * s + c0 + r0 + r) * h + hh]
                               : 0.f;
#pragma unroll
        for (int r = 0; r < BATCH; ++r) {
          if (r0 + r < lp) {
            run = __fadd_rn(run, __fmul_rn(v[r], a));
            hdt[(int64_t)(r0 + r) * h + hh] = v[r];
            hcum[(int64_t)(r0 + r) * h + hh] = run;
          }
        }
      }
    }
  }
  stage<N_MAX / 4>(cs, RS, Cm + off + (int64_t)i0 * n, n, rows - i0, 16, n,
                   np, vec);
  stage<N_MAX / 4>(bs, RS, Bm + off, n, rows, i0 + 16, n, np, vec);
  stage_wait();
  __syncthreads();

  for (int e = t; e < 16 * n; e += THREADS) {
    const int ri = e % 16, k = e / 16;
    ct[(int64_t)k * lp + i0 + ri] = cs[ri * RS + k];
  }
  const int ri = t / 16, tj = t % 16;
  const int nq = blockIdx.x + 1;     // column groups up to the block's end
  float acc[L_MAX / 16] = {};
  for (int k = 0; k < np; k += 4) {
    const float4 cv = ld4(cs + ri * RS + k);
#pragma unroll
    for (int q = 0; q < L_MAX / 16; ++q) {
      if (q < nq) {
        const float4 bv = ld4(bs + (tj + 16 * q) * RS + k);
        acc[q] = fmaf(cv.x, bv.x, acc[q]);
        acc[q] = fmaf(cv.y, bv.y, acc[q]);
        acc[q] = fmaf(cv.z, bv.z, acc[q]);
        acc[q] = fmaf(cv.w, bv.w, acc[q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < L_MAX / 16; ++q)
    if (q < nq) cbt[(int64_t)(tj + 16 * q) * lp + i0 + ri] = acc[q];
}

// ---- per (b, chunk, h), taken in ticket order (item = (b·nc + c)·h + h'):
//   1. the chunk's state;
//   2. the in-order pass: wait for chunk c − 1 of the same (b, h) to
//      publish the state entering chunk c, publish exp(cum_L)·prev + state
//      (the final state at the last chunk), so the next chunk can start
//      its pass;
//   3. y = (C Bᵀ ∘ tril(exp(cum_i − cum_j)))·(dt·x) + exp(cum_i)·(C·prevᵀ).
// A CTA waits only for a ticket below its own, taken by a CTA that is
// already running, so the chain always moves.
__global__ void __launch_bounds__(THREADS, 2)
    ssd_scan_chunk_kernel(const float* __restrict__ x,
                          const float* __restrict__ Bm,
                          const float* __restrict__ cbuf,
                          float* __restrict__ y, float* __restrict__ st,
                          float* __restrict__ fs, int* __restrict__ flags,
                          int s, int h, int p, int n, int l, int lp, int nc,
                          bool vec, bool xvec, bool svec) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // (L_MAX, XS) x, then prevᵀ (n, p), x
  float* buf = xs + L_MAX * XS;   // (L_MAX, RS) B, then Cᵀ, then (C Bᵀ)ᵀ
  float* cum = buf + L_MAX * RS;  // (L_MAX,)
  float* dts = cum + L_MAX;       // (L_MAX,)  dt, 0 past l and S
  float* dec = dts + L_MAX;       // (L_MAX,)  exp(cum_L − cum_l)
  __shared__ int item_s;
  const int t = threadIdx.x;
  if (t == 0) item_s = atomicAdd(flags + (int64_t)gridDim.x, 1);
  __syncthreads();
  const int item = item_s;
  const int hh = item % h, c = (item / h) % nc, b = item / (h * nc);
  const int c0 = c * l;
  const int rows = min(l, s - c0);   // rows of the chunk before S
  const int lk = up(l, 8), np = up(n, 8), pt = up(p, 8);
  const int64_t xoff = (((int64_t)b * s + c0) * h + hh) * p;
  const float* cbt = cbuf + ((int64_t)b * nc + c) * (lp + n + 2 * h) * lp;
  const float* hdt = cbt + (int64_t)(lp + n) * lp + hh;   // (lp, h) dt
  const float* hcum = hdt + (int64_t)lp * h;                // (lp, h) cum

  // ---- 1. the chunk's state
  if (t < L_MAX) {
    dts[t] = t < lp ? hdt[(int64_t)t * h] : 0.f;
    cum[t] = t < lp ? hcum[(int64_t)t * h] : 0.f;
  }
  stage<N_MAX / 4>(buf, RS, Bm + ((int64_t)b * s + c0) * n, n, rows, lk, n,
                   np, vec);
  stage<P_MAX / 4>(xs, XS, x + xoff, (int64_t)h * p, rows, lk, p, pt, xvec);
  __syncthreads();
  const float total = cum[l - 1];
  if (t < lk) dec[t] = expf(total - cum[t]);
  stage_wait();
  __syncthreads();
  // (x·dt)·exp(cum_L − cum_l), as the plain version rounds it
  for (int i = t; i < lk * (P_MAX / 4); i += THREADS) {
    const int li = i / (P_MAX / 4), q = 4 * (i % (P_MAX / 4));
    if (q >= pt) continue;
    float4* v = reinterpret_cast<float4*>(xs + li * XS + q);
    const float d = dts[li], e = dec[li];
    float4 u = *v;
    u.x = __fmul_rn(__fmul_rn(u.x, d), e);
    u.y = __fmul_rn(__fmul_rn(u.y, d), e);
    u.z = __fmul_rn(__fmul_rn(u.z, d), e);
    u.w = __fmul_rn(__fmul_rn(u.w, d), e);
    *v = u;
  }
  __syncthreads();

  // state (p, n) = Σ_l xw[l][p] · B[l][n]: warp w rows 32·(w % 2) +
  // [0, 32), columns 32·(w / 2) + [0, 32); a thread p 4·(lane % 8) +
  // [0, 4), n 8·(lane / 8) + [0, 8)
  const int sp = 32 * (t / 32 % 2) + 4 * (t % 8);
  const int sn = 32 * (t / 64) + 8 * (t % 32 / 8);
  float sacc[8][4] = {};          // [n offset][p offset]
  if (sp < pt && sn < np) {
    for (int k = 0; k < lk; ++k) {
      const float4 a = ld4(xs + k * XS + sp);
      fma4<0>(sacc, ld4(buf + k * RS + sn), a);
      fma4<4>(sacc, ld4(buf + k * RS + sn + 4), a);
    }
  }
  __syncthreads();

  // ---- 2. the pass: Cᵀ is staged meanwhile
  float* prev = xs;               // (n, XS) the state entering the chunk, ᵀ
  if (c > 0) {
    stage<L_MAX / 4>(buf, RS, cbt + (int64_t)lp * lp, lp, n, np, lp, lp,
                     true);
    if (t == 0)
      while (ld_acquire(flags + item - h) == 0) __nanosleep(32);
    __syncthreads();
    stage<P_MAX / 4>(prev, XS, st + ((int64_t)item - h) * n * p, p, n, np, p,
                     pt, svec);
  }
  stage_wait();
  __syncthreads();
  {
    const float keep = expf(total);
    const bool last = c == nc - 1;
    float* out = last ? fs + ((int64_t)b * h + hh) * p * n
                      : st + (int64_t)item * n * p;
    if (sp < p && sn < n) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const float4 pv = c > 0 ? ld4(prev + (sn + q) * XS + sp)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sacc[q][r] = __fadd_rn(__fmul_rn(pa[r], keep), sacc[q][r]);
      }
      if (last) {   // (p, n)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (sp + r >= p) continue;
          float* o = out + (int64_t)(sp + r) * n + sn;
          const float v0[4] = {sacc[0][r], sacc[1][r], sacc[2][r], sacc[3][r]};
          const float v1[4] = {sacc[4][r], sacc[5][r], sacc[6][r], sacc[7][r]};
          store4(o, v0, sn, n, vec);
          store4(o + 4, v1, sn + 4, n, vec);
        }
      } else {      // (n, p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (sn + q < n)
            store4(out + (int64_t)(sn + q) * p + sp, sacc[q], sp, p, svec);
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (t == 0 && c < nc - 1) st_release(flags + item, 1);

  // ---- 3. y.  Warp w takes rows 8w + 4·hf + [0, 4) (block w) and
  // 8·(15 − w) + 4·hf + [0, 4) (block 15 − w), whose lower-triangle work
  // sums to the same for every warp, and columns 4·(lane % 16) + [0, 4).
  const int w = t / 32, lane = t % 32;
  const int hf = lane / 16, yp = 4 * (lane % 16);
  const int ra = 8 * w + 4 * hf, rb = 8 * (15 - w) + 4 * hf;
  const bool aon = 8 * w < lp, bon = 8 * (15 - w) < lp;
  float iacc[8][4] = {};          // C · prevᵀ, rows ra.., then rb..
  if (c > 0) {
    for (int k = 0; k < np; ++k) {
      const float4 pv = ld4(prev + k * XS + yp);
      fma4<0>(iacc, ld4(buf + k * RS + ra), pv);
      fma4<4>(iacc, ld4(buf + k * RS + rb), pv);
    }
    // ∘ exp(cum_i), as the plain version rounds it
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float e = expf(cum[(r < 4 ? ra : rb - 4) + r]);
#pragma unroll
      for (int q = 0; q < 4; ++q) iacc[r][q] = __fmul_rn(iacc[r][q], e);
    }
  }
  __syncthreads();

  // (C Bᵀ)ᵀ and x again (now in L2)
  stage<L_MAX / 4>(buf, RS, cbt, lp, lp, lp, lp, lp, true);
  stage<P_MAX / 4>(xs, XS, x + xoff, (int64_t)h * p, rows, lp, p, pt, xvec);
  stage_wait();
  __syncthreads();
  // the decayed C Bᵀ in place, (j, i), as the plain version rounds it:
  // select before the exp (j > i never forms exp(positive)), zeros above
  // the diagonal; and dt·x
  // Row j needs i from its 8-block on (the diagonal loop reads no
  // further left); rows j and lp − 1 − j share a warp pass, ~lp/4 + 1
  // float4 slots between them.
  for (int k = t / 32; k < lp / 2; k += THREADS / 32) {
    const int ja = k, jb = lp - 1 - k;
    const int sa = 2 * (ja / 8), sb = 2 * (jb / 8);
    const int na = lp / 4 - sa, nb = lp / 4 - sb;
    for (int e = t % 32; e < na + nb; e += 32) {
      const int j = e < na ? ja : jb, i = 4 * (e < na ? sa + e : sb + e - na);
      float4* v = reinterpret_cast<float4*>(buf + j * RS + i);
      float o[4] = {0.f, 0.f, 0.f, 0.f};
      if (i + 3 >= j) {
        const float4 u = *v;
        const float uv[4] = {u.x, u.y, u.z, u.w};
        const float cj = cum[j];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          if (i + r >= j) o[r] = __fmul_rn(uv[r], expf(cum[i + r] - cj));
      }
      *v = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  for (int e = t; e < lp * (P_MAX / 4); e += THREADS) {
    const int li = e / (P_MAX / 4), q = 4 * (e % (P_MAX / 4));
    if (q >= pt) continue;
    float4* v = reinterpret_cast<float4*>(xs + li * XS + q);
    const float d = dts[li];
    float4 u = *v;
    u.x = __fmul_rn(u.x, d);
    u.y = __fmul_rn(u.y, d);
    u.z = __fmul_rn(u.z, d);
    u.w = __fmul_rn(u.w, d);
    *v = u;
  }
  __syncthreads();

  // y_diag = Σ_j W[i][j] · xd[j][p] over j up to each block's diagonal
  // (W is zero above it)
  float dacc[8][4] = {};
  const int ka = aon ? 8 * (w + 1) : 0, kb = bon ? min(8 * (16 - w), lp) : 0;
  for (int j = 0; j < ka; ++j) {
    const float4 xv = ld4(xs + j * XS + yp);
    fma4<0>(dacc, ld4(buf + j * RS + ra), xv);
    if (bon) fma4<4>(dacc, ld4(buf + j * RS + rb), xv);
  }
  for (int j = ka; j < kb; ++j)
    fma4<4>(dacc, ld4(buf + j * RS + rb), ld4(xs + j * XS + yp));

  // y = y_diag + y_inter, rows past l or S not written
  float* yc = y + xoff;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = (r < 4 ? ra : rb - 4) + r;
    if (!(r < 4 ? aon : bon) || i >= rows || yp >= p) continue;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = __fadd_rn(dacc[r][q], iacc[r][q]);
    store4(yc + (int64_t)i * h * p + yp, v, yp, p, xvec);
  }
}

constexpr size_t CB_SMEM = 4 * (16 + L_MAX) * RS;                         // 76,032 B
constexpr size_t CHUNK_SMEM = 4 * (L_MAX * XS + L_MAX * RS + 3 * L_MAX);  // 105,984 B

}  // namespace

// x (b, s, h, p), dt (b, s, h), A (h,), Bm/Cm (b, s, n) f32; y like x, fs
// (b, h, p, n); scratch from the wrapper: st (b, nc, h, n, p) f32, flags
// (b·nc·h + 1) int32, cbuf (b, nc, lp + n + 2h, lp) f32 with lp = l
// rounded up to 16 ((C Bᵀ)ᵀ, Cᵀ, then dt and cum, (lp, h) each).  The wrapper checks p <= 64, n <= 128,
// l <= 128.  Two launches: C Bᵀ (which also clears the flags), then the
// chunks.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* A,
                               const void* Bm, const void* Cm, void* y,
                               void* fs, void* st, void* flags, void* cbuf,
                               long long b, long long s, long long h,
                               long long p, long long n, long long l,
                               void* stream) {
  if (b == 0 || h == 0 || s == 0) return 0;
  if (l <= 0 || l > L_MAX || p <= 0 || p > P_MAX || n <= 0 || n > N_MAX)
    return (int)cudaErrorInvalidValue;
  const long long nc = (s + l - 1) / l;
  const int lp = (int)((l + 15) / 16 * 16);
  auto a16 = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
  // 16-byte copies and stores need rows of a multiple of 4 floats and
  // aligned bases: B and final-state rows (n), x and y rows (p), the
  // state buffer's rows (p)
  const bool vec = n % 4 == 0 && a16(Bm) && a16(fs);
  const bool xvec = p % 4 == 0 && a16(x) && a16(y);
  const bool svec = p % 4 == 0 && a16(st);
  cudaStream_t strm = (cudaStream_t)stream;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(ssd_scan_cb_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)CB_SMEM)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(ssd_scan_chunk_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)CHUNK_SMEM)) != cudaSuccess)
    return (int)err;
  ssd_scan_cb_kernel<<<dim3((unsigned)(lp / 16), (unsigned)nc, (unsigned)b),
                       THREADS, CB_SMEM, strm>>>(
      (const float*)dt, (const float*)A, (const float*)Bm, (const float*)Cm,
      (float*)cbuf, (int*)flags, (int)s, (int)h, (int)n, (int)l, lp,
      vec && a16(Cm));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long items = b * nc * h;
  ssd_scan_chunk_kernel<<<(unsigned)items, THREADS, CHUNK_SMEM, strm>>>(
      (const float*)x, (const float*)Bm, (const float*)cbuf, (float*)y,
      (float*)st, (float*)fs, (int*)flags,
      (int)s, (int)h, (int)p, (int)n, (int)l, lp, (int)nc, vec, xvec, svec);
  return (int)cudaGetLastError();
}
